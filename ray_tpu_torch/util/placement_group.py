"""Placement groups: atomic multi-bundle resource reservations.

Parity: python/ray/util/placement_group.py (:41 PlacementGroup, :145
placement_group()). Strategies PACK/SPREAD/STRICT_PACK/STRICT_SPREAD
from the reference, plus the TPU-native "SLICE" strategy: bundles are
mapped onto ICI-contiguous chips of one slice so a gang-scheduled
jax.distributed group gets a torus-contiguous sub-mesh (the reference
approximates this with per-pod custom resources, python/ray/_private/
accelerators/tpu.py:375; here it is a first-class strategy).

On the single-host runtime every strategy degenerates to reserving
bundles against the node; the 2-phase prepare/commit of the reference's
GcsPlacementGroupScheduler (gcs_placement_group_scheduler.h:122) is not
needed until multi-node lands.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .._private.ids import PlacementGroupID
from ..object_ref import ObjectRef

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "SLICE")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self._bundles = bundles
        self._strategy = strategy

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self) -> ObjectRef:
        """An ObjectRef that resolves (to True) when all bundles are reserved."""
        from .._private import worker

        client = worker.get_client()
        from .._private.ids import ObjectID

        oid = ObjectID.generate()

        def waiter():
            ok = client.pg_ready(self.id.binary(), timeout=3600.0)
            client.put_value(ok, object_id=oid)

        threading.Thread(target=waiter, daemon=True).start()
        return ObjectRef(oid)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        from .._private import worker

        return worker.get_client().pg_ready(self.id.binary(), timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles, self._strategy))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    priority: Optional[int] = None,
    tenant: Optional[str] = None,
) -> PlacementGroup:
    """``priority``/``tenant`` override the driver's registered
    JobConfig identity for this reservation (fairsched): a
    higher-priority reservation that cannot fit may preempt
    strictly-lower-priority gangs to claim its chips."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy}; must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError("each bundle must be a non-empty dict of resources")
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resource amounts must be >= 0")
    from .._private import worker

    client = worker.get_client()
    pg_id = client.create_placement_group(
        [dict(b) for b in bundles], strategy, name,
        tenant=tenant, priority=priority,
    )
    return PlacementGroup(PlacementGroupID(pg_id), [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from .._private import worker

    worker.get_client().remove_placement_group(pg.id.binary())


def placement_group_table() -> dict:
    from .._private import worker

    items = worker.get_client().list_state("placement_groups")
    return {it["pg_id"]: it for it in items}


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group the calling task/actor runs inside, or None.

    Parity: python/ray/util/placement_group.py
    get_current_placement_group (reference callers use it for nested
    scheduling — children placed into the parent's PG). The executor
    pins (pg_id, bundle) in a contextvar; bundles/strategy come from
    the hub's PG table.
    """
    from ..runtime_context import _current_pg

    cur = _current_pg.get()
    if cur is None:
        return None
    pg_id = cur[0]
    from .._private import worker

    if not worker.is_initialized():
        return None
    for it in worker.get_client().list_state("placement_groups"):
        if it["pg_id"] == pg_id.hex():
            return PlacementGroup(
                PlacementGroupID(pg_id), it["bundles"], it["strategy"]
            )
    return None
