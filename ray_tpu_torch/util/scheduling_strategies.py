"""Scheduling strategies. Parity: python/ray/util/scheduling_strategies.py."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    """Schedule a task/actor into a placement group bundle."""

    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: Optional[bool] = None,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    """Pin to a node (single-host runtime: always the local node)."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}


# "DEFAULT" / "SPREAD" string strategies are also accepted, matching the
# reference's hybrid/spread policy names (src/ray/raylet/scheduling/policy/).
DEFAULT_SCHEDULING_STRATEGY = "DEFAULT"
SPREAD_SCHEDULING_STRATEGY = "SPREAD"
