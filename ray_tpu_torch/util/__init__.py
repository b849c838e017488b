"""Utilities: placement groups, scheduling strategies, actor pools; the
state API (``util.state``), metrics, the sampling profiler's reader and
the remote debugger (``util.metrics``, ``util.profiler``, ``util.rpdb``)
are submodules, imported where used."""

from .actor_pool import ActorPool
from .placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "get_current_placement_group",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
]
