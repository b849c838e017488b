"""Checker registry: importing this package registers every checker
with :func:`ray_tpu_torch.tools.graftlint.core.register`. Add a new rule by
dropping a module here and importing it below (see README.md)."""

from . import (  # noqa: F401
    gl001_lock_discipline,
    gl002_reactor_except,
    gl003_blocking_async,
    gl004_remote_misuse,
    gl005_unbounded_accumulator,
    gl006_accumulator_init,
    gl007_reflection_dispatch,
    gl008_wall_clock_duration,
    gl009_unbounded_registry,
    gl010_cross_shard_state,
    gl011_retry_without_backoff,
    gl012_protocol_conformance,
    gl013_thread_ownership,
    gl014_lock_order,
    gl015_async_discipline,
    gl016_resource_lifecycle,
    gl017_deadline_conformance,
    gl018_invariant_reserialization,
)
