"""The parallel layer (counterpart of ``ray_tpu/parallel``): meshes over
the ranks of a process group, shardings, train state, train and eval
steps (on one device or over a mesh), and the pipeline schedules. See
``parallel/mesh.py`` for the axis conventions."""

from .mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    MeshConfig,
    NamedSharding,
    P,
    batch_sharding,
    batch_spec,
    dp_degree,
    get_mesh,
    make_mesh,
    mesh_axis_size,
    set_mesh,
    single_device_mesh,
)
from .pipeline import pipe_mesh, pipeline_apply, pipeline_sharded, pipeline_train
from .train_step import (
    AdamWState,
    Optimizer,
    TrainState,
    create_train_state,
    default_optimizer,
    global_norm,
    make_eval_step,
    make_train_step,
    state_shardings,
    tree_leaves,
    tree_map,
)

__all__ = [
    "AXIS_ORDER",
    "BATCH_AXES",
    "MeshConfig",
    "NamedSharding",
    "P",
    "batch_sharding",
    "batch_spec",
    "dp_degree",
    "get_mesh",
    "make_mesh",
    "mesh_axis_size",
    "set_mesh",
    "single_device_mesh",
    "pipe_mesh",
    "pipeline_apply",
    "pipeline_sharded",
    "pipeline_train",
    "AdamWState",
    "Optimizer",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "global_norm",
    "make_eval_step",
    "make_train_step",
    "state_shardings",
    "tree_leaves",
    "tree_map",
]
