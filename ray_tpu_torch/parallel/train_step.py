"""Train state, optimizer and train steps: the port of
``ray_tpu/parallel/train_step.py`` on one device.

``default_optimizer`` computes what the reference's optax chain computes,
``clip_by_global_norm`` then ``adamw`` on a warmup-cosine schedule, as
plain functions on tensors (an ``init``/``update`` pair):

- the clip divides by the global norm and multiplies by the limit only
  when the norm is at least the limit (a select, not a clamp);
- AdamW keeps its moments in the parameter dtype, corrects the bias with
  the count after it is incremented, adds ``weight_decay * p`` to the Adam
  direction of every tensor (no mask) and then scales by ``-lr``;
- the schedule reads the count before it is incremented, so step 0 has
  lr 0 and changes no parameter;
- Python scalars are rounded to the parameter dtype before they multiply
  a tensor, as JAX's weakly typed scalars are (b1 = 0.9 is 0.8984375 in
  bf16), and every op of the chain rounds to that dtype, a product before
  the sum it feeds, as XLA rounds them on the CPU: given the same clip
  factor, bf16 results equal optax's bit for bit there;
- on the CPU the chain runs as that loop of ops, on a CUDA device as one
  kernel a leaf that repeats its ops and roundings bit for bit
  (``ops/cuda_adamw.py``).

The global norm is summed in f32 (the reference sums each bf16 leaf in
bf16).

Over a mesh (``create_train_state(mesh, ...)``, ``make_train_step(loss_fn,
optimizer, mesh, state_sh)``) every rank runs the same calls and holds its
shards of the parameters and of their Adam moments (each moment takes its
parameter's spec, as ``map_opt`` does in the reference; counts and the step
are replicated). The step sets the ambient mesh around ``loss_fn``, which
takes the global batch, as the reference's step does, and returns the
global loss (the models cut their rows and sum the ranks' shares,
``parallel/comm.py``). Gradients are summed over every axis a parameter is
replicated on, in one flat buffer per (axes, dtype); the global norm sums
each shard's squares in f32, once per distinct shard, across the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._private.device import DeviceLike, resolve_device
from ..ops import cuda_adamw
from ..util import tracing
from . import comm
from .mesh import AXIS_ORDER, NamedSharding, P, mesh_axis_size, replicated_axes, set_mesh

Params = Any


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: Any


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree (nested dicts, lists, tuples) in a
    fixed order: dict keys in insertion order, depth first."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32 (0-d tensor)."""
    sq = [torch.linalg.vector_norm(t, 2, dtype=torch.float32) ** 2 for t in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    decay_steps)``: linear from 0 to peak over ``warmup_steps``, then
    cosine from peak to 0 over the remaining ``decay_steps - warmup_steps``."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_value * max(count, 0) / warmup_steps
        c = min(count - warmup_steps, cos_steps)
        return peak_value * 0.5 * (1 + math.cos(math.pi * c / cos_steps))

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int          # updates applied so far
    mu: Params          # first moment, in the parameter dtype
    nu: Params          # second moment, in the parameter dtype


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params,
    grad_norm=None) -> (state, grad_norm)`` applies the update to ``params``
    IN PLACE (under ``torch.no_grad``) and returns the global norm of
    ``grads`` before clipping (computed here unless given: a sharded step
    gives the norm over every shard); ``grads`` is any tree with the leaves
    of ``params`` in their order, a flat list included. ``learning_rate(count)`` is the
    schedule."""
    init: Callable[[Params], AdamWState]
    update: Callable[[Params, AdamWState, Params], Tuple[AdamWState, torch.Tensor]]
    learning_rate: Callable[[int], float]


def default_optimizer(learning_rate: float = 3e-4, *, warmup_steps: int = 100,
                      total_steps: int = 10000, weight_decay: float = 0.1,
                      grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.95
                      ) -> Optimizer:
    """clip_by_global_norm(grad_clip) then AdamW(b1, b2, eps 1e-8,
    weight_decay) on warmup_cosine_decay_schedule(learning_rate,
    warmup_steps, max(total_steps, warmup_steps + 1))."""
    eps = 1e-8  # optax.adamw's default
    sched = warmup_cosine_decay_schedule(learning_rate, warmup_steps,
                                         max(total_steps, warmup_steps + 1))

    def init(params: Params) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads: Params, state: AdamWState, params: Params,
               grad_norm: torch.Tensor = None) -> Tuple[AdamWState, torch.Tensor]:
        gs, ps = tree_leaves(grads), tree_leaves(params)
        mus, nus = tree_leaves(state.mu), tree_leaves(state.nu)
        gnorm = global_norm(gs) if grad_norm is None else grad_norm
        count = state.count + 1
        # f32 bias corrections; the lr reads the count before the increment
        bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** count)
        cuda_adamw.adamw_update(gs, ps, mus, nus, gnorm, cuda_adamw.AdamWStep(
            grad_clip, b1, b2, eps, weight_decay, sched(state.count), bc1, bc2))
        return AdamWState(count, state.mu, state.nu), gnorm

    return Optimizer(init, update, sched)


def create_train_state(*args, **kwargs):
    """``create_train_state(generator, init_params_fn, optimizer,
    device=None) -> TrainState`` on one device, or
    ``create_train_state(mesh, generator, init_params_fn, optimizer,
    param_specs) -> (TrainState, shardings)`` over a mesh, as the
    reference's: see ``_create_state`` and ``_create_sharded_state``."""
    if args and isinstance(args[0], DeviceMesh):
        return _create_sharded_state(*args, **kwargs)
    return _create_state(*args, **kwargs)


def _create_state(generator: torch.Generator,
                  init_params_fn: Callable[[torch.Generator], Params],
                  optimizer: Optimizer, device: DeviceLike = None) -> TrainState:
    """A fresh TrainState on ``device`` (the GPU unless "cpu" is asked;
    raises without CUDA): ``init_params_fn(generator)`` makes the
    parameters, which become leaves that require grad, and
    ``optimizer.init`` the optimizer state beside them."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                      init_params_fn(generator))
    return TrainState(0, params, optimizer.init(tree_map(lambda t: t.detach(), params)))


def _structure(tree) -> Any:
    if isinstance(tree, P):
        return None
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _shardings(mesh: DeviceMesh, param_specs: Params, opt_state: Any) -> Tuple[Any, Any]:
    """(param shardings, optimizer-state shardings): a subtree of the
    optimizer state shaped like the parameters takes their specs (matched by
    structure, as ``map_opt``); everything else is replicated."""
    def to_sharding(specs):
        if isinstance(specs, P):
            return NamedSharding(mesh, specs)
        if isinstance(specs, dict):
            return {k: to_sharding(v) for k, v in specs.items()}
        return type(specs)(to_sharding(v) for v in specs)

    shape = _structure(param_specs)

    def map_opt(node):
        if isinstance(node, (dict, list)) and _structure(node) == shape:
            return to_sharding(param_specs)
        if dataclasses.is_dataclass(node):
            return type(node)(**{f.name: map_opt(getattr(node, f.name))
                                 for f in dataclasses.fields(node)})
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[map_opt(x) for x in node])
        if isinstance(node, (tuple, list)):
            return type(node)(map_opt(x) for x in node)
        if isinstance(node, dict):
            return {k: map_opt(v) for k, v in node.items()}
        return NamedSharding(mesh, P())

    return to_sharding(param_specs), map_opt(opt_state)


def state_shardings(mesh: DeviceMesh, param_specs: Params,
                    init_fn: Callable[[], TrainState]) -> Tuple[TrainState, TrainState]:
    """(shardings, state) of the TrainState ``init_fn()`` makes: the params
    take ``param_specs``, every param-shaped subtree of the optimizer state
    (the Adam moments) too, and the rest (counts, the step) is replicated.
    ``init_fn`` runs here (make it cheap, on the ``meta`` device, where only
    the structure matters)."""
    state = init_fn()
    param_sh, opt_sh = _shardings(mesh, param_specs, state.opt_state)
    return TrainState(NamedSharding(mesh, P()), param_sh, opt_sh), state


def _create_sharded_state(mesh: DeviceMesh, generator: torch.Generator,
                          init_params_fn: Callable[[torch.Generator], Params],
                          optimizer: Optimizer, param_specs: Params
                          ) -> Tuple[TrainState, TrainState]:
    """This rank's TrainState over ``mesh`` and the state's shardings.
    ``init_params_fn(generator)`` runs on every rank (the same generator
    state gives the same full tree), and each rank keeps its shards: the
    full tree lives only while they are cut."""
    from ..models.convert import shard_params

    params = shard_params(tree_map(lambda t: t.detach(), init_params_fn(generator)),
                          mesh, param_specs)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    state = TrainState(0, params, optimizer.init(tree_map(lambda t: t.detach(), params)))
    return state, state_shardings(mesh, param_specs, lambda: state)[0]


def _spec_list(state_sh: TrainState) -> List[P]:
    """The specs of the parameter leaves, in ``tree_leaves`` order."""
    def leaves(tree):
        if isinstance(tree, NamedSharding):
            return [tree.spec]
        if isinstance(tree, dict):
            return [s for v in tree.values() for s in leaves(v)]
        return [s for v in tree for s in leaves(v)]

    return leaves(state_sh.params)


def reduce_grads(grads: List[torch.Tensor], specs: List[P], mesh: DeviceMesh
                 ) -> List[torch.Tensor]:
    """Each gradient summed over the axes its parameter is replicated on:
    one flat buffer per (axes, dtype), one all-reduce per axis."""
    groups: Dict[Any, List[int]] = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        axes = tuple(replicated_axes(mesh, spec))
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in groups.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        comm.all_reduce_axes_(flat, mesh, axes)
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


def sharded_global_norm(grads: List[torch.Tensor], specs: List[P],
                        mesh: DeviceMesh) -> torch.Tensor:
    """The global norm of sharded gradients: each shard's squares in f32
    over the number of ranks holding that shard, summed across the mesh."""
    sq = [torch.linalg.vector_norm(g, 2, dtype=torch.float32) ** 2
          / math.prod(mesh_axis_size(mesh, a) for a in replicated_axes(mesh, s))
          for g, s in zip(grads, specs)]
    total = comm.all_reduce_axes_(torch.stack(sq).sum(), mesh, AXIS_ORDER)
    return torch.sqrt(total)


def make_train_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
                    optimizer: Optimizer, mesh: DeviceMesh = None,
                    state_sh: TrainState = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``:
    loss and gradients by autograd, then the optimizer. ``grad_norm`` is
    the global norm before clipping. The parameters and the optimizer
    state are updated IN PLACE under ``torch.no_grad()``, the counterpart
    of the reference step's donation: the returned state holds the same
    tensors, and the state passed in must not be used again. Nothing here
    waits for the device; ``loss`` and ``grad_norm`` are 0-d tensors.

    With ``mesh`` and ``state_sh`` (from ``create_train_state(mesh, ...)``)
    every rank calls the step with the same global batch: ``loss_fn`` runs
    under ``set_mesh(mesh)``, the gradients are summed over the axes each
    parameter is replicated on, and the norm is taken over every shard, so
    loss, norm and the replicated leaves agree on every rank.

    The step opens ``tracing.span``s ``train_step.forward`` (``loss_fn``),
    ``train_step.backward`` (``torch.autograd.grad``), on a mesh
    ``train_step.grad_sync`` (the gradients' sum and the global norm) and
    ``train_step.update`` (the optimizer): ranges in a torch profiler's
    trace, records for the hub under ``RAY_TPU_TORCH_TRACING``."""
    specs = _spec_list(state_sh) if mesh is not None else None

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        gnorm = None
        with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            with tracing.span("train_step.forward"):
                loss = loss_fn(state.params, batch)
            with tracing.span("train_step.backward"):
                grads = torch.autograd.grad(loss, leaves)
            if mesh is not None:
                with tracing.span("train_step.grad_sync"):
                    grads = reduce_grads(list(grads), specs, mesh)
                    gnorm = sharded_global_norm(grads, specs, mesh)
        with tracing.span("train_step.update"):
            opt_state, gnorm = optimizer.update(grads, state.opt_state, state.params, gnorm)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def make_eval_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
                   mesh: DeviceMesh = None, state_sh: TrainState = None
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """``step(state, batch) -> {"loss"}`` without gradients (under
    ``set_mesh(mesh)`` when a mesh is given)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with torch.no_grad(), (set_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
            return {"loss": loss_fn(state.params, batch)}

    return step
