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
  factor, bf16 results equal optax's bit for bit there.

The global norm is summed in f32 (the reference sums each bf16 leaf in
bf16). Mesh, ``state_shardings`` and ``param_specs`` wait for the
collectives slice: on one device they mean nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from .._private.device import DeviceLike, resolve_device

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
    """``init(params) -> state``; ``update(grads, state, params) ->
    (state, grad_norm)`` applies the update to ``params`` IN PLACE (under
    ``torch.no_grad``) and returns the global norm of ``grads`` before
    clipping; ``grads`` is any tree with the leaves of ``params`` in
    their order, a flat list included. ``learning_rate(count)`` is the
    schedule."""
    init: Callable[[Params], AdamWState]
    update: Callable[[Params, AdamWState, Params], Tuple[AdamWState, torch.Tensor]]
    learning_rate: Callable[[int], float]


def _scalar(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype``, as a weakly typed JAX scalar is."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


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
    def update(grads: Params, state: AdamWState,
               params: Params) -> Tuple[AdamWState, torch.Tensor]:
        gs, ps = tree_leaves(grads), tree_leaves(params)
        mus, nus = tree_leaves(state.mu), tree_leaves(state.nu)
        gnorm = global_norm(gs)
        keep = gnorm < grad_clip
        # optax selects t / norm * clip where the norm reaches the clip;
        # dividing and multiplying by 1 elsewhere is exact
        one = torch.ones((), device=gnorm.device)
        count = state.count + 1
        # f32 bias corrections and lr, each rounded to the leaf dtype
        bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** count)
        lr = sched(state.count)
        for g, p, mu, nu in zip(gs, ps, mus, nus):
            dt = p.dtype
            # optax's ops one at a time, each product rounded before its sum
            g = (g / torch.where(keep, one, gnorm).to(dt)
                 * torch.where(keep, one, _scalar(grad_clip, dt)).to(dt))
            mu.mul_(_scalar(b1, dt)).add_(g * _scalar(1 - b1, dt))
            nu.mul_(_scalar(b2, dt)).add_(g.square().mul_(_scalar(1 - b2, dt)))
            u = mu / _scalar(bc1, dt)
            u /= (nu / _scalar(bc2, dt)).sqrt_().add_(_scalar(eps, dt))
            u.add_(p * _scalar(weight_decay, dt))
            p.add_(u.mul_(_scalar(-lr, dt)))
        return AdamWState(count, state.mu, state.nu), gnorm

    return Optimizer(init, update, sched)


def create_train_state(generator: torch.Generator,
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


def make_train_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
                    optimizer: Optimizer
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``:
    loss and gradients by autograd, then the optimizer. ``grad_norm`` is
    the global norm before clipping. The parameters and the optimizer
    state are updated IN PLACE under ``torch.no_grad()``, the counterpart
    of the reference step's donation: the returned state holds the same
    tensors, and the state passed in must not be used again. Nothing here
    waits for the device; ``loss`` and ``grad_norm`` are 0-d tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        opt_state, gnorm = optimizer.update(grads, state.opt_state, state.params)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def make_eval_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """``step(state, batch) -> {"loss"}`` without gradients."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            return {"loss": loss_fn(state.params, batch)}

    return step
