"""RLModule: the neural-net abstraction, on torch tensors.

Port of ``ray_tpu/rllib/core.py``. A module is a pure-function pair
(init, apply) over a params tree of tensors (nested dicts and lists),
with the reference's key names (``pi_torso``, ``pi``, ``vf_torso``,
``vf``, each layer ``{"w", "b"}``), so a JAX tree carried over as numpy
(``params_from_numpy``) computes the same thing here. Env-runner actors
receive plain numpy arrays (``params_to_numpy``), as in the reference.

Randomness comes from ``torch.Generator`` objects the caller owns: the
orthogonal init draws on a CPU generator (the weights then move to the
device, so a seed gives the same weights on the CPU and on the card; they
differ from ``PRNGKey``'s), and ``sample_actions`` draws its Gumbel noise
from a generator on the observations' device. The stream differs from
``jax.random.categorical``'s; the distribution does not.

Also here: the learners' optimizer, optax's ``adam`` (optionally after
``clip_by_global_norm``) as an ``init``/``update`` pair of plain
functions, and the small tree helpers the learners share.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..parallel.train_step import global_norm

Params = Any


@dataclass(frozen=True)
class MLPSpec:
    """Policy+value network spec (reference analogue: RLModule catalog
    defaults — fcnet_hiddens)."""

    obs_dim: int
    num_actions: int
    hiddens: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


# ---------------------------------------------------------------- trees
def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map over the leaves of nested dicts, lists, tuples and named
    tuples; any other object is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(tree_map(fn, v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``tree_map``'s order: dict keys in insertion order,
    depth first."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Same tree with every numpy array (or tensor) as a tensor on
    ``device`` (the GPU unless "cpu" is asked), in its own dtype; Python
    numbers stay as they are."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x)).to(dev)
        return x

    return tree_map(conv, tree)


def params_to_numpy(params: Any) -> Any:
    """Same tree with every tensor as a numpy array on the host."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, params
    )


def to_tensors(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``:
    integer columns as int64 (the index dtype), the rest as they are."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
            # an array read from the object store is read-only; torch
            # wants to own writable memory
            v = v if v.flags.writeable else v.copy()
        t = torch.as_tensor(v)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def device_of(params: Params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------- module
def orthogonal(generator: torch.Generator, fan_in: int, fan_out: int, gain: float,
               device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A (fan_in, fan_out) orthogonal matrix times ``gain``, drawn on the
    CPU generator ``generator`` and moved to ``device``."""
    w = torch.empty(fan_in, fan_out)
    torch.nn.init.orthogonal_(w, gain, generator=generator)
    return w.to(device=device, dtype=dtype)


def dense(generator, fan_in, fan_out, gain, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {
        "w": orthogonal(generator, fan_in, fan_out, gain, device, dtype),
        "b": torch.zeros(fan_out, dtype=dtype, device=device),
    }


def init_mlp_module(generator: torch.Generator, spec: MLPSpec,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Separate policy and value torsos with orthogonal init.

    Mirrors the reference's RLlib catalog defaults (vf_share_layers=False)
    and the standard PPO init recipe: orthogonal(sqrt(2)) hidden layers,
    orthogonal(0.01) policy head, orthogonal(1.0) value head — the small
    policy-head gain keeps the initial policy near-uniform so early value
    errors can't collapse exploration. ``generator`` is a CPU generator;
    the tree lands on ``device`` (the GPU unless "cpu" is asked).
    """
    dev = resolve_device(device)

    def mlp(head_out, head_gain):
        layers = []
        fan_in = spec.obs_dim
        for h in spec.hiddens:
            layers.append(dense(generator, fan_in, h, math.sqrt(2.0), dev, spec.dtype))
            fan_in = h
        return layers, dense(generator, fan_in, head_out, head_gain, dev, spec.dtype)

    pi_torso, pi_head = mlp(spec.num_actions, 0.01)
    vf_torso, vf_head = mlp(1, 1.0)
    return {"pi_torso": pi_torso, "pi": pi_head, "vf_torso": vf_torso, "vf": vf_head}


def _mlp_forward(layers, head, x):
    for layer in layers:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ head["w"] + head["b"]


def forward(params: Dict[str, Any], obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
    logits = _mlp_forward(params["pi_torso"], params["pi"], obs)
    value = _mlp_forward(params["vf_torso"], params["vf"], obs)[..., 0]
    return logits, value


def gumbel_argmax(logits: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Categorical samples by the Gumbel-max trick, as
    ``jax.random.categorical`` draws them, from uniform draws in [0, 1)
    of ``logits``' shape."""
    tiny = torch.finfo(uniform.dtype).tiny
    gumbel = -torch.log(-torch.log(uniform.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def take_along(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """logp_all[..., actions] (``take_along_axis`` on the last axis)."""
    return torch.gather(logp_all, -1, actions[..., None])[..., 0]


@torch.no_grad()
def sample_actions(params: Dict[str, Any], obs: torch.Tensor, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (actions, logp, value) for exploration rollouts; the noise comes
    from ``generator``, on ``obs``' device."""
    logits, value = forward(params, obs)
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    actions = gumbel_argmax(logits, u)
    logp = take_along(torch.log_softmax(logits, -1), actions)
    return actions, logp, value


@torch.no_grad()
def values_only(params: Dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
    """Batched V(s) for truncation bootstraps."""
    return forward(params, obs)[1]


# ---------------------------------------------------------------- optimizer
class AdamState(NamedTuple):
    count: int      # updates applied so far
    mu: Params      # first moment
    nu: Params      # second moment


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (params, state)`` returns new tensors (the inputs are not changed);
    ``grads`` has the leaves of ``params`` in their order (any tree, a
    flat list included)."""
    init: Callable[[Params], AdamState]
    update: Callable[[Any, AdamState, Params], Tuple[Params, AdamState]]


def adam(lr: float, grad_clip: Optional[float] = None, *, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """optax's ``adam(lr)``, after ``clip_by_global_norm(grad_clip)`` when
    a clip is given (``optax.chain(clip, adam)``): moments
    ``(1 - b) * g + b * m``, bias corrections with the incremented count,
    ``m_hat / (sqrt(v_hat) + eps)`` scaled by ``-lr``; the clip divides by
    the global norm and multiplies by the limit only where the norm
    reaches it (a select, not a clamp). No weight decay."""

    def init(params: Params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads: Any, state: AdamState, params: Params) -> Tuple[Params, AdamState]:
        gs, ps = tree_leaves(grads), tree_leaves(params)
        if grad_clip is not None:
            # dividing and multiplying by 1 where the norm is below the
            # clip is exact, and needs no wait for the norm on the host
            gnorm = global_norm(gs)
            keep = gnorm < grad_clip
            one = torch.ones((), device=gnorm.device)
            div = torch.where(keep, one, gnorm)
            mul = torch.where(keep, one, torch.full((), grad_clip, device=gnorm.device))
            gs = [g / div * mul for g in gs]
        count = state.count + 1
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
        mus, nus, new_ps = [], [], []
        for g, p, m, v in zip(gs, ps, tree_leaves(state.mu), tree_leaves(state.nu)):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * (g * g) + b2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            mus.append(m)
            nus.append(v)
            new_ps.append(p + (-lr) * u)
        return tree_unflatten(params, new_ps), AdamState(
            count, tree_unflatten(state.mu, mus), tree_unflatten(state.nu, nus))

    return Optimizer(init, update)


def value_and_grad(loss_fn: Callable[..., Tuple[torch.Tensor, Any]], params: Params, *args
                   ) -> Tuple[Tuple[torch.Tensor, Any], List[torch.Tensor]]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``: the
    gradients of the first output with respect to ``params``' leaves, as a
    list in ``tree_leaves`` order; ``params`` themselves are not changed."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        out, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(out, leaves, allow_unused=True)
    # a leaf the loss does not read (BC's value head) has gradient 0, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (out.detach(), tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, aux)), grads
