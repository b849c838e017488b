"""The system under test, as a user's train loop builds it: the model
configuration of the configuration's family (``families/<family>.py``
``model_config``), ``parallel.create_train_state`` with
``default_optimizer`` (clip, then AdamW), and ``parallel.make_train_step``
over the model's ``loss_fn``; and the readings of its first steps that
``check.py`` compares with the reference.

Over a mesh (a cell whose workload names one) the state is
``create_train_state(mesh, ...)``'s, as a user's loop builds it: every rank
makes the whole seeded tree and keeps its shards of the family's
``param_specs``. The step takes the global batch. The readings are the
whole tree's, each rank reading its parts (``parts``), summed over the
ranks, on every rank.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from . import registry
from . import traffic as traffic_gen
from . import weights


def family(cfg: dict):
    return registry.family(cfg["program"]["family"])


def model_config(cfg: dict):
    """(the program's model config for ``cfg``, its ``loss_fn``), from the
    configuration's family."""
    return family(cfg).model_config(cfg)


def parts(cfg: dict, mesh) -> weights.Parts:
    """This rank's part of each leaf over ``mesh``, from the program's
    specs: each dimension cut as the program shards it; a part held alike
    on several ranks (a leaf replicated over an axis) counted on the rank
    at index 0 of each such axis. None without a mesh."""
    if mesh is None:
        return None
    from ray_tpu_torch.parallel.mesh import axis_index, replicated_axes, shard_slice

    fam = family(cfg)
    specs = fam.param_specs(model_config(cfg)[0])
    out = {}
    for leaf in weights.leaves(cfg):
        spec = weights.get(specs, leaf.name)
        cut = tuple(shard_slice(mesh, e, n) for e, n in zip(spec, leaf.shape))
        counts = all(axis_index(mesh, a) == 0 for a in replicated_axes(mesh, spec))
        out[leaf.name] = weights.Part(cut, counts)
    return out


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device, fault: Optional[str] = None,
          mesh=None):
    """(train state, step): the weights from the seed, the optimizer of the
    traffic mix, and the train step, over ``mesh`` when given. Faults the
    check must catch: ``fault="unchanged"`` gives a step that computes the
    loss and returns its state unchanged; ``fault="ascent"`` one that
    applies each update with its sign turned (it holds a copy of the
    parameters: tests only); ``fault="noexchange"`` leaves the exchange
    between the ranks out of the gradient of each gathered shard: the
    reduce-scatter keeps this rank's block of its own gradient, unsummed
    (it patches the program's collectives for the rest of the process:
    tests only)."""
    from ray_tpu_torch import parallel

    mcfg, loss_fn = model_config(cfg)
    opt = parallel.default_optimizer(**traffic["optimizer"])

    def make(_generator):
        return weights.make(cfg, seed, device)

    if mesh is None:
        state = parallel.create_train_state(None, make, opt, device)
        step = parallel.make_train_step(lambda p, b: loss_fn(p, b, mcfg), opt)
    else:
        state, state_sh = parallel.create_train_state(mesh, None, make, opt,
                                                      family(cfg).param_specs(mcfg))
        step = parallel.make_train_step(lambda p, b: loss_fn(p, b, mcfg), opt, mesh, state_sh)
    if fault == "noexchange":
        if mesh is None:
            raise ValueError("fault 'noexchange' needs a mesh")
        _leave_out_the_exchange()
    if fault == "unchanged":
        def step(state, batch):
            with torch.no_grad(), _on(mesh):
                loss = loss_fn(state.params, batch, mcfg)
            return state, {"loss": loss, "grad_norm": torch.zeros(()), "step": state.step + 1}
    elif fault == "ascent":
        descent = step

        def step(state, batch):
            ps = [weights.get(state.params, leaf.name) for leaf in weights.leaves(cfg)]
            before = [p.detach().clone() for p in ps]
            state, m = descent(state, batch)
            with torch.no_grad():
                for p, b in zip(ps, before):
                    p.copy_(2 * b - p)
            return state, m
    elif fault not in (None, "half", "noexchange"):
        raise ValueError(f"unknown fault {fault!r}")
    return state, step


def _leave_out_the_exchange() -> None:
    """The fault ``noexchange``: the program's reduce-scatter (the backward
    of each gather of a sharded parameter) keeps this rank's block of the
    gradient it is given, without the other ranks' terms."""
    from ray_tpu_torch.parallel import comm
    from ray_tpu_torch.parallel.mesh import axis_index, mesh_axis_size

    def own_block(t, mesh, axis, dim):
        n = t.shape[dim] // mesh_axis_size(mesh, axis)
        return t.narrow(dim, axis_index(mesh, axis) * n, n).contiguous()

    comm.reduce_scatter = own_block


def _on(mesh):
    """The ambient mesh of the program's models, where there is one."""
    if mesh is None:
        return contextlib.nullcontext()
    from ray_tpu_torch import parallel

    return parallel.set_mesh(mesh)


def _summed(values: List[float], device: torch.device) -> List[float]:
    """``values`` summed over the ranks of the default process group."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.tolist()


def _summed_lists(lists: Dict[str, List[float]], device: torch.device) -> Dict[str, List[float]]:
    names = list(lists)
    flat = _summed([v for n in names for v in lists[n]], device)
    out, i = {}, 0
    for n in names:
        out[n], i = flat[i:i + len(lists[n])], i + len(lists[n])
    return out


def first_steps(state, step, cfg: dict, traffic: dict, seed: int, device: torch.device,
                fault: Optional[str] = None,
                on_step: Callable[[int, float], None] = lambda k, loss: None, mesh=None):
    """Run the first ``check_steps`` steps through ``step`` on the traffic's
    batches and read what ``check.gaps`` compares: each step's loss, each
    leaf's norm of the first step's gradient as the optimizer got it
    (its first moment over 1 - b1, before the clip's factor) and a seeded
    sample of its elements, and each leaf's change after the last step,
    its norm and its elements at the same positions; and, where the family
    pins decisions, each step's ``pins``, read before the step. Over
    ``mesh`` (every rank calls this alike) the readings are the whole
    tree's on every rank. ``fault="half"`` feeds a loss mask that keeps
    half of each batch. The readings also hold ``seconds``: each step's
    (its loss read back) and the readings'. Returns (state, readings)."""
    opt = traffic["optimizer"]
    b1, clip = opt.get("b1", 0.9), opt.get("grad_clip", 1.0)
    fam, own = family(cfg), parts(cfg, mesh)
    pins = getattr(fam, "pins", None)
    mcfg = model_config(cfg)[0] if pins is not None else None
    out = {"losses": [], "seconds": []}
    t0 = time.perf_counter()
    for k in range(1, traffic["check_steps"] + 1):
        batch = traffic_gen.batch(traffic, cfg["vocab_size"], seed, k, device)
        if fault == "half":
            batch["mask"] = traffic_gen.half_mask(traffic, device)
        if pins is not None:
            with torch.no_grad(), _on(mesh):
                out.setdefault("pins", []).append(pins(state.params, batch, mcfg))
        state, m = step(state, batch)
        loss = float(m["loss"])
        out["seconds"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["losses"].append(loss)
        on_step(k, loss)
        if k == 1:
            gnorm = float(m["grad_norm"])
            factor = 1.0 if gnorm < clip else clip / gnorm
            mu = state.opt_state.mu
            if own is None:
                out["grad_norms"] = {
                    leaf.name: float(torch.linalg.vector_norm(weights.get(mu, leaf.name)))
                    / (1 - b1) / factor
                    for leaf in weights.leaves(cfg)}
            else:
                names = [leaf.name for leaf in weights.leaves(cfg)]
                sq = _summed([float(torch.linalg.vector_norm(weights.get(mu, n))) ** 2
                              if own[n].counts else 0.0 for n in names], device)
                out["grad_norms"] = {n: math.sqrt(s) / (1 - b1) / factor for n, s in zip(names, sq)}
            out["grad_sample"] = weights.sample(cfg, seed, mu, 1 / (1 - b1) / factor, own)
            if own is not None:
                out["grad_sample"] = _summed_lists(out["grad_sample"], device)
    if own is None:
        out["update_norms"], out["update_sample"] = weights.change(cfg, seed, state.params)
    else:
        sq, picked = weights.change_parts(cfg, seed, state.params, own)
        names = list(sq)
        out["update_norms"] = {n: math.sqrt(s) for n, s in zip(names, _summed(list(sq.values()), device))}
        out["update_sample"] = _summed_lists(picked, device)
    out["seconds"].append(time.perf_counter() - t0)
    return state, out
