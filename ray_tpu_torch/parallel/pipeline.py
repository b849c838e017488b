"""Pipeline parallelism: microbatches streamed through stages on a ``pipe``
mesh axis, the port of ``ray_tpu/parallel/pipeline.py``.

In the JAX package the whole pipeline is one SPMD program over a ``pipe``
mesh axis, its hops ``lax.ppermute`` inside a compiled loop. Here each
rank is one stage in its own process and runs the same tick loop; each
tick's hops go down the pipe for activations and up it for gradients, as
paired sends and receives posted together (``parallel/comm.py``
``exchange``). A rank sends only when its slot of the tick was live, and
its neighbour receives only then, so the hops pair up as the reference's
masked ones do.

Each rank holds its stage's parameters as the shard of the stacked tree
(``P("pipe")``: a leading dim of 1), and the trainer returns the gradients
in the same shape. ``pipe_mesh`` builds a one-axis mesh named ``pipe``
over the world, as the JAX tests build ``Mesh(devices, ("pipe",))``.

The backward recomputes the stage from its stashed input (remat), so only
inputs are stashed. 1F1B (stage p runs the forward of microbatch m at tick
p + m and its backward at tick 2(P - 1) - p + m) holds at most
min(M, 2P - 1) of them; GPipe (all forwards, then all backwards in reverse
order) holds all M. The trainer measures what it stashed
(``run.stats``: the most inputs and bytes held at once), where the
reference's test reads XLA's compiled temp memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._private.device import DeviceLike, resolve_device
from . import comm
from .mesh import axis_index, mesh_axis_size
from .train_step import tree_leaves, tree_map


def pipe_mesh(device: DeviceLike = None, axis_name: str = "pipe") -> DeviceMesh:
    """A one-axis mesh named ``axis_name`` over every rank of the default
    process group (the GPU unless "cpu" is asked), one stage per rank."""
    import torch.distributed as dist

    return init_device_mesh(resolve_device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _stage(stacked_params: Any) -> Any:
    """This rank's stage parameters from its (1, ...) shard of the stack,
    as leaves of their own."""
    return tree_map(lambda p: p[0].detach().requires_grad_(True), stacked_params)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   microbatches: torch.Tensor, *, mesh: DeviceMesh,
                   axis_name: str = "pipe") -> torch.Tensor:
    """Forward of M microbatches through the stages: ``stage_params`` are
    this rank's stage's, ``microbatches`` the whole (M, mb, ...) feed
    (stage 0 reads it). Stage p runs microbatch t - p at tick t and hands
    its output to p + 1. Returns the (M, ...) outputs on every rank (the
    last stage's, broadcast). Each stage's output has its input's shape,
    as in the reference."""
    n, idx = mesh_axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    M = microbatches.shape[0]
    shape, dtype, dev = microbatches.shape[1:], microbatches.dtype, microbatches.device
    outputs = torch.zeros_like(microbatches)
    state = None
    for t in range(M + n - 1):
        m = t - idx
        send = {}
        if 0 <= m < M:
            out = stage_fn(stage_params, microbatches[m] if idx == 0 else state)
            if idx == n - 1:
                outputs[m] = out
            else:
                send[idx + 1] = out
        recv = {idx - 1: (shape, dtype)} if idx > 0 and 0 <= t + 1 - idx < M else {}
        got = comm.exchange(mesh, axis_name, send, recv, dev) if n > 1 else {}
        state = got.get(idx - 1)
    return comm.broadcast_(outputs, mesh, axis_name, n - 1)


def pipeline_sharded(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, mesh: DeviceMesh, *, axis_name: str = "pipe",
                     microbatch_size: Optional[int] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``run(batch) -> outputs``: the batch (the same on every rank) split
    into microbatches of ``microbatch_size`` (default batch / stages) and
    streamed through the stages; ``stacked_params`` is this rank's (1, ...)
    shard of the stacked stage parameters. Every rank gets the outputs."""

    def run(batch: torch.Tensor) -> torch.Tensor:
        Btot = batch.shape[0]
        mb = microbatch_size or max(1, Btot // mesh_axis_size(mesh, axis_name))
        micro = batch.reshape(Btot // mb, mb, *batch.shape[1:])
        out = pipeline_apply(stage_fn, _stage(stacked_params), micro, mesh=mesh,
                             axis_name=axis_name)
        return out.reshape(Btot, *out.shape[2:])

    return run


def pipeline_train(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
                   mesh: DeviceMesh, *, loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                                          torch.Tensor],
                   axis_name: str = "pipe", microbatch_size: Optional[int] = None,
                   schedule: str = "1f1b") -> Callable[[torch.Tensor, torch.Tensor], Any]:
    """``run(batch, targets) -> (mean loss, grads)``: forward and backward
    of every microbatch through the stages on the ``schedule`` ("1f1b" or
    "gpipe"), the loss ``loss_fn(y, t)`` of each microbatch on the last
    stage, averaged over the microbatches. ``grads`` has the shape of
    ``stacked_params`` (this rank's stage, leading dim 1). ``run.stats``
    holds what the last run stashed: ``peak_stash`` inputs and
    ``peak_stash_bytes`` at most at once, and ``microbatches``."""
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown schedule {schedule!r}")
    n, idx = mesh_axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    params = _stage(stacked_params)
    leaves = tree_leaves(params)

    def run(batch: torch.Tensor, targets: torch.Tensor):
        Btot = batch.shape[0]
        mb = microbatch_size or max(1, Btot // n)
        M = Btot // mb
        micro = batch.reshape(M, mb, *batch.shape[1:])
        tmicro = targets.reshape(M, mb, *targets.shape[1:])
        shape, dtype, dev = micro.shape[1:], micro.dtype, micro.device
        if schedule == "1f1b":
            def m_bwd(s):
                return s - (2 * (n - 1) - idx)
            ticks = 2 * (n - 1) + M + 1
        else:
            def m_bwd(s):
                return (M - 1) - (s - ((M - 1 + n - 1) + (n - 1 - idx)))
            ticks = (M - 1) + 2 * (n - 1) + M + 1

        stash: Dict[int, torch.Tensor] = {}
        peak = peak_bytes = 0
        grad_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        fwd_in = bwd_in = None
        for s in range(ticks):
            send = {}
            # ---- forward slot: stash the input, pass the output down
            m_f = s - idx
            if 0 <= m_f < M:
                x_in = micro[m_f] if idx == 0 else fwd_in
                stash[m_f] = x_in
                peak = max(peak, len(stash))
                peak_bytes = max(peak_bytes, sum(t.numel() * t.element_size()
                                                 for t in stash.values()))
                if idx < n - 1:
                    with torch.no_grad():
                        send[idx + 1] = stage_fn(params, x_in)
            # ---- backward slot: recompute from the stashed input
            m_b = m_bwd(s)
            if 0 <= m_b < M:
                x = stash.pop(m_b).detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(params, x)
                    if idx == n - 1:
                        loss = loss_fn(y, tmicro[m_b])
                        grads = torch.autograd.grad(loss, leaves + [x])
                        loss_acc += loss.detach().float()
                    else:
                        grads = torch.autograd.grad(y, leaves + [x], grad_outputs=bwd_in)
                for acc, g in zip(grad_acc, grads[:-1]):
                    acc += g
                if idx > 0:
                    send[idx - 1] = grads[-1]
            # ---- hops: activations down (p -> p+1), gradients up (p -> p-1),
            # received where the next tick's slot is live
            recv = {}
            if idx > 0 and 0 <= s + 1 - idx < M:
                recv[idx - 1] = (shape, dtype)
            if idx < n - 1 and 0 <= m_bwd(s + 1) < M:
                recv[idx + 1] = (shape, dtype)
            got = comm.exchange(mesh, axis_name, send, recv, dev) if n > 1 else {}
            fwd_in, bwd_in = got.get(idx - 1), got.get(idx + 1)
        loss = comm.all_reduce_(loss_acc, mesh, axis_name) / M
        it = iter(grad_acc)
        grads = tree_map(lambda p: (next(it) / M).to(p.dtype)[None], params)
        run.stats = {"peak_stash": peak, "peak_stash_bytes": peak_bytes, "microbatches": M}
        return loss, grads

    run.stats = {}
    return run
