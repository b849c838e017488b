"""Ulysses (DeepSpeed-style) sequence parallelism, the port of
``ray_tpu/ops/ulysses.py``: two all-to-all reshards around local attention.

Each rank holds a block of the sequence with every head. An all-to-all
over the ``seq`` axis gives each rank the whole sequence for a block of
the heads (n_heads / n and n_kv_heads / n of them); attention runs on it
(the port's ``flash_attention``: the flash forward kernel on the card, the
dK/dV and dQ kernels in its backward), and a second all-to-all takes the
result back to sequence blocks. Each all-to-all's backward is the other
(``parallel/comm.py``). On the card the reshards are contiguous copies,
which is what the kernels take.

q (B, S_local, H, hd) and k/v (B, S_local, KVH, hd); H and KVH must divide
by the axis size (pad or replicate KV heads up to it for strong GQA).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import comm
from ..parallel.mesh import get_mesh, mesh_axis_size
from .attention import flash_attention


def _seq_to_heads(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(B, S/n, H, hd) sequence blocks -> (B, S, H/n, hd) head blocks."""
    n = mesh_axis_size(mesh, axis)
    B, S_l, H, hd = x.shape
    send = x.reshape(B, S_l, n, H // n, hd).permute(2, 0, 1, 3, 4)  # head block j to rank j
    got = comm.all_to_all_grad(send.contiguous(), mesh, axis)       # block i from rank i
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * S_l, H // n, hd)


def _heads_to_seq(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(B, S, H/n, hd) head blocks -> (B, S/n, H, hd) sequence blocks."""
    n = mesh_axis_size(mesh, axis)
    B, S, H_l, hd = x.shape
    send = x.reshape(B, n, S // n, H_l, hd).permute(1, 0, 2, 3, 4)  # sequence block i to rank i
    got = comm.all_to_all_grad(send.contiguous(), mesh, axis)       # head block j from rank j
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * H_l, hd)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: DeviceMesh = None, axis_name: str = "seq",
                      causal: bool = True) -> torch.Tensor:
    """This rank's sequence block of attention over the whole sequence
    (blocks in axis order); every rank of the axis calls it. ``mesh``
    defaults to the ambient one."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise ValueError("ulysses_attention needs a mesh (pass one, or set_mesh)")
    n = mesh_axis_size(mesh, axis_name)
    H, KVH = q.shape[2], k.shape[2]
    if H % n != 0:
        raise ValueError(f"n_heads {H} must divide by seq-parallel degree {n}")
    if KVH % n != 0:
        raise ValueError(
            f"n_kv_heads {KVH} must divide by seq-parallel degree {n}; "
            "replicate/pad KV heads up to the degree for GQA models")
    qh, kh, vh = (_seq_to_heads(t, mesh, axis_name) for t in (q, k, v))
    return _heads_to_seq(flash_attention(qh, kh, vh, causal=causal), mesh, axis_name)
