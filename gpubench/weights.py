"""The cell's weights, made from the seed on the device.

Each leaf of the parameter tree is made by layer: layer ``l`` of leaf
``name`` is a standard normal drawn from its own generator, seeded from
(seed, name, l), scaled by 1 / sqrt(fan_in); norm weights are ones. So
the whole tree is a few large calls, and any slice can be made again
alone (``layer_slice``): the train loop measures the parameters' change
against the start that way (``change``), and the reference starts from
the same tree.

The leaves, their shapes and the tree's layout are the family's
(``families/<family>.py`` ``leaves``): the layout the program takes is its
interface, like the shape of a batch. Parameters are float32 master
weights.

A rank of a cell laid over a mesh holds a ``Part`` of each leaf and
reads only that part (``sample``, ``change_parts``); summed over the
ranks, the parts' readings are the whole tree's.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import registry


class Leaf(NamedTuple):
    name: str                   # path in the tree, "blocks.wq"
    shape: Tuple[int, ...]      # whole leaf, layers first when ``layered``
    fan_in: Optional[int]       # None: ones (a norm weight)
    layered: bool


class Part(NamedTuple):
    """The part of a leaf one rank holds: ``cut``, one slice of each
    dimension of the whole leaf, and ``counts``: whether this rank's copy is
    the one read when the ranks' readings are summed (of the ranks holding
    the same part, one counts)."""
    cut: Tuple[slice, ...]
    counts: bool


Parts = Optional[Dict[str, Part]]   # by leaf name; None: the whole tree, counted


def leaves(cfg: dict) -> List[Leaf]:
    """The leaves of a configuration's tree, in the tree's order."""
    return registry.family(cfg["program"]["family"]).leaves(cfg)


def mix(*parts) -> int:
    """A 63-bit seed from the parts (a run's seed may be of any size)."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _fill(t: torch.Tensor, seed: int, leaf: Leaf, layer: int) -> torch.Tensor:
    if leaf.fan_in is None:
        return t.fill_(1.0)
    g = torch.Generator(device=t.device).manual_seed(mix(seed, leaf.name, layer))
    return t.normal_(generator=g).mul_(1.0 / math.sqrt(leaf.fan_in))


def layer_slice(cfg: dict, seed: int, leaf: Leaf, layer: int,
                device: torch.device) -> torch.Tensor:
    """Layer ``layer`` of ``leaf`` (the whole leaf when it has no layers),
    float32, as ``make`` made it."""
    shape = leaf.shape[1:] if leaf.layered else leaf.shape
    return _fill(torch.empty(shape, dtype=torch.float32, device=device), seed, leaf,
                 layer if leaf.layered else 0)


def _whole(leaf: Leaf) -> Tuple[slice, ...]:
    return tuple(slice(0, n) for n in leaf.shape)


def make(cfg: dict, seed: int, device: torch.device) -> Dict[str, object]:
    """The whole tree, float32 on ``device``, in the family's layout."""
    tree: Dict[str, object] = {}
    for leaf in leaves(cfg):
        t = torch.empty(leaf.shape, dtype=torch.float32, device=device)
        if leaf.layered:
            for layer in range(leaf.shape[0]):
                _fill(t[layer], seed, leaf, layer)
        else:
            _fill(t, seed, leaf, 0)
        put(tree, leaf.name, t)
    return tree


def _locate(pos: torch.Tensor, shape: Tuple[int, ...], cut: Tuple[slice, ...]):
    """(held, local): which flat positions ``pos`` of a whole leaf of
    ``shape`` lie in ``cut``, and each one's flat position in the part."""
    held = torch.ones_like(pos, dtype=torch.bool)
    local = torch.zeros_like(pos)
    rest = pos.clone()
    stride = 1
    for n, s in zip(reversed(shape), reversed(cut)):
        coord = rest % n
        rest //= n
        held &= (coord >= s.start) & (coord < s.stop)
        local += (coord - s.start) * stride
        stride *= s.stop - s.start
    return held, local


def change_parts(cfg: dict, seed: int, params: dict, parts: Parts = None
                 ) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """Each leaf's change from the start (a tree of ``params``' layout), p_0
    made again from the seed a layer at a time: (the sum of squares of
    p - p_0, its elements at the positions ``sample`` reads). With ``parts``
    the tree holds this rank's parts and both are this rank's share of the
    sum over the ranks: 0 and 0.0 where it holds nothing or is not counted."""
    sq_sums, picked = {}, {}
    for leaf in leaves(cfg):
        p = get(params, leaf.name).detach()
        cut, counts = (_whole(leaf), True) if parts is None else parts[leaf.name]
        held, local = _locate(positions(seed, leaf, math.prod(leaf.shape)), leaf.shape, cut)
        idx, held = local.to(p.device), held.to(p.device) & counts
        layers = range(cut[0].start, cut[0].stop) if leaf.layered else range(1)
        per = p.numel() // len(layers)
        sq, vals = 0.0, torch.zeros(idx.numel(), dtype=torch.float64, device=p.device)
        for i, l in enumerate(layers):
            whole = layer_slice(cfg, seed, leaf, l, p.device)
            d = ((p[i] if leaf.layered else p).float() - whole[cut[1:] if leaf.layered else cut])
            d = d.reshape(-1)
            if counts:
                sq += float(torch.linalg.vector_norm(d)) ** 2
            here = held & ((idx // per) == i)
            vals[here] = d[idx[here] % per].double()
        sq_sums[leaf.name], picked[leaf.name] = sq, vals.tolist()
    return sq_sums, picked


def change(cfg: dict, seed: int, params: dict) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """Each leaf's change from the start: (its norm ||p - p_0||, its
    elements at the positions ``sample`` reads)."""
    sq, picked = change_parts(cfg, seed, params)
    return {n: math.sqrt(v) for n, v in sq.items()}, picked


SAMPLE = 16384   # elements of a leaf that ``sample`` reads


def positions(seed: int, leaf: Leaf, numel: int) -> torch.Tensor:
    """The SAMPLE flat positions of ``leaf`` drawn from (seed, leaf)."""
    g = torch.Generator(device="cpu").manual_seed(mix(seed, "sample", leaf.name))
    return torch.randint(0, numel, (min(SAMPLE, numel),), generator=g)


def sample(cfg: dict, seed: int, tree: dict, scale: float = 1.0,
           parts: Parts = None) -> Dict[str, List[float]]:
    """Each leaf's elements at SAMPLE positions drawn from (seed, leaf),
    times ``scale``: the same positions on both sides of a comparison. With
    ``parts`` the tree holds this rank's parts and an element it does not
    hold, or holds uncounted, reads 0.0 (the ranks' samples sum to the
    whole tree's)."""
    out = {}
    for leaf in leaves(cfg):
        t = get(tree, leaf.name).detach().reshape(-1)
        pos = positions(seed, leaf, math.prod(leaf.shape))
        if parts is None:
            out[leaf.name] = (t[pos.to(t.device)].double() * scale).tolist()
            continue
        cut, counts = parts[leaf.name]
        held, local = _locate(pos, leaf.shape, cut)
        vals = torch.zeros(pos.numel(), dtype=torch.float64)
        if counts:
            vals[held] = t[local[held].to(t.device)].double().cpu() * scale
        out[leaf.name] = vals.tolist()
    return out


def get(tree: dict, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def put(tree: dict, name: str, value) -> None:
    *path, last = name.split(".")
    for part in path:
        tree = tree.setdefault(part, {})
    tree[last] = value
