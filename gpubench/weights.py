"""The cell's weights, made from the seed on the device.

Each leaf of the parameter tree is made by layer: layer ``l`` of leaf
``name`` is a standard normal drawn from its own generator, seeded from
(seed, name, l), scaled by 1 / sqrt(fan_in); norm weights are ones. So
the whole tree is a few large calls, and any slice can be made again
alone (``layer_slice``): the train loop measures the parameters' change
against the start that way (``change``), and the reference starts from
the same tree.

The tree has the layout the program takes (stacked layers under the
reference package's key names): that layout is its interface, like the
shape of a batch. Parameters are float32 master weights.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Leaf(NamedTuple):
    name: str                   # path in the tree, "blocks.wq"
    shape: Tuple[int, ...]      # whole leaf, layers first when ``layered``
    fan_in: Optional[int]       # None: ones (a norm weight)
    layered: bool


def leaves(cfg: dict) -> List[Leaf]:
    """The leaves of a configuration's tree, in the tree's order."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F, L = cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    out = [
        Leaf("embed", (V, D), D, False),
        Leaf("blocks.attn_norm", (L, D), None, True),
        Leaf("blocks.wq", (L, D, H, hd), D, True),
        Leaf("blocks.wk", (L, D, KVH, hd), D, True),
        Leaf("blocks.wv", (L, D, KVH, hd), D, True),
        Leaf("blocks.wo", (L, H, hd, D), H * hd, True),
        Leaf("blocks.mlp_norm", (L, D), None, True),
        Leaf("blocks.w_gate", (L, D, F), D, True),
        Leaf("blocks.w_up", (L, D, F), D, True),
        Leaf("blocks.w_down", (L, F, D), F, True),
    ]
    return out + [Leaf("final_norm", (D,), None, False), Leaf("lm_head", (D, V), D, False)]


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


def make(cfg: dict, seed: int, device: torch.device) -> Dict[str, object]:
    """The whole tree, float32 on ``device``: {"embed", "blocks": {...},
    "final_norm", "lm_head"}."""
    tree: Dict[str, object] = {"blocks": {}}
    for leaf in leaves(cfg):
        t = torch.empty(leaf.shape, dtype=torch.float32, device=device)
        if leaf.layered:
            for layer in range(leaf.shape[0]):
                _fill(t[layer], seed, leaf, layer)
        else:
            _fill(t, seed, leaf, 0)
        put(tree, leaf.name, t)
    return tree


def change(cfg: dict, seed: int, params: dict) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """Each leaf's change from the start (a tree of ``params``' layout), p_0
    made again from the seed a layer at a time: (its norm ||p - p_0||, its
    elements at the positions ``sample`` reads)."""
    norms, picked = {}, {}
    for leaf in leaves(cfg):
        p = get(params, leaf.name).detach()
        idx = positions(seed, leaf, p.numel()).to(p.device)
        layers = leaf.shape[0] if leaf.layered else 1
        per = p.numel() // layers
        sq, vals = 0.0, torch.empty(idx.numel(), dtype=torch.float64, device=p.device)
        for l in range(layers):
            d = ((p[l] if leaf.layered else p).float() - layer_slice(cfg, seed, leaf, l, p.device))
            d = d.reshape(-1)
            sq += float(torch.linalg.vector_norm(d)) ** 2
            here = (idx // per) == l
            vals[here] = d[idx[here] % per].double()
        norms[leaf.name], picked[leaf.name] = math.sqrt(sq), vals.tolist()
    return norms, picked


SAMPLE = 16384   # elements of a leaf that ``sample`` reads


def positions(seed: int, leaf: Leaf, numel: int) -> torch.Tensor:
    """The SAMPLE flat positions of ``leaf`` drawn from (seed, leaf)."""
    g = torch.Generator(device="cpu").manual_seed(mix(seed, "sample", leaf.name))
    return torch.randint(0, numel, (min(SAMPLE, numel),), generator=g)


def sample(cfg: dict, seed: int, tree: dict, scale: float = 1.0) -> Dict[str, List[float]]:
    """Each leaf's elements at SAMPLE positions drawn from (seed, leaf),
    times ``scale``: the same positions on both sides of a comparison."""
    out = {}
    for leaf in leaves(cfg):
        t = get(tree, leaf.name).detach().reshape(-1)
        out[leaf.name] = (t[positions(seed, leaf, t.numel()).to(t.device)].double() * scale).tolist()
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
