"""The one generator of the benchmark's traffic.

A training mix (``"kind": "train"``) is a stream of batches of
``batch`` sequences of ``seq_len`` + 1 token ids (inputs and their next
tokens), drawn on the device from a generator seeded from (seed, step):
every step gets rows of its own, every seed the same shapes. ``tokens``
names the distribution of the ids: ``"uniform"`` over the vocabulary.
The mix also carries the job's optimizer (the keyword arguments of
``default_optimizer``) and ``check_steps``, the first steps that the
comparison with the reference follows.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import mix


def tokens_per_step(traffic: dict) -> int:
    return traffic["batch"] * traffic["seq_len"]


def batch(traffic: dict, vocab_size: int, seed: int, step: int,
          device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch, ``{"tokens": (batch, seq_len + 1) int64}``."""
    if traffic["kind"] != "train" or traffic["tokens"] != "uniform":
        raise ValueError(f"unknown traffic {traffic['kind']!r} / {traffic['tokens']!r}")
    g = torch.Generator(device=device).manual_seed(mix(seed, "batch", step))
    shape = (traffic["batch"], traffic["seq_len"] + 1)
    return {"tokens": torch.randint(0, vocab_size, shape, generator=g, device=device)}


def half_mask(traffic: dict, device: torch.device) -> torch.Tensor:
    """A loss mask that keeps half of a batch: the first half of its rows,
    or of its positions when it has one row (a fault the check must catch)."""
    B, S1 = traffic["batch"], traffic["seq_len"] + 1
    mask = torch.ones((B, S1), dtype=torch.float32, device=device)
    if B > 1:
        mask[B // 2:] = 0
    else:
        mask[:, S1 // 2:] = 0
    return mask
