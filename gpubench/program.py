"""The system under test, as a user's train loop builds it: the model
configuration of ``ray_tpu_torch.models``, ``parallel.create_train_state``
with ``default_optimizer`` (clip, then AdamW), and
``parallel.make_train_step`` over the model's ``loss_fn``; and the
readings of its first steps that ``check.py`` compares with the reference.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from . import traffic as traffic_gen
from . import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict):
    """The program's config object for ``cfg`` (a configuration file)."""
    from ray_tpu_torch.models import llama

    run = cfg["program"]
    if cfg["hidden_size"] // cfg["num_attention_heads"] != cfg["head_dim"]:
        raise ValueError("the program derives head_dim as hidden_size / num_attention_heads")
    return llama.LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"], max_seq_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=DTYPES[run["dtype"]], param_dtype=DTYPES[run["param_dtype"]],
        remat=run["remat"], attention_impl=run["attention_impl"],
        ce_impl=run["ce_impl"]), llama.loss_fn


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device, fault: Optional[str] = None):
    """(train state, step): the weights from the seed, the optimizer of the
    traffic mix, and the train step. Faults the check must catch:
    ``fault="unchanged"`` gives a step that computes the loss and returns
    its state unchanged; ``fault="ascent"`` one that applies each update
    with its sign turned (it holds a copy of the parameters: tests only)."""
    from ray_tpu_torch import parallel

    mcfg, loss_fn = model_config(cfg)
    params = weights.make(cfg, seed, device)
    opt = parallel.default_optimizer(**traffic["optimizer"])
    state = parallel.create_train_state(None, lambda _g: params, opt, device)
    step = parallel.make_train_step(lambda p, b: loss_fn(p, b, mcfg), opt)
    if fault == "unchanged":
        def step(state, batch):
            with torch.no_grad():
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
    elif fault not in (None, "half"):
        raise ValueError(f"unknown fault {fault!r}")
    return state, step


def first_steps(state, step, cfg: dict, traffic: dict, seed: int, device: torch.device,
                fault: Optional[str] = None,
                on_step: Callable[[int, float], None] = lambda k, loss: None):
    """Run the first ``check_steps`` steps through ``step`` on the traffic's
    batches and read what ``check.gaps`` compares: each step's loss, each
    leaf's norm of the first step's gradient as the optimizer got it
    (its first moment over 1 - b1, before the clip's factor) and a seeded
    sample of its elements, and each leaf's change after the last step,
    its norm and its elements at the same positions. ``fault="half"``
    feeds a loss mask that keeps half of each batch. The readings also
    hold ``seconds``: each step's (its loss read back) and the readings'.
    Returns (state, readings)."""
    opt = traffic["optimizer"]
    b1, clip = opt.get("b1", 0.9), opt.get("grad_clip", 1.0)
    out = {"losses": [], "seconds": []}
    t0 = time.perf_counter()
    for k in range(1, traffic["check_steps"] + 1):
        batch = traffic_gen.batch(traffic, cfg["vocab_size"], seed, k, device)
        if fault == "half":
            batch["mask"] = traffic_gen.half_mask(traffic, device)
        state, m = step(state, batch)
        loss = float(m["loss"])
        out["seconds"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["losses"].append(loss)
        on_step(k, loss)
        if k == 1:
            gnorm = float(m["grad_norm"])
            factor = 1.0 if gnorm < clip else clip / gnorm
            out["grad_norms"] = {
                leaf.name: float(torch.linalg.vector_norm(weights.get(state.opt_state.mu, leaf.name)))
                / (1 - b1) / factor
                for leaf in weights.leaves(cfg)}
            out["grad_sample"] = weights.sample(cfg, seed, state.opt_state.mu, 1 / (1 - b1) / factor)
    out["update_norms"], out["update_sample"] = weights.change(cfg, seed, state.params)
    out["seconds"].append(time.perf_counter() - t0)
    return state, out
