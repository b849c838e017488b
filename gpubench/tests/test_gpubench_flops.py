"""The frozen FLOP counts against hand-worked values."""

import math

import pytest

from gpubench import flops, registry, weights


@pytest.mark.parametrize("config, traffic, gflop", [
    ("mistral-7b-v0.3", "train.b8.s4096", 23.35),
    ("mistral-7b-v0.3", "train.b1.s32768", 34.62),
    ("mistral-7b-v0.3-full", "train.b32.s4096", 45.90)])
def test_model_flops_per_token(config, traffic, gflop):
    cfg, seq = registry.config(config), registry.traffic(traffic)["seq_len"]
    assert flops.train_flops_per_token(cfg, seq) / 1e9 == pytest.approx(gflop, abs=0.01)


def test_mistral_16_layers_hand_count():
    cfg = registry.config("mistral-7b-v0.3")
    # a layer's matrices (218,112,000 parameters less its two norms) x 16, and the lm head
    assert flops.matmul_params_per_token(cfg) == 16 * (218_112_000 - 2 * 4096) + 4096 * 32768
    assert flops.train_flops_per_token(cfg, 32768) == 34_628_173_824


def test_mistral_32_layers_hand_count():
    cfg = registry.config("mistral-7b-v0.3-full")
    assert flops.matmul_params_per_token(cfg) == 32 * (218_112_000 - 2 * 4096) + 4096 * 32768
    # every parameter: the layers, embedding, lm head and final norm
    layers = [lf for lf in weights.leaves(cfg)]
    assert sum(math.prod(lf.shape) for lf in layers) == 7_248_023_552


def test_op_work():
    f, b = flops.attention_call(1, 32, 32768, 128, 8, backward=False)
    assert f == 2 * 32 * 32768 ** 2 * 128
    assert b == 2 * 32768 * 32 * 128 * 2 + 2 * 32768 * 8 * 128 * 2 + 32 * 32768 * 4
    assert flops.attention_call(1, 32, 32768, 128, 8, backward=True)[0] == 2.5 * f
    assert flops.ce_call(32768, 4096, 32768, backward=True)[0] == 2 * flops.ce_call(
        32768, 4096, 32768, backward=False)[0]
