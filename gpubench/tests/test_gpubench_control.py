"""The control (the reference with float8 operands, one precision below
the program's bf16, in the program's place) reads far above the program
at a tiny size, and fails the tiny cells' limits; the card run of it at
the cells' sizes sets their limits (``python3 -m gpubench.calibrate``)."""

import pytest
import torch

from gpubench import check, program, reference
from gpubench.tests import tiny


def test_control_fails_where_the_program_passes():
    cfg, dev = tiny.LLAMA, torch.device("cpu")
    fails = 0
    for seed in (21, 22, 23):
        ref = reference.run(cfg, tiny.TRAFFIC, seed, dev)
        state, step = program.setup(cfg, tiny.TRAFFIC, seed, dev)
        _, prog = program.first_steps(state, step, cfg, tiny.TRAFFIC, seed, dev)
        ctrl = reference.run(cfg, tiny.TRAFFIC, seed, dev, reference.Numerics(fp8=True))
        ok_prog = check.judge(check.gaps(prog, ref), tiny.LIMITS)
        ok_ctrl = check.judge(check.gaps(ctrl, ref), tiny.LIMITS)
        assert all(c["ok"] for c in ok_prog.values()), ok_prog
        fails += not all(c["ok"] for c in ok_ctrl.values())
    assert fails == 3


def test_fp8_rounding():
    t = torch.tensor([0.0, 1.0, -3.0, 448.0 / 7])
    q = reference.to_fp8(t)
    assert q[0] == 0 and q.abs().max() == pytest.approx(448.0 / 7)
    assert not torch.equal(reference.to_fp8(torch.linspace(0, 1, 1000)), torch.linspace(0, 1, 1000))


def test_a_number_without_a_limit_is_not_compared():
    numbers = dict.fromkeys(check.NAMES, 0.5)
    limits = {**dict.fromkeys(check.NAMES, 0.1), "loss_gap": None}
    judged = check.judge(numbers, limits)
    assert list(judged) == [n for n in check.NAMES if n != "loss_gap"]
    assert not any(c["ok"] for c in judged.values())
