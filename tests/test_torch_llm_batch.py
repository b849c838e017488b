"""``build_llm_processor`` of the port against the reference's.

test_llm.py's batch inference on both packages: the JAX package's
``LLAMA_TINY`` parameters (f32, ``PRNGKey(0)``) written once with its
``save_params_npz`` go through ``checkpoint_path`` into both packages'
``build_llm_processor`` (``accelerator_type=""``; the port's engine with
``engine_kwargs={"device": "cpu"}``) over the same Dataset of 8 prompts.
Every row's ``generated_ids`` and ``num_generated`` must be equal across
the packages and equal to an in-process JAX ``LlamaEngine``'s greedy
tokens. The accelerator asked for: the port's default ``"GPU"`` asks the
pool actors for ``tensor_parallel_size`` GPUs through ``num_gpus`` (the
pinned resource), where the reference's ``"TPU"`` asks for ``num_tpus``;
``""`` asks for none in both.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; each processor starts one pool actor, whose engine
is built once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as ref_data
from ray_tpu import llm as ref_llm
from ray_tpu.models import llama as jl
from ray_tpu_torch import data as port_data
from ray_tpu_torch import llm as port_llm
from ray_tpu_torch.models import llama as tl

JCFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
PROMPTS = [[i + 1, i + 2, i + 3] for i in range(6)] + [[7, 1, 9, 4, 4, 2, 8], [11]]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jl.init_params(jax.random.PRNGKey(0), JCFG)
    path = str(tmp_path_factory.mktemp("llm_batch") / "tiny.npz")
    ref_llm.save_params_npz(params, path)
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield path, params
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _configs(path, **kw):
    common = dict(checkpoint_path=path, max_batch_size=4, max_seq_len=64, **kw)
    return (ref_llm.LLMConfig(model_config=JCFG, **common),
            port_llm.LLMConfig(model_config=TCFG, engine_kwargs={"device": "cpu"}, **common))


def _rows(data, cfg, pkg_llm, max_tokens):
    ds = data.from_items([{"prompt_ids": np.array(p)} for p in PROMPTS])
    processor = pkg_llm.build_llm_processor(cfg, concurrency=1, batch_size=4,
                                            max_tokens=max_tokens)
    return [([int(x) for x in r["prompt_ids"]],
             [int(t) for t in r["generated_ids"][: r["num_generated"]]])
            for r in processor(ds).materialize().iter_rows()]


def test_processors_generate_the_same_tokens(setup):
    path, params = setup
    ref_cfg, port_cfg = _configs(path, accelerator_type="")
    want = _rows(ref_data, ref_cfg, ref_llm, 5)
    got = _rows(port_data, port_cfg, port_llm, 5)
    assert got == want
    assert [p for p, _ in got] == PROMPTS
    local = ref_llm.LlamaEngine(JCFG, params, max_batch=1, max_seq=64)
    assert [g for _, g in got] == [local.generate(p, max_tokens=5) for p in PROMPTS]


def _asked(data, cfg, pkg_llm):
    stage = pkg_llm.build_llm_processor(cfg)(data.range(1))._logical.ops()[-1]
    return stage.resources, stage.concurrency, stage.batch_size


@pytest.mark.parametrize("tp", [1, 2])
def test_the_accelerator_asked_for(setup, tp):
    path, _ = setup
    ref_cfg, port_cfg = _configs(path, tensor_parallel_size=tp)
    assert port_cfg.accelerator_type == "GPU" and ref_cfg.accelerator_type == "TPU"
    assert _asked(port_data, port_cfg, port_llm) == ({"GPU": float(tp)}, 1, 16)
    assert _asked(ref_data, ref_cfg, ref_llm) == ({"TPU": float(tp)}, 1, 16)
    ref_cfg, port_cfg = _configs(path, tensor_parallel_size=tp, accelerator_type="")
    assert _asked(port_data, port_cfg, port_llm) == _asked(ref_data, ref_cfg, ref_llm) == (
        {}, 1, 16)
