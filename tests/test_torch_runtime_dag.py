"""DAGs and compiled DAGs of the port against the reference's.

Each program runs once on ``ray_tpu`` and once on ``ray_tpu_torch``,
both runtimes up at once in this process, and the two results must be
equal. They are the programs of test_dag.py and
test_compiled_dag_channels.py: ``.bind()`` and ``execute`` of function
and actor nodes, input attributes, multi-output nodes, legacy compiled
mode with pipelined executes, channel mode (the resident loop on each
actor, channels between them) with zero task events across its
executes, the in-DAG allreduce in both modes and its bind checks,
teardown (the actor answers again) and the refusal of an out-of-order
get; and a channel written by a task in another process. The port's
channels are the C++ ring, named with its own prefix.

Then ``LLAMA_TINY`` (f32) from one ``.npz``, scored through a compiled
DAG by a ``ray_tpu`` actor (the JAX ``loss_fn``) and by a
``ray_tpu_torch`` ``LlamaActor(device="cpu")`` (flash attention and the
fused CE, their plain versions on the CPU): in legacy mode the mean loss
of ``score``, in channel mode the per-row losses of an int32 batch; the
two packages agree within test_torch_llama.py's f32 loss tolerance
(rtol 1e-5).

Cost: one runtime per package for the whole file, four CPUs and four
pooled workers each; every get has a timeout. Classes and functions that
run remotely are defined inside the programs, so they pickle by value
and no worker imports this file.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

T = 60
LOSS_RTOL = 1e-5  # test_torch_llama.py, f32 losses


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, max_workers=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4, max_workers=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _dag(rt):
    return importlib.import_module(f"{rt.__name__}.dag")


def _n_task_events(rt):
    return len(rt._private.worker.get_client().list_state("tasks"))


def function_dag(rt):
    InputNode = _dag(rt).InputNode

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def square(x):
        return x * x

    with InputNode() as inp:
        dag = square.bind(add.bind(inp, 3))
    return rt.get(dag.execute(2), timeout=T)


def actor_dag_state(rt):
    InputNode = _dag(rt).InputNode

    @rt.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    acc = Acc.remote()
    with InputNode() as inp:
        dag = acc.add.bind(inp)
    out = [rt.get(dag.execute(5), timeout=T), rt.get(dag.execute(7), timeout=T)]
    rt.kill(acc)
    return out


def multi_output_and_input_attributes(rt):
    d = _dag(rt)

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def dec(x):
        return x - 1

    @rt.remote
    def mul(a, b):
        return a * b

    with d.InputNode() as inp:
        multi = d.MultiOutputNode([inc.bind(inp), dec.bind(inp)])
    with d.InputNode() as inp:
        attrs = mul.bind(inp["x"], inp["y"])
    return (rt.get(multi.execute(10), timeout=T), rt.get(attrs.execute({"x": 3, "y": 4}),
                                                         timeout=T),
            [type(n).__name__ for n in multi._topo()])


def compiled_legacy_pipelining(rt):
    InputNode = _dag(rt).InputNode

    @rt.remote
    class Stage:
        def __init__(self, mult):
            self.mult = mult

        def run(self, x):
            return x * self.mult

    s1, s2 = Stage.remote(2), Stage.remote(10)
    with InputNode() as inp:
        dag = s2.run.bind(s1.run.bind(inp))
    compiled = dag.experimental_compile(max_inflight_executions=4)
    refs = [compiled.execute(i) for i in range(8)]  # overlapped
    out = (compiled._channel_mode, [r.get(timeout=T) for r in refs])
    compiled.teardown()
    rt.kill(s1)
    rt.kill(s2)
    return out


def channel_written_by_a_task(rt):
    ShmChannel = importlib.import_module(f"{rt.__name__}.experimental.channel").ShmChannel
    ch = ShmChannel.create(shape=(16,), dtype="float32", capacity=2)
    try:
        @rt.remote
        def producer(chan, n):
            for i in range(n):
                chan.write(np.full(16, float(i), np.float32), timeout_s=T)
            return chan.backend

        ref = producer.remote(ch, 5)
        got = [float(ch.read(timeout_s=T)[0]) for _ in range(5)]
        return got, rt.get(ref, timeout=T), ch.backend
    finally:
        ch.close(unlink=True)


def _stages(rt):
    @rt.remote
    class Doubler:
        def run(self, x):
            return x * 2.0

    @rt.remote
    class AddOne:
        def run(self, x):
            return x + 1.0

    return Doubler.remote(), AddOne.remote()


def channel_pipeline_zero_task_events(rt):
    InputNode = _dag(rt).InputNode
    a, b = _stages(rt)
    with InputNode() as inp:
        dag = b.run.bind(a.run.bind(inp).with_shm_channel((4,))).with_shm_channel((4,))
    compiled = dag.experimental_compile(max_inflight_executions=4)
    warm = compiled.execute(np.ones(4, np.float32)).get(timeout=T).tolist()
    before = _n_task_events(rt)
    refs = [compiled.execute(np.full(4, float(i), np.float32)) for i in range(8)]
    outs = [r.get(timeout=T).tolist() for r in refs]
    events = _n_task_events(rt) - before
    backends = sorted({ch.backend for ch in compiled._edge_chans.values()})
    compiled.teardown()
    rt.kill(a)
    rt.kill(b)
    return compiled._channel_mode, warm, outs, events, backends


def channel_multi_output(rt):
    d = _dag(rt)
    a, b = _stages(rt)
    with d.InputNode() as inp:
        dag = d.MultiOutputNode([a.run.bind(inp).with_shm_channel((2,)),
                                 b.run.bind(inp).with_shm_channel((2,))])
    compiled = dag.experimental_compile()
    out = compiled.execute(np.array([1.0, 2.0], np.float32)).get(timeout=T)
    compiled.teardown()
    rt.kill(a)
    rt.kill(b)
    return compiled._channel_mode, [o.tolist() for o in out]


def unannotated_graph_is_legacy_and_teardown_frees_the_actor(rt):
    InputNode = _dag(rt).InputNode
    a, b = _stages(rt)
    with InputNode() as inp:
        legacy = a.run.bind(inp)  # no channel hint
    compiled = legacy.experimental_compile()
    out = [compiled._channel_mode, float(compiled.execute(np.ones(2)).get(timeout=T)[0])]
    with InputNode() as inp:
        chan = a.run.bind(inp).with_shm_channel((2,))
    compiled = chan.experimental_compile()
    out.append(compiled.execute(np.ones(2, np.float32)).get(timeout=T).tolist())
    compiled.teardown()
    # the resident loop released the actor: plain calls work again
    out.append(float(rt.get(a.run.remote(np.ones(2)), timeout=T)[0]))
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(np.ones(2, np.float32))
    rt.kill(a)
    rt.kill(b)
    return out


def out_of_order_get_is_refused(rt):
    InputNode = _dag(rt).InputNode
    a, b = _stages(rt)
    with InputNode() as inp:
        dag = a.run.bind(inp).with_shm_channel((2,))
    compiled = dag.experimental_compile()
    r1 = compiled.execute(np.ones(2, np.float32))
    r2 = compiled.execute(np.full(2, 3.0, np.float32))
    with pytest.raises(RuntimeError, match="execution order"):
        r2.get(timeout=10)
    out = [r1.get(timeout=T).tolist(), r2.get(timeout=T).tolist()]
    compiled.teardown()
    rt.kill(a)
    rt.kill(b)
    return out


def _scales(rt, ks):
    @rt.remote
    class Scale:
        def __init__(self, k):
            self.k = k

        def run(self, x):
            return x * self.k

        def add(self, x):
            return x + self.k

    return [Scale.remote(k) for k in ks]


def allreduce_in_the_loops(rt):
    d = _dag(rt)
    a, b = _scales(rt, (2.0, 3.0))
    with d.InputNode() as inp:
        na = a.run.bind(inp).with_shm_channel((4,))
        nb = b.run.bind(inp).with_shm_channel((4,))
        dag = d.MultiOutputNode(d.allreduce.bind([na, nb], op="sum"))
    compiled = dag.experimental_compile(max_inflight_executions=4)
    warm = [o.tolist() for o in compiled.execute(np.ones(4, np.float32)).get(timeout=T)]
    before = _n_task_events(rt)
    refs = [compiled.execute(np.full(4, float(i), np.float32)) for i in range(6)]
    outs = [[o.tolist() for o in r.get(timeout=T)] for r in refs]
    events = _n_task_events(rt) - before
    mode = compiled._channel_mode
    compiled.teardown()
    rt.kill(a)
    rt.kill(b)
    return mode, warm, outs, events


def allreduce_ops_and_legacy(rt):
    d = _dag(rt)
    a, b = _scales(rt, (1.0, 10.0))
    with d.InputNode() as inp:
        dag = d.MultiOutputNode(d.allreduce.bind(
            [a.add.bind(inp).with_shm_channel((2,)), b.add.bind(inp).with_shm_channel((2,))],
            op="max"))
    compiled = dag.experimental_compile()
    out = [compiled._channel_mode,
           [o.tolist() for o in compiled.execute(np.zeros(2, np.float32)).get(timeout=T)]]
    compiled.teardown()
    with d.InputNode() as inp:
        dag = d.MultiOutputNode(d.allreduce.bind([a.add.bind(inp), b.add.bind(inp)], op="sum"))
    compiled = dag.experimental_compile()
    out += [compiled._channel_mode,
            [o.tolist() for o in compiled.execute(np.zeros(2, np.float32)).get(timeout=T)]]
    rt.kill(a)
    rt.kill(b)
    return out


def allreduce_bind_checks(rt):
    d = _dag(rt)
    (a,) = _scales(rt, (1.0,))
    msgs = []
    with d.InputNode() as inp:
        n1, n2 = a.run.bind(inp), a.run.bind(inp)
        for nodes, kw in (([n1, n2], {}), ([n1], {}), ([n1, n2], {"op": "xor"}),
                          ([n1, inp], {})):
            with pytest.raises(ValueError) as e:
                d.allreduce.bind(nodes, **kw)
            msgs.append(str(e.value))
    rt.kill(a)
    return msgs


PROGRAMS = [function_dag, actor_dag_state, multi_output_and_input_attributes,
            compiled_legacy_pipelining, channel_written_by_a_task,
            channel_pipeline_zero_task_events, channel_multi_output,
            unannotated_graph_is_legacy_and_teardown_frees_the_actor,
            out_of_order_get_is_refused, allreduce_in_the_loops, allreduce_ops_and_legacy,
            allreduce_bind_checks]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_same_program_same_result(runtimes, program):
    ref = program(ray_tpu)
    got = program(ray_tpu_torch)
    assert got == ref


def test_channel_mode_runs_on_the_native_ring_without_task_events(runtimes):
    mode, _, outs, events, backends = channel_pipeline_zero_task_events(ray_tpu_torch)
    assert mode and events == 0 and backends == ["native"]
    assert outs == [[2.0 * i + 1.0] * 4 for i in range(8)]


@pytest.fixture(scope="module")
def llama_actors(runtimes, tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.llm import save_params_npz
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.llm import LLMConfig, LlamaActor
    from ray_tpu_torch.models import llama as tl

    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    path = str(tmp_path_factory.mktemp("llama") / "tiny.npz")
    save_params_npz(jl.init_params(jax.random.PRNGKey(0), jcfg), path)
    kw = dict(checkpoint_path=path, max_batch_size=4, max_seq_len=64)

    @ray_tpu.remote
    class JaxScorer:
        def __init__(self, llm_config):
            self.cfg = llm_config.model_config
            self.params = llm_config.load_params()

        def score(self, tokens):
            import jax.numpy as jnp

            from ray_tpu.models import llama

            return float(llama.loss_fn(self.params, {"tokens": jnp.asarray(tokens)}, self.cfg))

        def row_losses(self, tokens):
            return np.array([self.score(tokens[i:i + 1]) for i in range(len(tokens))],
                            np.float32)

    class RowScorer(LlamaActor):
        """LlamaActor with each row's mean loss of an int32 batch, in one
        forward through flash attention and the fused CE."""

        def row_losses(self, tokens):
            import torch

            from ray_tpu_torch.models import llama
            from ray_tpu_torch.ops import cuda_ce

            cfg = dataclasses.replace(self.config, attention_impl="flash", ce_impl="fused")
            with torch.inference_mode():
                t = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
                inputs, targets, _ = llama.unpack_batch({"tokens": t})
                B, S = inputs.shape
                x = llama.forward_hidden(self.params, inputs, cfg)
                nll = cuda_ce.fused_cross_entropy(x.reshape(B * S, cfg.dim),
                                                  self.params["lm_head"].to(cfg.dtype),
                                                  targets.reshape(B * S))
                return nll.reshape(B, S).mean(dim=1).float().cpu().numpy()

    ref = JaxScorer.remote(JaxLLMConfig(model_config=jcfg, **kw))
    port = ray_tpu_torch.remote(RowScorer).remote(LLMConfig(model_config=tcfg, **kw),
                                                  device="cpu")
    yield ref, port, tcfg
    ray_tpu.kill(ref)
    ray_tpu_torch.kill(port)


def test_llama_scored_through_compiled_dags_agrees(llama_actors):
    import torch

    ref, port, cfg = llama_actors
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    losses = {}
    for rt, actor, arg in ((ray_tpu, ref, tokens),
                           (ray_tpu_torch, port, torch.from_numpy(tokens))):
        InputNode = _dag(rt).InputNode
        with InputNode() as inp:
            legacy = actor.score.bind(inp)
        compiled = legacy.experimental_compile()
        assert not compiled._channel_mode
        mean = [compiled.execute(arg).get(timeout=T) for _ in range(2)]
        with InputNode() as inp:
            inp.with_shm_channel(tokens.shape, "int32")
            chan = actor.row_losses.bind(inp).with_shm_channel((2,), "float32")
        compiled = chan.experimental_compile(max_inflight_executions=2)
        assert compiled._channel_mode
        rows = [r.get(timeout=T) for r in [compiled.execute(tokens) for _ in range(2)]]
        compiled.teardown()
        assert mean[0] == mean[1] and np.array_equal(rows[0], rows[1])
        losses[rt.__name__] = (mean[0], rows[0])
    (jm, jr), (tm, tr) = losses["ray_tpu"], losses["ray_tpu_torch"]
    np.testing.assert_allclose(tm, jm, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tr, jr, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tr.mean(), tm, rtol=LOSS_RTOL)
    assert np.isfinite(tr).all() and abs(tm - np.log(cfg.vocab_size)) < 1.0
