"""Rank programs of the port's mesh tests, one process per rank.

    python tests/torch_mesh_ranks.py <case> <rank> <world> <dir>

Each rank joins a gloo group of ``world`` ranks on a ``FileStore`` in
``<dir>`` (no TCP port, so test files may run side by side), runs the case
named on its inputs (``<dir>/args.json`` and the arrays the test wrote
there), and writes its result to ``<dir>/out<rank>.pt``. ``launch`` starts
the ranks and collects their results. The module imports neither JAX nor
a test module (its ranks would then import ``tests/conftest.py``), and
every join, collective and wait is bounded by a timeout, so that a hang
fails a test instead of running the suite into its time limit.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 90


def launch(case: str, world: int, workdir, timeout: float = TIMEOUT_S, **args) -> list:
    """Run ``case`` on ``world`` ranks; returns each rank's result. Raises
    with the ranks' stderr if one fails or the run outlasts ``timeout``."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), workdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    except subprocess.TimeoutExpired:
        errs.append(f"{case}: ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict, as the .npz format of save_params_npz."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().float().cpu().numpy()
    return out


def _family(name):
    from ray_tpu_torch.models import llama, moe_llama, vit

    return {"llama": (llama, llama.LLAMA_TINY), "moe": (moe_llama, moe_llama.MOE_TINY),
            "vit": (vit, vit.VIT_TINY)}[name]


# ---------------------------------------------------------------------
# cases: (rank, world, dir, args) -> result
# ---------------------------------------------------------------------

def case_mesh(rank, world, d, args):
    """make_mesh shapes and coordinates, the indivisible error, shard and
    gather round trips, and a sharded state's specs and shapes."""
    import dataclasses

    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import convert, llama
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_axis_size

    def shape(m):
        return {a: mesh_axis_size(m, a) for a in AXIS_ORDER}

    out = {}
    m = parallel.make_mesh(device="cpu")
    out["default"] = (shape(m), parallel.dp_degree(m))
    m = parallel.make_mesh(data=2, model=1, device="cpu") if world % 2 == 0 else m
    out["data2"] = (shape(m), parallel.dp_degree(m), m.get_coordinate())
    try:
        parallel.make_mesh(data=3, device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    mesh = parallel.make_mesh(fsdp=2, model=2, device="cpu")
    out["coordinate"] = mesh.get_coordinate()
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    full = convert.load_params_npz(os.path.join(d, "params.npz"))
    specs = llama.param_specs(cfg)
    shards = convert.shard_params(full, mesh, specs)
    out["shard_shapes"] = {k: tuple(v.shape) for k, v in _flat(shards).items()}
    out["contiguous"] = all(t.is_contiguous() for t in parallel.tree_leaves(shards))
    back = convert.gather_params(shards, mesh, specs)
    out["round_trip"] = all(np.array_equal(_flat(back)[k], np.asarray(v, np.float32))
                            for k, v in _flat_np(full).items())
    opt = parallel.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    state, sh = parallel.create_train_state(
        mesh, None, lambda _: convert.params_from_numpy(full, "cpu"), opt, specs)
    out["param_spec_wq"] = tuple(sh.params["blocks"]["wq"].spec)
    out["param_spec_embed"] = tuple(sh.params["embed"].spec)
    out["mu_spec_wq"] = tuple(sh.opt_state.mu["blocks"]["wq"].spec)
    out["count_spec"] = tuple(sh.opt_state.count.spec)
    out["step_spec"] = tuple(sh.step.spec)
    out["moments_shadow"] = all(
        mu.shape == p.shape and nu.shape == p.shape
        for p, mu, nu in zip(parallel.tree_leaves(state.params),
                             parallel.tree_leaves(state.opt_state.mu),
                             parallel.tree_leaves(state.opt_state.nu)))
    shapes, _ = parallel.state_shardings(mesh, specs, lambda: state)
    out["state_shardings_match"] = shapes.opt_state.nu["lm_head"].spec == specs["lm_head"]
    return out


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def case_single(rank, world, d, args):
    """single_device_mesh in a world of one."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_axis_size

    m = parallel.single_device_mesh("cpu")
    return {a: mesh_axis_size(m, a) for a in AXIS_ORDER}


def case_train(rank, world, d, args):
    """For each of ``args["runs"]`` (a tag, a family, a mesh shape and
    config overrides, its inputs in ``<dir>/<tag>/``): ``args["steps"]``
    sharded train steps of the family at its tiny size, f32, from the JAX
    package's parameters; per-step loss and grad norm, and the parameters
    gathered after the steps. One process group serves every run."""
    return {run["tag"]: _train_run(os.path.join(d, run["tag"]), run, args["steps"])
            for run in args["runs"]}


def _train_run(d, run, steps):
    import dataclasses

    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import convert

    mod, base = _family(run["family"])
    cfg = dataclasses.replace(base, dtype=torch.float32, **run.get("config", {}))
    mesh = parallel.make_mesh(device="cpu", **run["mesh"])
    full = convert.load_params_npz(os.path.join(d, "params.npz"))
    specs = mod.param_specs(cfg)
    opt = parallel.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    state, sh = parallel.create_train_state(
        mesh, None, lambda _: convert.params_from_numpy(full, "cpu"), opt, specs)
    step = parallel.make_train_step(lambda p, b: mod.loss_fn(p, b, cfg), opt, mesh, sh)
    data = np.load(os.path.join(d, "batches.npz"))
    losses, norms = [], []
    for i in range(steps):
        batch = {k[len(f"{i}/"):]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(f"{i}/")}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ev = parallel.make_eval_step(lambda p, b: mod.loss_fn(p, b, cfg), mesh, sh)
    eval_loss = float(ev(state, batch)["loss"])
    return {"losses": losses, "grad_norms": norms, "eval_loss": eval_loss,
            "params": _flat(convert.gather_params(state, mesh, specs)),
            "shard_wq": tuple(state.params["blocks"]["wq"].shape)
            if "blocks" in state.params else None}


def _leaves(tree, prefix=""):
    """{"a/b": tensor} of a nested dict, by name (two trees may order
    their keys differently)."""
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def case_checkpoint(rank, world, d, args):
    """A sharded ``Checkpoint.from_torch`` of LLAMA_TINY's TrainState (f32)
    after ``args["steps"]`` steps at ``args["save"]``, and one more step
    of the uninterrupted run; then ``to_torch(target, shardings=)`` onto
    each mesh shape of ``args["restores"]``, every restored shard held
    bit for bit against ``shard_params`` of the tree gathered at the save,
    and one step there. ``args["indivisible"]``: a shape that a spec does
    not divide. With ``args["unsharded"]`` (a checkpoint of whole params
    the test wrote), this rank's shards of it at ``args["save"]``."""
    import dataclasses

    from ray_tpu_torch import parallel, train
    from ray_tpu_torch.models import convert, llama
    from ray_tpu_torch.parallel.mesh import NamedSharding

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    full = convert.load_params_npz(os.path.join(d, "params.npz"))
    specs = llama.param_specs(cfg)
    opt = parallel.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    data = np.load(os.path.join(d, "batches.npz"))
    batches = [{"tokens": torch.from_numpy(data[str(i)])} for i in range(len(data.files))]

    def loss(p, b):
        return llama.loss_fn(p, b, cfg)

    n = args["steps"]
    mesh = parallel.make_mesh(device="cpu", **args["save"])
    state, sh = parallel.create_train_state(
        mesh, None, lambda _: convert.params_from_numpy(full, "cpu"), opt, specs)
    step = parallel.make_train_step(loss, opt, mesh, sh)
    for b in batches[:n]:
        state, _ = step(state, b)
    ckpt = train.Checkpoint.from_torch(state, os.path.join(d, "ckpt"), shardings=sh)
    # copies: a leaf no axis splits comes back as itself, which the next
    # step updates in place
    saved = {k: parallel.tree_map(torch.clone, convert.gather_params(tree, mesh, specs))
             for k, tree in (("params", state.params), ("mu", state.opt_state.mu),
                             ("nu", state.opt_state.nu))}
    _, m = step(state, batches[n])
    out = {"uninterrupted": float(m["loss"]), "saved": {k: _flat(v) for k, v in saved.items()},
           "restores": {}}
    for shape in args["restores"]:
        new_mesh = parallel.make_mesh(device="cpu", **shape)
        new_sh, _ = parallel.state_shardings(new_mesh, specs, lambda: state)
        restored = ckpt.to_torch(target=state, shardings=new_sh)
        got = {"params": restored.params, "mu": restored.opt_state.mu,
               "nu": restored.opt_state.nu}
        leaves = {k: [(a, _leaves(convert.shard_params(saved[k], new_mesh, specs))[n])
                      for n, a in _leaves(v).items()] for k, v in got.items()}
        res = {"bit_equal": {k: all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
                             for k, pairs in leaves.items()},
               "contiguous": all(a.is_contiguous() for pairs in leaves.values() for a, _ in pairs),
               "requires_grad": [t.requires_grad for t in parallel.tree_leaves(restored.params)],
               "counts": (restored.step, restored.opt_state.count),
               "wq_shape": tuple(restored.params["blocks"]["wq"].shape)}
        new_step = parallel.make_train_step(loss, opt, new_mesh, new_sh)
        _, m = new_step(restored, batches[n])   # updates the restored leaves in place
        out["restores"][json.dumps(shape, sort_keys=True)] = dict(res, loss=float(m["loss"]))
    if args.get("indivisible"):
        bad_mesh = parallel.make_mesh(device="cpu", **args["indivisible"])
        bad_sh, _ = parallel.state_shardings(bad_mesh, specs, lambda: state)
        try:
            ckpt.to_torch(target=state, shardings=bad_sh)
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    if args.get("unsharded"):
        def bind(spec_tree):
            if isinstance(spec_tree, dict):
                return {k: bind(v) for k, v in spec_tree.items()}
            return NamedSharding(mesh, spec_tree)

        shards = train.Checkpoint(args["unsharded"]).to_torch(shardings=bind(specs))
        out["unsharded"] = _flat(shards)
    return out


def _qkv(d):
    z = np.load(os.path.join(d, "qkv.npz"))
    return {k: torch.from_numpy(z[k]) for k in z.files}


def _attention_case(rank, world, d, args, fn):
    """Each case's q/k/v/cotangent split over a seq mesh; the blocks' output
    and gradients gathered back whole."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(seq=world, device=args.get("device", "cpu"))
    dev = parallel.mesh.mesh_device(mesh)
    out = {}
    arrays = _qkv(d)
    for case in args["cases"]:
        tag = case["tag"]
        q, k, v, g = (arrays[f"{tag}/{n}"].to(dev) for n in ("q", "k", "v", "g"))
        if args.get("bf16"):
            q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
        blocks = [comm.local_part(t, mesh, ("seq",), 1).contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        kernels = _attention_kernels()
        for w in kernels.values():
            w.launches = 0
        try:
            o = fn(*blocks, mesh=mesh, causal=case["causal"])
        except ValueError as e:
            out[tag] = {"error": str(e)}
            continue
        gq, gk, gv = torch.autograd.grad(o, blocks,
                                         comm.local_part(g, mesh, ("seq",), 1).contiguous())
        out[tag] = {n: comm.all_gather(t.detach(), mesh, "seq", 1).float().cpu()
                    for n, t in (("o", o), ("dq", gq), ("dk", gk), ("dv", gv))}
        out[tag]["launches"] = {n: w.launches for n, w in kernels.items()}
    return out


def _attention_kernels():
    from ray_tpu_torch.ops import cuda_attention

    return {n: getattr(cuda_attention, n) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")}


def case_ring(rank, world, d, args):
    from ray_tpu_torch.ops import ring_attention, ring_attention_sharded

    out = _attention_case(rank, world, d, args, lambda q, k, v, mesh, causal: ring_attention(
        q, k, v, mesh=mesh, causal=causal, block_q=16, block_kv=16))
    if args.get("sharded"):
        from ray_tpu_torch import parallel

        mesh = parallel.get_mesh() or parallel.make_mesh(seq=world, device="cpu")
        a = _qkv(d)
        tag = args["cases"][0]["tag"]
        q = a[f"{tag}/q"].requires_grad_(True)
        o = ring_attention_sharded(q, a[f"{tag}/k"], a[f"{tag}/v"], mesh,
                                   causal=args["cases"][0]["causal"], block_q=16, block_kv=16)
        (gq,) = torch.autograd.grad(o, [q], a[f"{tag}/g"])
        out["sharded"] = {"o": o.detach(), "dq": gq}
    return out


def case_ulysses(rank, world, d, args):
    from ray_tpu_torch.ops import ulysses_attention

    return _attention_case(rank, world, d, args, lambda q, k, v, mesh, causal: ulysses_attention(
        q, k, v, mesh=mesh, causal=causal))


def case_pipeline(rank, world, d, args):
    """pipeline_train (both schedules) and pipeline_sharded on a pipe mesh
    of every rank: loss, the stage gradients gathered whole, what was
    stashed."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import P

    mesh = parallel.pipe_mesh("cpu")
    z = np.load(os.path.join(d, "pipe.npz"))
    stacked = {k: z[k] for k in ("w", "b")}
    specs = {"w": P("pipe"), "b": P("pipe")}
    local = convert.shard_params(stacked, mesh, specs)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return torch.mean((y - t) ** 2)

    out = {}
    for key, batch, targets in (("small", "batch", "targets"), ("big", "big_batch", "big_targets")):
        for schedule in ("1f1b", "gpipe"):
            run = parallel.pipeline_train(stage, local, mesh, loss_fn=loss_fn,
                                          microbatch_size=args["microbatch"], schedule=schedule)
            loss, grads = run(torch.from_numpy(z[batch]), torch.from_numpy(z[targets]))
            out[f"{key}/{schedule}"] = {
                "loss": float(loss), "stats": dict(run.stats),
                "grads": {k: v.cpu() for k, v in convert.gather_params(grads, mesh, specs).items()}}
    fwd = parallel.pipeline_sharded(stage, local, mesh, microbatch_size=args["microbatch"])
    with torch.no_grad():
        out["forward"] = fwd(torch.from_numpy(z["batch"]))
    return out


def case_pipeline_one_microbatch(rank, world, d, args):
    """pipeline_sharded with a single microbatch: each stage adds its c."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import P

    mesh = parallel.pipe_mesh("cpu")
    local = convert.shard_params({"c": np.asarray([1.0, 10.0], np.float32)}, mesh,
                                 {"c": P("pipe")})
    run = parallel.pipeline_sharded(lambda p, x: x + p["c"], local, mesh, microbatch_size=4)
    with torch.no_grad():
        return run(torch.zeros((4, 3)))


def case_spans(rank, world, d, args):
    """The names of the span records one train step emits on this rank
    over ``args["mesh"]`` (tracing on, the records kept in the rank)."""
    import dataclasses

    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import tracing

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32, remat=True)
    mesh = parallel.make_mesh(device="cpu", **args["mesh"])
    opt = parallel.default_optimizer(1e-3, warmup_steps=0)
    state, sh = parallel.create_train_state(
        mesh, torch.Generator().manual_seed(0), lambda g: llama.init_params(g, cfg, device="cpu"),
        opt, llama.param_specs(cfg))
    step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt, mesh, sh)
    tokens = torch.randint(0, cfg.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    records = []
    tracing._emit = records.append
    tracing.enable()
    step(state, {"tokens": tokens})
    return [r["name"] for r in records]


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def main(case: str, rank: int, world: int, d: str) -> None:
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    if args.get("device") == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = CASES[case](rank, world, d, args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"out{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
