#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile | --mesh-nccl]

Runs from the root of a checkout and needs one Hopper card, ``nvcc`` and
nothing else (``--mesh-nccl``: four cards, and it runs only the mesh
training paths and the op-level mesh paths over NCCL, one rank a card,
against one device, then Anakin over four cards and Sebulba at SLICE,
each's update against one card's; see ``mesh_nccl_phase`` and
``rllib_nccl_phase``): it builds the kernels from ``ray_tpu_torch/csrc``,
starts the graftlint phase beside the next phases (the port's gate,
``python -m ray_tpu_torch.tools.graftlint ray_tpu_torch``, in a
subprocess: it must exit 0 with no finding; printed: the files it
checked and its seconds, before the runtime phase) and then

1. kernel phases: each of the seven hand-written kernels of the model
   at the main paths' shapes, held against its plain PyTorch version
   (f32 from the same bf16 inputs, TF32 off) and timed beside its bound, the plain
   version and one PyTorch library call used only as a yardstick (SDPA
   and its backward, ``F.cross_entropy(x @ w)``); two runs of each
   attention kernel held bit for bit, and the two backward kernels
   together beside the SDPA backward; the CE backward's three kernels
   (dlog, dx, dW) each on one chunk of rows, dx and dW beside the one
   matmul each computes on that chunk (dlog has no such call), then
   the whole chunked backward against its 6 N D V bound and
   ``F.cross_entropy(x @ w)``'s backward, and two runs of it held bit for
   bit; a digest of the CE kernels' outputs, so that two trees' runs show
   whether their bits agree; the one-pass AdamW kernel at the largest
   leaf of the benchmark's Mistral cells, held bit for bit against the
   plain loop of ops over two updates (clipped, then not), timed beside
   its bound (28 B an element), the plain loop and the library's
   ``torch._fused_adamw_`` (no clip; the port never calls it);
2. scoring phase: ``LLAMA_BENCH`` (full width and depth, random weights
   from a seed, bf16) runs ``loss_fn`` with ``attention_impl="flash"``
   and ``ce_impl="fused"`` on 8 x 2049 tokens, then on a small batch the
   loss, the final hidden states and the per-token losses of the kernel
   paths are held against the plain attention and CE paths;
3. serving phase: a ``LlamaEngine`` answers 8 greedy requests, and the
   cached path's last logits are held against ``forward`` with flash
   attention;
4. training check: on 2 x 512 tokens, the gradients of every parameter
   tensor and the loss of the kernel paths against the plain paths, at
   ``LLAMA_BENCH`` in bf16 with remat;
5. training phase: ``ray_tpu_torch.parallel`` ``create_train_state`` and
   ``make_train_step`` train ``LLAMA_BENCH`` (bf16 parameters, remat,
   flash + fused) with ``default_optimizer(1e-4, warmup_steps=10,
   total_steps=1000)`` on the same 8 x 2049 batch every step: one warm-up
   step, then 10 timed steps (step time, tokens/s, MFU against the dense
   bf16 peak, peak memory, losses and grad norms);
6. LoRA serving phase: a seeded rank-8 adapter on ``blocks/wq`` and
   ``lm_head``, written as ``.npz`` and read back, folded into the same
   ``LLAMA_BENCH`` weights with ``apply_lora``; a ``LlamaEngine`` on the
   folded tree (f32 compute on the bf16 weights) answers 4 greedy
   requests, whose tokens must equal the argmax of ``forward`` on the
   folded tree and differ from the unadapted engine's on one at least;
6b. runtime phase: ``ray_tpu_torch.init(num_cpus=2)`` must detect the
   card; a ``LlamaActor`` with ``num_gpus=1`` is placed in the placement
   group of ``LLMConfig(model_config=LLAMA_BENCH).placement_bundles()``
   and must see one card, the driver's (by UUID); both processes build
   ``LLAMA_BENCH`` in bf16 from a fresh generator seeded 0 and their
   parameter digests must be equal; the actor scores the 8 x 2049 batch,
   put into the object store as a CPU tensor (loss within ``LOSS_RTOL``
   of the in-process ``loss_fn``'s, printed bit for bit, timed against
   it) and answers 8 greedy requests (tokens equal to an in-process
   engine's); a CUDA tensor goes to a GPU actor and back, and a task
   without a GPU that gets it must raise; then the runtime's round trips,
   put/get rates and ``/dev/shm``, and after ``shutdown()`` no worker
   process may be left;
6c. trainer phase: ``LLAMA_BENCH`` trained as in the training phase
   (bf16 parameters from a fresh generator seeded 0, remat, flash + fused
   CE, the same optimizer) for 4 steps on the runtime phase's 8 x 2049
   batch, first in this process, then by a ``TorchTrainer`` gang of one
   ``use_gpu`` worker in its own ``init(num_cpus=2)``, the batch in
   ``train_loop_config`` as a CPU tensor: the worker reports each step,
   commits ``Checkpoint.from_torch(state)`` after step 2, fails on purpose
   before step 3 on its first attempt, is restarted by
   ``FailureConfig(max_failures=1)`` and resumes from that checkpoint
   (``CheckpointConfig(num_to_keep=1)``). Both attempts must see one card,
   the driver's by UUID, from two pids; the 4 losses must match this
   process's within ``TRAIN_LOSS_RTOL`` (bit-equality printed); the run
   must end at ``training_iteration`` 4 with one checkpoint kept and no
   worker process left after ``shutdown()``; printed: placement and
   first-step seconds, step ms beside this process's, checkpoint bytes,
   save and commit seconds, restart-to-resumed seconds, ``fit()`` seconds.
   Before the run storage goes, the kept checkpoint (step 2) is loaded on
   the host and its ``.params`` written by ``Checkpoint.from_torch`` to a
   directory of their own;
6c'. train_to_serve phase: that directory through ``LLMConfig(
   checkpoint_path=dir).load_params()`` onto the card: every leaf
   bit-equal to the TrainState's (dtype included), and ``loss_fn`` with
   flash attention and the fused CE on the trainer's batch within
   ``TRAIN_LOSS_RTOL`` of the loss the resumed worker reported for step 3
   (these parameters' loss on that batch); then, in its own
   ``init(num_cpus=2)``, ``serve.run(build_llm_app(LLMConfig(..., the same
   checkpoint_path)), route_prefix="/llm", http_options={"port": a free
   port})``: the replica asks for ``{"num_gpus": 1.0}`` and must see the
   driver's card by UUID with its engine there, and the 8 prompts POSTed
   over HTTP with ``urllib`` (32 greedy tokens each) must get exactly an
   in-process engine's tokens. Printed: checkpoint bytes, save and load
   seconds, the leaves' equality and the loss error, ``serve.run`` and
   first-HTTP-answer seconds, the requests' seconds and tokens/s, the
   replica's card; after ``shutdown()`` no worker process may be left;
6d. serve phase, in its own ``init(num_cpus=2)`` that must detect the
   card: (a) ``serve_scoring``, a deployment with ``num_gpus=1`` whose
   ``@serve.batch(max_batch_size=8)`` method takes one 2049-token row per
   request and scores the stacked rows in one forward (flash attention,
   fused CE; ``LLAMA_BENCH`` from a fresh generator seeded 0, its digest
   equal to the driver's): eight concurrent handle calls must make one
   batch of 8 whose per-request losses match the driver's rows of the
   same forward within ``LOSS_RTOL`` (bit-equality printed), timed
   against it (median of 3); then ``serve.delete``, and the card must
   return to the pool; (b) ``serve_llm``, ``serve.run(build_openai_app(
   LLMConfig(LLAMA_BENCH, ...)))`` with the LoRA phase's adapter
   directory: eight concurrent completions (the runtime phase's prompts,
   32 greedy tokens) must equal an in-process engine's tokens with the
   right ``usage`` and ``finish_reason``, a streamed request
   (``generate_stream``) its tokens, and a request naming the adapter an
   in-process engine's on the folded tree (and differ from the base's).
   Each replica must see one card, the driver's by UUID, and be
   constructed exactly once (the hub's actor table and creation events,
   which also give the constructor's seconds); after ``shutdown()`` no
   worker process may be left;
6e. cluster phase: ``python -m ray_tpu_torch start --head --num-gpus 0``
   (``RAY_TPU_TORCH_NUM_GPUS=0`` in its environment only) and ``start
   --address ... --num-gpus 1 --node-id gpu-node`` in two processes; this
   process joins as a client (``init(address=...)``): two live nodes,
   the one GPU on ``gpu-node``, and each of the hub's node-agent message
   types (and the CLI's SHUTDOWN) with both ends in the source. A
   ``LlamaActor`` with ``num_gpus=1`` in the group of
   ``placement_bundles()`` must run on ``gpu-node`` (``util.state``) and
   see the driver's card by UUID, with the driver's parameter digest; it
   scores the runtime phase's batch, put by this client as a CPU tensor
   (loss within ``LOSS_RTOL`` of the in-process ``loss_fn``'s, timed
   against it); printed: the client's task round trips to each node and
   a 256 MiB CPU tensor put, echoed by an actor on ``gpu-node`` and got
   back. A job submitted through the CLI runs a one-GPU task that must
   land on ``gpu-node`` and see the card; ``status`` and ``summary`` must
   run; ``stop --address`` from a place with no pid file (SHUTDOWN over
   the wire) must take the head and the agent down within
   ``CLUSTER_STOP_S`` with no worker process left;
6f. dag phase, in its own ``init(num_cpus=2)``: a ``num_gpus=1``
   ``LlamaActor`` (``LLAMA_BENCH``, bf16, seeded 0, the driver's card)
   scores the runtime phase's batch through compiled DAGs: in legacy mode
   (``actor.score.bind``, 6 executes, the batch by value and by a ref, each
   loss bit-equal to the driver's)
   and in channel mode (a method that takes the int32 batch as numpy and
   returns the 8 per-row losses as f32, both annotated with
   ``with_shm_channel``; 16 executes, 10 of them pipelined up to the
   ring's capacity of 4, each bit-equal to the driver's rows; the C++ ring
   backend; no task event across the 10). The counters are zeroed in the
   actor before each compile and read after each teardown, since the
   resident loop holds the actor. Printed: each mode's ms per execute
   beside ``actor.score.remote`` and the in-process call; after teardown
   the actor answers again and holds the one GPU;
6g. workflow phase: a two-node workflow (a CPU task makes the batch, a
   ``num_gpus=1`` task builds ``LLAMA_BENCH`` and scores it); the first
   run fails by a planned fault in the scoring node (status FAILED), the
   resume replays that node only (status SUCCEEDED) and its loss is
   bit-equal to the driver's;
6h. data phase: 64 seeded 2049-token rows in 8 blocks (``from_numpy``);
   ``map_batches`` of a scoring class with ``batch_size=8, concurrency=1,
   num_gpus=1`` (one pool actor on the driver's card with
   ``CUDA_VISIBLE_DEVICES='0'``; its per-row losses bit-equal to the
   driver's; each batch's launches returned as columns); the rows staged
   onto the card by ``iter_torch_batches(batch_size=8,
   device_put="cuda")`` with ``prefetch_batches`` 2 and 0, each batch equal
   to its rows and its loss in this process bit-equal to scoring the rows
   moved directly; ``build_llm_processor`` on ``LLAMA_BENCH``
   (``concurrency=1, batch_size=8, max_tokens=32``, greedy) over the 8
   prompts, whose tokens must equal an in-process engine's, with no
   kernel launched in its pool actor (read through ``__ray_call__`` while
   the stage's output is still open). Printed: rows/s, ms per batch with
   each prefetch, one batch's host-to-card copy, tokens/s;
6i. tune phase, in its own ``init(num_cpus=2)``: a ``Tuner`` over a
   function trainable ``with_resources(..., {"GPU": 1})`` that trains
   ``LLAMA_BENCH`` as the trainer phase does (``trainer_setup``/
   ``trainer_loop`` at the trial's learning rate) for 3 steps on the
   runtime phase's batch, a ``grid_search`` over two learning rates: the
   two trials must run one after another (the second starts after the
   first's last step, when no process of the first runs), each pinned
   '0', the driver's card by UUID; each trial's losses must be bit-equal
   to the same lr run in this process first, and ``get_best_result("loss",
   "min")`` must pick the lower last loss. Then a ``Tuner`` wrapping a
   ``use_gpu`` ``TorchTrainer`` of the same loop at 2 layers (full width),
   3 steps, the same grid, one trial at a time: the same checks, and the
   hub's actor table must show each trial's actor on a CPU and its gang's
   worker holding the GPU. Printed: each trial's placement s, step ms
   beside the in-process steps, ``fit()`` s and launch counts;
6j. collective phase: an "nccl" group over this process's cards (world
   size 1 here): allreduce under every ``ReduceOp``, reduce, broadcast,
   allgather and reducescatter on f32 and bf16 tensors of one
   ``LLAMA_BENCH`` layer's parameter count (47.19 M), each held against
   the group's plain path on CPU copies and timed (ms, GB/s), then barrier
   and send/recv; a "store" group of a ``num_gpus=1`` actor with CUDA
   tensors and a CPU actor: allreduce and allgather of 4 M f32 bit-equal to
   numpy's, each result on its rank's device;
6k. mesh phase (the parallel layer): ``LLAMA_BENCH`` trained 3 steps on the
   runtime phase's batch (bf16, remat, flash + fused CE, the trainer
   phase's seed and optimizer), each path's losses held to the same steps
   on one device in this process: ``mesh_world1``, a one-GPU
   ``TorchTrainer`` worker whose loop builds ``make_mesh()`` from
   ``TorchConfig.mesh_shape`` over its NCCL world of one (full depth;
   bit-equality printed, within ``TRAIN_LOSS_RTOL``); ``mesh_shared``, 4
   gloo ranks sharing the card at (fsdp 2, model 2), and ``mesh_ring``, 2
   gloo ranks at seq 2 with ``attention_impl="ring"`` (both at
   ``MESH_DEPTH`` layers, within ``MESH_LOSS_RTOL``; printed: launches per
   rank, staged bytes and where each step's host time went). After its
   steps ``mesh_shared`` saves its sharded state (a sharded
   ``Checkpoint.from_torch``), takes a fourth step, and restores the
   checkpoint with ``to_torch(target, shardings=)`` onto a mesh of
   (fsdp 4) in the same ranks (``mesh_restore``): every restored shard
   (parameters and both Adam moments) must equal ``shard_params`` of the
   tree gathered at the save bit for bit, and one step there must match
   the fourth step within ``MESH_LOSS_RTOL`` (printed: the checkpoint's
   bytes, save and restore seconds, the restored step's ms). Then, on 2
   ranks against one rank: Ulysses and the ring at LLAMA_BENCH's heads
   (``mesh_ulysses``, ``mesh_ring_op``), 1F1B and GPipe over 2 stages of 8
   blocks (gradients against the sequential microbatches; 1F1B's peak
   memory below GPipe's, summed over the ranks), and the expert-parallel
   MoE FFN at Mixtral's expert widths (``mesh_expert``);
6l. rllib phase (``ray_tpu_torch.rllib``, which reaches no kernel of the
   port: the RL MLPs' products are torch matmuls, as the reference's are
   plain ``@``), its workers started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
   and ``OMP_NUM_THREADS=1``: (1) Anakin
   through ``PodracerConfig.build()`` in its own ``init(num_cpus=2)``, the
   worker pinned to the card (it must report ``cuda:0``), at the config's
   defaults (hiddens (32, 32), 16-step fragments, lr 5e-3, compiled DAG)
   with both losses: two same-seed 4-tick runs at 64 envs must give
   bitwise-equal metrics rows, and over ``RLLIB_TICKS`` ticks at 4096 envs
   the mean episode return of the last 5 ticks must exceed the first 5's;
   printed: env steps/s and supersteps/s, the reward trajectory, and for a
   superstep run in this process its ms, kernel launches (torch.profiler)
   and peak memory; (2) every learner's update (the Anakin superstep's
   with V-trace and with APPO, PPO's, DQN's, SAC's, BC's, MARWIL's,
   CQL's) at its config's default shapes, from one seeded params tree and
   host batch, on the card and on the CPU: losses within ``RLLIB_RTOL``
   (atol ``RLLIB_ATOL``), each updated tensor within ``RLLIB_RTOL`` of its
   CPU twin in norm (``rllib_hold``), with the card's update ms; (3) BC
   trained 25 epochs from a 2000-row ``Dataset`` whose batches
   ``iter_batches(device_put=...)`` stages on the card (loss below 0.25,
   accuracy above 0.9); (4) Sebulba, 2 actors x 16 envs on CPU bundles and
   the learner on the card (asserted from its metrics), 10 rounds after a
   first: rounds/s and the bytes handed off a round. No kernel of the port
   may be launched in this process during the phase;
7. MoE check: ``MIXTRAL_8X7B``'s widths cut to 2 layers (bf16, remat) on
   2 x 513 tokens, the flash path against the einsum attention path with
   the routing pinned to the einsum path's (loss, aux loss, every
   gradient), and unpinned (how many assignments move, loss, aux loss);
8. MoE training phase: the same model through ``create_train_state`` and
   ``make_train_step`` on 4 x 2049 tokens, a warm-up step and 5 timed
   steps (step time, tokens/s, MFU on ``active_param_count``, peak
   memory); the dense dispatch's pieces timed at that shape;
9. MoE scoring phase: the widths cut to 4 layers, ``loss_fn`` on the same
   batch under ``inference_mode``, median of 3;
10. ViT phase: ``VIT_B_16`` at full size on 64 seeded 224x224x3 images,
   a warm-up and 5 timed train steps, then a forward-only eval; its bf16
   logits are held against its f32 logits on 8 images.

Each kernel's launch counter is set to 0 just before each main-path run
(the scoring batches, the engine's requests, the training steps) and read
just after it, before any check runs; the counts go into the kernels line
per path. The scoring path must launch the two forward kernels, the
training path all eight (per step: the flash forward twice per layer,
once more in remat's recompute, each attention backward kernel once per
layer, the CE forward once, each CE backward kernel once per chunk of
rows, the AdamW kernel once per parameter leaf). The MoE training path
launches the three attention kernels and the AdamW kernel as the dense
one does and no CE kernel (its loss is the CE on full logits, as in the
reference), the MoE scoring path the flash forward once per layer.
The serving and LoRA serving paths launch none: like the JAX engine, the
engine's attention is the plain cached einsum; ViT's training launches
the AdamW kernel once per leaf a step and no other (its attention is an
einsum in the reference too). The runtime paths
(``runtime_scoring``, ``runtime_serving``) are counted in the actor's
process, zeroed there just before the call and read just after it:
scoring must launch the flash forward once per layer and the CE forward
once, serving none; ``train_to_serve`` (counted in this process around
the scoring of the loaded checkpoint) as scoring, and
``train_to_serve_http`` (in the HTTP replica's process, around the 8
requests) none; so must ``serve_scoring`` and ``serve_llm`` in their
replicas' processes (zeroed and read through handle calls, and through
``__ray_call__`` on the OpenAI app's replica), and ``cluster_scoring`` in
the ``LlamaActor``'s process on the agent's node; ``dag_legacy`` (6 batches) and
``dag_channel`` (16) in the DAG's actor, ``workflow_scoring`` (1) in the
workflow's scoring task, ``data_pool`` (8) in the pool actor, summed from
its per-batch columns, and ``data_staging`` (8) in this process must
launch the flash forward once per layer and the CE forward once per
batch, and ``llm_processor`` none. The ``trainer`` path is counted in the gang's
worker, zeroed there before each step and read after it: each step must
launch all eight kernels as a training step does; so must each step of
``tune_trial`` (counted in the trial's actor) and of ``tune_trainer``
(in the wrapped trainer's worker; 2 layers). The mesh paths are counted in
their ranks and summed over them: each step of ``mesh_world1`` as a
training step; of ``mesh_shared`` per rank as a training step on its heads
and rows (the CE over its 4 rows); of ``mesh_ring`` rank r runs the flash
forward 2 (r + 1) times a layer and each backward kernel r + 1 times (its
hop plan), the CE kernels on its half of the sequence, the AdamW kernel
once per leaf (on every rank, on its shard); ``mesh_restore``
per rank as a training step on every head and a quarter of the rows;
``mesh_ulysses`` one of each attention kernel a rank, ``mesh_ring_op``
r + 1 each, ``mesh_expert`` none. ``--profile`` adds a
``torch.profiler`` breakdown of one scoring batch, of the serving run
(whose printed times then carry the profiler's cost), of one training
step, with the optimizer update's share of it, of one MoE training step,
one MoE scoring batch and one ViT training step. The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed; without a CUDA device it
exits with 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Tolerances, each against a plain version computed in f32 from the same
# bf16 inputs. Attention: P is rounded to bf16 before P.V (as the reference
# kernel does) and o is written in bf16, for unit-variance inputs; the
# absolute limit covers the large early causal rows, the per-row relative
# one (||o - ref|| / ||ref||) the late rows, whose |o| is only a few 1e-2.
ATTN_O_ATOL = 2e-2
ATTN_ROW_RTOL = 1e-2
# lse and the CE outputs: f32 sums of exact bf16 products, in another order.
STAT_ATOL = 1e-3
# Whole model in bf16 (16 layers), kernel paths against the plain paths on
# 2 x 512 tokens: the mean loss (relative), the final hidden states (per
# row, relative) and the per-token losses (absolute). The loss of a
# random-weight model sits near ln V whatever attention does, so the
# hidden states and per-token losses carry the check. Each limit is a few
# times the reading on an H100 (PERF.md): 1.8e-5, 1.9e-2, 5.7e-2.
LOSS_RTOL = 1e-3
HIDDEN_ROW_RTOL = 5e-2
NLL_ATOL = 1.5e-1
# Cached-vs-full last logits, relative to the largest logit.
LOGIT_RTOL = 5e-2
# Backward kernels: p and dS (attention) or dlog (CE) are rounded to bf16
# where the reference rounds and the outputs are bf16; the plain versions
# run in f32. Each output row (dq, dk, dv, dx, dW along the last axis) is
# held relative to its norm, floored at 1e-3 of the largest row norm for
# rows that cancel to ~0 (causal dq row 0). Readings on an H100: 3.5e-3 to
# 4.4e-3 (attention), 1.7e-3 and 2.2e-3 (CE).
GRAD_ROW_RTOL = 1e-2
# Training check, LLAMA_BENCH bf16 on 2 x 512 tokens with remat: per
# parameter tensor ||g_kernels - g_plain|| / ||g_plain|| (bf16 through 16
# layers twice), and the loss (relative). Each limit is a few times the
# reading on an H100 (PERF.md): gradients 1.4e-2 to 3.2e-2, loss 1.3e-5.
TRAIN_GRAD_RTOL = 1e-1
TRAIN_LOSS_RTOL = 1e-4
# The MoE check with the routing pinned is held to the two limits above
# (readings on an H100: gradients 1.1e-2 to 1.7e-2, loss 3.9e-5). Free,
# top-k routing is discontinuous: the bf16 differences of the two attention
# paths send some assignments to other experts (read 1.39%, at most 5%
# allowed), and the loss and the aux loss move by more than the pinned
# limits (read 7.3e-5 and 2.9e-4, 1e-2 allowed).
MOE_FREE_RTOL = 1e-2
MOE_FREE_MOVED = 5e-2
# ViT-B/16, bf16 activations against f32 activations (the same f32
# weights) on 8 images: logits absolute, for logits of order 1 (read 4.8e-2).
VIT_LOGIT_ATOL = 0.25

# The one card this script has been run on: NVIDIA H100 SXM. Dense bf16
# tensor-core peak (FLOP/s) and memory rate (bytes/s) from its data sheet.
CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS, PEAK_BW = 989e12, 3.35e12


def fail_unless(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def row_rel_err(out: torch.Tensor, ref: torch.Tensor, floor: float = 0.0) -> float:
    """max over rows (last axis) of ||out - ref|| / ||ref||, each norm
    floored at ``floor`` times the largest row norm."""
    ref = ref.float()
    norms = ref.norm(dim=-1)
    diff = (out.float() - ref).norm(dim=-1)
    return (diff / norms.clamp_min(floor * norms.max())).max().item()


def digest(*tensors: torch.Tensor) -> str:
    """First 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median over CUDA events of single calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# kernel-name fragments of each class in a device-time breakdown
KERNEL_CLASSES = (
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("fused_ce_fwd", ("ce_partial_kernel", "ce_combine_kernel")),
    ("fused_ce_bwd_dlog", ("ce_bwd_dlog_kernel",)),
    ("fused_ce_bwd_dx", ("ce_bwd_dx_kernel",)),
    ("fused_ce_bwd_dw", ("ce_bwd_dw_kernel",)),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
)


def device_breakdown(label: str, fn):
    """Run fn once under torch.profiler, print where the device time went
    (kernel time by class, the top kernels, and the busy share of the wall
    time: a lower bound, since the profiler slows the host) and return
    fn's result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(per_kernel.values())
    if busy == 0.0:
        print(f"profile {label}: wall {wall_ms:.2f} ms; device time not measured "
              "(the profiler saw no kernels)")
        return result
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for kname, ms in per_kernel.items():
        cls = next((name for name, frags in KERNEL_CLASSES
                    if any(f in kname for f in frags)), "other")
        classes[cls] += ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: wall {wall_ms:.2f} ms, kernels {busy:.2f} ms "
          f"({busy / wall_ms:.1%} busy); " +
          ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})" for k, v in classes.items()))
    for kname, ms in top:
        print(f"  {ms:9.3f} ms  {kname[:110]}")
    return result


@contextlib.contextmanager
def moe_routing(moe_ops, record=None, replay=None):
    """Wrap ``moe_ops.top_k_gating`` (which ``moe_ffn`` looks up at each
    call): append each call's (router logits, gating result) to
    ``record``; with ``replay``, a list of logits from an earlier run in
    the same call order, route on those values while the gradient flows
    through this run's own logits (straight through)."""
    real = moe_ops.top_k_gating
    calls = None if replay is None else iter(replay)

    def gating(logits, **kw):
        if calls is not None:
            ref = next(calls)
            logits = logits + (ref - logits).detach()
        out = real(logits, **kw)
        if record is not None:
            record.append((logits.detach().clone(), out))
        return out

    moe_ops.top_k_gating = gating
    try:
        yield
    finally:
        moe_ops.top_k_gating = real


def moe_flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs per token of the MoE model as ``llama.flops_per_token``
    counts the dense one: 6 x the active non-embedding parameters plus the
    attention term; the dense dispatch and combine einsums are not in it."""
    from ray_tpu_torch.models import moe_llama

    n = moe_llama.active_param_count(cfg) - cfg.vocab_size * cfg.dim
    return 6.0 * n + 12 * cfg.n_layers * cfg.dim * seq_len


def timed_steps(step, state, batch, n_steps):
    """A warm-up step, then ``n_steps`` timed ones (host clock, ending in a
    synchronize) -> (state, metrics of every step, seconds per timed step)."""
    state, m = step(state, batch)
    metrics = [m]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, (time.perf_counter() - t0) / n_steps


def optimizer_share(label, loss_fn, opt, state, batch):
    """One more train step, not profiled, with CUDA events around the
    optimizer update: prints the update's time and its share of the step's
    wall time, returns the new state."""
    from ray_tpu_torch import parallel

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_update(grads, opt_state, prm):
        marks[0].record()
        out = opt.update(grads, opt_state, prm)
        marks[1].record()
        return out

    step = parallel.make_train_step(
        loss_fn, parallel.Optimizer(opt.init, timed_update, opt.learning_rate))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms, opt_ms = (time.perf_counter() - t0) * 1e3, marks[0].elapsed_time(marks[1])
    print(f"{label} optimizer (global norm + update): {opt_ms:.2f} ms between CUDA events "
          f"of a {step_ms:.2f} ms step ({opt_ms / step_ms:.1%})")
    return state


# The largest leaf of the benchmark's Mistral-7B cells: w_gate (and w_up,
# w_down), 16 layers stacked, 939,524,096 f32 elements.
ADAMW_SHAPE = (16, 4096, 14336)


def adamw_phase(dev, gen, peak_flops: float, peak_bw: float) -> dict:
    """The one-pass AdamW kernel (``ops/cuda_adamw.py``) on one f32 leaf of
    ``ADAMW_SHAPE``: two updates, the clip engaged and then not, bit-equal
    to the plain loop of ops on a copy; then the kernel's time beside its
    bound (g, p, mu and nu read and p, mu and nu written: 28 B an element),
    the plain loop's and ``torch._fused_adamw_``'s over the same four
    tensors (AdamW without the clip: a library yardstick the port never
    calls). The global norm, a reduction before the pass, is not timed.
    Returns the kernel's record."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.ops import cuda_adamw

    def hp(count):
        bc1 = 1.0 - float(torch.tensor(0.9, dtype=torch.float32) ** count)
        bc2 = 1.0 - float(torch.tensor(0.95, dtype=torch.float32) ** count)
        return cuda_adamw.AdamWStep(1.0, 0.9, 0.95, 1e-8, 0.1, 3e-4, bc1, bc2)

    n = math.prod(ADAMW_SHAPE)
    p = torch.randn(ADAMW_SHAPE, generator=gen, device=dev).mul_(0.02)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    ref = [[t.clone()] for t in (p, mu, nu)]
    max_abs_err = 0.0
    for count, scale in ((1, 1e-3), (2, 1e-6)):      # norms ~31 (clipped) and ~0.03
        g = torch.randn(ADAMW_SHAPE, generator=gen, device=dev).mul_(scale)
        gnorm = parallel.global_norm([g])
        cuda_adamw.adamw_update([g], [p], [mu], [nu], gnorm, hp(count))
        cuda_adamw.adamw_update_plain([g], *ref, gnorm, hp(count))
        errs = [(a - b[0]).abs().max().item() for a, b in zip((p, mu, nu), ref)]
        max_abs_err = max(max_abs_err, *errs)
        same = [torch.equal(a, b[0]) for a, b in zip((p, mu, nu), ref)]
        fail_unless(all(same), f"fused_adamw: update {count} (norm {gnorm.item():.4g}) not "
                               f"bit-equal to the plain loop (p, mu, nu: {same}; max abs "
                               f"differences {errs})")
    del ref
    torch.cuda.empty_cache()
    step = hp(3)
    ms = time_ms(lambda: cuda_adamw.adamw_update([g], [p], [mu], [nu], gnorm, step), 20)
    plain_ms = time_ms(lambda: cuda_adamw.adamw_update_plain([g], [p], [mu], [nu], gnorm, step),
                       5, warmup=1)
    steps = [torch.tensor(3.0, device=dev)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        [p], [g], [mu], [nu], [], steps, lr=3e-4, beta1=0.9, beta2=0.95, weight_decay=0.1,
        eps=1e-8, amsgrad=False, maximize=False), 20)
    b_ms, b_by = bound(20.0 * n, 28.0 * n, peak_flops, peak_bw)
    print(f"kernel fused_adamw [w_gate leaf {'x'.join(map(str, ADAMW_SHAPE))}, {n} f32]: "
          f"bit-equal to the plain loop over 2 updates (clipped, unclipped; max abs difference "
          f"{max_abs_err!r}); {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch._fused_adamw_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}, 28 B an element) -> {b_ms / ms:.1%} of bound; "
          f"{28.0 * n / ms / 1e9:.3f} TB/s")
    del p, mu, nu, g
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def _worker_pids() -> list:
    """Pids of the port's runtime workers on this machine."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{d}/stat") as f:
                zombie = f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except OSError:
            continue
        if b"ray_tpu_torch._private.worker_process" in cmd and not zombie:
            pids.append(int(d))
    return pids


def bench_inputs(cfg):
    """The runtime phase's inputs: the 8 x 2049 token batch (CPU, from a
    generator seeded 1) and the 8 prompts (numpy seeded 7)."""
    tokens = torch.randint(0, cfg.vocab_size, (8, 2049), generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 601, 8)]
    return tokens, prompts


def runtime_phase(cfg, dev, smi: str, kernel_names) -> dict:
    """The runtime phase: ``LLAMA_BENCH`` scored and served by a
    ``LlamaActor`` that the port's runtime pins to the card, inside the
    placement group of ``LLMConfig.placement_bundles()``; a CUDA tensor
    through the object store; the runtime's own costs. Returns the actor's
    launch counts per main path ({"runtime_scoring": {...},
    "runtime_serving": {...}}), read in the actor's process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import GenRequest, LLMConfig, LlamaActor, LlamaEngine
    from ray_tpu_torch.llm._internal.actor import param_digest
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy, placement_group,
                                    remove_placement_group)

    def tag(line):
        print(f"runtime [{smi}]: {line}")

    rt.init(num_cpus=2)
    gpus = rt.cluster_resources().get("GPU", 0)
    fail_unless(gpus == 1, f"runtime: detected {gpus} GPUs, want 1")
    llm_cfg = LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=1024,
                        engine_kwargs={"prefill_chunk": 256})
    bundles, strategy = llm_cfg.placement_bundles()
    fail_unless((bundles, strategy) == ([{"GPU": 1.0, "CPU": 1.0}], "PACK"),
                f"runtime: placement_bundles() gave {bundles}, {strategy}")
    pg = placement_group(bundles, strategy=strategy)
    fail_unless(pg.wait(60), "runtime: placement group not ready within 60 s")
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(LlamaActor).options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)).remote(llm_cfg)
    info = rt.get(actor.info.remote(), timeout=300)  # placed and built, or GetTimeoutError
    start_s = time.perf_counter() - t0
    props = torch.cuda.get_device_properties(dev)
    tag(f"actor pid {info['pid']} in the {strategy} group of {bundles} after {start_s:.2f} s: "
        f"CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']!r}, sees "
        f"{info['device_count']} card(s), {info.get('name')} {info.get('uuid')}; the driver's "
        f"card {props.name} {props.uuid}")
    fail_unless(info["device_count"] == 1, f"runtime: the actor sees {info['device_count']} cards")
    fail_unless(info.get("uuid") == str(props.uuid) and info.get("name") == props.name,
                "runtime: the actor's card is not the driver's")

    # the same weights in both processes, from the same fresh seeded generator
    params = llm_cfg.load_params(dev)
    mine = param_digest(params)
    theirs = rt.get(actor.param_digest.remote(), timeout=300)
    tag(f"parameter digest: driver {mine[:16]}, actor {theirs[:16]}")
    fail_unless(mine == theirs, "runtime: the actor's parameters differ from the driver's")

    # scoring: the batch goes through the object store as a CPU tensor
    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    tokens, prompts = bench_inputs(cfg)
    tok_ref = rt.put(tokens)
    rt.get(actor.reset_launches.remote(), timeout=60)
    loss_actor = rt.get(actor.score.remote(tok_ref), timeout=300)
    counted = {"runtime_scoring": rt.get(actor.launches.remote(), timeout=60)}
    on_dev = tokens.to(dev)
    with torch.inference_mode():
        loss_here = llama.loss_fn(params, {"tokens": on_dev}, fast).item()
    want = dict.fromkeys(kernel_names, 0)
    want.update(flash_attention_fwd=cfg.n_layers, fused_ce_fwd=1)
    fail_unless(counted["runtime_scoring"] == want,
                f"runtime scoring launched {counted['runtime_scoring']}, want {want}")
    err = abs(loss_actor - loss_here) / abs(loss_here)
    tag(f"scoring (8x2048 through the object store): actor loss {loss_actor!r}, in-process "
        f"{loss_here!r}, relative {err:.3e}, bit-equal {loss_actor == loss_here}; launches in "
        f"the actor {counted['runtime_scoring']}")
    fail_unless(err <= LOSS_RTOL, f"runtime: scoring loss relative err {err} > {LOSS_RTOL}")
    actor_ms, here_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        rt.get(actor.score.remote(tok_ref), timeout=300)
        actor_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            llama.loss_fn(params, {"tokens": tokens.to(dev)}, fast).item()
        here_ms.append((time.perf_counter() - t0) * 1e3)
    a_ms, h_ms = statistics.median(actor_ms), statistics.median(here_ms)
    nvcc_s = rt.get(actor.kernel_build_seconds.remote(), timeout=60)
    tag(f"scoring time (median of 3): actor call {a_ms:.2f} ms, in-process {h_ms:.2f} ms "
        f"(tokens from the host each time), runtime cost {a_ms - h_ms:.2f} ms; the actor "
        + ("loaded the kernel library the driver built" if nvcc_s == 0.0
           else f"built the kernel library itself in {nvcc_s:.2f} s"))

    # serving: 8 greedy requests in the actor and in an in-process engine

    def requests():
        return [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
                for i, p in enumerate(prompts)]

    rt.get(actor.reset_launches.remote(), timeout=60)
    t0 = time.perf_counter()
    served = rt.get(actor.generate.remote(requests()), timeout=600)
    serve_s = [time.perf_counter() - t0]
    counted["runtime_serving"] = rt.get(actor.launches.remote(), timeout=60)
    t0 = time.perf_counter()
    rt.get(actor.generate.remote(requests()), timeout=600)  # warm: the decode shapes ran
    serve_s.append(time.perf_counter() - t0)
    eng = LlamaEngine(cfg, params, max_batch=8, max_seq=1024, prefill_chunk=256, device=dev)
    local_s = []
    for _ in range(2):
        local = requests()
        pending = list(local)
        t0 = time.perf_counter()
        while pending or eng.num_active():
            while pending and eng.has_capacity():
                eng.add_request(pending.pop(0))
            eng.step()
        local_s.append(time.perf_counter() - t0)
    same = sum(served[r.request_id] == r.generated for r in local)
    tag(f"serving: 8 greedy requests, 32 new tokens each: actor {serve_s[0]:.3f} s (first, "
        f"counted) and {serve_s[1]:.3f} s (again), in-process engine {local_s[0]:.3f} s and "
        f"{local_s[1]:.3f} s; {same} of 8 token lists equal; launches in the actor "
        f"{counted['runtime_serving']}")
    fail_unless(same == 8, f"runtime: {8 - same} of 8 served token lists differ")
    fail_unless(counted["runtime_serving"] == dict.fromkeys(kernel_names, 0),
                f"runtime serving launched {counted['runtime_serving']}")
    del eng, local, params, on_dev
    rt.kill(actor)
    remove_placement_group(pg)

    # a CUDA tensor through the object store: to a GPU actor and back, and
    # refused by a task that has no GPU
    @rt.remote(num_gpus=1)
    class Probe:
        def take(self, t):
            return str(t.device), t

        def ping(self):
            return None

        def fetch(self, refs):
            t0 = time.perf_counter()
            t = rt.get(refs[0], timeout=120)
            return time.perf_counter() - t0, t.shape

    @rt.remote(num_gpus=0)
    def fetch_without_gpu(refs):
        import os as _os

        try:
            rt.get(refs[0], timeout=120)
        except RuntimeError as e:
            return _os.environ.get("CUDA_VISIBLE_DEVICES"), str(e)
        return _os.environ.get("CUDA_VISIBLE_DEVICES"), None

    @rt.remote
    def noop():
        return None

    probe = Probe.remote()
    x = torch.randn(1024, 1024, device=dev).to(torch.bfloat16)
    x_ref = rt.put(x)
    where, back = rt.get(probe.take.remote(x_ref), timeout=300)
    visible, refused = rt.get(fetch_without_gpu.remote([x_ref]), timeout=300)
    tag(f"CUDA tensor: put from {x.device}, arrived on {where} in the GPU actor, came back on "
        f"{back.device} equal {torch.equal(back, x)}; a num_gpus=0 task "
        f"(CUDA_VISIBLE_DEVICES={visible!r}) raised: {refused}")
    fail_unless(where == "cuda:0" and back.device == dev and torch.equal(back, x),
                "runtime: the CUDA tensor did not round-trip through the GPU actor")
    fail_unless(refused is not None and "CUDA tensor" in refused,
                "runtime: get of a CUDA tensor in a task without a GPU did not raise")

    # the runtime's own costs
    rt.get([noop.remote() for _ in range(8)], timeout=120)
    rtt = []
    for _ in range(200):
        t0 = time.perf_counter()
        rt.get(noop.remote(), timeout=60)
        rtt.append((time.perf_counter() - t0) * 1e3)
    art = []
    for _ in range(200):
        t0 = time.perf_counter()
        rt.get(probe.ping.remote(), timeout=60)
        art.append((time.perf_counter() - t0) * 1e3)
    big = torch.randn(128 * 2**20 // 128, 128).to(torch.bfloat16)  # 256 MiB
    gib = big.numel() * 2 / 2**30
    put_s, get_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        big_ref = rt.put(big)
        put_s.append(time.perf_counter() - t0)
        dt, shape = rt.get(probe.fetch.remote([big_ref]), timeout=300)
        fail_unless(tuple(shape) == tuple(big.shape), f"runtime: got a tensor of {shape}")
        get_s.append(dt)
        del big_ref
    # the same bytes as a numpy array, which a getter maps without a copy
    # (read-only, as in the reference); a tensor is copied out of the segment
    arr = big.view(torch.uint8).numpy()
    np_put, np_get = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        arr_ref = rt.put(arr)
        np_put.append(time.perf_counter() - t0)
        np_get.append(rt.get(probe.fetch.remote([arr_ref]), timeout=300)[0])
        del arr_ref
    shm = os.statvfs("/dev/shm")
    tag(f"task round trip {statistics.median(rtt):.3f} ms, actor call round trip "
        f"{statistics.median(art):.3f} ms (medians of 200); put {gib / statistics.median(put_s):.2f}"
        f" GiB/s, get in another process {gib / statistics.median(get_s):.2f} GiB/s (256 MiB bf16 "
        f"CPU tensor, medians of 3; the same bytes as a numpy array: put "
        f"{gib / statistics.median(np_put):.2f}, get {gib / statistics.median(np_get):.2f} GiB/s);"
        f" /dev/shm {shm.f_blocks * shm.f_frsize / 2**30:.1f} GiB, "
        f"{shm.f_bavail * shm.f_frsize / 2**30:.1f} GiB free")

    pids = _worker_pids()
    rt.shutdown()
    deadline = time.time() + 30
    while _worker_pids() and time.time() < deadline:
        time.sleep(0.1)
    left = _worker_pids()
    tag(f"shutdown: {len(pids)} worker processes before, {len(left)} left")
    fail_unless(not left, f"runtime: worker processes left after shutdown: {left}")
    return counted


# The trainer phase: steps, the step whose state is checkpointed, and the
# step before which the first attempt fails on purpose.
TRAINER_STEPS, TRAINER_CHECKPOINT_AT, TRAINER_FAIL_AT = 4, 2, 3


def trainer_setup(cfg, dev, lr: float = 1e-4):
    """(train state, train step) of the trainer and tune phases, the same
    in the driver and in the gang's worker or the trial's: ``cfg``
    (LLAMA_BENCH, bf16 parameters) with remat, flash attention and the
    fused CE, parameters from a fresh generator seeded 0 (as
    ``LLMConfig.load_params``), and ``default_optimizer(lr,
    warmup_steps=10, total_steps=1000)``."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import llama

    tcfg = dataclasses.replace(cfg, remat=True, attention_impl="flash", ce_impl="fused")
    opt = parallel.default_optimizer(lr, warmup_steps=10, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = parallel.create_train_state(gen, lambda g: llama.init_params(g, tcfg, dev), opt, dev)
    return state, parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, tcfg), opt)


def _running(pids) -> list:
    """Those of ``pids`` whose process still runs (not gone, not a zombie)."""
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.append(pid)
        except OSError:
            pass
    return out


def trainer_loop(config):
    """The train loop of the trainer and tune phases, run by the gang's
    worker or the trial's actor, at learning rate ``config.get("lr",
    1e-4)``.

    Each step zeroes the eight launch counters of this process, runs the
    train step and reports its loss, grad norm, host-clock ms (ending in a
    synchronize) and the counts. After step ``checkpoint_at`` it reports
    ``Checkpoint.from_torch(state)``; on the first attempt only (no marker
    file yet) it raises before step ``fail_at``. A restarted worker resumes
    from ``get_checkpoint()``. Events with their wall-clock times go to
    ``config["log"]``, one JSON object a line: the start (with the card
    this process sees and which processes of earlier starts still run),
    each step, a checkpoint, a failure and a resume."""
    import json
    import os
    import shutil
    import tempfile

    from ray_tpu_torch import train
    from ray_tpu_torch._native import build

    def note(**event):
        with open(config["log"], "a") as f:
            f.write(json.dumps(event) + "\n")

    dev = torch.device("cuda", 0)
    first = not os.path.exists(config["marker"])
    props = torch.cuda.get_device_properties(dev)
    earlier = []
    if os.path.exists(config["log"]):
        with open(config["log"]) as f:
            earlier = [e["pid"] for e in map(json.loads, f) if e["event"] == "start"]
    note(event="start", attempt=1 if first else 2, t=time.time(), pid=os.getpid(),
         visible=os.environ.get("CUDA_VISIBLE_DEVICES"), count=torch.cuda.device_count(),
         name=props.name, uuid=str(props.uuid), lr=config.get("lr", 1e-4),
         free_gib=torch.cuda.mem_get_info(dev)[0] / 2**30, earlier_running=_running(earlier))
    state, step = trainer_setup(config["cfg"], dev, config.get("lr", 1e-4))
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = ckpt.to_torch(target=state, device=dev)
        torch.cuda.synchronize()
        note(event="resumed", t=time.time(), load_s=time.perf_counter() - t0,
             from_step=state.step, path=ckpt.path)
    wrappers = _kernel_wrappers(config["kernel_names"])
    batch = {"tokens": config["tokens"].to(dev)}
    for i in range(state.step, config["steps"]):
        if first and i + 1 == config["fail_at"]:
            open(config["marker"], "w").close()
            note(event="fail", t=time.time(), before_step=i + 1)
            raise RuntimeError(f"planned failure before step {i + 1}")
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        metrics = {"step": m["step"], "loss": m["loss"].item(),
                   "grad_norm": m["grad_norm"].item(), "step_ms": ms,
                   "launches": {n: w.launches for n, w in wrappers.items()},
                   "pid": os.getpid(), "nvcc_s": build.build_seconds}
        note(event="step", t=time.time(), **metrics)
        if m["step"] != config["checkpoint_at"]:
            train.report(metrics)
            continue
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(dir=config["scratch"])
        ckpt = train.Checkpoint.from_torch(state, path=tmp)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=ckpt)  # commits: a copytree into run storage
        commit_s = time.perf_counter() - t0
        shutil.rmtree(tmp)
        note(event="checkpoint", step=m["step"], bytes=nbytes, save_s=save_s,
             commit_s=commit_s)


def _n_leaves(tree) -> int:
    """The leaves of a nested dict (a parameter tree or its specs)."""
    return sum(map(_n_leaves, tree.values())) if isinstance(tree, dict) else 1


def llama_leaves(cfg) -> int:
    """The parameter leaves of a llama ``cfg``: one AdamW launch each an
    update (on a mesh, on each rank's shard)."""
    from ray_tpu_torch.models import llama

    return _n_leaves(llama.param_specs(cfg))


def train_step_counts(cfg, tokens) -> dict:
    """The launches of one training step of ``cfg`` with remat on a (B, S+1)
    token batch: the flash forward twice a layer, each attention backward
    kernel once a layer, the CE forward once, each CE backward kernel once
    a chunk of rows (``cuda_ce.chunk_rows``: a 256 MiB bf16 dlog budget),
    the AdamW kernel once a parameter leaf."""
    n_rows = tokens.shape[0] * (tokens.shape[1] - 1)
    ce_chunks = -(-n_rows // (256 * 2**20 // (cfg.vocab_size * 2) // 128 * 128))
    return {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd_dkv": cfg.n_layers,
            "flash_attention_bwd_dq": cfg.n_layers, "fused_ce_fwd": 1,
            "fused_ce_bwd_dlog": ce_chunks, "fused_ce_bwd_dx": ce_chunks,
            "fused_ce_bwd_dw": ce_chunks, "fused_adamw": llama_leaves(cfg)}


def trainer_phase(cfg, dev, smi: str, kernel_names, export_dir: str) -> tuple:
    """The trainer phase: ``LLAMA_BENCH`` trained by a one-GPU
    ``TorchTrainer`` gang that checkpoints, fails once on purpose, is
    restarted by ``FailureConfig`` and resumes from the checkpoint; every
    step's loss is held against the same steps run in this process first.
    Returns the worker's launch counts summed over the steps
    ({"trainer": {...}}), each step's counted in the worker, and the
    trained parameters handed to the train_to_serve phase
    (``export_trained_params`` of the kept checkpoint into ``export_dir``,
    done before the run storage is removed, with the loss that the
    resumed worker reported for the step after it, and the batch)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    def tag(line):
        print(f"trainer [{smi}]: {line}")

    tokens, _ = bench_inputs(cfg)
    state, step = trainer_setup(cfg, dev)
    batch = {"tokens": tokens.to(dev)}
    here, here_ms = [], []
    for _ in range(TRAINER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        here.append(m["loss"].item())
        torch.cuda.synchronize()
        here_ms.append((time.perf_counter() - t0) * 1e3)
    del state, step, batch, m
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    fs = os.statvfs(root)
    tag(f"storage {root}: {fs.f_bavail * fs.f_frsize / 2**30:.1f} GiB free")
    config = {"cfg": cfg, "tokens": tokens, "steps": TRAINER_STEPS,
              "checkpoint_at": TRAINER_CHECKPOINT_AT, "fail_at": TRAINER_FAIL_AT,
              "kernel_names": list(kernel_names), "log": os.path.join(root, "events.jsonl"),
              "marker": os.path.join(root, "failed_once"), "scratch": os.path.join(root, "tmp")}
    os.makedirs(config["scratch"])

    class Collect:
        def __init__(self):
            self.rows = []

        def on_result(self, metrics):
            self.rows.append(metrics)

    collect = Collect()
    rt.init(num_cpus=2)
    try:
        trainer = train.TorchTrainer(
            trainer_loop, train_loop_config=config,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(
                name="llama_bench", storage_path=os.path.join(root, "runs"), callbacks=[collect],
                failure_config=train.FailureConfig(max_failures=1),
                checkpoint_config=train.CheckpointConfig(num_to_keep=1)))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        pids = _worker_pids()
    finally:
        rt.shutdown()
    deadline = time.time() + 30
    while _worker_pids() and time.time() < deadline:
        time.sleep(0.1)
    left = _worker_pids()
    try:
        with open(config["log"]) as f:
            events = [json.loads(line) for line in f]
        run_dir = os.path.join(root, "runs", "llama_bench")
        kept = sorted(d for d in os.listdir(run_dir) if d.startswith("checkpoint_"))
        fail_unless(result.checkpoint is not None, "trainer: fit() returned no checkpoint")
        handoff = export_trained_params(result.checkpoint, export_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    fail_unless(result.error is None, f"trainer: fit() ended in error: {result.error}")
    starts = [e for e in events if e["event"] == "start"]
    props = torch.cuda.get_device_properties(dev)
    for e in starts:
        tag(f"attempt {e['attempt']}: worker pid {e['pid']}, CUDA_VISIBLE_DEVICES="
            f"{e['visible']!r}, sees {e['count']} card(s), {e['name']} {e['uuid']}")
    fail_unless([e["attempt"] for e in starts] == [1, 2],
                f"trainer: attempts {[e['attempt'] for e in starts]}, want [1, 2]")
    fail_unless(starts[0]["pid"] != starts[1]["pid"], "trainer: the restart reused the pid")
    for e in starts:
        fail_unless(e["count"] == 1 and e["uuid"] == str(props.uuid),
                    f"trainer: attempt {e['attempt']} saw {e['count']} cards, {e['uuid']}; "
                    f"the driver's card is {props.uuid}")
    (fail,) = [e for e in events if e["event"] == "fail"]
    (saved,) = [e for e in events if e["event"] == "checkpoint"]
    (resumed,) = [e for e in events if e["event"] == "resumed"]
    fail_unless(resumed["from_step"] == TRAINER_CHECKPOINT_AT,
                f"trainer: resumed from step {resumed['from_step']}")
    steps = [r["step"] for r in collect.rows]
    fail_unless(steps == list(range(1, TRAINER_STEPS + 1)), f"trainer: reported steps {steps}")
    fail_unless(result.metrics["training_iteration"] == TRAINER_STEPS,
                f"trainer: training_iteration {result.metrics['training_iteration']}")
    fail_unless(len(kept) == 1 and result.checkpoint is not None
                and os.path.basename(result.checkpoint.path) == kept[0],
                f"trainer: checkpoints kept {kept}, result's {result.checkpoint}")
    fail_unless(not left, f"trainer: worker processes left after shutdown: {left}")
    after = collect.rows[TRAINER_CHECKPOINT_AT]
    fail_unless(handoff["step"] == TRAINER_CHECKPOINT_AT and after["step"] == handoff["step"] + 1
                and after["pid"] == starts[1]["pid"],
                f"trainer: the kept checkpoint is of step {handoff['step']}, the row after it "
                f"step {after['step']} from pid {after['pid']}")
    handoff.update(loss=after["loss"], tokens=tokens)
    losses = [r["loss"] for r in collect.rows]
    gnorms = " ".join(f"{r['grad_norm']:.5f}" for r in collect.rows)
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, here)]
    tag(f"losses, worker: {' '.join(repr(v) for v in losses)}; in-process: "
        f"{' '.join(repr(v) for v in here)}; max relative err {max(errs):.3e}, bit-equal "
        f"{losses == here}; grad norms {gnorms}")
    fail_unless(max(errs) <= TRAIN_LOSS_RTOL,
                f"trainer: loss relative err {max(errs)} > {TRAIN_LOSS_RTOL}")
    want = train_step_counts(cfg, tokens)
    for r in collect.rows:
        fail_unless(r["launches"] == want,
                    f"trainer: step {r['step']} launched {r['launches']}, want {want}")
    counted = {n: sum(r["launches"][n] for r in collect.rows) for n in kernel_names}
    t_attempt1 = starts[0]["t"] - t_fit
    later = [r["step_ms"] for r in collect.rows if r["step"] not in (1, TRAINER_FAIL_AT)]
    tag(f"placement: the first worker started its loop {t_attempt1:.2f} s after fit(); its first "
        f"step {collect.rows[0]['step_ms']:.2f} ms, the restarted worker's first step "
        f"{collect.rows[TRAINER_FAIL_AT - 1]['step_ms']:.2f} ms; kernel library in the worker: "
        + ", ".join("the driver's" if r["nvcc_s"] == 0.0 else f"built in {r['nvcc_s']:.2f} s"
                    for r in (collect.rows[0], collect.rows[TRAINER_FAIL_AT - 1])))
    worker_ms = " ".join(f"{r['step_ms']:.2f}" for r in collect.rows)
    tag(f"step ms, worker: {worker_ms} "
        f"(median of the steps not first in their process {statistics.median(later):.2f}); "
        f"in-process: {' '.join(f'{v:.2f}' for v in here_ms)} (median of steps 2-"
        f"{TRAINER_STEPS} {statistics.median(here_ms[1:]):.2f})")
    tag(f"checkpoint after step {saved['step']}: {saved['bytes']} bytes, from_torch "
        f"{saved['save_s']:.2f} s, report's commit (copytree) {saved['commit_s']:.2f} s; "
        f"restart to resumed {resumed['t'] - fail['t']:.2f} s (of which to_torch "
        f"{resumed['load_s']:.2f} s); kept {kept}")
    tag(f"fit() {fit_s:.2f} s; training_iteration {result.metrics['training_iteration']}; "
        f"launches per step in the worker {want}; {len(pids)} worker processes before "
        f"shutdown, {len(left)} after")
    return {"trainer": counted}, handoff


def export_trained_params(checkpoint, path: str) -> dict:
    """The parameters of the trainer's TrainState checkpoint, copied out of
    its run storage: the state loaded on the host, its ``.params`` kept and
    written with ``Checkpoint.from_torch`` into ``path``. Returns the
    directory, the host parameters, the state's step, the file's bytes and
    the seconds of the state's load and of the save."""
    from ray_tpu_torch import train

    t0 = time.perf_counter()
    state = train.Checkpoint(checkpoint.path).to_torch(device="cpu")
    state_s = time.perf_counter() - t0
    params, step = state["params"], state["step"]
    del state  # the Adam moments: two thirds of the 5.3 GB
    t0 = time.perf_counter()
    train.Checkpoint.from_torch(params, path)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return {"path": path, "params": params, "step": step, "bytes": nbytes, "save_s": save_s,
            "state_s": state_s}


def replica_load_s(replica) -> float:
    """Runs in an ``LLMServer`` replica through ``__ray_call__``: the
    seconds of one more ``load_params`` of its config onto its card, in a
    process whose CUDA context is up, ending in a synchronize."""
    cfg = replica.instance.config
    t0 = time.perf_counter()
    params = cfg.load_params(cfg.engine_kwargs.get("device"))
    torch.cuda.synchronize()
    del params
    return time.perf_counter() - t0


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (bound, released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_json(url: str, body: dict, timeout_s: float) -> dict:
    """The JSON answer to a JSON POST (urllib, standard library only)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return json.loads(r.read())


def train_to_serve_phase(cfg, dev, smi: str, kernel_names, handoff: dict) -> dict:
    """The train_to_serve phase: the trainer phase's parameters, written by
    ``Checkpoint.from_torch`` (``handoff``), loaded back through
    ``LLMConfig(checkpoint_path=dir).load_params()`` on the card and (a)
    scored with flash attention and the fused CE on the trainer's batch
    (every leaf bit-equal to the TrainState's, dtype included; the loss
    within ``TRAIN_LOSS_RTOL`` of the resumed worker's report for the step
    after the checkpoint, whose loss is these parameters' on this batch),
    then (b) served by ``build_llm_app`` behind Serve's HTTP ingress: the
    8 prompts POSTed with urllib, greedy, must get an in-process engine's
    tokens exactly. Returns the launch counts ({"train_to_serve": {...}},
    counted in this process around the scoring, and "train_to_serve_http",
    in the replica's process around the 8 requests)."""
    import threading
    import urllib.error

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.llm import GenRequest, LLMConfig, LlamaEngine, build_llm_app
    from ray_tpu_torch.llm._internal.actor import _kernels
    from ray_tpu_torch.llm.config import _flatten
    from ray_tpu_torch.models import llama

    def tag(line):
        print(f"train_to_serve [{smi}]: {line}")

    t_phase = time.perf_counter()
    wrappers = {n: w for n, w in _kernels().items() if n in kernel_names}
    want_zero = dict.fromkeys(kernel_names, 0)
    counted = {}
    path = handoff["path"]
    # ---- (a) the checkpoint loaded on the card and scored ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = LLMConfig(model_config=cfg, checkpoint_path=path).load_params()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    trained, loaded = _flatten(handoff["params"]), _flatten(params)  # {"blocks/wq": ...}
    fail_unless(list(trained) == list(loaded),
                f"train_to_serve: leaves {list(loaded)}, the TrainState's {list(trained)}")
    unequal = [k for k, t in trained.items()
               if loaded[k].device != dev or loaded[k].dtype != t.dtype
               or not torch.equal(loaded[k].cpu(), t)]
    tag(f"checkpoint of step {handoff['step']}'s parameters: the TrainState loaded on the host "
        f"in {handoff['state_s']:.2f} s; {handoff['bytes']} bytes, "
        f"Checkpoint.from_torch {handoff['save_s']:.2f} s, LLMConfig.load_params onto "
        f"{dev} {load_s:.2f} s; {len(trained) - len(unequal)} of {len(trained)} leaves "
        f"bit-equal to the TrainState's, dtype and card included; unequal {unequal}")
    fail_unless(not unequal, f"train_to_serve: leaves differ from the TrainState's: {unequal}")
    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    batch = {"tokens": handoff["tokens"].to(dev)}
    for w in wrappers.values():
        w.launches = 0
    with torch.inference_mode():
        loss = llama.loss_fn(params, batch, fast).item()
    counted["train_to_serve"] = {n: w.launches for n, w in wrappers.items()}
    err = abs(loss - handoff["loss"]) / abs(handoff["loss"])
    tag(f"score of the trainer's batch: loss {loss!r}, the resumed worker's step "
        f"{handoff['step'] + 1} {handoff['loss']!r}; relative err {err:.3e}, bit-equal "
        f"{loss == handoff['loss']}; launches {counted['train_to_serve']}")
    fail_unless(err <= TRAIN_LOSS_RTOL,
                f"train_to_serve: loss relative err {err} > {TRAIN_LOSS_RTOL}")
    want = dict(want_zero, flash_attention_fwd=cfg.n_layers, fused_ce_fwd=1)
    fail_unless(counted["train_to_serve"] == want,
                f"train_to_serve launched {counted['train_to_serve']}, want {want}")
    del batch

    # ---- (b) served over HTTP from the same directory ----
    _, prompts = bench_inputs(cfg)
    engine_kwargs = {"prefill_chunk": 256}
    llm_cfg = LLMConfig(model_config=cfg, checkpoint_path=path, max_batch_size=8,
                        max_seq_len=1024, engine_kwargs=engine_kwargs)
    eng = LlamaEngine(cfg, params, max_batch=8, max_seq=1024, device=dev, **engine_kwargs)
    local = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
             for i, p in enumerate(prompts)]
    pending = list(local)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    while pending or eng.num_active():
        while pending and eng.has_capacity():
            eng.add_request(pending.pop(0))
        eng.step()
    local_s = time.perf_counter() - t0
    engine_counts = {n: w.launches for n, w in wrappers.items()}
    fail_unless(engine_counts == want_zero,
                f"train_to_serve: the in-process engine launched {engine_counts}")
    del eng

    props = torch.cuda.get_device_properties(dev)
    app = build_llm_app(llm_cfg)
    fail_unless(app.deployment.ray_actor_options == {"num_gpus": 1.0},
                f"train_to_serve: the replica asks for {app.deployment.ray_actor_options}")
    port = _free_port()
    url = f"http://127.0.0.1:{port}/llm"
    rt.init(num_cpus=2)
    try:
        t0 = time.perf_counter()
        serve.run(app, route_prefix="/llm", http_options={"port": port})
        run_s = time.perf_counter() - t0
        first, last, n404 = None, None, 0
        while first is None and time.perf_counter() - t0 < 120:
            try:
                first = _post_json(url, {"prompt_ids": prompts[0], "max_tokens": 1}, 600)
            except urllib.error.HTTPError as e:
                if e.code != 404:  # 404: the proxy's routes refresh ~1 s after serve.run
                    raise
                last, n404 = e, n404 + 1
                time.sleep(0.3)
        fail_unless(first is not None, f"train_to_serve: no HTTP answer: {last!r}")
        first_s = time.perf_counter() - t0
        reps = constructions(worker.get_client(), lambda a: a["resources"].get("GPU", 0) > 0)
        (replica,) = rt.get(rt.get_actor(serve.CONTROLLER_NAME).get_replicas.remote(
            app.deployment.name), timeout=60)
        where = rt.get(replica.__ray_call__.remote(replica_probe, True), timeout=60)
        answers, latency = [None] * 8, [None] * 8

        def post(i):
            t = time.perf_counter()
            answers[i] = _post_json(url, {"prompt_ids": prompts[i], "max_tokens": 32}, 600)
            latency[i] = time.perf_counter() - t

        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(700)
        http_s = time.perf_counter() - t1
        counted["train_to_serve_http"] = rt.get(
            replica.__ray_call__.remote(replica_probe), timeout=60)["launches"]
        warm_load_s = rt.get(replica.__ray_call__.remote(replica_load_s), timeout=300)
        fail_unless(all(a is not None for a in answers),
                    "train_to_serve: an HTTP request did not return")
        same = sum(a == {"token_ids": r.generated, "num_generated": 32}
                   for a, r in zip(answers, local))
        tag(f"serve.run(build_llm_app(...), route_prefix=\"/llm\") {run_s:.2f} s, first "
            f"HTTP answer {first_s:.2f} s after its start ({n404} answers 404 before it); "
            f"replica constructions {len(reps)}, "
            + ", ".join(f"placed after {w:.2f} s, constructor {c:.2f} s" for _, w, c in reps)
            + f" (load_params again in the replica, its CUDA context up: {warm_load_s:.2f} s)"
            + f"; replica pid {where['pid']}, "
            f"num_gpus 1.0, CUDA_VISIBLE_DEVICES={where['visible']!r}, sees "
            f"{where['count']} card(s), {where['name']} {where['uuid']}, engine on "
            f"{where['engine_device']}; the driver's card {props.name} {props.uuid}")
        tag(f"8 concurrent HTTP POSTs (urllib), 32 greedy tokens each, prompts "
            f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens: {http_s:.3f} s for "
            f"all, per request {min(latency):.3f}-{max(latency):.3f} s, {8 * 32 / http_s:.1f} "
            f"tokens/s together; the in-process engine {local_s:.3f} s; {same} of 8 token "
            f"lists equal the in-process engine's; launches in the replica "
            f"{counted['train_to_serve_http']}, in the in-process engine {engine_counts}")
        fail_unless(len(reps) == 1, f"train_to_serve: {len(reps)} replicas were constructed")
        fail_unless(where["count"] == 1 and where["uuid"] == str(props.uuid)
                    and str(where["engine_device"]).startswith("cuda"),
                    "train_to_serve: the replica's engine is not on the driver's card")
        fail_unless(same == 8, f"train_to_serve: {8 - same} of 8 HTTP answers differ: "
                    f"{answers[0]}")
        fail_unless(counted["train_to_serve_http"] == want_zero,
                    f"train_to_serve_http launched {counted['train_to_serve_http']}")
    finally:
        serve.shutdown()
        rt.shutdown()
    deadline = time.time() + 30
    while _worker_pids() and time.time() < deadline:
        time.sleep(0.1)
    left = _worker_pids()
    fail_unless(not left, f"train_to_serve: worker processes left after shutdown: {left}")
    tag(f"phase {time.perf_counter() - t_phase:.1f} s (the trainer phase's export before it: "
        f"{handoff['state_s'] + handoff['save_s']:.1f} s)")
    return counted


def row_losses(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Each row's mean next-token loss of a (B, S+1) token batch, in one
    forward: ``llama.loss_fn``'s fused path without its final mean (with
    ``attention_impl="flash"``, the flash forward once per layer and the
    fused CE forward once)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import cuda_ce

    inputs, targets, _ = llama.unpack_batch({"tokens": tokens})
    B, S = inputs.shape
    x = llama.forward_hidden(params, inputs, cfg)
    nll = cuda_ce.fused_cross_entropy(x.reshape(B * S, cfg.dim), params["lm_head"].to(cfg.dtype),
                                      targets.reshape(B * S))
    return nll.reshape(B, S).mean(dim=1)


def launch_probe(_instance=None, reset: bool = False) -> dict:
    """The kernels' launch counters in the calling process (zeroed after
    reading if ``reset``); runs in an actor through ``__ray_call__``."""
    from ray_tpu_torch.llm._internal.actor import _kernels

    counts = {name: w.launches for name, w in _kernels().items()}
    if reset:
        for w in _kernels().values():
            w.launches = 0
    return counts


def card_of() -> dict:
    """This process's pid and CUDA_VISIBLE_DEVICES, how many cards it
    sees, and the first one's name and UUID (None without a card)."""
    props = torch.cuda.get_device_properties(0) if torch.cuda.is_available() else None
    return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "count": torch.cuda.device_count() if props is not None else 0,
            "name": props.name if props is not None else None,
            "uuid": str(props.uuid) if props is not None else None}


def process_probe(server, reset: bool = False) -> dict:
    """Runs in a Serve replica's process, on its user object: the
    process, the card it sees, where the object's engine runs, and the
    kernels' launch counters (zeroed after reading if ``reset``)."""
    engine = getattr(server, "engine", None)
    return {**card_of(), "engine_device": str(engine.device) if engine is not None else None,
            "launches": launch_probe(reset=reset)}


def replica_probe(replica, reset: bool = False) -> dict:
    """``process_probe`` through ``__ray_call__`` on a replica's actor."""
    return process_probe(replica.instance, reset)


def constructions(client, keep) -> list:
    """(actor id, seconds its creation waited to be placed, seconds its
    constructor took) of each actor row that ``keep`` selects, from the
    hub's actor table and task events (an actor's creation task has its
    id). Every replica a controller starts is one such actor."""
    events = {e["task_id"]: e for e in client.list_state("tasks")}
    out = []
    for a in client.list_state("actors"):
        if keep(a):
            e = events.get(a["actor_id"], {})
            out.append((a["actor_id"],
                        e.get("started_at", math.nan) - e.get("submitted_at", math.nan),
                        e.get("finished_at", math.nan) - e.get("started_at", math.nan)))
    return out


def serve_phase(cfg, dev, smi: str, kernel_names, adapter_path: str) -> dict:
    """The serve phase: ``LLAMA_BENCH`` scored by a ``@serve.batch``
    deployment and served by ``build_openai_app``, each in a Serve replica
    that the port's runtime pins to the card. Returns the replicas'
    launch counts per main path ({"serve_scoring": {...}, "serve_llm":
    {...}}), read in the replica's process."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.llm import (GenRequest, LLMConfig, LlamaEngine, apply_lora,
                                   build_openai_app, load_lora_adapter)
    from ray_tpu_torch.llm._internal.actor import param_digest

    def tag(line):
        print(f"serve [{smi}]: {line}")

    props = torch.cuda.get_device_properties(dev) if dev.type == "cuda" else None
    want_zero = dict.fromkeys(kernel_names, 0)
    counted = {}

    def gpu_replicas():
        return constructions(client, lambda a: a["resources"].get("GPU", 0) > 0)

    rt.init(num_cpus=2)
    client = worker.get_client()
    try:
        gpus = rt.cluster_resources().get("GPU", 0)
        fail_unless(gpus == 1, f"serve: detected {gpus} GPUs, want 1")

        # ---- (a) serve_scoring: @serve.batch through K1 and K4 ----
        @serve.deployment(name="scorer", max_ongoing_requests=8,
                          ray_actor_options={"num_gpus": 1})
        class Scorer:
            """LLAMA_BENCH on the replica's card (a fresh generator seeded
            0); each request is one (S+1,) token row, and a batch of up to
            8 is scored in one forward."""

            def __init__(self, cfg, device):
                from ray_tpu_torch.llm import LLMConfig

                self.params = LLMConfig(model_config=cfg).load_params(device)
                self.dev = self.params["embed"].device
                self.cfg = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
                self.batches = []

            def info(self, reset=False):
                return process_probe(self, reset)

            def digest(self):
                from ray_tpu_torch.llm._internal.actor import param_digest

                return param_digest(self.params)

            def batch_sizes(self):
                return list(self.batches)

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=2.0)
            async def __call__(self, rows):
                self.batches.append(len(rows))
                with torch.inference_mode():
                    losses = row_losses(self.params, torch.stack(rows).to(self.dev), self.cfg)
                    return [(v, os.getpid()) for v in losses.tolist()]

        device = None if dev.type == "cuda" else "cpu"  # None: the GPU
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        handle = serve.run(Scorer.bind(cfg, device))
        run_s = time.perf_counter() - t0
        info = handle.info.remote().result(timeout_s=600)
        first_s = time.perf_counter() - t0
        reps = gpu_replicas()
        ((_, *ctrl),) = constructions(client, lambda a: a["name"] == serve.CONTROLLER_NAME)
        tag(f"serve_scoring: serve.run returned after {run_s:.2f} s (the controller waited "
            f"{ctrl[0]:.2f} s for a worker, its constructor {ctrl[1]:.2f} s), first answer after "
            f"{first_s:.2f} s; replica constructions {len(reps)}, constructor "
            + ", ".join(f"{c:.2f} s (placed after {w:.2f} s)" for _, w, c in reps)
            + f"; replica pid {info['pid']}, CUDA_VISIBLE_DEVICES={info['visible']!r}, sees "
            f"{info['count']} card(s), {info['name']} {info['uuid']}; the driver's card "
            f"{props.name if props else None} {props.uuid if props else None}")
        fail_unless(len(reps) == 1, f"serve_scoring: {len(reps)} replicas were constructed")
        fail_unless(info["count"] == 1 and props is not None and info["uuid"] == str(props.uuid),
                    "serve_scoring: the replica's card is not the driver's")
        params = LLMConfig(model_config=cfg).load_params(dev)
        mine, theirs = param_digest(params), handle.digest.remote().result(timeout_s=300)
        tag(f"parameter digest: driver {mine[:16]}, replica {theirs[:16]}")
        fail_unless(mine == theirs, "serve_scoring: the replica's parameters differ")

        fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
        tokens, prompts = bench_inputs(cfg)

        def score_batch():
            resps = [handle.remote(tokens[i]) for i in range(8)]
            return [r.result(timeout_s=300) for r in resps]

        handle.info.remote(True).result(timeout_s=60)  # launch counters to 0
        served = score_batch()
        counted["serve_scoring"] = handle.info.remote().result(timeout_s=60)["launches"]
        sizes = handle.batch_sizes.remote().result(timeout_s=60)
        with torch.inference_mode():
            here = row_losses(params, tokens.to(dev), fast).tolist()
        got = [v for v, _ in served]
        errs = [abs(a - b) / abs(b) for a, b in zip(got, here)]
        tag(f"serve_scoring: 8 concurrent handle calls, one 2049-token row each: batches "
            f"{sizes}, pids {sorted({p for _, p in served})}; per-request losses "
            f"{' '.join(repr(v) for v in got)}; driver's rows {' '.join(repr(v) for v in here)}; "
            f"max relative err {max(errs):.3e}, bit-equal {got == here}; launches in the "
            f"replica {counted['serve_scoring']}")
        want = dict(want_zero, flash_attention_fwd=cfg.n_layers, fused_ce_fwd=1)
        fail_unless(counted["serve_scoring"] == want,
                    f"serve_scoring launched {counted['serve_scoring']}, want {want}")
        fail_unless(sizes == [8], f"serve_scoring: the replica saw batches {sizes}, want [8]")
        fail_unless({p for _, p in served} == {info["pid"]},
                    "serve_scoring: a request was answered by another process")
        fail_unless(max(errs) <= LOSS_RTOL,
                    f"serve_scoring: loss relative err {max(errs)} > {LOSS_RTOL}")
        handle_ms, here_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            score_batch()
            handle_ms.append((time.perf_counter() - t0) * 1e3)
            sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                row_losses(params, tokens.to(dev), fast).tolist()
            here_ms.append((time.perf_counter() - t0) * 1e3)
        sizes = handle.batch_sizes.remote().result(timeout_s=60)
        noop_ms = []
        for _ in range(3):  # the same 8 calls' Serve path around a method that does nothing
            t0 = time.perf_counter()
            [r.result(timeout_s=60) for r in [handle.batch_sizes.remote() for _ in range(8)]]
            noop_ms.append((time.perf_counter() - t0) * 1e3)
        h_ms, d_ms = statistics.median(handle_ms), statistics.median(here_ms)
        tag(f"serve_scoring time (median of 3 batches of 8): handle {h_ms:.2f} ms, in-process "
            f"{d_ms:.2f} ms (tokens from the host each time), Serve's cost {h_ms - d_ms:.2f} ms; "
            f"8 concurrent calls of a method that does nothing {statistics.median(noop_ms):.2f} "
            f"ms (median of 3); batches {sizes}")
        fail_unless(sizes == [8] * 4, f"serve_scoring: the replica saw batches {sizes}")
        fail_unless(len(gpu_replicas()) == 1, "serve_scoring: the replica was constructed again")
        serve.delete("scorer")
        deadline = time.time() + 60
        while rt.available_resources().get("GPU", 0) < 1 and time.time() < deadline:
            time.sleep(0.1)
        fail_unless(rt.available_resources().get("GPU", 0) == 1,
                    "serve_scoring: the card did not return to the pool after serve.delete")

        # ---- (b) serve_llm: the OpenAI app, streaming, a LoRA adapter ----
        adapter_dir = os.path.dirname(adapter_path)
        adapter_id = os.path.basename(adapter_path)[:-len(".npz")]
        engine_kwargs = {"prefill_chunk": 256}
        if device is not None:
            engine_kwargs["device"] = device
        local_kwargs = dict(engine_kwargs, device=dev)  # the in-process engines
        llm_cfg = LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=1024,
                            engine_kwargs=engine_kwargs,
                            lora_config={"dynamic_lora_loading_path": adapter_dir,
                                         "max_adapters_per_replica": 2})
        app = build_openai_app(llm_cfg)
        fail_unless(app.deployment.ray_actor_options == {"num_gpus": 1.0},
                    f"serve_llm: the replica asks for {app.deployment.ray_actor_options}")
        before = {r[0] for r in gpu_replicas()}
        t0 = time.perf_counter()
        handle = serve.run(app)
        run_s = time.perf_counter() - t0
        stats = handle.engine_stats.remote().result(timeout_s=600)
        first_s = time.perf_counter() - t0
        reps = [r for r in gpu_replicas() if r[0] not in before]
        (replica,) = rt.get(rt.get_actor(serve.CONTROLLER_NAME).get_replicas.remote(
            app.deployment.name), timeout=60)
        where = rt.get(replica.__ray_call__.remote(replica_probe, True), timeout=60)
        tag(f"serve_llm: serve.run returned after {run_s:.2f} s, first answer (engine_stats "
            f"{stats}) after {first_s:.2f} s; replica constructions {len(reps)}, constructor "
            + ", ".join(f"{c:.2f} s (placed after {w:.2f} s)" for _, w, c in reps)
            + f"; replica pid {where['pid']}, CUDA_VISIBLE_DEVICES={where['visible']!r}, sees "
            f"{where['count']} card(s), {where['name']} {where['uuid']}, engine on "
            f"{where['engine_device']}")
        fail_unless(len(reps) == 1, f"serve_llm: {len(reps)} replicas were constructed")
        fail_unless(where["count"] == 1 and props is not None and where["uuid"] == str(props.uuid),
                    "serve_llm: the replica's card is not the driver's")


        def complete_all():
            """8 concurrent completions, one thread each: (seconds for all,
            each request's seconds, the answers)."""
            answers, latency = [None] * 8, [None] * 8

            def complete(i):
                t = time.perf_counter()
                answers[i] = handle.remote({"prompt": prompts[i], "max_tokens": 32}).result(
                    timeout_s=600)
                latency[i] = time.perf_counter() - t

            t0 = time.perf_counter()
            threads = [threading.Thread(target=complete, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(700)
            fail_unless(all(a is not None for a in answers),
                        "serve_llm: a completion did not return")
            return time.perf_counter() - t0, latency, answers

        batch_s, latency, answers = complete_all()
        counted["serve_llm"] = rt.get(replica.__ray_call__.remote(replica_probe), timeout=60)[
            "launches"]
        batch2_s, latency2, answers2 = complete_all()  # again: the decode shapes ran

        t0 = time.perf_counter()
        stream, ttft = [], None
        for tok in handle.options(method_name="generate_stream", stream=True).remote(
                prompts[0], 32):
            ttft = ttft if ttft is not None else time.perf_counter() - t0
            stream.append(tok)
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        adapted = handle.remote({"model": adapter_id, "prompt": prompts[0],
                                 "max_tokens": 32}).result(timeout_s=600)
        adapter_s = time.perf_counter() - t0
        after = rt.get(replica.__ray_call__.remote(replica_probe), timeout=60)

        eng = LlamaEngine(cfg, params, max_batch=8, max_seq=1024, **local_kwargs)
        local = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
                 for i, p in enumerate(prompts)]
        local_s = []
        for _ in range(2):
            local = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
                     for i, p in enumerate(prompts)]
            pending = list(local)
            t0 = time.perf_counter()
            while pending or eng.num_active():
                while pending and eng.has_capacity():
                    eng.add_request(pending.pop(0))
                eng.step()
            local_s.append(time.perf_counter() - t0)
        folded = apply_lora(params, load_lora_adapter(adapter_path))
        lora_eng = LlamaEngine(cfg, folded, max_batch=8, max_seq=1024, **local_kwargs)
        lora_want = lora_eng.generate(prompts[0], max_tokens=32)
        same = sum(a["choices"][0]["token_ids"] == r.generated == b["choices"][0]["token_ids"]
                   for a, b, r in zip(answers, answers2, local))
        fields_ok = all(
            a["object"] == "text_completion" and a["model"] == llm_cfg.model_id
            and a["choices"][0]["index"] == 0 and a["choices"][0]["finish_reason"] == "length"
            and a["usage"] == {"prompt_tokens": len(p), "completion_tokens": 32,
                               "total_tokens": len(p) + 32}
            for a, p in zip(answers, prompts))
        for label, b_s, lat in (("first, counted", batch_s, latency),
                                ("again", batch2_s, latency2)):
            tps = [32 / s for s in lat]
            tag(f"serve_llm: 8 concurrent completions ({label}), 32 greedy tokens each, prompts "
                f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens: {b_s:.3f} s for all, "
                f"per request {min(lat):.3f}-{max(lat):.3f} s ({min(tps):.1f}-{max(tps):.1f} "
                f"tokens/s each, {8 * 32 / b_s:.1f} tokens/s together)")
        tag(f"serve_llm: the in-process engine: {local_s[0]:.3f} s and {local_s[1]:.3f} s for the "
            f"same 8 requests; {same} of 8 token lists equal the in-process engine's in both "
            f"rounds; usage, finish_reason and fields right: {fields_ok}")
        tag(f"serve_llm: streamed (generate_stream): first token after {ttft * 1e3:.1f} ms, "
            f"32 tokens after {stream_s:.3f} s, equal to the in-process engine's "
            f"{stream == local[0].generated}; adapter {adapter_id!r} by \"model\": "
            f"{adapter_s:.3f} s (its engine folded and built on first use), tokens equal to an "
            f"in-process engine's on the folded tree {adapted['choices'][0]['token_ids'] == lora_want}"
            f", differ from the base's {adapted['choices'][0]['token_ids'] != local[0].generated}"
            f"; launches in the replica {counted['serve_llm']}; pid {after['pid']}")
        fail_unless(same == 8, f"serve_llm: {8 - same} of 8 served token lists differ")
        fail_unless(fields_ok, f"serve_llm: wrong response fields: {answers[0]}")
        fail_unless(stream == local[0].generated, "serve_llm: streamed tokens differ")
        fail_unless(adapted["model"] == adapter_id
                    and adapted["choices"][0]["token_ids"] == lora_want,
                    "serve_llm: the adapter's tokens differ from the folded engine's")
        fail_unless(adapted["choices"][0]["token_ids"] != local[0].generated,
                    "serve_llm: the adapter changed no token")
        fail_unless(counted["serve_llm"] == want_zero,
                    f"serve_llm launched {counted['serve_llm']}")
        fail_unless(after["pid"] == where["pid"] and len(gpu_replicas()) == 2,
                    "serve_llm: the replica was constructed again")
        del eng, lora_eng, folded, params, local
        pids = _worker_pids()
        serve.shutdown()
    finally:
        rt.shutdown()
    deadline = time.time() + 30
    while _worker_pids() and time.time() < deadline:
        time.sleep(0.1)
    left = _worker_pids()
    tag(f"shutdown: {len(pids)} worker processes before, {len(left)} left")
    fail_unless(not left, f"serve: worker processes left after shutdown: {left}")
    return counted


# The cluster phase: seconds a head or node agent may take to start and
# register, and to exit after `stop`.
CLUSTER_JOIN_S, CLUSTER_STOP_S = 60.0, 30.0

# The hub's message types whose other end is the node agent, or the
# CLI's `stop` for SHUTDOWN: constant -> the module holding that end.
AGENT_MESSAGES = {
    name: "_private/node_agent.py"
    for name in ("REGISTER_NODE", "NODE_HEARTBEAT", "WORKER_EXITED", "SPAWN_WORKER",
                 "KILL_WORKER", "OBJ_READ", "OBJ_READ_REPLY", "OBJ_SPILL", "OBJ_RESTORE",
                 "OBJ_UNLINK")
}
AGENT_MESSAGES["SHUTDOWN"] = "scripts.py"

# A job's entrypoint: a client of the cluster whose one-GPU task reports
# the node it ran on and the card it sees.
JOB_SCRIPT = """
import os
import ray_tpu_torch as rt
rt.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
@rt.remote(num_gpus=1)
def card():
    import os
    import torch
    props = torch.cuda.get_device_properties(0)
    return os.environ["RAY_TPU_TORCH_NODE_ID"], props.name, str(props.uuid)
print("JOB CARD", rt.get(card.remote(), timeout=300))
"""


def message_ends(pkg_dir: str) -> dict:
    """constant -> (its hub end, its other end), each "file:line" or None:
    a handler ``_on_<type>``, a send of ``P.<NAME>`` or the type's string
    in ``_private/hub.py``, and ``P.<NAME>`` in the other module."""
    sys.path.insert(0, os.path.dirname(pkg_dir))
    from ray_tpu_torch._private import protocol as P

    def first(rel, patterns):
        with open(os.path.join(pkg_dir, rel)) as f:
            for i, line in enumerate(f, 1):
                if any(re.search(p, line) for p in patterns):
                    return f"{os.path.basename(rel)}:{i}"
        return None

    out = {}
    for name, other in AGENT_MESSAGES.items():
        value = getattr(P, name)
        out[value] = (first("_private/hub.py", [rf"def _on_{value}\b", rf"\bP\.{name}\b",
                                                  rf"[\"']{value}[\"']"]),
                      first(other, [rf"\bP\.{name}\b"]))
    return out


def cluster_phase(cfg, dev, smi: str, kernel_names) -> dict:
    """The cluster phase: a head with no GPU and a node agent that holds
    the card, both started through the CLI; this process joins as a
    client (``init(address=...)``) and scores ``LLAMA_BENCH`` through a
    ``LlamaActor`` placed on the agent's node; a job submitted through the
    CLI runs a one-GPU task there; ``stop`` takes the cluster down.
    Returns the actor's launch counts ({"cluster_scoring": {...}}), read
    in the actor's process."""
    import shutil
    import socket
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMConfig, LlamaActor
    from ray_tpu_torch.llm._internal.actor import param_digest
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import (NodeAffinitySchedulingStrategy,
                                    PlacementGroupSchedulingStrategy, metrics, placement_group,
                                    remove_placement_group, state)

    def tag(line):
        print(f"cluster [{smi}]: {line}")

    root = os.path.dirname(os.path.abspath(__file__))
    ends = message_ends(os.path.join(root, "ray_tpu_torch"))
    tag("message types with both ends: " + ", ".join(
        f"{t} {a} <-> {b}" for t, (a, b) in ends.items()))
    fail_unless(all(a and b for a, b in ends.values()),
                f"cluster: message types missing an end: "
                f"{[t for t, (a, b) in ends.items() if not (a and b)]}")
    fail_unless(not rt.is_initialized(), "cluster: the driver already holds a runtime")

    scratch = tempfile.mkdtemp(prefix="ray_tpu_torch_cluster_")
    homes = {k: os.path.join(scratch, k) for k in ("head", "cli")}
    for d in homes.values():
        os.makedirs(d)
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    # the head's HOME keeps its pid file; the CLI's has none, so `stop`
    # reaches the head over the wire (SHUTDOWN)
    head_env = dict(os.environ, PYTHONPATH=path, HOME=homes["head"], RAY_TPU_TORCH_NUM_GPUS="0")
    cli_env = dict(os.environ, PYTHONPATH=path, HOME=homes["cli"])
    procs = {}

    def launch(name, argv, env):
        log = open(os.path.join(scratch, f"{name}.log"), "w")
        procs[name] = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *argv], env=env,
                                       cwd=root, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        return procs[name]

    def log_of(name):
        with open(os.path.join(scratch, f"{name}.log")) as f:
            return f.read()

    def cli(*argv, timeout=120.0):
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv], env=cli_env,
                             cwd=root, capture_output=True, text=True, timeout=timeout)
        fail_unless(out.returncode == 0, f"cluster: `{' '.join(argv[:2])}` exited "
                    f"{out.returncode}: {out.stdout[-2000:]} {out.stderr[-2000:]}")
        return out.stdout

    counted = {}
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        deadline = t0 + CLUSTER_JOIN_S
        head = launch("head", ["start", "--head", "--num-gpus", "0", "--num-cpus", "1",
                               "--port", str(port), "--host", "127.0.0.1"], head_env)
        while not (m := re.search(r"head started at (tcp://\S+)", log_of("head"))):
            fail_unless(head.poll() is None and time.perf_counter() < deadline,
                        f"cluster: the head did not start: {log_of('head')[-2000:]}")
            time.sleep(0.05)
        addr = m.group(1)
        head_s = time.perf_counter() - t0
        agent = launch("agent", ["start", "--address", addr, "--num-gpus", "1", "--num-cpus",
                                 "2", "--node-id", "gpu-node"], cli_env)
        rt.init(address=addr)
        while True:
            alive = {n["node_id"]: n for n in rt.nodes() if n["alive"]}
            if "gpu-node" in alive:
                break
            fail_unless(agent.poll() is None and time.perf_counter() < deadline,
                        f"cluster: the agent did not join: {log_of('agent')[-2000:]}")
            time.sleep(0.05)
        joined_s = time.perf_counter() - t0
        gpus = {nid: n["resources"].get("GPU", 0) for nid, n in alive.items()}
        total = rt.cluster_resources()
        tag(f"head at {addr} up after {head_s:.2f} s, gpu-node joined after {joined_s:.2f} s; "
            f"live nodes {sorted(alive)}, GPUs by node {gpus}, cluster GPU {total.get('GPU', 0)}")
        fail_unless(sorted(alive) == ["gpu-node", "node0"], f"cluster: live nodes {sorted(alive)}")
        fail_unless(gpus == {"node0": 0, "gpu-node": 1.0} and total.get("GPU") == 1.0,
                    f"cluster: GPUs by node {gpus}, in all {total.get('GPU')}")

        # the model on the agent's node, in the placement group of its bundles
        llm_cfg = LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=1024,
                            engine_kwargs={"prefill_chunk": 256})
        bundles, strategy = llm_cfg.placement_bundles()
        pg = placement_group(bundles, strategy=strategy)
        fail_unless(pg.wait(60), "cluster: placement group not ready within 60 s")
        t1 = time.perf_counter()
        args = (llm_cfg,) if dev.type == "cuda" else (llm_cfg, "cpu")
        actor = rt.remote(num_gpus=1)(LlamaActor).options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)).remote(*args)
        info = rt.get(actor.info.remote(), timeout=300)
        built_s = time.perf_counter() - t1
        where = [w["node_id"] for w in state.list_workers() if w.get("pid") == info["pid"]]
        props = torch.cuda.get_device_properties(dev) if dev.type == "cuda" else None
        tag(f"LlamaActor pid {info['pid']} on {where} (state.list_workers) in the {strategy} "
            f"group of {bundles}, built after {built_s:.2f} s: CUDA_VISIBLE_DEVICES="
            f"{info['cuda_visible_devices']!r}, sees {info['device_count']} card(s), "
            f"{info.get('name')} {info.get('uuid')}; the driver's card "
            f"{props.name if props else None} {props.uuid if props else None}")
        fail_unless(where == ["gpu-node"], f"cluster: the actor runs on {where}")
        if props is not None:
            fail_unless(info["device_count"] == 1 and info.get("uuid") == str(props.uuid)
                        and info.get("name") == props.name,
                        "cluster: the actor's card is not the driver's")
        params = llm_cfg.load_params(dev)
        mine, theirs = param_digest(params), rt.get(actor.param_digest.remote(), timeout=300)
        tag(f"parameter digest: driver {mine[:16]}, actor {theirs[:16]}")
        fail_unless(mine == theirs, "cluster: the actor's parameters differ from the driver's")

        # scoring: the runtime phase's batch, put by this client as a CPU tensor
        fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
        tokens, _ = bench_inputs(cfg)
        tok_ref = rt.put(tokens)
        rt.get(actor.reset_launches.remote(), timeout=60)
        loss_actor = rt.get(actor.score.remote(tok_ref), timeout=300)
        counted["cluster_scoring"] = rt.get(actor.launches.remote(), timeout=60)
        with torch.inference_mode():
            loss_here = llama.loss_fn(params, {"tokens": tokens.to(dev)}, fast).item()
        want = dict.fromkeys(kernel_names, 0)
        want.update(flash_attention_fwd=cfg.n_layers, fused_ce_fwd=1)
        err = abs(loss_actor - loss_here) / abs(loss_here)
        tag(f"scoring (8x2048 put by the client): actor loss {loss_actor!r}, in-process "
            f"{loss_here!r}, relative {err:.3e}, bit-equal {loss_actor == loss_here}; launches "
            f"in the actor {counted['cluster_scoring']}")
        fail_unless(counted["cluster_scoring"] == want,
                    f"cluster scoring launched {counted['cluster_scoring']}, want {want}")
        fail_unless(math.isfinite(loss_actor) and err <= LOSS_RTOL,
                    f"cluster: scoring loss relative err {err} > {LOSS_RTOL}")
        actor_ms, here_ms = [], []
        for _ in range(3):
            t1 = time.perf_counter()
            rt.get(actor.score.remote(tok_ref), timeout=300)
            actor_ms.append((time.perf_counter() - t1) * 1e3)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                llama.loss_fn(params, {"tokens": tokens.to(dev)}, fast).item()
            here_ms.append((time.perf_counter() - t1) * 1e3)
        a_ms, h_ms = statistics.median(actor_ms), statistics.median(here_ms)
        tag(f"scoring time (median of 3): actor on gpu-node {a_ms:.2f} ms, in-process "
            f"{h_ms:.2f} ms, cluster cost {a_ms - h_ms:.2f} ms")
        del params

        # the client's round trips, to the head's node and to gpu-node
        @rt.remote
        def noop():
            return None

        def rtt_ms(node, n=100):
            f = noop.options(scheduling_strategy=NodeAffinitySchedulingStrategy(node_id=node))
            rt.get([f.remote() for _ in range(4)], timeout=120)  # warm workers
            out = []
            for _ in range(n):
                t1 = time.perf_counter()
                rt.get(f.remote(), timeout=60)
                out.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(out)

        rtt = {node: rtt_ms(node) for node in ("node0", "gpu-node")}

        # 256 MiB CPU tensor: put by the client, through an actor on
        # gpu-node, and back
        @rt.remote(num_cpus=0)
        class Echo:
            def echo(self, t):
                return t

        echo = Echo.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_id="gpu-node")).remote()
        rt.get(echo.echo.remote(torch.zeros(4)), timeout=120)
        big = torch.randn(2**20, 128, generator=torch.Generator().manual_seed(2)).to(
            torch.bfloat16)  # 256 MiB
        gib = big.numel() * big.element_size() / 2**30
        legs = []  # (put, the actor's echo ready, get) seconds
        for i in range(3):
            t1 = time.perf_counter()
            ref = rt.put(big)
            t2 = time.perf_counter()
            out = echo.echo.remote(ref)
            rt.wait([out], timeout=300)
            t3 = time.perf_counter()
            back = rt.get(out, timeout=300)
            legs.append((t2 - t1, t3 - t2, time.perf_counter() - t3))
            if i == 0:
                fail_unless(torch.equal(back, big), "cluster: the 256 MiB tensor came back changed")
            del ref, out, back
        trip = statistics.median(sum(leg) for leg in legs)
        put_s, echo_s, get_s = (statistics.median(leg[k] for leg in legs) for k in range(3))
        tag(f"client round trips (medians of 100): task on node0 {rtt['node0']:.3f} ms, on "
            f"gpu-node {rtt['gpu-node']:.3f} ms; put -> actor on gpu-node -> get of a 256 MiB "
            f"bf16 CPU tensor {trip * 1e3:.1f} ms (median of 3), {gib / trip:.3f} GiB/s: put "
            f"{put_s * 1e3:.1f} ms, the echo ready {echo_s * 1e3:.1f} ms, get "
            f"{get_s * 1e3:.1f} ms (medians)")
        rt.kill(echo)
        rt.kill(actor)
        remove_placement_group(pg)

        # a job through the CLI: its one-GPU task runs on gpu-node
        t1 = time.perf_counter()
        job = cli("job", "submit", "--address", addr, "--wait", "--timeout", "300", "--",
                  sys.executable, "-c", JOB_SCRIPT, timeout=360)
        job_s = time.perf_counter() - t1
        m = re.search(r"JOB CARD \('([^']*)', '([^']*)', '([^']*)'\)", job)
        tag(f"job: submit --wait returned after {job_s:.2f} s, SUCCEEDED "
            f"{'SUCCEEDED' in job}, its task ran on {m.group(1) if m else None} and saw "
            f"{m.group(2) if m else None} {m.group(3) if m else None}")
        fail_unless("SUCCEEDED" in job and m is not None, f"cluster: the job failed: {job[-2000:]}")
        fail_unless(m.group(1) == "gpu-node", f"cluster: the job's task ran on {m.group(1)}")
        if props is not None:
            fail_unless((m.group(2), m.group(3)) == (props.name, str(props.uuid)),
                        "cluster: the job's card is not the driver's")
        status = cli("status", "--address", addr)
        row = next((ln.split() for ln in status.splitlines() if ln.startswith("gpu-node")), None)
        summary = json.loads(cli("summary", "tasks", "--address", addr))
        handled = {dict(m["tags"]).get("type"): m["value"] for m in metrics.snapshot()
                   if m["name"] == "ray_tpu_hub_messages_total"}
        tag(f"status: gpu-node row {row}; summary: {summary['total']} tasks "
            f"{summary['by_state']}; the hub handled from the agent: "
            + ", ".join(f"{t} {int(handled.get(t, 0))}" for t in
                        ("register_node", "node_heartbeat", "worker_exited", "obj_read_reply")))
        fail_unless(row is not None and row[1] == "True" and row[-1] == "1.0",
                    f"cluster: status shows gpu-node as {row}")
        fail_unless(summary["total"] >= 1, f"cluster: summary {summary}")

        # stop from a place with no pid file: SHUTDOWN over the wire
        pids = _worker_pids()
        rt.shutdown()
        t1 = time.perf_counter()
        out = cli("stop", "--address", addr)
        fail_unless(f"sent shutdown to hub at {addr}" in out, f"cluster: stop said {out!r}")
        deadline = t1 + CLUSTER_STOP_S
        while ((head.poll() is None or agent.poll() is None or _worker_pids())
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        gone_s = time.perf_counter() - t1
        left = _worker_pids()
        tag(f"stop: head exited {head.poll()}, agent exited {agent.poll()}, {len(pids)} worker "
            f"processes before, {len(left)} left, after {gone_s:.2f} s (limit "
            f"{CLUSTER_STOP_S:.0f} s); start-to-joined {joined_s:.2f} s, actor built "
            f"{built_s:.2f} s, stop-to-gone {gone_s:.2f} s")
        fail_unless(head.poll() is not None and agent.poll() is not None and not left,
                    f"cluster: after stop head {head.poll()}, agent {agent.poll()}, workers {left}")
    finally:
        if rt.is_initialized():
            rt.shutdown()
        # a failed run: the head first (its agent then reaps its workers)
        for name in ("head", "agent"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(scratch, ignore_errors=True)
    return counted


def _same_card(where: dict, dev, what: str) -> None:
    """A process placed with num_gpus=1 sees one card, the driver's."""
    fail_unless(where["visible"] == "0", f"{what}: CUDA_VISIBLE_DEVICES={where['visible']!r}")
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        fail_unless(where["count"] == 1 and where["uuid"] == str(props.uuid),
                    f"{what}: sees {where['count']} card(s), {where['uuid']}, not the "
                    f"driver's {props.uuid}")


def _scoring_counts(kernel_names, n_layers: int, n: int) -> dict:
    want = dict.fromkeys(kernel_names, 0)
    want.update(flash_attention_fwd=n_layers * n, fused_ce_fwd=n)
    return want


def dag_phase(cfg, dev, smi: str, kernel_names, params) -> dict:
    """The DAG phase: ``LLAMA_BENCH`` in a ``num_gpus=1`` ``LlamaActor``
    scored through compiled DAGs, in legacy mode (``actor.score.bind``)
    and in channel mode (a resident loop on the actor, C++ rings for the
    int32 batch and the per-row losses). ``params`` are the driver's
    weights. Returns the actor's launch counts per path."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.llm import LLMConfig, LlamaActor
    from ray_tpu_torch.models import llama

    def tag(line):
        print(f"dag [{smi}]: {line}")

    class RowScorer(LlamaActor):
        """``LlamaActor`` with each row's mean loss of an int32 numpy batch,
        returned as f32 numpy: the payloads a channel carries."""

        def row_losses(self, tokens):
            fast = dataclasses.replace(self.config, attention_impl="flash", ce_impl="fused")
            with torch.inference_mode():
                t = torch.from_numpy(tokens).to(self.device)
                return row_losses(self.params, t, fast).float().cpu().numpy()

    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    tokens, _ = bench_inputs(cfg)
    tok32 = tokens.to(torch.int32).numpy()
    on_dev = tokens.to(dev)
    with torch.inference_mode():
        loss_here = llama.loss_fn(params, {"tokens": on_dev}, fast).item()
        rows_here = row_losses(params, on_dev, fast).float().cpu().numpy()
    rt.init(num_cpus=2)
    try:
        llm_cfg = LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=1024)
        actor = rt.remote(num_gpus=1)(RowScorer).remote(llm_cfg, device=str(dev))
        where = rt.get(actor.__ray_call__.remote(lambda _instance: card_of()), timeout=300)
        _same_card(where, dev, "dag")
        counted = {}

        # legacy mode: each execute submits the actor task
        with InputNode() as inp:
            legacy = actor.score.bind(inp).experimental_compile()
        fail_unless(not legacy._channel_mode, "dag: an unannotated graph compiled to channels")
        tok_ref = rt.put(tokens)
        rt.get(actor.__ray_call__.remote(launch_probe, True), timeout=60)
        legacy_ms, legacy_loss = {"value": [], "ref": []}, []
        for arg in (tokens, tokens, tokens, tok_ref, tok_ref, tok_ref):
            t0 = time.perf_counter()
            legacy_loss.append(legacy.execute(arg).get(timeout=300))
            legacy_ms["ref" if arg is tok_ref else "value"].append((time.perf_counter() - t0) * 1e3)
        legacy.teardown()
        counted["dag_legacy"] = rt.get(actor.__ray_call__.remote(launch_probe), timeout=60)
        tag(f"legacy mode (actor.score.bind, 6 executes: the batch by value, then by a ref put "
            f"once): losses {legacy_loss}, in-process {loss_here!r}, bit-equal "
            f"{all(v == loss_here for v in legacy_loss)}; launches in the actor "
            f"{counted['dag_legacy']}")
        fail_unless(all(v == loss_here for v in legacy_loss),
                    f"dag: legacy losses {legacy_loss} differ from the driver's {loss_here!r}")
        fail_unless(counted["dag_legacy"] == _scoring_counts(kernel_names, cfg.n_layers, 6),
                    f"dag legacy launched {counted['dag_legacy']}")

        # channel mode: the resident loop holds the actor until teardown, so
        # the counters are zeroed before compiling and read after teardown
        rt.get(actor.__ray_call__.remote(launch_probe, True), timeout=60)
        cap = 4
        with InputNode() as inp:
            inp.with_shm_channel(tok32.shape, "int32")
            node = actor.row_losses.bind(inp).with_shm_channel((8,), "float32")
        t0 = time.perf_counter()
        chan = node.experimental_compile(max_inflight_executions=cap)
        fail_unless(chan._channel_mode, "dag: the annotated graph did not compile to channels")
        backends = sorted({ch.backend for ch in chan._edge_chans.values()})
        first = chan.execute(tok32).get(timeout=300)
        first_s = time.perf_counter() - t0
        client = rt._private.worker.get_client()
        events = len(client.list_state("tasks"))
        t0 = time.perf_counter()
        refs = [chan.execute(tok32) for _ in range(10)]  # pipelined up to the ring's capacity
        outs = [r.get(timeout=300) for r in refs]
        pipe_ms = (time.perf_counter() - t0) * 1e3 / 10
        events_after = len(client.list_state("tasks"))
        seq_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            outs.append(chan.execute(tok32).get(timeout=300))
            seq_ms.append((time.perf_counter() - t0) * 1e3)
        chan.teardown()
        n_chan = 1 + len(outs)
        counted["dag_channel"] = rt.get(actor.__ray_call__.remote(launch_probe), timeout=60)
        same = [np.array_equal(o, rows_here) for o in [first] + outs]
        tag(f"channel mode: backend {backends}, ring capacity {cap}; {n_chan} executes of the "
            f"int32 8x2049 batch -> 8 f32 row losses {first.tolist()}; in-process "
            f"{rows_here.tolist()}; {sum(same)} of {n_chan} bit-equal; task events "
            f"{events} before the 10 pipelined executes, {events_after} after; launches in the "
            f"actor {counted['dag_channel']}")
        fail_unless(backends == ["native"], f"dag: channel backends {backends}")
        fail_unless(all(same), "dag: channel-mode row losses differ from the driver's")
        fail_unless(events_after == events,
                    f"dag: {events_after - events} task events across the channel executes")
        fail_unless(counted["dag_channel"] == _scoring_counts(kernel_names, cfg.n_layers, n_chan),
                    f"dag channel launched {counted['dag_channel']}")

        # the same call submitted as an actor task, and in this process
        remote_ms, ref_ms, here_ms = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            rt.get(actor.score.remote(tokens), timeout=300)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            rt.get(actor.score.remote(tok_ref), timeout=300)
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                llama.loss_fn(params, {"tokens": tokens.to(dev)}, fast).item()
            here_ms.append((time.perf_counter() - t0) * 1e3)
        gpu_free = rt.available_resources().get("GPU", 0)
        alive = [a for a in client.list_state("actors") if a["state"] == "ALIVE"]
        tag(f"execute ms (median): legacy {statistics.median(legacy_ms['value']):.2f} by value, "
            f"{statistics.median(legacy_ms['ref']):.2f} by ref (of 3 each), channel "
            f"{statistics.median(seq_ms):.2f} one at a time (of 5) and {pipe_ms:.2f} per execute "
            f"pipelined (10); actor.score.remote {statistics.median(remote_ms):.2f} by value, "
            f"{statistics.median(ref_ms):.2f} by ref, in-process {statistics.median(here_ms):.2f} "
            f"(medians of 3); compile to first result "
            f"{first_s:.2f} s; after teardown the actor answered, {len(alive)} actor(s) alive, "
            f"GPU free {gpu_free}")
        fail_unless(len(alive) == 1 and gpu_free == 0,
                    f"dag: {len(alive)} actors alive, GPU free {gpu_free} after teardown")
        rt.kill(actor)
    finally:
        rt.shutdown()
    return counted


def workflow_phase(cfg, dev, smi: str, kernel_names, params, storage: str) -> dict:
    """The workflow phase: a two-node durable workflow whose second node, a
    ``num_gpus=1`` task, scores the batch; its first attempt fails on
    purpose, and the resume replays that node only. Returns its launch
    counts, read in the task's process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import llama

    def tag(line):
        print(f"workflow [{smi}]: {line}")

    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    tokens, _ = bench_inputs(cfg)
    with torch.inference_mode():
        loss_here = llama.loss_fn(params, {"tokens": tokens.to(dev)}, fast).item()
    runs = os.path.join(storage, "runs")
    os.makedirs(runs)
    device = str(dev)

    @rt.remote
    def make_batch(seed):
        open(os.path.join(runs, "make_batch"), "a").write("x")
        return torch.randint(0, cfg.vocab_size, (8, 2049),
                             generator=torch.Generator().manual_seed(seed))

    @rt.remote(num_gpus=1)
    def score(batch):
        from ray_tpu_torch.llm import LLMConfig

        open(os.path.join(runs, "score"), "a").write("x")
        if not os.path.exists(os.path.join(runs, "fault_done")):
            open(os.path.join(runs, "fault_done"), "w").close()
            raise RuntimeError("planned fault in the scoring node")
        p = LLMConfig(model_config=cfg).load_params(device)
        launch_probe(reset=True)
        with torch.inference_mode():
            loss = llama.loss_fn(p, {"tokens": batch.to(device)}, fast).item()
        return loss, launch_probe(), card_of()

    workflow.init(os.path.join(storage, "wf"))
    with InputNode() as inp:
        wf = score.bind(make_batch.bind(inp))
    rt.init(num_cpus=2)
    try:
        t0 = time.perf_counter()
        try:
            workflow.run(wf, workflow_id="score", args=1)
            raised = None
        except Exception as e:  # the planned fault
            raised = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        status = workflow.get_status("score")
        fail_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, counts, where = workflow.resume("score", wf, args=1)
        resume_s = time.perf_counter() - t0
        final = workflow.get_status("score")
        calls = {n: len(open(os.path.join(runs, n)).read()) for n in ("make_batch", "score")}
        tag(f"first run raised {raised!r}; status {status}; resume {final} in {resume_s:.2f} s "
            f"(first run {fail_s:.2f} s): runs per node {calls}; loss {loss!r}, in-process "
            f"{loss_here!r}, bit-equal {loss == loss_here}; the node's process {where}; launches "
            f"there {counts}; list_all {workflow.list_all()}")
        fail_unless(raised is not None and status == "FAILED",
                    f"workflow: the faulty run raised {raised!r}, status {status}")
        fail_unless(final == "SUCCEEDED" and calls == {"make_batch": 1, "score": 2},
                    f"workflow: status {final}, runs per node {calls}")
        fail_unless(loss == loss_here, f"workflow: loss {loss!r} is not the driver's {loss_here!r}")
        _same_card(where, dev, "workflow")
        fail_unless(counts == _scoring_counts(kernel_names, cfg.n_layers, 1),
                    f"workflow scoring launched {counts}")
    finally:
        rt.shutdown()
    return {"workflow_scoring": counts}


def data_phase(cfg, dev, smi: str, kernel_names, params) -> dict:
    """The Data phase: 64 seeded 2049-token rows staged onto the card by
    ``iter_torch_batches`` and scored in this process; the same rows
    scored by a ``num_gpus=1`` actor-pool UDF of ``map_batches``; the 8
    prompts through ``build_llm_processor``. Returns the launch counts per
    path: ``data_staging`` in this process, ``data_pool`` and
    ``llm_processor`` in the pool actors."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.actor import _rebuild_handle
    from ray_tpu_torch.llm import LLMConfig, LlamaEngine, GenRequest, build_llm_processor
    from ray_tpu_torch.models import llama

    def tag(line):
        print(f"data [{smi}]: {line}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    rows = np.random.default_rng(11).integers(0, cfg.vocab_size, (64, 2049), dtype=np.int32)
    with torch.inference_mode():
        rows_here = np.concatenate([
            row_losses(params, torch.from_numpy(rows[i:i + 8]).to(dev), fast).float().cpu().numpy()
            for i in range(0, 64, 8)])
    _, prompts = bench_inputs(cfg)
    engine_kwargs = {"prefill_chunk": 256}
    if dev.type != "cuda":
        engine_kwargs["device"] = str(dev)
    device = str(dev)

    class BatchScorer:
        """Map-batches UDF: each row's mean loss of an int32 batch, with this
        process's card and the batch's kernel launches as columns."""

        def __init__(self):
            from ray_tpu_torch.llm import LLMConfig as _Cfg

            self.params = _Cfg(model_config=cfg).load_params(device)

        def __call__(self, batch):
            launch_probe(reset=True)
            with torch.inference_mode():
                tokens = torch.from_numpy(np.array(batch["data"]))  # a writable copy
                losses = row_losses(self.params, tokens.to(device), fast)
            losses = losses.float().cpu().numpy()
            counts, where = launch_probe(), card_of()
            n = len(losses)
            return {"loss": losses, "k1": np.full(n, counts["flash_attention_fwd"]),
                    "k4": np.full(n, counts["fused_ce_fwd"]),
                    "others": np.full(n, sum(counts.values()) - counts["flash_attention_fwd"]
                                      - counts["fused_ce_fwd"]),
                    "visible": np.array([where["visible"]] * n),
                    "uuid": np.array([where["uuid"] or ""] * n)}

    rt.init(num_cpus=2)
    counted = {}
    try:
        ds = data.from_numpy(np.split(rows, 8)).materialize()
        fail_unless(ds.num_blocks() == 8 and ds.count() == 64, "data: not 64 rows in 8 blocks")

        # the pool first: the card goes to a worker that has run no user code
        t0 = time.perf_counter()
        scored = ds.map_batches(BatchScorer, batch_size=8, concurrency=1, num_gpus=1).take_all()
        pool_s = time.perf_counter() - t0
        got = np.array([r["loss"] for r in scored], np.float32)
        k1 = sorted({int(r["k1"]) for r in scored})
        k4 = sorted({int(r["k4"]) for r in scored})
        others = sorted({int(r["others"]) for r in scored})
        visible = sorted({str(r["visible"]) for r in scored})
        uuids = sorted({str(r["uuid"]) for r in scored})
        counted["data_pool"] = dict.fromkeys(kernel_names, 0)
        counted["data_pool"].update(flash_attention_fwd=sum(int(r["k1"]) for r in scored[::8]),
                                    fused_ce_fwd=sum(int(r["k4"]) for r in scored[::8]))
        tag(f"map_batches(BatchScorer, batch_size=8, concurrency=1, num_gpus=1): {len(scored)} "
            f"rows in {pool_s:.2f} s ({len(scored) / pool_s:.1f} rows/s, the actor's start and "
            f"model build included); per batch K1 {k1}, K4 {k4}, others {others}; "
            f"CUDA_VISIBLE_DEVICES {visible}, card {uuids}; "
            f"{int((got == rows_here).sum())} of 64 row losses bit-equal to the driver's")
        fail_unless(len(scored) == 64 and np.array_equal(got, rows_here),
                    "data: the pool's row losses differ from the driver's")
        fail_unless(k1 == [cfg.n_layers] and k4 == [1] and others == [0],
                    f"data: a pool batch launched K1 {k1}, K4 {k4}, others {others}")
        fail_unless(visible == ["0"], f"data: the pool actor saw CUDA_VISIBLE_DEVICES {visible}")
        if dev.type == "cuda":
            fail_unless(uuids == [str(torch.cuda.get_device_properties(dev).uuid)],
                        f"data: the pool actor's card {uuids} is not the driver's")

        # staging: each batch a tensor on the card, scored in this process
        with torch.inference_mode():
            direct = [llama.loss_fn(params, {"tokens": torch.from_numpy(rows[i:i + 8]).to(dev)},
                                    fast).item() for i in range(0, 64, 8)]
        def staged_pass(prefetch):
            """(ms per batch, [(staged tensor, its loss)]) of one pass."""
            out = []
            sync()
            t0 = time.perf_counter()
            for b in ds.iter_torch_batches(batch_size=8, device_put=device,
                                           prefetch_batches=prefetch):
                with torch.inference_mode():
                    out.append((b["data"], llama.loss_fn(params, {"tokens": b["data"]},
                                                         fast).item()))
            sync()
            return (time.perf_counter() - t0) * 1e3 / max(len(out), 1), out

        launch_probe(reset=True)
        _, first = staged_pass(2)  # the counted run; it also warms the stream and pinned pool
        counted["data_staging"] = launch_probe()
        equal = sum(t.device.type == dev.type
                    and torch.equal(t.cpu(), torch.from_numpy(rows[8 * i:8 * i + 8]))
                    for i, (t, _) in enumerate(first))
        bit_equal = sum(loss == direct[i] for i, (_, loss) in enumerate(first))
        fail_unless(len(first) == 8 and equal == 8 and bit_equal == 8,
                    f"data staging: {len(first)} batches, {equal} equal on {dev.type}, "
                    f"{bit_equal} losses bit-equal")
        del first
        times = {2: [], 0: []}
        for prefetch in (2, 0, 2, 0):  # in turns
            times[prefetch].append(staged_pass(prefetch)[0])
        per_batch = {k: statistics.median(v) for k, v in times.items()}
        # the host-to-card copy alone: one batch from pinned memory
        if dev.type == "cuda":
            pinned = torch.from_numpy(rows[:8]).pin_memory()
            copy_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), 20)
            copy_bytes = pinned.numel() * pinned.element_size()
            rate = f"{copy_bytes / 2**30 / (copy_ms / 1e3):.3f} GiB/s ({copy_bytes} bytes in " \
                   f"{copy_ms:.4f} ms)"
        else:
            rate = "not measured (no card)"
        t0 = time.perf_counter()
        n_only = sum(1 for _ in ds.iter_batches(batch_size=8, device_put=device,
                                                prefetch_batches=2))
        sync()
        only_ms = (time.perf_counter() - t0) * 1e3 / n_only
        tag(f"iter_torch_batches(batch_size=8, device_put={device!r}): 8 of 8 batches on the "
            f"card equal to their rows, 8 of 8 losses bit-equal to scoring the rows moved "
            f"directly; ms per batch with scoring (median of 2 passes in turns after a counted "
            f"one): prefetch 2 {per_batch[2]:.2f}, prefetch 0 {per_batch[0]:.2f}; staging "
            f"alone {only_ms:.3f} ms per batch; copy of one batch {rate}; launches in this "
            f"process (the counted pass) {counted['data_staging']}")
        fail_unless(counted["data_staging"] == _scoring_counts(kernel_names, cfg.n_layers, 8),
                    f"data staging launched {counted['data_staging']}")

        # batch inference: build_llm_processor over the 8 prompts
        llm_cfg = LLMConfig(model_config=cfg, max_batch_size=8, max_seq_len=1024,
                            engine_kwargs=engine_kwargs)
        eng = LlamaEngine(cfg, params, max_batch=8, max_seq=1024, device=dev, prefill_chunk=256)
        local = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
                 for i, p in enumerate(prompts)]
        pending = list(local)
        t0 = time.perf_counter()
        while pending or eng.num_active():
            while pending and eng.has_capacity():
                eng.add_request(pending.pop(0))
            if eng.num_active():
                eng.step()
        local_s = time.perf_counter() - t0
        del eng
        processor = build_llm_processor(llm_cfg, concurrency=1, batch_size=8, max_tokens=32)
        pds = data.from_items([{"prompt_ids": np.array(p)} for p in prompts])
        t0 = time.perf_counter()
        it = processor(pds).iter_batches(batch_size=None, prefetch_batches=0)
        batches = [next(it)]
        client = rt._private.worker.get_client()
        pool = [a for a in client.list_state("actors")
                if a["state"] == "ALIVE" and a["resources"].get("GPU")]
        fail_unless(len(pool) == 1, f"data: {len(pool)} GPU actors alive during the processor")
        counted["llm_processor"] = rt.get(_rebuild_handle(bytes.fromhex(pool[0]["actor_id"]))
                                          .__ray_call__.remote(launch_probe), timeout=60)
        batches += list(it)
        proc_s = time.perf_counter() - t0
        gen = [list(map(int, g[:n])) for b in batches
               for g, n in zip(b["generated_ids"], b["num_generated"])]
        same = sum(g == r.generated for g, r in zip(gen, local))
        n_tok = sum(len(g) for g in gen)
        tag(f"build_llm_processor(LLAMA_BENCH, concurrency=1, batch_size=8, max_tokens=32, "
            f"greedy): {len(gen)} rows, {same} of 8 token lists equal to the in-process "
            f"engine's; {n_tok} tokens in {proc_s:.2f} s ({n_tok / proc_s:.1f} tokens/s, the "
            f"pool actor's start and model build included), in-process {local_s:.2f} s "
            f"({n_tok / local_s:.1f} tokens/s); launches in the pool actor "
            f"{counted['llm_processor']}")
        fail_unless(len(gen) == 8 and same == 8, f"data: {8 - same} processor token lists differ")
        fail_unless(counted["llm_processor"] == dict.fromkeys(kernel_names, 0),
                    f"data: the processor launched {counted['llm_processor']}")
    finally:
        rt.shutdown()
    return counted



# The tune phase: the grid's learning rates, the steps of each trial, and
# the depth and steps of the Trainer the second Tuner wraps.
TUNE_LRS, TUNE_STEPS = (1e-4, 3e-4), 3
TUNE_TRAINER_LAYERS, TUNE_TRAINER_STEPS = 2, 3


def tune_trial(config):
    """The function trainable of the tune phase: ``trainer_loop`` in the
    trial's actor, at the trial's learning rate."""
    trainer_loop(config)


def _trials(events):
    """{pid: (start event, [step events])} of a trainer_loop log, in the
    order the processes started."""
    out = {}
    for e in events:
        if e["event"] == "start":
            out[e["pid"]] = (e, [])
        elif e["event"] == "step":
            out[e["pid"]][1].append(e)
    return out


def tune_phase(cfg, dev, smi: str, kernel_names) -> dict:
    """The tune phase: a ``Tuner`` over ``tune_trial`` with ``{"GPU": 1}``,
    a grid of ``TUNE_LRS``, ``TUNE_STEPS`` steps of ``LLAMA_BENCH`` each on
    the runtime phase's batch, the trials pinned to the card one after
    another; then a ``Tuner`` wrapping a ``use_gpu`` ``TorchTrainer`` of
    ``trainer_loop`` at ``TUNE_TRAINER_LAYERS`` layers (full width) over the
    same grid, one trial at a time, whose gang, not its trial actor, must
    hold the card. Each trial's losses are held bit for bit against the
    same lr run in this process first, and each step, counted in the
    process that trains, must launch all eight kernels. Returns the launch
    counts summed over the steps ({"tune_trial": ..., "tune_trainer":
    ...})."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train, tune

    def tag(line):
        print(f"tune [{smi}]: {line}")

    tokens, _ = bench_inputs(cfg)
    wcfg = dataclasses.replace(cfg, n_layers=TUNE_TRAINER_LAYERS)
    batch = {"tokens": tokens.to(dev)}
    here, here_ms = {}, {}
    for key, c, n in (("trial", cfg, TUNE_STEPS), ("trainer", wcfg, TUNE_TRAINER_STEPS)):
        for lr in TUNE_LRS:
            state, step = trainer_setup(c, dev, lr)
            losses, ms = [], []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(m["loss"].item())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            here[key, lr], here_ms[key, lr] = losses, ms
            del state, step, m
            torch.cuda.empty_cache()
    del batch
    props = torch.cuda.get_device_properties(dev)

    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    base = {"cfg": cfg, "tokens": tokens, "steps": TUNE_STEPS, "checkpoint_at": 0,
            "fail_at": TUNE_STEPS + 1, "kernel_names": list(kernel_names),
            "log": os.path.join(root, "trials.jsonl"), "marker": os.path.join(root, "never"),
            "scratch": root}
    wrapped_config = {**base, "cfg": wcfg, "steps": TUNE_TRAINER_STEPS,
                      "fail_at": TUNE_TRAINER_STEPS + 1,
                      "log": os.path.join(root, "gangs.jsonl")}
    rt.init(num_cpus=2)
    try:
        t_fit = time.time()
        grid = tune.Tuner(
            tune.with_resources(tune_trial, {"GPU": 1}),
            param_space={**base, "lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=train.RunConfig(name="llama_bench", storage_path=os.path.join(root, "runs")),
        ).fit()
        fit_s = time.time() - t_fit
        client = rt._private.worker.get_client()
        before = {a["actor_id"] for a in client.list_state("actors")}
        trainer = train.TorchTrainer(
            trainer_loop, train_loop_config=wrapped_config,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="inner", storage_path=os.path.join(root, "runs")))
        t_wrap = time.time()
        wgrid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1),
            run_config=train.RunConfig(name="llama_bench_trainer",
                                       storage_path=os.path.join(root, "runs")),
        ).fit()
        wrap_s = time.time() - t_wrap
        actors = [a for a in client.list_state("actors") if a["actor_id"] not in before]
    finally:
        rt.shutdown()
    try:
        with open(base["log"]) as f:
            trials = _trials(map(json.loads, f))
        with open(wrapped_config["log"]) as f:
            gangs = _trials(map(json.loads, f))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    counted = {}
    for path, key, res, runs, c, n, t_start, s_total in (
            ("tune_trial", "trial", grid, trials, cfg, TUNE_STEPS, t_fit, fit_s),
            ("tune_trainer", "trainer", wgrid, gangs, wcfg, TUNE_TRAINER_STEPS, t_wrap, wrap_s)):
        fail_unless(not res.errors, f"tune: {path} trials ended in error: {res.errors}")
        fail_unless(len(res) == len(TUNE_LRS) and len(runs) == len(TUNE_LRS),
                    f"tune: {path}: {len(res)} results from {len(runs)} processes")
        want = train_step_counts(c, tokens)
        for start, steps in runs.values():
            lr = start["lr"]
            tag(f"{path} lr {lr}: pid {start['pid']}, CUDA_VISIBLE_DEVICES={start['visible']!r}, "
                f"sees {start['count']} card(s), {start['name']} {start['uuid']}, "
                f"{start['free_gib']:.2f} GiB free at its start; earlier trials' processes "
                f"still running: {start['earlier_running']}")
            fail_unless(start["visible"] == "0" and start["count"] == 1
                        and start["uuid"] == str(props.uuid),
                        f"tune: {path} lr {lr} saw {start['count']} cards ({start['visible']!r}, "
                        f"{start['uuid']}); the driver's card is {props.uuid}")
            fail_unless(not start["earlier_running"],
                        f"tune: {path} lr {lr} started while {start['earlier_running']} ran")
            losses = [e["loss"] for e in steps]
            fail_unless(len(steps) == n and all(e["launches"] == want for e in steps),
                        f"tune: {path} lr {lr} launched {[e['launches'] for e in steps]}, "
                        f"want {n} x {want}")
            fail_unless(losses == here[key, lr],
                        f"tune: {path} lr {lr} losses {losses}, in-process {here[key, lr]}")
            worker_ms = " ".join(f"{e['step_ms']:.2f}" for e in steps)
            local_ms = " ".join(f"{v:.2f}" for v in here_ms[key, lr])
            tag(f"{path} lr {lr}: losses {' '.join(repr(v) for v in losses)}, bit-equal to "
                f"the in-process run; step ms {worker_ms} (in-process {local_ms}); launches "
                f"per step {want}")
        (first, first_steps), (second, _) = runs.values()
        fail_unless(second["t"] > first_steps[-1]["t"],
                    f"tune: {path}'s second trial started before the first's last step ended")
        best = res.get_best_result("loss", "min")
        lowest = min(TUNE_LRS, key=lambda lr: here[key, lr][-1])
        fail_unless(best.metrics["config"]["lr"] == lowest,
                    f"tune: {path}'s best result is lr {best.metrics['config']['lr']}, the lowest "
                    f"last loss is lr {lowest}'s")
        tag(f"{path}: placement {first['t'] - t_start:.2f} s from fit() to the first trial's loop, {second['t'] - first_steps[-1]['t']:.2f} s "
            f"from the first trial's last step to the second's loop; fit() {s_total:.2f} s; "
            f"best lr {lowest} (last loss {here[key, lowest][-1]!r})")
        counted[path] = {name: sum(e["launches"][name] for _, st in runs.values() for e in st)
                         for name in kernel_names}
    gpu = [a for a in actors if a["resources"].get("GPU")]
    tag(f"tune_trainer actors: {[a['resources'] for a in actors]}")
    fail_unless(len(actors) == 2 * len(TUNE_LRS) and len(gpu) == len(TUNE_LRS)
                and all(a["resources"] == {"CPU": 1.0} for a in actors if a not in gpu),
                f"tune: the wrapped trainer's trial actors and gangs held {actors}; want each "
                f"trial's actor on a CPU and its gang's worker on the GPU")
    return counted


def collective_phase(cfg, dev, smi: str) -> None:
    """The collective phase: an "nccl" group over this process's cards,
    each op (allreduce under every ReduceOp, reduce, broadcast, allgather,
    reducescatter, barrier, send/recv) on f32 and bf16 tensors of one
    ``LLAMA_BENCH`` layer's parameter count, held against the group's plain
    path on CPU copies and timed (CUDA events); then a "store" group of a
    ``num_gpus=1`` actor holding CUDA tensors and a CPU actor, whose
    allreduce and allgather must be bit-equal to numpy's, each result on
    its rank's device."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import types

    def tag(line):
        print(f"collective [{smi}]: {line}")

    n_dev = torch.cuda.device_count()
    numel = (llama.param_count(cfg) - 2 * cfg.vocab_size * cfg.dim - cfg.dim) // cfg.n_layers
    g = col.init_collective_group(n_dev, 0, group_name="chip_smoke")
    plain = col.init_collective_group(n_dev, 0, group_name="chip_smoke_plain",
                                      devices=["cpu"] * n_dev)
    fail_unless(g.backend == "nccl", f"collective: the default backend is {g.backend}")
    gen = torch.Generator().manual_seed(3)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            xs = [(torch.rand(numel, generator=gen) + 0.5).to(dtype) for _ in range(n_dev)]
            on_card = [x.to(f"cuda:{i}") for i, x in enumerate(xs)]
            rtol = 1e-6 if dtype == torch.float32 else 1e-2
            mb = xs[0].numel() * xs[0].element_size() / 1e6
            cases = [(f"allreduce {op.name}", lambda t, o=op: g.allreduce(t, types.AllReduceOptions(reduceOp=o)),
                      lambda t, o=op: plain.allreduce(t, types.AllReduceOptions(reduceOp=o)),
                      op in (types.ReduceOp.MIN, types.ReduceOp.MAX)) for op in types.ReduceOp]
            cases += [
                ("reduce SUM", lambda t: g.reduce(t, types.ReduceOptions(root_rank=0)),
                 lambda t: plain.reduce(t, types.ReduceOptions(root_rank=0)), False),
                ("broadcast", lambda t: g.broadcast(t, types.BroadcastOptions(root_rank=0)),
                 lambda t: plain.broadcast(t, types.BroadcastOptions(root_rank=0)), True),
                ("allgather", g.allgather, plain.allgather, True),
                ("reducescatter SUM", g.reducescatter, plain.reducescatter, False),
            ]
            for name, op, ref_op, exact in cases:
                outs, refs = op(on_card), ref_op(xs)
                err = max((o.cpu().float() - r.float()).abs().max().item()
                          for o, r in zip(outs, refs))
                ok = all(o.device == torch.device("cuda", i) and o.dtype == r.dtype
                         and torch.allclose(o.cpu().float(), r.float(), rtol=0 if exact else rtol,
                                            atol=0) for i, (o, r) in enumerate(zip(outs, refs)))
                fail_unless(ok, f"collective: nccl {name} {dtype} differs from the plain path "
                                f"(max abs err {err})")
                del outs, refs
                ms = time_ms(lambda: op(on_card), 10)
                tag(f"nccl {name} {str(dtype)[6:]} x {numel} on {n_dev} card(s): max abs err "
                    f"{err:.3e} against the plain path; {ms:.4f} ms, {mb / ms:.1f} GB/s of one "
                    f"rank's {mb:.1f} MB")
            g.barrier()
            g.send([on_card[0]], types.SendOptions(dst_rank=n_dev - 1))
            got = g.recv(types.RecvOptions(src_rank=n_dev - 1))
            fail_unless(got.device == torch.device("cuda", n_dev - 1)
                        and torch.equal(got.cpu(), xs[0]), f"collective: send/recv {dtype}")
            fail_unless(all(torch.equal(c.cpu(), x) for c, x in zip(on_card, xs)),
                        f"collective: an op changed its {dtype} inputs")
            tag(f"nccl barrier and send/recv {str(dtype)[6:]}: done, inputs untouched")
            del xs, on_card, got
    finally:
        col.destroy_collective_group("chip_smoke")
        col.destroy_collective_group("chip_smoke_plain")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(5)
    data = [rng.standard_normal(1 << 22).astype(np.float32) for _ in range(2)]
    rt.init(num_cpus=2)
    try:
        @rt.remote
        class Rank:
            def run(self, rank, x):
                import time

                from ray_tpu_torch.util import collective as c

                t = torch.from_numpy(x).to("cuda" if rank == 0 else "cpu")
                c.init_collective_group(2, rank, backend="store", group_name="chip_smoke_store")
                try:
                    t0 = time.perf_counter()
                    red = c.allreduce(t, group_name="chip_smoke_store")
                    ar_s = time.perf_counter() - t0
                    gat = c.allgather(t, group_name="chip_smoke_store")
                finally:
                    c.destroy_collective_group("chip_smoke_store")
                return {"card": card_of(), "devices": [str(red.device), str(gat.device)],
                        "allreduce": red.cpu().numpy(), "allgather": gat.cpu().numpy(),
                        "allreduce_s": ar_s}

        ranks = [Rank.options(num_gpus=1).remote(), Rank.remote()]
        outs = rt.get([a.run.remote(r, data[r]) for r, a in enumerate(ranks)], timeout=300)
        for a in ranks:
            rt.kill(a)
    finally:
        rt.shutdown()
    want_sum, want_stack = np.stack(data).sum(axis=0), np.stack(data)
    for r, out in enumerate(outs):
        dev_want = "cuda:0" if r == 0 else "cpu"
        tag(f"store rank {r}: pid {out['card']['pid']}, CUDA_VISIBLE_DEVICES="
            f"{out['card']['visible']!r}, {out['card']['count']} card(s); results on "
            f"{out['devices']}; allreduce of {data[r].nbytes / 1e6:.1f} MB in "
            f"{out['allreduce_s'] * 1e3:.2f} ms ({data[r].nbytes / 1e9 / out['allreduce_s']:.3f} "
            f"GB/s)")
        fail_unless(out["devices"] == [dev_want, dev_want],
                    f"collective: store rank {r}'s results are on {out['devices']}")
        fail_unless(out["card"]["count"] == (1 if r == 0 else 0),
                    f"collective: store rank {r} sees {out['card']['count']} cards")
        fail_unless(out["allreduce"].tobytes() == want_sum.tobytes()
                    and out["allgather"].tobytes() == want_stack.tobytes(),
                    f"collective: store rank {r}'s results are not bit-equal to numpy's")
    tag("store allreduce and allgather across a GPU actor (CUDA tensors) and a CPU actor: "
        "bit-equal to numpy on both ranks")

# ---------------------------------------------------------------------
# graftlint phase: the port's lint gate
# ---------------------------------------------------------------------

def graftlint_start() -> dict:
    """Starts ``python -m ray_tpu_torch.tools.graftlint ray_tpu_torch
    --format json`` from the checkout's root in a subprocess, and a thread
    that waits for it and stamps its end; the subprocess is killed at exit
    if it is still running."""
    import atexit
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.tools.graftlint",
                             "ray_tpu_torch", "--format", "json"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    run = {"proc": proc, "root": root, "t0": time.perf_counter()}

    def wait():
        run["out"], run["err"] = proc.communicate()
        run["s"] = time.perf_counter() - run["t0"]

    run["thread"] = threading.Thread(target=wait, daemon=True)
    run["thread"].start()
    return run


def graftlint_phase(run: dict, smi: str, timeout_s: float = 600) -> None:
    """The graftlint phase: the gate started by ``graftlint_start`` must
    exit 0 with no finding (its packaged baseline is empty)."""
    from ray_tpu_torch.tools.graftlint.core import iter_python_files

    run["thread"].join(timeout_s)
    fail_unless(not run["thread"].is_alive(), f"graftlint: still running after {timeout_s} s")
    proc = run["proc"]
    fail_unless(proc.returncode == 0,
                f"graftlint: exit code {proc.returncode}: {run['out'][-2000:]}{run['err'][-2000:]}")
    report = json.loads(run["out"])
    fail_unless(report["findings"] == [] and report["baselined"] == 0,
                f"graftlint: findings {report['findings'][:5]}, baselined {report['baselined']}")
    files = sum(1 for _ in iter_python_files([os.path.join(run["root"], "ray_tpu_torch")]))
    print(f"graftlint [{smi}]: python -m ray_tpu_torch.tools.graftlint ray_tpu_torch: exit 0, "
          f"0 findings, 0 baselined, {files} files checked (GL001-GL018) in {run['s']:.2f} s, "
          "beside the kernel and model phases")


# ---------------------------------------------------------------------
# mesh phase: the parallel layer over ranks
# ---------------------------------------------------------------------

MESH_STEPS = 3
# The depth of mesh_shared and mesh_ring (LLAMA_BENCH's width): cut from 16
# layers to keep the script inside half its time limit.
MESH_DEPTH = 8
# The steps' losses of the sharded runs against the one-device step in
# this process, relative. bf16 activations and parameters: a sharded run
# sums the model halves of each projection and the fsdp halves of each
# gradient as two bf16 partials where one device sums once (2^-8 relative
# each, averaged over 65 536 tokens in the loss).
MESH_LOSS_RTOL = 5e-3
# Ulysses and the ring against one rank's flash_attention on the same bf16
# inputs: o and the gradients per row relative to the row's norm (the ring
# merges its hops in f32 and rounds once; Ulysses runs the same kernel on
# the same heads).
MESH_ATTN_ROW_RTOL = 1e-2
# The 1F1B pipeline's stage gradients against the same microbatches run
# sequentially on one rank (same kernels, same order; f32 sums of the
# microbatches on both sides), per tensor ||g - g_ref|| / ||g_ref||.
MESH_PIPE_GRAD_RTOL = 1e-2
# The expert-parallel MoE FFN (f32, TF32 off) against one rank's: the two
# ranks' combines summed in another order.
MESH_EXPERT_RTOL = 1e-5
MESH_RANK_TIMEOUT_S = 600


def _mesh_rank_main(rank, world, workdir, fn):
    """One rank of a mesh phase: a group on a FileStore in ``workdir``
    (gloo, every rank on card 0; or ``payload["backend"]`` "nccl", rank r
    on card r), ``fn(rank, world, payload)`` run and its result saved for
    the process that started the ranks."""
    import datetime

    import torch.distributed as dist

    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    backend = payload.get("backend", "gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
    try:
        out = fn(rank, world, payload)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def run_ranks(fn, world: int, payload: dict, timeout_s: float = MESH_RANK_TIMEOUT_S) -> list:
    """``fn`` on ``world`` spawned ranks (sharing card 0 over gloo, or one
    card each over NCCL, as ``_mesh_rank_main`` says); their results in rank
    order. A rank that fails or outlasts ``timeout_s`` fails the phase, and
    no rank is left running."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        torch.save(payload, os.path.join(workdir, "payload.pt"))
        ctx = mp.start_processes(_mesh_rank_main, args=(world, workdir, fn), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.time() + timeout_s
        try:
            while not ctx.join(timeout=5):
                fail_unless(time.time() < deadline,
                            f"mesh: {fn.__name__} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _kernel_wrappers(names):
    from ray_tpu_torch.llm._internal.actor import _kernels

    every = _kernels()
    return {n: every[n] for n in names}


def mesh_train_steps(mesh, cfg, tokens, steps, kernel_names, restore=None):
    """``steps`` sharded train steps of ``cfg`` (LLAMA_BENCH, bf16) over
    ``mesh`` from the trainer phase's seeded parameters and optimizer, each
    step counted: launches (zeroed just before it), staged bytes and the
    transport's host seconds (waiting for the card before a copy out, the
    copies, the collectives' calls), host ms ending in a synchronize; and
    the peak memory. With ``restore``, then ``mesh_restore`` of the state."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import comm

    dev = torch.device("cuda", torch.cuda.current_device())
    opt = parallel.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, sh = parallel.create_train_state(mesh, gen, lambda g: llama.init_params(g, cfg, dev),
                                            opt, llama.param_specs(cfg))
    step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt, mesh, sh)
    batch = {"tokens": tokens.to(dev)}
    wrappers = _kernel_wrappers(kernel_names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(steps):
        for w in wrappers.values():
            w.launches = 0
        comm.staging.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rows.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "launches": {n: w.launches for n, w in wrappers.items()},
                     "staged": comm.staging.bytes, "wait_s": comm.staging.wait_s,
                     "copy_s": comm.staging.copy_s, "comm_s": comm.staging.comm_s})
    out = {"rows": rows, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "wq": tuple(state.params["blocks"]["wq"].shape)}
    if restore is not None:
        out["restore"] = mesh_restore(mesh, cfg, opt, state, sh, step, batch, wrappers, restore)
    return out


def mesh_restore(mesh, cfg, opt, state, sh, step, batch, wrappers, p):
    """``mesh_restore``: this rank's state saved by a sharded
    ``Checkpoint.from_torch`` into ``p["path"]`` (the mesh's first rank
    writes the gathered tree), the tree gathered again to the host as the
    reference, a step of the uninterrupted run; then ``to_torch(target,
    shardings=)`` onto a mesh of the shape ``p["mesh"]`` built in the same
    ranks, every restored shard (parameters and both Adam moments) held
    against ``shard_params`` of the gathered tree there, and one step on
    the restored state, its launches counted (zeroed just before it)."""
    from ray_tpu_torch import parallel, train
    from ray_tpu_torch.models import gather_params, llama, shard_params

    specs = llama.param_specs(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = train.Checkpoint.from_torch(state, p["path"], shardings=sh)
    save_s = time.perf_counter() - t0
    # host copies (a leaf no axis splits comes back as itself, which the next
    # step updates in place)
    saved = {k: parallel.tree_map(lambda t: t.to("cpu", copy=True),
                                  gather_params(tree, mesh, specs))
             for k, tree in (("params", state.params), ("mu", state.opt_state.mu),
                             ("nu", state.opt_state.nu))}
    _, m = step(state, batch)   # the uninterrupted run's next step
    uninterrupted = m["loss"].item()
    new_mesh = parallel.make_mesh(**p["mesh"])
    new_sh, _ = parallel.state_shardings(new_mesh, specs, lambda: state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt.to_torch(target=state, shardings=new_sh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0

    def named(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(named(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    unequal = []
    for key, tree in (("params", restored.params), ("mu", restored.opt_state.mu),
                      ("nu", restored.opt_state.nu)):
        want = named(shard_params(saved[key], new_mesh, specs))
        for name, t in named(tree).items():
            w = want[name]
            if not (t.dtype == w.dtype and t.is_contiguous() and torch.equal(t, w)):
                unequal.append(f"{key}/{name}")
    counts = (restored.step, restored.opt_state.count)
    wq = tuple(restored.params["blocks"]["wq"].shape)
    del saved, state
    new_step = parallel.make_train_step(lambda q, b: llama.loss_fn(q, b, cfg), opt, new_mesh,
                                        new_sh)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = new_step(restored, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"unequal": unequal, "loss": m["loss"].item(), "uninterrupted": uninterrupted,
            "ms": ms, "launches": {n: w.launches for n, w in wrappers.items()},
            "save_s": save_s, "restore_s": restore_s, "counts": counts, "wq": wq,
            "bytes": sum(os.path.getsize(os.path.join(ckpt.path, f))
                         for f in os.listdir(ckpt.path))}


def _breakdown(row) -> str:
    """Where a sharded step's host time went, from its transport counters."""
    rest = row["ms"] / 1e3 - row["wait_s"] - row["copy_s"] - row["comm_s"]
    return (f"gloo calls {row['comm_s']:.3f} s, host copies {row['copy_s']:.3f} s, waiting for "
            f"the card before a copy {row['wait_s']:.3f} s, the rest {rest:.3f} s")


def mesh_world1_loop(config):
    """The ``mesh_world1`` train loop, in a one-GPU TorchTrainer worker:
    ``make_mesh()`` over the gang's NCCL group of one (shaped by
    ``TorchConfig.mesh_shape``), then the sharded steps, each reported."""
    import torch.distributed as dist

    from ray_tpu_torch import parallel, train

    mesh = parallel.make_mesh()
    out = mesh_train_steps(mesh, config["cfg"], config["tokens"], config["steps"],
                           config["kernel_names"])
    sizes = {a: parallel.mesh_axis_size(mesh, a) for a in parallel.AXIS_ORDER}
    for i, row in enumerate(out["rows"]):
        train.report({**row, "sizes": sizes, "backend": dist.get_backend(),
                      "peak_gib": out["peak_gib"], "step": i + 1})


def mesh_train_rank(rank, world, p):
    from ray_tpu_torch import parallel

    mesh = parallel.make_mesh(**p["mesh"])
    return mesh_train_steps(mesh, p["cfg"], p["tokens"], p["steps"], p["kernel_names"],
                            p.get("restore"))


def _attn_inputs(p, dev):
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    B, T, H, KVH, hd = p["shape"]
    return [torch.randn(shape, generator=gen, device=dev).bfloat16()
            for shape in ((B, T, H, hd), (B, T, KVH, hd), (B, T, KVH, hd), (B, T, H, hd))]


def mesh_attention_rank(rank, world, p):
    """Ulysses and the ring, each on this rank's sequence block of seeded
    inputs, against one rank's flash_attention on the whole: the block's o
    and gradients' row-relative errors, each op's launches (zeroed just
    before it), staged bytes and forward + backward ms."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.ops import flash_attention, ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import comm
    from ray_tpu_torch.parallel.mesh import mesh_device

    mesh = parallel.make_mesh(seq=world)
    dev = mesh_device(mesh)  # the card _mesh_rank_main set
    q, k, v, g = _attn_inputs(p, dev)
    wrappers = _kernel_wrappers(p["kernel_names"])
    whole = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ro = flash_attention(*whole, causal=True)
    refs = [ro, *torch.autograd.grad(ro, whole, g)]
    blocks = [comm.local_part(t, mesh, ("seq",), 1).contiguous().requires_grad_(True)
              for t in (q, k, v)]
    gb = comm.local_part(g, mesh, ("seq",), 1).contiguous()
    out = {}
    for op, fn in (("ulysses", ulysses_attention), ("ring_op", ring_attention)):
        for w in wrappers.values():
            w.launches = 0
        comm.staging.reset()
        o = fn(*blocks, mesh=mesh, causal=True)
        grads = torch.autograd.grad(o, blocks, gb)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        staged = comm.staging.bytes
        ms = time_ms(lambda: torch.autograd.grad(fn(*blocks, mesh=mesh, causal=True), blocks,
                                                 gb), 3, warmup=1)
        errs = {n: row_rel_err(a, comm.local_part(r, mesh, ("seq",), 1), 0 if n == "o" else 1e-3)
                for n, a, r in zip(("o", "dq", "dk", "dv"), (o, *grads), refs)}
        out[op] = {"errs": errs, "launches": launches, "staged": staged, "ms": ms,
                   "card": dev.index}
    return out


def _pipe_stage(cfg):
    """A pipeline stage of ``cfg`` blocks (flash attention), x -> x."""
    from ray_tpu_torch.models import llama

    def stage(params, x):
        cos, sin = llama.rope_table(cfg, x.shape[1], device=x.device)
        for layer in llama._layers(params):
            x = llama.block_fn(cfg, x, layer, cos, sin)
        return x

    return stage


def mesh_pipeline_rank(rank, world, p):
    """1F1B and GPipe over ``world`` stages of ``cfg.n_layers // world``
    LLAMA_BENCH blocks each (seeded bf16 weights, flash attention), the
    loss the mean square of the last stage's output against seeded
    targets: this stage's gradients against the same microbatches run
    through every stage on this rank alone (f32 sums of the microbatches,
    as the pipeline's), and each schedule's peak memory above what it found
    (after a first run of each, whose first-use allocations it excludes)."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import mesh_device

    mesh = parallel.pipe_mesh()
    dev = mesh_device(mesh)  # the card _mesh_rank_main set
    cfg = p["cfg"]
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = llama.init_params(gen, cfg, dev)["blocks"]
    per = cfg.n_layers // world
    stacked = {k: v.reshape(world, per, *v.shape[1:]) for k, v in blocks.items()}
    local = {k: v[rank:rank + 1].clone() for k, v in stacked.items()}
    B, S, mb = p["batch"]
    x = torch.randn(B, S, cfg.dim, generator=gen, device=dev).to(cfg.dtype)
    t = torch.randn(B, S, cfg.dim, generator=gen, device=dev).to(cfg.dtype)
    stage = _pipe_stage(cfg)

    def loss_fn(y, tt):
        return torch.mean((y.float() - tt.float()) ** 2)

    wrappers = _kernel_wrappers(p["kernel_names"])
    runs = {schedule: parallel.pipeline_train(stage, local, mesh, loss_fn=loss_fn,
                                              microbatch_size=mb, schedule=schedule)
            for schedule in ("1f1b", "gpipe")}
    for run in runs.values():  # first-use allocations (cuBLAS) out of the measured peaks
        run(x, t)
    out = {}
    for schedule, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        loss, grads = run(x, t)
        torch.cuda.synchronize()
        out[schedule] = {"loss": loss.item(), "ms": (time.perf_counter() - t0) * 1e3,
                         "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                         "stats": dict(run.stats),
                         "launches": {n: w.launches for n, w in wrappers.items()},
                         "grads": {k: v[0] for k, v in grads.items()}}
    # the reference: every microbatch through every stage on this rank
    mine = {k: v[rank].detach().requires_grad_(True) for k, v in stacked.items()}
    allp = [{k: v[s] for k, v in stacked.items()} for s in range(world)]
    allp[rank] = mine
    acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in mine.items()}
    total = 0.0
    for m in range(B // mb):
        h = x[m * mb:(m + 1) * mb]
        for s in range(world):
            h = stage(allp[s], h)
        loss = loss_fn(h, t[m * mb:(m + 1) * mb])
        total += loss.item()
        for (k, a), gr in zip(acc.items(), torch.autograd.grad(loss, list(mine.values()))):
            a += gr
    M = B // mb
    errs = {}
    for k, a in acc.items():
        ref = (a / M).to(cfg.dtype).float()
        for schedule in ("1f1b", "gpipe"):
            got = out[schedule]["grads"][k].float()
            errs[f"{schedule}/{k}"] = ((got - ref).norm() / ref.norm()).item()
    for schedule in out:
        del out[schedule]["grads"]
    return {"runs": out, "errs": errs, "ref_loss": total / M, "card": dev.index}


def mesh_expert_rank(rank, world, p):
    """moe_ffn with the experts split over ``expert`` (world ranks), f32 at
    Mixtral's expert widths, against one rank's moe_ffn on all experts:
    outputs (row-relative) and aux loss."""
    from ray_tpu_torch import parallel
    from ray_tpu_torch.models import shard_params
    from ray_tpu_torch.ops import moe as moe_ops
    from ray_tpu_torch.parallel import P
    from ray_tpu_torch.parallel.mesh import mesh_device

    mesh = parallel.make_mesh(expert=world)
    dev = mesh_device(mesh)  # the card _mesh_rank_main set
    mc = p["moe"]
    gen = torch.Generator(device=dev).manual_seed(0)
    full = moe_ops.init_moe_params(gen, mc, dtype=torch.float32, device=dev)
    B, S = p["tokens"]
    x = torch.randn(B, S, mc.d_model, generator=gen, device=dev)
    specs = {"router": P(None, None), "w_gate": P("expert", None, None),
             "w_up": P("expert", None, None), "w_down": P("expert", None, None)}
    local = shard_params(full, mesh, specs)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = moe_ops.moe_ffn(local, x, mc, mesh=mesh, token_axes=((), ()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref, ref_aux = moe_ops.moe_ffn(full, x, mc)
    return {"err": row_rel_err(out, ref), "aux": aux.item(), "ref_aux": ref_aux.item(),
            "ms": ms, "experts": tuple(local["w_gate"].shape), "card": dev.index}


def mesh_op_paths(cfg, kernel_names, tag, world: int, backend: str,
                  timeout_s: float = MESH_RANK_TIMEOUT_S) -> dict:
    """The op-level mesh paths on ``world`` ranks (gloo ranks sharing card
    0, or one NCCL rank a card): Ulysses and the ring op at seq ``world``
    (LLAMA_BENCH's heads), 1F1B and GPipe over ``world`` stages of
    LLAMA_BENCH blocks, the expert FFN at expert ``world`` (Mixtral's
    experts), each rank held against one rank's result on its own card.
    Returns the launches by path, summed over each path's ranks. A rank
    that outlasts ``timeout_s`` fails the path."""
    from ray_tpu_torch.ops import moe as moe_ops

    counted = {}
    where = (f"{world} gloo ranks on one card" if backend == "gloo"
             else f"{world} NCCL ranks, one a card")
    payload = {"shape": (1, 4096, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim), "seed": 3,
               "kernel_names": list(kernel_names), "backend": backend}
    outs = run_ranks(mesh_attention_rank, world, payload, timeout_s)
    attn = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    for op in ("ulysses", "ring_op"):
        for r, o in enumerate(x[op] for x in outs):
            for n, e in o["errs"].items():
                fail_unless(math.isfinite(e) and e <= MESH_ATTN_ROW_RTOL,
                            f"mesh_{op}: rank {r} {n} row-relative err {e} > "
                            f"{MESH_ATTN_ROW_RTOL}")
            hops = 1 if op == "ulysses" else r + 1  # the ring's plan: r + 1 blocks
            fail_unless(all(o["launches"][n] == hops for n in attn),
                        f"mesh_{op}: rank {r} launched {o['launches']}, want {hops} of each "
                        f"attention kernel")
            tag(f"mesh_{op} rank {r} on card {o['card']} (seq {world}, {where}; B 1, T 4096, "
                f"H {cfg.n_heads}, KVH {cfg.n_kv_heads}, hd {cfg.head_dim}, causal): "
                "row-relative err against one rank's flash_attention "
                + ", ".join(f"{n} {e:.3e}" for n, e in o["errs"].items())
                + f"; launches {o['launches']}; staged {o['staged'] / 2**20:.1f} MiB; forward "
                f"+ backward {o['ms']:.2f} ms")
        counted[f"mesh_{op}"] = {n: sum(x[op]["launches"][n] for x in outs)
                                 for n in kernel_names}

    pcfg = dataclasses.replace(cfg, attention_impl="flash", remat=False)
    payload = {"cfg": pcfg, "batch": (16, 2048, 1), "kernel_names": list(kernel_names),
               "backend": backend}
    outs = run_ranks(mesh_pipeline_rank, world, payload, timeout_s)
    for r, o in enumerate(outs):
        for n, e in o["errs"].items():
            fail_unless(math.isfinite(e) and e <= MESH_PIPE_GRAD_RTOL,
                        f"mesh_pipeline: rank {r} {n} gradient relative err {e}")
        one, gp = o["runs"]["1f1b"], o["runs"]["gpipe"]
        # 1F1B: stage r holds at most 2 (world - 1 - r) + 1 inputs at once
        most = min(one["stats"]["microbatches"], 2 * (world - 1 - r) + 1)
        fail_unless(one["stats"]["peak_stash"] <= most,
                    f"mesh_pipeline: 1F1B stage {r} stashed {one['stats']['peak_stash']}, "
                    f"more than {most}")
        tag(f"mesh_pipeline rank {r} on card {o['card']} ({world} stages of "
            f"{pcfg.n_layers // world} LLAMA_BENCH blocks, {where}, 16 microbatches of 1 x "
            "2048): gradient relative err against sequential "
            + ", ".join(f"{n} {e:.3e}" for n, e in o["errs"].items() if n.startswith("1f1b"))
            + f"; loss 1F1B {one['loss']!r} GPipe {gp['loss']!r} sequential {o['ref_loss']!r}; "
            f"peak above the weights 1F1B {one['peak_gib']:.3f} GiB (stash "
            f"{one['stats']['peak_stash']}) vs GPipe {gp['peak_gib']:.3f} GiB (stash "
            f"{gp['stats']['peak_stash']}); ms 1F1B {one['ms']:.1f} GPipe {gp['ms']:.1f}; "
            f"launches 1F1B {one['launches']}")
    # stage 0 stashes views of its input; the later stages' stashes are memory
    peaks = {s: sum(o["runs"][s]["peak_gib"] for o in outs) for s in ("1f1b", "gpipe")}
    fail_unless(peaks["1f1b"] < peaks["gpipe"],
                f"mesh_pipeline: 1F1B peak {peaks['1f1b']} GiB not below GPipe's {peaks['gpipe']}")
    counted["mesh_pipeline"] = {n: sum(o["runs"][s]["launches"][n] for o in outs
                                       for s in ("1f1b", "gpipe")) for n in kernel_names}

    mix = moe_llama_widths()
    payload = {"moe": moe_ops.MoEConfig(d_model=mix.dim, d_ff=mix.ffn_dim,
                                        n_experts=mix.n_experts, k=mix.experts_per_token,
                                        capacity_factor=mix.capacity_factor),
               "tokens": (2, 2048), "backend": backend}
    outs = run_ranks(mesh_expert_rank, world, payload, timeout_s)
    for r, o in enumerate(outs):
        fail_unless(o["err"] <= MESH_EXPERT_RTOL and o["aux"] == o["ref_aux"],
                    f"mesh_expert: rank {r} row-relative err {o['err']}, aux {o['aux']} vs "
                    f"{o['ref_aux']}")
        tag(f"mesh_expert rank {r} on card {o['card']} (expert {world}, {where}; Mixtral "
            f"experts D {mix.dim} F {mix.ffn_dim}, E {mix.n_experts} "
            f"top-{mix.experts_per_token}, 2 x 2048 tokens, f32): holds experts "
            f"{o['experts']}; row-relative err against one rank's moe_ffn {o['err']:.3e}; aux "
            f"equal; {o['ms']:.2f} ms")
    counted["mesh_expert"] = {n: 0 for n in kernel_names}
    return counted


def mesh_phase(cfg, dev, smi: str, kernel_names) -> dict:
    """The mesh phase: LLAMA_BENCH trained over meshes of ranks, its
    sharded state saved and restored onto a mesh of another shape, and the
    sequence, pipeline and expert parallel ops on two ranks sharing the
    card, each held against one rank. Returns the launches by path, summed
    over each path's ranks."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    def tag(line):
        print(f"mesh [{smi}]: {line}")

    t_phase = time.perf_counter()
    counted = {}
    tokens, _ = bench_inputs(cfg)
    tcfg = dataclasses.replace(cfg, remat=True, attention_impl="flash", ce_impl="fused")
    per_step = train_step_counts(cfg, tokens)

    def one_device(c):
        """The one-device steps a training path is held against."""
        state, step = trainer_setup(c, dev)
        batch = {"tokens": tokens.to(dev)}
        losses = []
        for _ in range(MESH_STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        del state, step, batch, m
        torch.cuda.empty_cache()
        tag(f"one-device losses at {c.n_layers} layers (in-process make_train_step): "
            f"{' '.join(repr(v) for v in losses)}")
        return losses

    here = one_device(cfg)

    # ---- mesh_world1: a TorchTrainer worker's NCCL world of one
    class Collect:
        def __init__(self):
            self.rows = []

        def on_result(self, metrics):
            self.rows.append(metrics)

    collect = Collect()
    rt.init(num_cpus=2)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_world1_") as root:
            t_fit = time.time()
            result = train.TorchTrainer(
                mesh_world1_loop,
                train_loop_config={"cfg": tcfg, "tokens": tokens, "steps": MESH_STEPS,
                                   "kernel_names": list(kernel_names)},
                torch_config=train.TorchConfig(mesh_shape={"fsdp": 1}),
                scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
                run_config=train.RunConfig(name="mesh_world1", storage_path=root,
                                           callbacks=[collect])).fit()
            fit_s = time.time() - t_fit
    finally:
        rt.shutdown()
    fail_unless(result.error is None, f"mesh_world1: fit() ended in error: {result.error}")
    rows = collect.rows
    fail_unless(len(rows) == MESH_STEPS, f"mesh_world1: {len(rows)} steps reported")
    fail_unless(rows[0]["backend"] == "nccl" and all(v == 1 for v in rows[0]["sizes"].values()),
                f"mesh_world1: backend {rows[0]['backend']}, mesh {rows[0]['sizes']}")
    losses = [r["loss"] for r in rows]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, here)]
    for r in rows:
        fail_unless(r["launches"] == per_step,
                    f"mesh_world1: step {r['step']} launched {r['launches']}, want {per_step}")
    fail_unless(max(errs) <= TRAIN_LOSS_RTOL, f"mesh_world1: loss relative err {max(errs)}")
    counted["mesh_world1"] = {n: sum(r["launches"][n] for r in rows) for n in kernel_names}
    tag(f"mesh_world1: TorchTrainer, one use_gpu worker, backend {rows[0]['backend']}, mesh "
        f"{rows[0]['sizes']}; losses {' '.join(repr(v) for v in losses)}; bit-equal to the "
        f"one-device step {losses == here} (max relative err {max(errs):.3e}); step ms "
        f"{' '.join(f'{r['ms']:.2f}' for r in rows)}; peak {rows[0]['peak_gib']:.2f} GiB; "
        f"launches per step {rows[0]['launches']}; fit() {fit_s:.2f} s")
    torch.cuda.empty_cache()

    # ---- mesh_shared: 4 gloo ranks sharing the card at (fsdp 2, model 2); these
    # and the ring's run at MESH_DEPTH layers (full width): their steps are the
    # gloo transport's, 10-12 s a step at 16 layers. Then mesh_restore: the
    # state saved sharded, restored at (fsdp 4) in the same ranks, one step
    cut = dataclasses.replace(cfg, n_layers=MESH_DEPTH)
    here = one_device(cut)
    tcfg = dataclasses.replace(tcfg, n_layers=MESH_DEPTH)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_restore_")
    restore_shape = {"fsdp": 4}
    payload = {"cfg": tcfg, "tokens": tokens, "steps": MESH_STEPS,
               "kernel_names": list(kernel_names), "mesh": {"fsdp": 2, "model": 2},
               "restore": {"path": os.path.join(ckpt_dir, "ckpt"), "mesh": restore_shape}}
    t0 = time.time()
    try:
        outs = run_ranks(mesh_train_rank, 4, payload)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.time() - t0
    # each rank: its heads (model 2) of every layer, its rows (fsdp 2) in the CE
    want = train_step_counts(cut, tokens[:tokens.shape[0] // 2])
    for r, o in enumerate(outs):
        fail_unless([x["loss"] for x in o["rows"]] == [x["loss"] for x in outs[0]["rows"]],
                    f"mesh_shared: rank {r}'s losses differ from rank 0's")
        for x in o["rows"]:
            fail_unless(x["launches"] == want,
                        f"mesh_shared: rank {r} launched {x['launches']}, want {want}")
        tag(f"mesh_shared rank {r}: wq shard {o['wq']}, launches per step "
            f"{o['rows'][-1]['launches']}, staged {o['rows'][-1]['staged'] / 2**30:.3f} GiB per "
            f"step, step ms {' '.join(f'{x['ms']:.1f}' for x in o['rows'])}, peak "
            f"{o['peak_gib']:.2f} GiB; last step: {_breakdown(o['rows'][-1])}")
    losses = [x["loss"] for x in outs[0]["rows"]]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, here)]
    fail_unless(max(errs) <= MESH_LOSS_RTOL,
                f"mesh_shared: loss relative err {max(errs)} > {MESH_LOSS_RTOL}")
    counted["mesh_shared"] = {n: sum(x["launches"][n] for o in outs for x in o["rows"])
                              for n in kernel_names}
    tag(f"mesh_shared: (fsdp 2, model 2), {cut.n_layers} layers, 4 gloo ranks on one card; losses "
        f"{' '.join(repr(v) for v in losses)} against one device's, max relative err "
        f"{max(errs):.3e}; {wall:.1f} s with the ranks' start and mesh_restore")

    # mesh_restore: each rank at (fsdp 4) holds its quarter of the rows and every head
    want = train_step_counts(cut, tokens[:tokens.shape[0] // 4])
    res = [o["restore"] for o in outs]
    for r, x in enumerate(res):
        fail_unless(not x["unequal"], f"mesh_restore: rank {r}'s restored shards differ from "
                                      f"shard_params of the gathered tree: {x['unequal'][:8]}")
        fail_unless(x["counts"] == (MESH_STEPS, MESH_STEPS),
                    f"mesh_restore: rank {r} restored step and count {x['counts']}")
        fail_unless(x["loss"] == res[0]["loss"],
                    f"mesh_restore: rank {r}'s restored loss differs from rank 0's")
        fail_unless(x["launches"] == want,
                    f"mesh_restore: rank {r} launched {x['launches']}, want {want}")
        tag(f"mesh_restore rank {r}: restored wq shard {x['wq']} at {restore_shape}, every "
            f"shard (params, mu, nu) bit-equal to shard_params of the gathered tree; save "
            f"{x['save_s']:.2f} s, restore {x['restore_s']:.2f} s, restored step "
            f"{x['ms']:.1f} ms, launches {x['launches']}")
    err = abs(res[0]["loss"] - res[0]["uninterrupted"]) / abs(res[0]["uninterrupted"])
    fail_unless(err <= MESH_LOSS_RTOL,
                f"mesh_restore: loss relative err {err} > {MESH_LOSS_RTOL} against the "
                "uninterrupted run")
    counted["mesh_restore"] = {n: sum(x["launches"][n] for x in res) for n in kernel_names}
    tag(f"mesh_restore: a sharded Checkpoint.from_torch after step {MESH_STEPS} at (fsdp 2, "
        f"model 2), {res[0]['bytes']} bytes, restored by to_torch(shardings=) at "
        f"{restore_shape} in the same 4 gloo ranks; step {MESH_STEPS + 1} loss "
        f"{res[0]['loss']!r} against the uninterrupted run's {res[0]['uninterrupted']!r}, "
        f"relative err {err:.3e}; save {max(x['save_s'] for x in res):.2f} s, restore "
        f"{max(x['restore_s'] for x in res):.2f} s, restored step "
        f"{max(x['ms'] for x in res):.1f} ms (slowest rank)")
    torch.cuda.empty_cache()

    # ---- mesh_ring: 2 gloo ranks at seq 2, ring attention
    rcfg = dataclasses.replace(tcfg, attention_impl="ring")
    payload = {"cfg": rcfg, "tokens": tokens, "steps": MESH_STEPS,
               "kernel_names": list(kernel_names), "mesh": {"seq": 2}}
    t0 = time.time()
    outs = run_ranks(mesh_train_rank, 2, payload)
    wall = time.time() - t0
    L = cut.n_layers
    rows_local = tokens.shape[0] * (tokens.shape[1] - 1) // 2
    ce_chunks = -(-rows_local // (256 * 2**20 // (cfg.vocab_size * 2) // 128 * 128))
    for r, o in enumerate(outs):
        hops = r + 1  # rank r attends the diagonal block and r past ones
        want = {"flash_attention_fwd": 2 * L * hops, "flash_attention_bwd_dkv": L * hops,
                "flash_attention_bwd_dq": L * hops, "fused_ce_fwd": 1,
                "fused_ce_bwd_dlog": ce_chunks, "fused_ce_bwd_dx": ce_chunks,
                "fused_ce_bwd_dw": ce_chunks, "fused_adamw": llama_leaves(cut)}
        for x in o["rows"]:
            fail_unless(x["launches"] == want,
                        f"mesh_ring: rank {r} launched {x['launches']}, the hop plan {want}")
        tag(f"mesh_ring rank {r}: launches per step {o['rows'][-1]['launches']} (hop plan: "
            f"{hops} block(s) a layer), staged {o['rows'][-1]['staged'] / 2**30:.3f} GiB per "
            f"step, step ms {' '.join(f'{x['ms']:.1f}' for x in o['rows'])}, peak "
            f"{o['peak_gib']:.2f} GiB; last step: {_breakdown(o['rows'][-1])}")
    losses = [x["loss"] for x in outs[0]["rows"]]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, here)]
    fail_unless(max(errs) <= MESH_LOSS_RTOL,
                f"mesh_ring: loss relative err {max(errs)} > {MESH_LOSS_RTOL}")
    counted["mesh_ring"] = {n: sum(x["launches"][n] for o in outs for x in o["rows"])
                            for n in kernel_names}
    tag(f"mesh_ring: seq 2, {cut.n_layers} layers, 2 gloo ranks, 2049-token rows; losses "
        f"{' '.join(repr(v) for v in losses)} against one device's flash, max relative err "
        f"{max(errs):.3e}; {wall:.1f} s with the ranks' start")
    torch.cuda.empty_cache()

    # ---- mesh_ulysses (and the ring op), mesh_pipeline, mesh_expert: op level
    counted.update(mesh_op_paths(cfg, kernel_names, tag, world=2, backend="gloo"))
    tag(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return counted


RLLIB_RTOL, RLLIB_ATOL = 1e-5, 1e-6
RLLIB_TICKS = 50            # Anakin ticks at the larger env count
RLLIB_ENVS = (64, 4096)     # PodracerConfig's default, and GPU-batched scale


def _anakin_config(loss: str, num_envs: int, seed: int = 0, **podracer):
    from ray_tpu_torch.rllib.podracer import PodracerConfig

    return (PodracerConfig().environment("CartPole-v1")
            .podracer(mode="anakin", num_envs=num_envs, use_compiled_dag=True, **podracer)
            .training(loss=loss).debugging(seed=seed))


def _rllib_batch(rng, T, N, obs_dim=4, num_actions=2) -> dict:
    """A seeded time-major V-trace batch (numpy) of T steps of N envs."""
    return {"obs": rng.standard_normal((T, N, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, (T, N)),
            "rewards": np.ones((T, N), np.float32),
            "dones": (rng.random((T, N)) < 0.05).astype(np.float32),
            "logp_mu": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
            "final_obs": rng.standard_normal((N, obs_dim)).astype(np.float32)}


def rllib_learner_cases() -> dict:
    """name -> run(device) -> (losses, params after one update): each
    learner's update at its config's default shapes, from one seeded
    params tree and one seeded host batch (the same on every device)."""
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, DQNConfig, MARWILConfig, PPOConfig,
                                     SACConfig, core, dqn, ppo, sac)
    from ray_tpu_torch.rllib.podracer import PodracerConfig
    from ray_tpu_torch.rllib.podracer.learner import make_update_fn

    rng = np.random.default_rng(0)
    cases = {}

    def p0(spec, seed):
        return core.params_to_numpy(core.init_mlp_module(torch.Generator().manual_seed(seed),
                                                         spec, "cpu"))

    for loss in ("vtrace", "appo"):
        cfg = PodracerConfig().training(loss=loss)
        batch, params = _rllib_batch(rng, cfg.rollout_fragment_length, cfg.num_envs), p0(cfg.spec, 1)

        def superstep(dev, cfg=cfg, batch=batch, params=params):
            opt, upd = make_update_fn(cfg, cfg.spec)
            p = core.params_from_numpy(params, dev)
            p, _, m = upd(p, opt.init(p), batch)
            return {k: m[k] for k in ("policy_loss", "vf_loss", "entropy")}, p
        cases[f"anakin_{loss}"] = superstep

    pcfg = PPOConfig()
    T, N = pcfg.rollout_fragment_length, pcfg.num_env_runners * pcfg.num_envs_per_env_runner
    rollout = _rllib_batch(rng, T, N)
    rollout["logp"] = rollout.pop("logp_mu")
    rollout["values"] = rng.standard_normal((T, N)).astype(np.float32)
    pspec = core.MLPSpec(4, 2, pcfg.hiddens)
    pparams = p0(pspec, 2)
    perms = torch.stack([torch.randperm(T * N, generator=torch.Generator().manual_seed(3 + e))
                         for e in range(pcfg.num_epochs)])

    def ppo_update(dev):
        opt, upd = ppo.make_ppo_update(pcfg, pspec)
        p = core.params_from_numpy(pparams, dev)
        p, _, m = upd(p, opt.init(p), rollout, perms)
        return dict(m), p
    cases["ppo"] = ppo_update

    def transitions(B, obs_dim, act):
        return {"obs": rng.standard_normal((B, obs_dim)).astype(np.float32), "actions": act,
                "rewards": rng.standard_normal(B).astype(np.float32),
                "next_obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
                "dones": (rng.random(B) < 0.05).astype(np.float32),
                "returns": rng.standard_normal(B).astype(np.float32)}

    dcfg = DQNConfig()
    dspec = core.MLPSpec(4, 2, dcfg.hiddens)
    dparams = core.params_to_numpy(dqn._init_q_net(torch.Generator().manual_seed(4), dspec, "cpu"))
    dbatch = transitions(dcfg.train_batch_size, 4, rng.integers(0, 2, dcfg.train_batch_size))

    def dqn_update(dev):
        opt, upd = dqn.make_dqn_update(dcfg, dspec)
        p = core.params_from_numpy(dparams, dev)
        target = core.tree_map(lambda t: t * 0.9, p)
        p, _, loss, _ = upd(p, target, opt.init(p), dbatch)
        return {"loss": loss}, p
    cases["dqn"] = dqn_update

    scfg = SACConfig()
    sparams = core.params_to_numpy(sac.init_sac_params(torch.Generator().manual_seed(5), 3, 1,
                                                       scfg.hiddens, "cpu"))
    B = scfg.train_batch_size
    sbatch = transitions(B, 3, rng.uniform(-1, 1, (B, 1)).astype(np.float32))
    eps = torch.randn((2, B, 1), generator=torch.Generator().manual_seed(6))

    def sac_update(dev):
        a, c, al, upd = sac.make_sac_update(scfg, 1)
        p = core.params_from_numpy(sparams, dev)
        tq = core.tree_map(torch.clone, {"q1": p["q1"], "q2": p["q2"]})
        la = torch.zeros((), device=dev)
        state = (p, tq, la, {"critic": c.init(tq), "actor": a.init(p["pi"]), "alpha": al.init(la)})
        (p, tq, la, _), closs, aloss = upd(state, sbatch, eps[0], eps[1])
        return {"critic_loss": closs, "actor_loss": aloss, "log_alpha": la}, (p, tq)
    cases["sac"] = sac_update

    for name, cls in (("bc", BCConfig), ("marwil", MARWILConfig), ("cql", CQLConfig)):
        cfg0 = cls()
        spec = core.MLPSpec(4, 2, cfg0.hiddens)
        batch = transitions(cfg0.train_batch_size, 4, rng.integers(0, 2, cfg0.train_batch_size))
        params = (core.params_to_numpy(dqn._init_q_net(torch.Generator().manual_seed(7), spec,
                                                       "cpu"))
                  if name == "cql" else p0(spec, 7))

        def offline(dev, cls=cls, name=name, batch=batch, params=params):
            algo = cls().training(device=str(dev)).build_algo(4, 2)
            p = core.params_from_numpy(params, dev)
            s = algo.optimizer.init(p)
            tb = core.to_tensors(batch, dev)
            if name == "bc":
                p, _, loss = algo._update(p, s, tb["obs"], tb["actions"])
            elif name == "marwil":
                p, _, _, loss, _, _ = algo._update(p, s, torch.ones((), device=dev), tb["obs"],
                                                   tb["actions"], tb["returns"])
            else:
                p, _, loss, _, _ = algo._update(p, core.tree_map(lambda t: t * 0.9, p), s, batch)
            return {"loss": loss}, p
        cases[name] = offline
    return cases


def rllib_hold(name: str, card, cpu) -> str:
    """Fail unless the card's losses are within RLLIB_RTOL (atol
    RLLIB_ATOL) of the CPU's and each updated tensor within RLLIB_RTOL of
    its CPU twin in norm (||card - cpu|| <= RTOL ||cpu|| + ATOL: Adam
    divides each element by its own RMS, so an element whose gradient is
    ~1e-10 turns the two devices' f32 summation orders into a visible step
    while the tensor agrees). Returns the errors as a line."""
    from ray_tpu_torch.rllib import core

    (lk, pk), (lc, pc) = card, cpu
    loss_err = 0.0
    for k in lc:
        a, b = float(lk[k]), float(lc[k])
        fail_unless(abs(a - b) <= RLLIB_RTOL * abs(b) + RLLIB_ATOL,
                    f"rllib learners: {name} {k} on the card {a!r}, on the CPU {b!r}")
        loss_err = max(loss_err, abs(a - b) / max(abs(b), 1e-30))
    worst = max_abs = 0.0
    for a, b in zip(core.tree_leaves(pk), core.tree_leaves(pc)):
        a, b = a.double().cpu(), b.double().cpu()
        err = (a - b).norm().item()
        fail_unless(err <= RLLIB_RTOL * b.norm().item() + RLLIB_ATOL,
                    f"rllib learners: {name} params differ by {err} in norm "
                    f"(||cpu|| {b.norm().item()})")
        worst = max(worst, err / max(b.norm().item(), 1e-30))
        max_abs = max(max_abs, (a - b).abs().max().item())
    return (f"{name}: losses rel err {loss_err:.2e}, params per-tensor rel err {worst:.2e} "
            f"(max abs {max_abs:.2e})")


def rllib_phase(dev, smi: str, kernels: dict) -> dict:
    """The rllib phase: Podracer's Anakin on the card (both losses, 64 and
    4096 envs; bitwise same-seed runs, learning over RLLIB_TICKS ticks, the
    launches and peak memory of a superstep), every learner's update on the
    card against the same update on the CPU, BC trained from a Dataset
    staged on the card, and Sebulba with its learner on the card. Returns
    the kernels' launches on the phase's in-process path (none: RLlib
    reaches no kernel of the port)."""
    import pickle

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import BCConfig, core
    from ray_tpu_torch.rllib.podracer import PodracerConfig
    from ray_tpu_torch.rllib.podracer.anakin import AnakinWorker

    def tag(line):
        print(f"rllib [{smi}]: {line}")

    t_phase = time.perf_counter()
    for wrapper, _, _ in kernels.values():
        wrapper.launches = 0
    # the workers spawned in the phase inherit: deterministic cuBLAS (the
    # Anakin workers), and one compute thread a process for the CPU side
    # (the Sebulba actors' small nets; a thread pool in each of several
    # processes on the host cost 15x in the CPU tests)
    saved = {k: os.environ.get(k) for k in ("CUBLAS_WORKSPACE_CONFIG", "OMP_NUM_THREADS")}
    os.environ.update(CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="1")
    try:
        # ---- 1. Anakin on the card, through PodracerConfig.build()
        rt.init(num_cpus=2, max_workers=2)
        try:
            fail_unless(rt.cluster_resources().get("GPU") == 1.0,
                        f"rllib: the runtime sees {rt.cluster_resources().get('GPU')} GPUs")
            builds = []  # seconds from build() to the worker's first tick
            for loss in ("vtrace", "appo"):
                rows = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    drv = _anakin_config(loss, RLLIB_ENVS[0], seed=3).build()
                    builds.append(time.perf_counter() - t0)
                    try:
                        fail_unless(drv.device == "cuda:0",
                                    f"rllib: the Anakin worker runs on {drv.device}")
                        rows.append(drv.train(num_ticks=4))
                        if len(rows) == 2:
                            steady = drv.train(num_ticks=20)
                    finally:
                        drv.stop()
                fail_unless(np.array_equal(rows[0]["metrics_rows"], rows[1]["metrics_rows"]),
                            f"rllib: two same-seed 4-tick Anakin runs ({loss}, "
                            f"{RLLIB_ENVS[0]} envs) differ")
                tag(f"anakin {loss}, {RLLIB_ENVS[0]} envs on {rows[1]['device']}: two same-seed "
                    f"4-tick runs bitwise equal (4 ticks in {rows[1]['time_s']:.2f} s, the "
                    f"first paying for the worker's first kernels); then "
                    f"{steady['steps_per_sec']:.0f} env steps/s, "
                    f"{20 / steady['time_s']:.1f} supersteps/s over 20 ticks")
                t0 = time.perf_counter()
                drv = _anakin_config(loss, RLLIB_ENVS[1], seed=0).build()
                builds.append(time.perf_counter() - t0)
                try:
                    big = drv.train(num_ticks=RLLIB_TICKS)
                    steady = drv.train(num_ticks=10)
                finally:
                    drv.stop()
                traj = big["reward_trajectory"]
                first, last = np.nanmean(traj[:5]), np.nanmean(traj[-5:])
                fail_unless(last > first, f"rllib: Anakin {loss} at {RLLIB_ENVS[1]} envs did "
                                          f"not learn: first 5 ticks {first}, last 5 {last}")
                tag(f"anakin {loss}, {RLLIB_ENVS[1]} envs ({RLLIB_ENVS[1] * 16} env steps a "
                    f"superstep): {steady['steps_per_sec']:.0f} env steps/s, "
                    f"{10 / steady['time_s']:.2f} supersteps/s over 10 ticks after "
                    f"{RLLIB_TICKS}; mean return over the {RLLIB_TICKS}, first 5 ticks "
                    f"{first:.2f}, last 5 {last:.2f}; trajectory "
                    + " ".join(f"{v:.1f}" for v in traj))
        finally:
            rt.shutdown()
        tag(f"anakin runs {time.perf_counter() - t_phase:.1f} s, of which {sum(builds):.1f} s in "
            f"{len(builds)} builds (a worker process, its CUDA start, the compiled DAG): "
            + " ".join(f"{b:.1f}" for b in builds))

        # a superstep in this process: its launches, and the memory the
        # worker's carry and a superstep take (above what the process held)
        for n_env in RLLIB_ENVS:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            w = AnakinWorker(pickle.dumps(_anakin_config("vtrace", n_env).training(
                device=str(dev))))
            for _ in range(3):
                w._superstep()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                w._superstep()
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            launches = sum(1 for e in prof.events() if e.name in (
                "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
            busy_us = sum(e.self_device_time_total for e in prof.key_averages())
            t0 = time.perf_counter()
            for _ in range(10):
                w._superstep()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 10 * 1e3
            tag(f"anakin superstep in this process, {n_env} envs: {ms:.2f} ms "
                f"({n_env * 16 / ms * 1e3:.0f} env steps/s), {launches} kernel launches, device "
                f"busy {busy_us / 1e3:.2f} ms of it (torch.profiler), peak memory "
                f"{peak / 2**20:.1f} MiB")
            del w
        torch.cuda.empty_cache()

        # ---- 2. every learner's update on the card against the CPU
        lines = []
        for name, run in rllib_learner_cases().items():
            card, cpu = run(dev), run(torch.device("cpu"))
            lines.append(rllib_hold(name, card, cpu))
            ms = time_ms(lambda: run(dev), 5)
            lines[-1] += f", update {ms:.2f} ms on the card"
        for line in lines:
            tag(f"learner {line}")
        tag(f"learners done at {time.perf_counter() - t_phase:.1f} s")

        # ---- 3. BC trained from a Dataset staged on the card
        rt.init(num_cpus=2, max_workers=2)
        try:
            import ray_tpu_torch.data as rdata

            rng = np.random.default_rng(0)
            obs = rng.normal(size=(2000, 4)).astype(np.float32)
            acts = (obs[:, 0] + obs[:, 1] > 0).astype(np.int64)
            ds = rdata.from_items([{"obs": o, "actions": a} for o, a in zip(obs, acts)])
            algo = BCConfig().training(lr=3e-3).build_algo(obs_dim=4, num_actions=2)
            fail_unless(all(t.is_cuda for t in core.tree_leaves(algo.params)),
                        "rllib: BC's params are not on the card")
            t0 = time.perf_counter()
            res = algo.train_on_dataset(ds, epochs=25)
            bc_s = time.perf_counter() - t0
            test = rng.normal(size=(200, 4)).astype(np.float32)
            acc = np.mean([algo.compute_single_action(o) == int(o[0] + o[1] > 0) for o in test])
            fail_unless(res["num_samples_trained"] == 25 * 2000 and res["loss"] < 0.25
                        and acc > 0.9, f"rllib: BC on the card: {res}, accuracy {acc}")
            tag(f"BC from a Dataset staged on the card (iter_batches device_put): 25 epochs of "
                f"2000 rows in {bc_s:.2f} s ({25 * 2000 / bc_s:.0f} rows/s), loss "
                f"{res['loss']:.4f}, accuracy {acc:.3f}")
        finally:
            rt.shutdown()

        tag(f"BC done at {time.perf_counter() - t_phase:.1f} s")
        # ---- 4. Sebulba: the learner on the card, the actors on CPU bundles
        rt.init(num_cpus=4, max_workers=4)
        try:
            cfg = (PodracerConfig().environment("CartPole-v1")
                   .podracer(mode="sebulba", namespace="chip_smoke")
                   .env_runners(num_actors=2, envs_per_actor=16).debugging(seed=7))
            drv = cfg.build()
            try:
                fail_unless(drv.layout["learner_bundle"] == {"GPU": 1}
                            and drv.layout["actor_bundle"] == {"CPU": 1},
                            f"rllib: Sebulba's layout on one card is {drv.layout}")
                traj = rt.get(drv._sample.remote(drv._cfg_blob, 0, 0, None)[0], timeout=300)
                handoff = cfg.num_actors * sum(a.nbytes for a in traj.values()
                                               if isinstance(a, np.ndarray))
                drv.train(num_rounds=1)  # the learner's first round pays its CUDA start
                res = drv.train(num_rounds=10)
                # where a round's time goes: one fragment, then one learner
                # update on it, each waited for alone
                t0 = time.perf_counter()
                tref, _ = drv._sample.remote(drv._cfg_blob, 0, 11, drv._carries[0])
                rt.get(tref, timeout=300)
                act_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                rt.get(drv._learn.remote(drv._cfg_blob, drv._state_ref, tref, tref)[1],
                       timeout=300)
                learn_s = time.perf_counter() - t0
            finally:
                drv.stop()
            fail_unless(res["learner_metrics"]["device"] == "cuda:0",
                        f"rllib: Sebulba's learner ran on {res['learner_metrics']['device']}")
            fail_unless(res["learner_step"] == 11 and np.isfinite(res["learner_metrics"]["vf_loss"]),
                        f"rllib: Sebulba: {res['learner_steps']} {res['learner_metrics']}")
            tag(f"sebulba, 2 actors x 16 envs on CPU bundles, the learner on "
                f"{res['learner_metrics']['device']}: {10 / res['time_s']:.2f} rounds/s, "
                f"{res['steps_per_sec']:.0f} env steps/s, {handoff} bytes handed off a round; "
                f"one fragment {act_s * 1e3:.1f} ms and one learner task {learn_s * 1e3:.1f} ms "
                f"as a task round trip each")
        finally:
            rt.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = {name: wrapper.launches for name, (wrapper, _, _) in kernels.items()}
    fail_unless(not any(counts.values()), f"rllib: a kernel of the port was launched: {counts}")
    left = _running(_worker_pids())
    fail_unless(not left, f"rllib: worker processes left after shutdown: {left}")
    tag(f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"rllib": counts}


def rllib_nccl_phase(smi: str) -> None:
    """``--mesh-nccl`` (four cards): Anakin over ``anakin_num_devices`` 4
    (one env shard and one replica a card, the grads averaged over an NCCL
    group of the four) and Sebulba at SLICE (2 actors and the learner, one
    card each), each through its driver, and each's update held against
    one card's update on the same batch (V-trace: the mean of the shards'
    means is the global mean)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import core
    from ray_tpu_torch.rllib.podracer import PodracerConfig
    from ray_tpu_torch.rllib.podracer.learner import (make_sharded_update, make_update_fn,
                                                      replicate, shard_batch)
    from ray_tpu_torch.util.collective.collective_group.nccl_group import NcclGroup

    def tag(line):
        print(f"rllib-nccl [{smi}]: {line}")

    cfg = PodracerConfig()
    batch = _rllib_batch(np.random.default_rng(0), cfg.rollout_fragment_length, cfg.num_envs)
    params = core.params_to_numpy(core.init_mlp_module(torch.Generator().manual_seed(1),
                                                       cfg.spec, "cpu"))
    one = torch.device("cuda", 0)
    opt, upd = make_update_fn(cfg, cfg.spec)
    p = core.params_from_numpy(params, one)
    ref, _, ref_m = upd(p, opt.init(p), batch)
    devs = [torch.device("cuda", i) for i in range(4)]
    _, supd = make_sharded_update(cfg, cfg.spec, NcclGroup(4, 0, "rllib-nccl", devices=devs))
    p = core.params_from_numpy(params, one)
    ps, _, m = supd(replicate(p, devs), replicate(opt.init(p), devs), shard_batch(batch, devs))
    for i in range(4):
        line = rllib_hold(f"sharded update, replica on card {i}",
                          ({k: m[k] for k in ref_m}, ps[i]), (ref_m, ref))
    tag(f"{line}; 4 cards against card 0 alone")

    rt.init(num_cpus=8, max_workers=8)
    try:
        drv = PodracerConfig().environment("CartPole-v1").podracer(
            mode="anakin", num_envs=4096, anakin_num_devices=4).build()
        try:
            r = drv.train(num_ticks=10)
        finally:
            drv.stop()
        fail_unless(r["device"] == "cuda:0" and r["updates"] == 10 and np.isfinite(r["vf_loss"]),
                    f"rllib-nccl: Anakin over 4 cards: {r['device']} {r['updates']}")
        tag(f"anakin over 4 cards, 4096 envs (1024 a card): {r['steps_per_sec']:.0f} env steps/s")
        scfg = (PodracerConfig().environment("CartPole-v1")
                .podracer(mode="sebulba", namespace="rllib-nccl")
                .env_runners(num_actors=2, envs_per_actor=32).debugging(seed=7))
        drv = scfg.build()
        try:
            fail_unless(drv.layout["strategy"] == "SLICE" and drv.layout["actor_device"] == "cuda",
                        f"rllib-nccl: Sebulba's layout on 4 cards is {drv.layout}")
            res = drv.train(num_rounds=5)
            trajs = [dict(batch, behavior_version=0)]
            state0 = {"params": params, "opt_state": core.params_to_numpy(
                opt.init(core.params_from_numpy(params, "cpu"))), "step": 0, "version": 0}
            new_state, lm = rt.get(drv._learn.remote(drv._cfg_blob, state0, *trajs), timeout=300)
        finally:
            drv.stop()
        fail_unless(res["learner_metrics"]["device"] == "cuda:0" and lm["device"] == "cuda:0",
                    f"rllib-nccl: Sebulba's learner ran on {lm['device']}")
        line = rllib_hold("sebulba learner", ({k: lm[k] for k in ref_m},
                                              core.params_from_numpy(new_state["params"], "cpu")),
                          (ref_m, ref))
        tag(f"sebulba at SLICE (2 actors and the learner, a card each): "
            f"{5 / res['time_s']:.2f} rounds/s; {line}, against card 0's update")
    finally:
        rt.shutdown()


def moe_llama_widths():
    from ray_tpu_torch.models import moe_llama

    return moe_llama.MIXTRAL_8X7B


def mesh_nccl_phase(cfg, dev, smi: str, kernel_names) -> None:
    """``--mesh-nccl`` (four cards): LLAMA_BENCH at full width and depth over
    an NCCL group of one rank a card, at (fsdp 2, model 2) and at (seq 2,
    model 2) with ring attention, each 3 steps held to the one-device steps
    on card 0, as ``mesh_shared`` and ``mesh_ring`` are on one card; then
    the op-level paths (Ulysses and the ring op at seq 4, 1F1B and GPipe
    over 4 stages of 4 blocks, the expert FFN at expert 4) over NCCL, each
    rank on its card held against one rank's result as on one card."""
    def tag(line):
        print(f"mesh-nccl [{smi}]: {line}")

    tokens, _ = bench_inputs(cfg)
    tcfg = dataclasses.replace(cfg, remat=True, attention_impl="flash", ce_impl="fused")
    state, step = trainer_setup(cfg, dev)
    batch = {"tokens": tokens.to(dev)}
    here = []
    for _ in range(MESH_STEPS):
        state, m = step(state, batch)
        here.append(m["loss"].item())
    del state, step, batch, m
    torch.cuda.empty_cache()
    tag(f"one-device losses on card 0: {' '.join(repr(v) for v in here)}")
    rows = tokens.shape[0] * (tokens.shape[1] - 1)
    chunks = -(-rows // 2 // (256 * 2**20 // (cfg.vocab_size * 2) // 128 * 128))
    L = cfg.n_layers
    for name, shape, c in (("fsdp 2, model 2", {"fsdp": 2, "model": 2}, tcfg),
                           ("seq 2, model 2, ring", {"seq": 2, "model": 2},
                            dataclasses.replace(tcfg, attention_impl="ring"))):
        payload = {"cfg": c, "tokens": tokens, "steps": MESH_STEPS, "backend": "nccl",
                   "kernel_names": list(kernel_names), "mesh": shape}
        t0 = time.time()
        outs = run_ranks(mesh_train_rank, 4, payload, timeout_s=240)
        wall = time.time() - t0
        for r, o in enumerate(outs):
            # rank = seq index * 2 + model index on the ring's mesh: r // 2 past blocks
            hops = r // 2 + 1 if "seq" in shape else 1
            want = {"flash_attention_fwd": 2 * L * hops, "flash_attention_bwd_dkv": L * hops,
                    "flash_attention_bwd_dq": L * hops, "fused_ce_fwd": 1,
                    "fused_ce_bwd_dlog": chunks, "fused_ce_bwd_dx": chunks,
                    "fused_ce_bwd_dw": chunks, "fused_adamw": llama_leaves(cfg)}
            fail_unless([x["loss"] for x in o["rows"]] == [x["loss"] for x in outs[0]["rows"]],
                        f"mesh-nccl {name}: rank {r}'s losses differ from rank 0's")
            for x in o["rows"]:
                fail_unless(x["launches"] == want,
                            f"mesh-nccl {name}: rank {r} launched {x['launches']}, want {want}")
            tag(f"{name} rank {r} (card {r}): launches per step {o['rows'][-1]['launches']}, "
                f"staged {o['rows'][-1]['staged']} bytes, step ms "
                f"{' '.join(f'{x['ms']:.2f}' for x in o['rows'])}, peak {o['peak_gib']:.2f} GiB")
        losses = [x["loss"] for x in outs[0]["rows"]]
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, here)]
        fail_unless(max(errs) <= MESH_LOSS_RTOL,
                    f"mesh-nccl {name}: loss relative err {max(errs)} > {MESH_LOSS_RTOL}")
        tag(f"{name}: 4 NCCL ranks, one a card, {L} layers; losses "
            f"{' '.join(repr(v) for v in losses)} against one device's, max relative err "
            f"{max(errs):.3e}; {wall:.1f} s with the ranks' start")
    t0 = time.time()
    counted = mesh_op_paths(cfg, kernel_names, tag, world=4, backend="nccl", timeout_s=240)
    tag(f"op-level paths over NCCL: {time.time() - t0:.1f} s with the ranks' starts; launches "
        f"summed over the ranks {counted}")


def main(argv) -> int:
    t_main = time.perf_counter()
    profile = argv == ["--profile"]
    nccl = argv == ["--mesh-nccl"]
    if argv and not (profile or nccl):
        print(f"usage: {sys.argv[0]} [--profile | --mesh-nccl]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import parallel
    from ray_tpu_torch._native import build
    from ray_tpu_torch.llm import GenRequest, LlamaEngine, apply_lora, load_lora_adapter
    from ray_tpu_torch.models import llama, moe_llama, vit
    from ray_tpu_torch.ops import cuda_adamw, cuda_attention, cuda_ce
    from ray_tpu_torch.ops import moe as moe_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    fail_unless(kind == CARD, f"peak rates are known for {CARD!r} only, not {kind!r}")
    peak_flops, peak_bw = PEAK_FLOPS, PEAK_BW
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks "
          f"{peak_flops / 1e12:.0f} TFLOP/s bf16, {peak_bw / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)")
    kname = "?"
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            # the readable part of the mangled name, with the head dim if any
            m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
            kname = f"{m.group(1)}<{m.group(2)}>" if m and m.group(2) else (m.group(1) if m else "?")
        elif "registers" in line or "spill" in line or "Performance" in line:
            print(f"  ptxas: {kname}: {line.strip()}")

    if nccl:  # the mesh training paths over NCCL, one rank a card, and nothing else
        n_cards = torch.cuda.device_count()
        fail_unless(n_cards >= 4, f"--mesh-nccl needs 4 cards, found {n_cards}")
        print("cards: " + " | ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()))
        mesh_nccl_phase(dataclasses.replace(llama.LLAMA_BENCH, param_dtype=torch.bfloat16), dev,
                        smi, ["flash_attention_fwd", "flash_attention_bwd_dkv",
                              "flash_attention_bwd_dq", "fused_ce_fwd", "fused_ce_bwd_dlog",
                              "fused_ce_bwd_dx", "fused_ce_bwd_dw", "fused_adamw"])
        rllib_nccl_phase(smi)
        print(f"wall [{smi}]: {time.perf_counter() - t_main:.1f} s, the kernels' build included")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": n_cards}}))
        return 0

    # ---------------- graftlint phase (started here, read before the runtime phase) ----------
    lint = graftlint_start()

    fa = cuda_attention.flash_attention_fwd
    ce = cuda_ce.fused_ce_fwd
    # name -> (wrapper with the launch counter, source, TPU kernel replaced)
    kernels = {
        "flash_attention_fwd": (fa, "flash_attention_fwd.cu", "ray_tpu/ops/pallas_attention.py:157"),
        "flash_attention_bwd_dkv": (cuda_attention.flash_attention_bwd_dkv,
                                    "flash_attention_bwd.cu", "ray_tpu/ops/pallas_attention.py:336"),
        "flash_attention_bwd_dq": (cuda_attention.flash_attention_bwd_dq,
                                   "flash_attention_bwd.cu", "ray_tpu/ops/pallas_attention.py:368"),
        "fused_ce_fwd": (ce, "fused_ce_fwd.cu", "ray_tpu/ops/pallas_ce.py:109"),
        "fused_ce_bwd_dlog": (cuda_ce.fused_ce_bwd_dlog, "fused_ce_bwd.cu",
                              "ray_tpu/ops/pallas_ce.py:208"),
        "fused_ce_bwd_dx": (cuda_ce.fused_ce_bwd_dx, "fused_ce_bwd.cu", "ray_tpu/ops/pallas_ce.py:208"),
        "fused_ce_bwd_dw": (cuda_ce.fused_ce_bwd_dw, "fused_ce_bwd.cu", "ray_tpu/ops/pallas_ce.py:229"),
        # optax's chain, which XLA fuses: no TPU kernel
        "fused_adamw": (cuda_adamw.fused_adamw, "fused_adamw.cu", None),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {}

    # ---------------- kernel phases ----------------
    def attn_phase(label, B, S, T, H, KVH, hd, causal):
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, KVH, hd, generator=gen, device=dev).bfloat16()
        o, lse = fa(q, k, v, causal=causal)
        o2, lse2 = fa(q, k, v, causal=causal)
        fail_unless(torch.equal(o, o2) and torch.equal(lse, lse2),
                    f"{label}: two runs of flash_attention_fwd gave different o or lse")
        del o2, lse2
        qf, kf, vf = q.float(), k.float(), v.float()
        ro, rlse = cuda_attention.flash_attention_plain(qf, kf, vf, causal=causal)
        err = (o.float() - ro).abs().max().item()
        err_row = row_rel_err(o, ro)
        err_lse = (lse - rlse).abs().max().item()
        fail_unless(math.isfinite(err) and err <= ATTN_O_ATOL,
                    f"{label}: o max abs err {err} > {ATTN_O_ATOL}")
        fail_unless(err_row <= ATTN_ROW_RTOL,
                    f"{label}: o max row-relative err {err_row} > {ATTN_ROW_RTOL}")
        fail_unless(err_lse <= STAT_ATOL, f"{label}: lse max abs err {err_lse} > {STAT_ATOL}")
        del ro, rlse
        ms = time_ms(lambda: fa(q, k, v, causal=causal), 20)
        plain_ms = time_ms(lambda: cuda_attention.flash_attention_plain(qf, kf, vf, causal=causal),
                           3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
        b_ms, b_by = bound(4.0 * hd * pairs * B * H, nbytes(q, k, v, o, lse),
                           peak_flops, peak_bw)
        print(f"kernel flash_attention_fwd [{label}] B{B} S{S} T{T} H{H} KVH{KVH} hd{hd} "
              f"causal={causal}: max_abs_err o {err:.3e} lse {err_lse:.3e}, "
              f"o max row-relative err {err_row:.3e}, two runs bit-identical; "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) -> {b_ms / ms:.1%} of bound")
        fwd = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)

        # backward: dK/dV and dQ kernels from the forward's o and lse
        do = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
        delta = cuda_attention.attention_delta(o, do)
        dkv = cuda_attention.flash_attention_bwd_dkv
        dqk = cuda_attention.flash_attention_bwd_dq
        dk, dv = dkv(q, k, v, do, lse, delta, causal=causal)
        dq = dqk(q, k, v, do, lse, delta, causal=causal)
        dk2, dv2 = dkv(q, k, v, do, lse, delta, causal=causal)
        dq2 = dqk(q, k, v, do, lse, delta, causal=causal)
        fail_unless(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                    f"{label}: two runs of flash_attention_bwd_dkv gave different dk or dv")
        fail_unless(torch.equal(dq, dq2), f"{label}: two runs of flash_attention_bwd_dq gave "
                                          "different dq")
        del dk2, dv2, dq2
        dof = do.float()
        plain = dict(causal=causal)
        rk, rv = cuda_attention.flash_attention_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, **plain)
        rq = cuda_attention.flash_attention_bwd_dq_plain(qf, kf, vf, dof, lse, delta, **plain)
        errs = {n: (row_rel_err(a, r, 1e-3), (a.float() - r).abs().max().item())
                for n, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        for n, (e, a) in errs.items():
            fail_unless(math.isfinite(a) and e <= GRAD_ROW_RTOL,
                        f"{label}: {n} max row-relative err {e} > {GRAD_ROW_RTOL}")
        del rk, rv, rq, dq, dk, dv
        ms_kv = time_ms(lambda: dkv(q, k, v, do, lse, delta, causal=causal), 20)
        ms_q = time_ms(lambda: dqk(q, k, v, do, lse, delta, causal=causal), 20)
        plain_kv = time_ms(lambda: cuda_attention.flash_attention_bwd_dkv_plain(
            qf, kf, vf, dof, lse, delta, **plain), 3, warmup=1)
        plain_q = time_ms(lambda: cuda_attention.flash_attention_bwd_dq_plain(
            qf, kf, vf, dof, lse, delta, **plain), 3, warmup=1)
        del qf, kf, vf, dof
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                          20)
        del out
        kv_out = nbytes(k, v)                      # dk, dv: k's and v's sizes
        b_kv, by_kv = bound(8.0 * hd * pairs * B * H,
                            nbytes(q, k, v, do, lse, delta) + kv_out, peak_flops, peak_bw)
        b_q, by_q = bound(6.0 * hd * pairs * B * H,
                          nbytes(q, k, v, do, lse, delta) + nbytes(q), peak_flops, peak_bw)
        print(f"kernel flash_attention_bwd [{label}]: row-relative err "
              + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
              + f"; two runs bit-identical; dkv {ms_kv:.4f} ms (plain {plain_kv:.4f} ms, bound "
              f"{b_kv:.4f} ms {by_kv} -> {b_kv / ms_kv:.1%}), dq {ms_q:.4f} ms (plain "
              f"{plain_q:.4f} ms, bound {b_q:.4f} ms {by_q} -> {b_q / ms_q:.1%}); dkv + dq "
              f"{ms_kv + ms_q:.4f} ms against the sdpa backward {lib_bwd:.4f} ms (dq, dk, dv "
              f"together): {(ms_kv + ms_q) / lib_bwd:.2f}x")
        return fwd, (dict(max_abs_err=max(errs["dk"][1], errs["dv"][1]), ms=ms_kv,
                          plain_ms=plain_kv, bound_ms=b_kv, bound_by=by_kv, library_ms=lib_bwd),
                     dict(max_abs_err=errs["dq"][1], ms=ms_q, plain_ms=plain_q, bound_ms=b_q,
                          bound_by=by_q, library_ms=lib_bwd))

    (record["flash_attention_fwd"], (record["flash_attention_bwd_dkv"],
                                     record["flash_attention_bwd_dq"])) = attn_phase(
        "main-path shape", 8, 2048, 2048, 16, 8, 128, True)
    attn_phase("non-causal, T != S", 8, 2048, 3000, 16, 8, 128, False)
    attn_phase("MoE training shape (Mixtral: H 32, KVH 8)", 4, 2048, 2048, 32, 8, 128, True)
    torch.cuda.empty_cache()

    N, D, V = 8 * 2048, 2048, 32000
    x = torch.randn(N, D, generator=gen, device=dev).bfloat16()
    w = (torch.randn(D, V, generator=gen, device=dev) / math.sqrt(D)).bfloat16()
    t = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    lse, tgt = ce(x, w, t)
    xf, wf = x.float(), w.float()
    rl, rt = cuda_ce.fused_ce_fwd_plain(xf, wf, t)
    err = max((lse - rl).abs().max().item(), (tgt - rt).abs().max().item())
    fail_unless(math.isfinite(err) and err <= STAT_ATOL,
                f"fused_ce_fwd: max abs err {err} > {STAT_ATOL}")
    del rl, rt
    ms = time_ms(lambda: ce(x, w, t), 50)
    plain_ms = time_ms(lambda: cuda_ce.fused_ce_fwd_plain(xf, wf, t), 3, warmup=1)
    tl = t.long()
    lib_ms = time_ms(lambda: F.cross_entropy(x @ w, tl, reduction="none"), 50)
    b_ms, b_by = bound(2.0 * N * D * V, nbytes(x, w, t, lse, tgt), peak_flops, peak_bw)
    print(f"kernel fused_ce_fwd N{N} D{D} V{V}: max_abs_err {err:.3e}; {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, F.cross_entropy(x@w) {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) -> {b_ms / ms:.1%} of bound")
    record["fused_ce_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms)

    # backward: per chunk of rows the dlog, dx and dW kernels; g = 1/N per
    # row as masked_mean gives. Each kernel alone on the first chunk, then
    # the whole backward (fused_ce_bwd, all chunks) against the plain one.
    g = torch.full((N,), 1.0 / N, device=dev)
    rows = cuda_ce.chunk_rows(N, V, x.element_size())
    n_chunks = -(-N // rows)
    k_dlog, k_dx, k_dw = cuda_ce.fused_ce_bwd_dlog, cuda_ce.fused_ce_bwd_dx, cuda_ce.fused_ce_bwd_dw
    xc, tc, lc, gc = x[:rows], t[:rows], lse[:rows], g[:rows]
    xcf = xc.float()
    dlog = k_dlog(xc, w, tc, lc, gc)
    ref = cuda_ce.fused_ce_bwd_dlog_plain(xcf, wf, tc, lc, gc)
    err_l, abs_l = row_rel_err(dlog, ref, 1e-3), (dlog.float() - ref).abs().max().item()
    del ref
    dlogf = dlog.float()
    dxc = k_dx(dlog, w)
    ref = cuda_ce.fused_ce_bwd_dx_plain(dlogf, wf)
    err_cx = row_rel_err(dxc, ref, 1e-3)
    del ref
    acc = k_dw(xc, dlog, None, last=False)
    ref = cuda_ce.fused_ce_bwd_dw_plain(xcf, dlogf, None, last=False)
    err_cw = row_rel_err(acc, ref, 1e-3)
    del ref, dlogf
    for n, e in (("dlog", err_l), ("dx (one chunk)", err_cx), ("dW sum (one chunk)", err_cw)):
        fail_unless(math.isfinite(e) and e <= GRAD_ROW_RTOL,
                    f"fused_ce_bwd: {n} max row-relative err {e} > {GRAD_ROW_RTOL}")
    dx, dw = cuda_ce.fused_ce_bwd(x, w, t, lse, g)
    rx, rw = cuda_ce.fused_ce_bwd_plain(xf, wf, t, lse, g)
    err_x, abs_x = row_rel_err(dx, rx, 1e-3), (dx.float() - rx).abs().max().item()
    err_w, abs_w = row_rel_err(dw, rw, 1e-3), (dw.float() - rw).abs().max().item()
    del rx, rw
    for n, e, a in (("dx", err_x, abs_x), ("dW", err_w, abs_w)):
        fail_unless(math.isfinite(a) and e <= GRAD_ROW_RTOL,
                    f"fused_ce_bwd: {n} max row-relative err {e} > {GRAD_ROW_RTOL}")
    dx2, dw2 = cuda_ce.fused_ce_bwd(x, w, t, lse, g)
    fail_unless(torch.equal(dx, dx2) and torch.equal(dw, dw2),
                "fused_ce_bwd: two runs gave different dx or dW")
    del dx2, dw2
    print(f"digests: fused_ce_fwd lse+tgt {digest(lse, tgt)}, fused_ce_bwd_dlog (first chunk) "
          f"{digest(dlog)}, fused_ce_bwd dx {digest(dx)} dW {digest(dw)}")
    ms_l = time_ms(lambda: k_dlog(xc, w, tc, lc, gc, out=dlog), 10)
    ms_x = time_ms(lambda: k_dx(dlog, w, out=dxc), 10)
    ms_w = time_ms(lambda: k_dw(xc, dlog, acc, last=False), 10)   # a middle chunk
    ms_bwd = time_ms(lambda: cuda_ce.fused_ce_bwd(x, w, t, lse, g), 5, warmup=1)
    plain_l = time_ms(lambda: cuda_ce.fused_ce_bwd_dlog_plain(xcf, wf, tc, lc, gc), 3, warmup=1)
    dlogf = dlog.float()
    plain_x = time_ms(lambda: cuda_ce.fused_ce_bwd_dx_plain(dlogf, wf), 3, warmup=1)
    plain_w = time_ms(lambda: cuda_ce.fused_ce_bwd_dw_plain(xcf, dlogf, None, last=False), 3,
                      warmup=1)
    del dlogf, xcf
    plain_bwd = time_ms(lambda: cuda_ce.fused_ce_bwd_plain(xf, wf, t, lse, g), 3, warmup=1)
    del xf, wf
    # one library call for each product on the same chunk operands: dx is
    # dlog w^T in bf16 (f32 sums), the dW step adds x_c^T dlog into the f32
    # sum; each result is held against the kernel's first
    lib_sum = acc.clone()
    lib_dx = torch.matmul(dlog, w.T)
    fail_unless(row_rel_err(lib_dx, k_dx(dlog, w), 1e-3) <= GRAD_ROW_RTOL,
                "fused_ce_bwd: torch.matmul(dlog, w.T) disagrees with the dx kernel")
    lib_w = torch.addmm(lib_sum, xc.T, dlog, out_dtype=torch.float32)
    fail_unless(row_rel_err(lib_w, k_dw(xc, dlog, lib_sum.clone(), last=False), 1e-3)
                <= GRAD_ROW_RTOL,
                "fused_ce_bwd: torch.addmm(sum, x_c.T, dlog) disagrees with the dW kernel")
    del lib_dx, lib_w
    lib_x = time_ms(lambda: torch.matmul(dlog, w.T), 10)
    lib_w = time_ms(lambda: torch.addmm(lib_sum, xc.T, dlog, out_dtype=torch.float32), 10)
    del lib_sum
    torch.cuda.empty_cache()
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    lib_loss = F.cross_entropy(xr @ wr, tl, reduction="none")
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_loss, (xr, wr), g, retain_graph=True), 5,
                      warmup=1)
    del lib_loss
    chunk_ops = 2.0 * rows * D * V
    b_l, by_l = bound(chunk_ops, nbytes(xc, w, tc, lc, gc, dlog), peak_flops, peak_bw)
    b_x, by_x = bound(chunk_ops, nbytes(dlog, w, dxc), peak_flops, peak_bw)
    b_w, by_w = bound(chunk_ops, nbytes(xc, dlog) + 2 * nbytes(acc), peak_flops, peak_bw)
    b_bwd, by_bwd = bound(6.0 * N * D * V, nbytes(x, w, t, lse, g, dx, dw), peak_flops, peak_bw)
    print(f"kernel fused_ce_bwd N{N} D{D} V{V}, {n_chunks} chunks of {rows} rows: row-relative "
          f"err dlog {err_l:.3e} (one chunk), dx {err_x:.3e} dW {err_w:.3e} (whole); two runs "
          f"bit-identical; per chunk: dlog {ms_l:.4f} ms (plain {plain_l:.4f} ms, bound "
          f"{b_l:.4f} ms {by_l} -> {b_l / ms_l:.1%}), dx {ms_x:.4f} ms (plain {plain_x:.4f} ms, "
          f"bound {b_x:.4f} ms {by_x} -> {b_x / ms_x:.1%}; torch.matmul(dlog, w.T) "
          f"{lib_x:.4f} ms), dW {ms_w:.4f} ms with the f32 sum read and written (plain "
          f"{plain_w:.4f} ms, bound {b_w:.4f} ms {by_w} -> {b_w / ms_w:.1%}; "
          f"torch.addmm(sum, x_c.T, dlog, out_dtype=f32) {lib_w:.4f} ms)")
    print(f"kernel fused_ce_bwd whole backward (dlog + dx + dW, {n_chunks} chunks): "
          f"{ms_bwd:.4f} ms (sum of per-chunk launches {n_chunks * (ms_l + ms_x + ms_w):.4f} ms), "
          f"plain {plain_bwd:.4f} ms, bound {b_bwd:.4f} ms ({by_bwd}, 6 N D V) -> "
          f"{b_bwd / ms_bwd:.1%} of bound; F.cross_entropy(x@w) backward {lib_bwd:.4f} ms "
          f"(dx, dW together)")
    record["fused_ce_bwd_dlog"] = dict(max_abs_err=abs_l, ms=ms_l, plain_ms=plain_l, bound_ms=b_l,
                                       bound_by=by_l, library_ms=None)
    record["fused_ce_bwd_dx"] = dict(max_abs_err=abs_x, ms=ms_x, plain_ms=plain_x, bound_ms=b_x,
                                     bound_by=by_x, library_ms=lib_x)
    record["fused_ce_bwd_dw"] = dict(max_abs_err=abs_w, ms=ms_w, plain_ms=plain_w, bound_ms=b_w,
                                     bound_by=by_w, library_ms=lib_w)
    del x, w, t, tl, lse, tgt, g, dx, dw, xr, wr, dlog, dxc, acc, xc, tc, lc, gc
    torch.cuda.empty_cache()
    record["fused_adamw"] = adamw_phase(dev, gen, peak_flops, peak_bw)

    launches = {name: {} for name in kernels}

    def zero():
        for wrapper, _, _ in kernels.values():
            wrapper.launches = 0

    def count(path):
        for name, (wrapper, _, _) in kernels.items():
            launches[name][path] = wrapper.launches

    # ---------------- scoring phase (main path) ----------------
    cfg = dataclasses.replace(llama.LLAMA_BENCH, param_dtype=torch.bfloat16)
    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    params = llama.init_params(gen, cfg, dev)
    print(f"LLAMA_BENCH: {llama.param_count(cfg) / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, dim {cfg.dim}, bf16")
    tokens = torch.randint(0, cfg.vocab_size, (8, 2049), generator=gen, device=dev)

    zero()
    times, losses = [], []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(llama.loss_fn(params, {"tokens": tokens}, fast).item())
            times.append(time.perf_counter() - t0)
    count("scoring")
    fail_unless(fa.launches > 0 and ce.launches > 0,
                f"scoring launched flash {fa.launches}, ce {ce.launches} times")
    fail_unless(all(math.isfinite(v) for v in losses), f"scoring loss not finite: {losses}")
    step = statistics.median(times)
    print(f"scoring: loss {losses[-1]:.5f}; {step * 1e3:.2f} ms per 8x2048 batch "
          f"(median of 3), {8 * 2048 / step:.0f} tokens/s; launches flash "
          f"{fa.launches} ce {ce.launches}")

    small = {"tokens": tokens[:2, :513]}
    inputs, targets, _ = llama.unpack_batch(small)
    with torch.inference_mode():
        lf = llama.loss_fn(params, small, fast).item()
        lx = llama.loss_fn(params, small, cfg).item()
        hf = llama.forward_hidden(params, inputs, fast)
        hx = llama.forward_hidden(params, inputs, cfg)
        head = params["lm_head"].to(cfg.dtype)
        nll_f = cuda_ce.fused_cross_entropy(hf.reshape(-1, cfg.dim), head, targets.reshape(-1))
        nll_x = cuda_ce.xla_cross_entropy(hx.reshape(-1, cfg.dim), head, targets.reshape(-1))
    err_loss = abs(lf - lx) / abs(lx)
    err_hidden = row_rel_err(hf, hx.float())
    err_nll = (nll_f - nll_x).abs().max().item()
    print(f"scoring check (2x512), kernel paths vs plain paths: loss {lf:.5f} vs {lx:.5f} "
          f"(relative {err_loss:.3e}); final hidden max row-relative err "
          f"{err_hidden:.3e}; per-token loss max abs err {err_nll:.3e}")
    fail_unless(err_loss <= LOSS_RTOL, f"scoring: loss relative err {err_loss} > {LOSS_RTOL}")
    fail_unless(err_hidden <= HIDDEN_ROW_RTOL,
                f"scoring: hidden row-relative err {err_hidden} > {HIDDEN_ROW_RTOL}")
    fail_unless(err_nll <= NLL_ATOL, f"scoring: per-token loss err {err_nll} > {NLL_ATOL}")
    del hf, hx, nll_f, nll_x
    if profile:
        with torch.inference_mode():
            device_breakdown("scoring (one 8x2048 batch)",
                             lambda: llama.loss_fn(params, {"tokens": tokens}, fast))
    del tokens
    torch.cuda.empty_cache()

    # ---------------- serving phase (main path) ----------------
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 601, 8)]
    eng = LlamaEngine(cfg, params, max_batch=8, max_seq=1024, prefill_chunk=256, device=dev)
    reqs = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=32)
            for i, p in enumerate(prompts)]
    first = {}

    def serve():
        t0 = time.perf_counter()
        for r in reqs:
            fail_unless(eng.add_request(r), f"request {r.request_id} refused")
        n_steps = 0
        while any(not r.done for r in reqs):
            emitted = eng.step()
            torch.cuda.synchronize()
            now = time.perf_counter() - t0
            n_steps += 1
            for r, _ in emitted:
                first.setdefault(r.request_id, now)
        return n_steps, time.perf_counter() - t0

    zero()
    n_steps, total = device_breakdown("serving", serve) if profile else serve()
    count("serving")
    for r in reqs:
        fail_unless(len(r.generated) == 32, f"request {r.request_id}: {len(r.generated)} tokens")
    ttft = sorted(first.values())
    decode_tokens = sum(len(r.generated) for r in reqs) - len(reqs)
    print(f"serving: 8 requests, prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens, 32 new each, {n_steps} steps in {total:.3f} s; TTFT mean "
          f"{statistics.mean(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; decode "
          f"{decode_tokens / (total - ttft[0]):.1f} tokens/s after the first token; "
          f"launches flash {fa.launches} ce {ce.launches}")

    prompt = torch.tensor([prompts[0]], device=dev)
    n = prompt.shape[1]
    fa.launches = 0
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, 1024, dev)
        for pos in range(0, n, 256):
            logits, cache = llama.forward_with_cache(params, prompt[:, pos:pos + 256],
                                                     cache, [pos], cfg)
        cached = logits[0, (n - 1) % 256]
        full = llama.forward(params, prompt, dataclasses.replace(cfg, attention_impl="flash"))[0, -1]
    err = (cached - full).abs().max().item()
    scale = max(1.0, full.abs().max().item())
    fail_unless(fa.launches > 0, "serving check never launched flash_attention_fwd")
    fail_unless(err <= LOGIT_RTOL * scale,
                f"serving: cached vs full logits max abs err {err} > {LOGIT_RTOL} x {scale}")
    print(f"serving check (prompt of {n}): cached vs flash-forward last logits max abs err "
          f"{err:.4f} (max |logit| {scale:.3f}); launches flash {fa.launches} "
          f"(a check, outside the main-path counts)")

    del eng, reqs, cache, logits

    # ---------------- LoRA serving phase (main path) ----------------
    # A seeded rank-8 adapter, A ~ N(0, 1/D) and B ~ N(0, 1/r), so that its
    # delta of the logits is of the logits' own size. The engine computes in
    # f32 from the bf16 weights: greedy tokens are then the argmax of
    # forward's logits exactly (in bf16 the cached and the full path round
    # apart, and a near tie can go either way).
    rank = 8
    arng = np.random.default_rng(1)
    L, D, H, hd = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.head_dim
    adapter = {
        "blocks/wq.A": (arng.standard_normal((L * D * H, rank)) / math.sqrt(D)).astype(np.float32),
        "blocks/wq.B": (arng.standard_normal((rank, hd)) / math.sqrt(rank)).astype(np.float32),
        "lm_head.A": (arng.standard_normal((D, rank)) / math.sqrt(D)).astype(np.float32),
        "lm_head.B": (arng.standard_normal((rank, cfg.vocab_size)) / math.sqrt(rank)
                      ).astype(np.float32),
    }
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    adapter_path = os.path.join(out_dir, "adapter.npz")
    np.savez(adapter_path, **adapter)
    folded = apply_lora(params, load_lora_adapter(adapter_path))
    fail_unless(folded["embed"] is params["embed"] and folded["lm_head"] is not params["lm_head"],
                "apply_lora: unadapted leaves must be shared, adapted ones new")
    lora_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    lora_prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                    for n in rng.integers(16, 65, 4)]
    lora_eng = LlamaEngine(lora_cfg, folded, max_batch=4, max_seq=256, prefill_chunk=64,
                           device=dev)
    lora_reqs = [GenRequest(request_id=f"lora{i}", prompt_ids=p, max_tokens=8, adapter_id="a")
                 for i, p in enumerate(lora_prompts)]
    zero()
    t0 = time.perf_counter()
    for r in lora_reqs:
        fail_unless(lora_eng.add_request(r), f"request {r.request_id} refused")
    lora_steps = 0
    while any(not r.done for r in lora_reqs):
        lora_eng.step()
        lora_steps += 1
    torch.cuda.synchronize()
    lora_s = time.perf_counter() - t0
    count("lora_serving")
    with torch.inference_mode():
        for r in lora_reqs:
            ids = list(r.prompt_ids)
            for tok in r.generated:
                logits = llama.forward(folded, torch.tensor([ids], device=dev), lora_cfg)
                fail_unless(int(logits[0, -1].argmax()) == tok,
                            f"LoRA serving: {r.request_id} token {len(ids) - len(r.prompt_ids)}"
                            f" is {tok}, forward's argmax {int(logits[0, -1].argmax())}")
                ids.append(tok)
    base_eng = LlamaEngine(lora_cfg, params, max_batch=4, max_seq=256, prefill_chunk=64,
                           device=dev)
    base = [base_eng.generate(p, max_tokens=8) for p in lora_prompts]
    n_diff = sum(b != r.generated for b, r in zip(base, lora_reqs))
    fail_unless(n_diff >= 1, "LoRA serving: the adapter changed no request's tokens")
    print(f"LoRA serving: rank-{rank} adapter on blocks/wq and lm_head folded into LLAMA_BENCH "
          f"(apply_lora); 4 greedy requests, prompts {min(map(len, lora_prompts))}-"
          f"{max(map(len, lora_prompts))} tokens, 8 new each, {lora_steps} steps in "
          f"{lora_s:.3f} s (f32 compute); every token equals forward's argmax on the folded "
          f"tree; {n_diff} of 4 differ from the unadapted engine's; launches "
          + ", ".join(f"{k} {launches[k]['lora_serving']}" for k in kernels))
    del lora_eng, base_eng, folded, params
    torch.cuda.empty_cache()

    graftlint_phase(lint, smi)

    # ---------------- runtime phase (main paths) ----------------
    # the actor's process has its own CUDA context: room next to this cache
    for path, counts in runtime_phase(cfg, dev, smi, list(kernels)).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- trainer phase (main path) ----------------
    # the worker's process has its own CUDA context: room next to this cache
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_to_serve_") as export_dir:
        trained, handoff = trainer_phase(cfg, dev, smi, list(kernels), export_dir)
        for path, counts in trained.items():
            for name in kernels:
                launches[name][path] = counts[name]
        torch.cuda.empty_cache()

        # ---------------- train_to_serve phase (main paths) ----------------
        # the trainer's parameters through LLMConfig.load_params, scored
        # here and served by a replica with its own CUDA context over HTTP
        for path, counts in train_to_serve_phase(cfg, dev, smi, list(kernels),
                                                 handoff).items():
            for name in kernels:
                launches[name][path] = counts[name]
    del handoff
    torch.cuda.empty_cache()

    # ---------------- serve phase (main paths) ----------------
    # each replica's process has its own CUDA context: room next to this cache
    for path, counts in serve_phase(cfg, dev, smi, list(kernels), adapter_path).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- cluster phase (main path) ----------------
    # the actor's process on the agent's node has its own CUDA context
    for path, counts in cluster_phase(cfg, dev, smi, list(kernels)).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- dag, workflow and data phases (main paths) ----------------
    # each in its own runtime, held against this process's LLAMA_BENCH (the
    # same weights: LLMConfig's generator seeded 0)
    from ray_tpu_torch.llm import LLMConfig

    bench_params = LLMConfig(model_config=cfg).load_params(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_") as storage:
        for phase in (lambda: dag_phase(cfg, dev, smi, list(kernels), bench_params),
                      lambda: workflow_phase(cfg, dev, smi, list(kernels), bench_params, storage),
                      lambda: data_phase(cfg, dev, smi, list(kernels), bench_params)):
            for path, counts in phase().items():
                for name in kernels:
                    launches[name][path] = counts[name]
    del bench_params
    torch.cuda.empty_cache()

    # ---------------- tune phase (main paths) ----------------
    # each trial's actor and each wrapped trainer's worker has its own CUDA context
    for path, counts in tune_phase(cfg, dev, smi, list(kernels)).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- collective phase ----------------
    collective_phase(cfg, dev, smi)

    # ---------------- mesh phase (main paths) ----------------
    # each rank's process has its own CUDA context; counted in each rank
    for path, counts in mesh_phase(cfg, dev, smi, list(kernels)).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- rllib phase (main paths) ----------------
    # the Anakin workers and Sebulba's learner have CUDA contexts of their
    # own; this process's learner updates and superstep are counted here
    for path, counts in rllib_phase(dev, smi, kernels).items():
        for name in kernels:
            launches[name][path] = counts[name]
    torch.cuda.empty_cache()

    # ---------------- training check ----------------
    train_cfg = dataclasses.replace(cfg, remat=True)
    train_fast = dataclasses.replace(train_cfg, attention_impl="flash", ce_impl="fused")
    opt = parallel.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
    state = parallel.create_train_state(gen, lambda g: llama.init_params(g, train_cfg, dev),
                                        opt, dev)
    names = ["embed", *(f"blocks.{k}" for k in state.params["blocks"]), "final_norm", "lm_head"]
    leaves = parallel.tree_leaves(state.params)
    small = {"tokens": torch.randint(0, cfg.vocab_size, (2, 513), generator=gen, device=dev)}
    lk = llama.loss_fn(state.params, small, train_fast)
    gk = torch.autograd.grad(lk, leaves)
    lp = llama.loss_fn(state.params, small, train_cfg)
    gp = torch.autograd.grad(lp, leaves)
    grad_errs = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                 for n, a, b in zip(names, gk, gp)}
    err_loss = abs(lk.item() - lp.item()) / abs(lp.item())
    del gk, gp, lk, lp
    print(f"training check (2x512, LLAMA_BENCH bf16, remat), kernel paths vs plain paths: "
          f"loss relative err {err_loss:.3e}; per-tensor gradient relative err "
          + ", ".join(f"{n} {e:.3e}" for n, e in grad_errs.items()))
    fail_unless(err_loss <= TRAIN_LOSS_RTOL, f"training: loss relative err {err_loss}")
    for n, e in grad_errs.items():
        fail_unless(e <= TRAIN_GRAD_RTOL, f"training: {n} gradient relative err {e} > "
                                          f"{TRAIN_GRAD_RTOL}")

    # ---------------- training phase (main path) ----------------
    train_step = parallel.make_train_step(
        lambda prm, b: llama.loss_fn(prm, b, train_fast), opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 2049), generator=gen, device=dev)}
    n_steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    state, metrics, step_s = timed_steps(train_step, state, batch, n_steps)  # lr 0 at step 0
    count("training")
    peak_mem = torch.cuda.max_memory_allocated()
    # The CE backward's chunks, from the contract and not from the code under
    # test: bf16 dlog chunks of the most 128-row blocks that fit 256 MiB.
    n_rows = batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1)
    ce_rows = 256 * 2**20 // (cfg.vocab_size * 2) // 128 * 128
    ce_chunks = -(-n_rows // ce_rows)
    per_step = {"flash_attention_fwd": 2 * train_cfg.n_layers,
                "flash_attention_bwd_dkv": train_cfg.n_layers,
                "flash_attention_bwd_dq": train_cfg.n_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd_dlog": ce_chunks, "fused_ce_bwd_dx": ce_chunks,
                "fused_ce_bwd_dw": ce_chunks, "fused_adamw": len(leaves)}
    for name, n in per_step.items():
        fail_unless(launches[name]["training"] == n * (n_steps + 1),
                    f"training launched {name} {launches[name]['training']} times, "
                    f"expected {n} per step")
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    fail_unless(all(math.isfinite(v) for v in losses + gnorms),
                f"training: loss or grad norm not finite: {losses} {gnorms}")
    fail_unless(losses[-1] < losses[0], f"training: loss did not fall: {losses}")
    tps = 8 * 2048 / step_s
    mfu = tps * llama.flops_per_token(train_cfg, 2048) / peak_flops
    print(f"training: LLAMA_BENCH bf16 params, remat, flash + fused CE, 8x2048 tokens per step; "
          f"{step_s * 1e3:.2f} ms per step (mean of {n_steps} after a warm-up step), "
          f"{tps:.0f} tokens/s, MFU {mfu:.2%} of {peak_flops / 1e12:.0f} TFLOP/s; peak memory "
          f"{peak_mem / 2**30:.2f} GiB; launches per step "
          + ", ".join(f"{k} {launches[k]['training'] // (n_steps + 1)}" for k in per_step))
    print("training losses: " + " ".join(f"{v:.5f}" for v in losses))
    print("training grad norms: " + " ".join(f"{v:.5f}" for v in gnorms))
    if profile:
        device_breakdown("training (one step)", lambda: train_step(state, batch))
        state = optimizer_share("training", lambda prm, b: llama.loss_fn(prm, b, train_fast),
                                opt, state, batch)
    del state, batch, metrics
    torch.cuda.empty_cache()

    # ---------------- MoE at Mixtral 8x7B's widths ----------------
    mix = dataclasses.replace(moe_llama.MIXTRAL_8X7B, param_dtype=torch.bfloat16, remat=True)
    moe_fast = dataclasses.replace(mix, n_layers=2, attention_impl="flash")
    moe_plain = dataclasses.replace(moe_fast, attention_impl="xla")
    moe_score = dataclasses.replace(moe_fast, n_layers=4)
    for label, c in (("training", moe_fast), ("scoring", moe_score)):
        print(f"MIXTRAL_8X7B widths (dim {c.dim}, {c.n_heads} heads of hd {c.head_dim}, "
              f"{c.n_kv_heads} kv heads, ffn {c.ffn_dim}, {c.n_experts} experts top-"
              f"{c.experts_per_token}, capacity factor {c.capacity_factor}, vocab "
              f"{c.vocab_size}), bf16, depth cut {mix.n_layers} -> {c.n_layers} layers for "
              f"{label}: {moe_llama.param_count(c) / 1e9:.3f} B params, "
              f"{moe_llama.active_param_count(c) / 1e9:.3f} B active per token")
    opt_m = parallel.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
    mstate = parallel.create_train_state(
        gen, lambda g: moe_llama.init_params(g, moe_fast, dev), opt_m, dev)

    # MoE check: flash path against the einsum attention path, same weights
    # and batch; routing pinned to the einsum path's, then free.
    m_names = ["embed", *(f"blocks.{k}" for k in mstate.params["blocks"]), "final_norm",
               "lm_head"]
    m_leaves = parallel.tree_leaves(mstate.params)
    small = {"tokens": torch.randint(0, mix.vocab_size, (2, 513), generator=gen, device=dev)}
    plain_calls, fast_calls, free_calls = [], [], []
    with moe_routing(moe_ops, record=plain_calls):
        lp = moe_llama.loss_fn(mstate.params, small, moe_plain)
        gp = torch.autograd.grad(lp, m_leaves)
    with moe_routing(moe_ops, record=fast_calls, replay=[c[0] for c in plain_calls]):
        lk = moe_llama.loss_fn(mstate.params, small, moe_fast)
        gk = torch.autograd.grad(lk, m_leaves)
    with moe_routing(moe_ops, record=free_calls), torch.no_grad():
        lfree = moe_llama.loss_fn(mstate.params, small, moe_fast)
    nl = moe_fast.n_layers
    fail_unless(len(plain_calls) == len(fast_calls) == 2 * nl and len(free_calls) == nl,
                f"MoE check: router calls {len(plain_calls)}, {len(fast_calls)}, "
                f"{len(free_calls)}; expected {2 * nl}, {2 * nl}, {nl}")
    fail_unless(all(torch.equal(a[1].dispatch, b[1].dispatch)
                    for a, b in zip(fast_calls, plain_calls)),
                "MoE check: the pinned flash run routed differently")
    grad_errs = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                 for n, a, b in zip(m_names, gk, gp)}
    del gk, gp

    def aux_of(calls):
        return sum(c[1].aux_loss.item() for c in calls[:nl]) / nl

    aux_p, aux_k, aux_free = aux_of(plain_calls), aux_of(fast_calls), aux_of(free_calls)
    err_loss = abs(lk.item() - lp.item()) / abs(lp.item())
    err_aux = abs(aux_k - aux_p) / abs(aux_p)
    err_loss_free = abs(lfree.item() - lp.item()) / abs(lp.item())
    err_aux_free = abs(aux_free - aux_p) / abs(aux_p)
    n_assign = nl * small["tokens"][:, :-1].numel() * mix.experts_per_token
    moved = sum(int((a[1].dispatch.sum(-1) - b[1].dispatch.sum(-1)).abs().sum().item()) // 2
                for a, b in zip(free_calls, plain_calls[:nl]))
    print(f"MoE check (2x512, {nl} layers, bf16, remat), flash vs einsum attention, routing "
          f"pinned to the einsum path's: loss relative err {err_loss:.3e}, aux loss relative err "
          f"{err_aux:.3e}; per-tensor gradient relative err "
          + ", ".join(f"{n} {e:.3e}" for n, e in grad_errs.items()))
    print(f"MoE check, routing free: {moved} of {n_assign} expert assignments moved "
          f"({moved / n_assign:.2%}); loss relative err {err_loss_free:.3e}, aux loss relative "
          f"err {err_aux_free:.3e} (aux {aux_free:.5f} vs {aux_p:.5f})")
    fail_unless(err_loss <= TRAIN_LOSS_RTOL, f"MoE check: loss relative err {err_loss}")
    fail_unless(err_aux <= TRAIN_LOSS_RTOL, f"MoE check: aux loss relative err {err_aux}")
    for n, e in grad_errs.items():
        fail_unless(e <= TRAIN_GRAD_RTOL, f"MoE check: {n} gradient relative err {e} > "
                                          f"{TRAIN_GRAD_RTOL}")
    fail_unless(err_loss_free <= MOE_FREE_RTOL and err_aux_free <= MOE_FREE_RTOL,
                f"MoE check, routing free: loss err {err_loss_free}, aux err {err_aux_free} > "
                f"{MOE_FREE_RTOL}")
    fail_unless(moved <= MOE_FREE_MOVED * n_assign,
                f"MoE check, routing free: {moved} of {n_assign} assignments moved")
    del plain_calls, fast_calls, free_calls, lp, lk, lfree, small
    torch.cuda.empty_cache()

    # ---------------- MoE training phase (main path) ----------------
    moe_step = parallel.make_train_step(lambda p, b: moe_llama.loss_fn(p, b, moe_fast), opt_m)
    mbatch = {"tokens": torch.randint(0, mix.vocab_size, (4, 2049), generator=gen, device=dev)}
    n_moe = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    mstate, metrics, step_s = timed_steps(moe_step, mstate, mbatch, n_moe)
    count("moe_training")
    peak_mem = torch.cuda.max_memory_allocated()
    per_step = {"flash_attention_fwd": 2 * nl, "flash_attention_bwd_dkv": nl,
                "flash_attention_bwd_dq": nl,
                "fused_adamw": len(parallel.tree_leaves(mstate.params))}
    for name in kernels:
        n = per_step.get(name, 0) * (n_moe + 1)
        fail_unless(launches[name]["moe_training"] == n,
                    f"MoE training launched {name} {launches[name]['moe_training']} times, "
                    f"expected {n}")
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    fail_unless(all(math.isfinite(v) for v in losses + gnorms),
                f"MoE training: loss or grad norm not finite: {losses} {gnorms}")
    fail_unless(losses[-1] < losses[0], f"MoE training: loss did not fall: {losses}")
    n_tok = 4 * 2048
    tps = n_tok / step_s
    mfu = tps * moe_flops_per_token(moe_fast, 2048) / peak_flops
    print(f"MoE training: {nl} layers at Mixtral widths, bf16 params, remat, flash attention, "
          f"4x2048 tokens per step; {step_s * 1e3:.2f} ms per step (mean of {n_moe} after a "
          f"warm-up step), {tps:.0f} tokens/s, MFU {mfu:.2%} of {peak_flops / 1e12:.0f} TFLOP/s "
          f"on active_param_count ({moe_flops_per_token(moe_fast, 2048) / 1e9:.2f} GFLOP per "
          f"token); peak memory {peak_mem / 2**30:.2f} GiB; launches per step "
          + ", ".join(f"{k} {launches[k]['moe_training'] // (n_moe + 1)}" for k in kernels))
    print("MoE training losses: " + " ".join(f"{v:.5f}" for v in losses))
    print("MoE training grad norms: " + " ".join(f"{v:.5f}" for v in gnorms))
    if profile:
        device_breakdown("MoE training (one step)", lambda: moe_step(mstate, mbatch))
        mstate = optimizer_share("MoE training",
                                 lambda p, b: moe_llama.loss_fn(p, b, moe_fast), opt_m,
                                 mstate, mbatch)

    # the dense dispatch's pieces, one layer's forward at the training shape
    T, E = n_tok, mix.n_experts
    C = max(4, math.ceil(T * mix.experts_per_token * mix.capacity_factor / E))
    layer = {k: v[0].detach() for k, v in mstate.params["blocks"].items()}
    with torch.inference_mode():
        xt = torch.randn(T, mix.dim, generator=gen, device=dev).bfloat16()
        router_logits = xt.float() @ layer["router"]
        gate = moe_ops.top_k_gating(router_logits, k=mix.experts_per_token,
                                    capacity_factor=mix.capacity_factor)
        disp, comb = gate.dispatch.bfloat16(), gate.combine.bfloat16()
        xe = torch.einsum("td,tec->ecd", xt, disp)
        hmid = torch.einsum("ecd,edf->ecf", xe, layer["w_gate"])
        ye = torch.einsum("ecf,efd->ecd", hmid, layer["w_down"])
        pieces = {
            "top_k_gating": lambda: moe_ops.top_k_gating(
                router_logits, k=mix.experts_per_token, capacity_factor=mix.capacity_factor),
            "dispatch einsum": lambda: torch.einsum("td,tec->ecd", xt, disp),
            "expert einsums (3)": lambda: (
                torch.einsum("ecd,edf->ecf", xe, layer["w_gate"]),
                torch.einsum("ecd,edf->ecf", xe, layer["w_up"]),
                torch.einsum("ecf,efd->ecd", hmid, layer["w_down"])),
            "combine einsum": lambda: torch.einsum("ecd,tec->td", ye, comb),
        }
        piece_ms = {n: time_ms(f, 5) for n, f in pieces.items()}
    disp_flop = 2.0 * T * E * C * mix.dim
    expert_flop = 3 * 2.0 * E * C * mix.dim * mix.ffn_dim
    print(f"MoE dense dispatch, one layer's forward at T {T}, E {E}, C {C}: dispatch and combine "
          f"einsums {disp_flop / 1e12:.2f} TFLOP each against {expert_flop / 1e12:.2f} TFLOP for "
          f"the experts; " + ", ".join(f"{n} {v:.3f} ms" for n, v in piece_ms.items()))
    del mstate, metrics, layer, xt, router_logits, gate, disp, comb, xe, hmid, ye, pieces
    torch.cuda.empty_cache()

    # ---------------- MoE scoring phase (main path) ----------------
    sparams = moe_llama.init_params(gen, moe_score, dev)
    zero()
    times, losses = [], []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(moe_llama.loss_fn(sparams, mbatch, moe_score).item())
            times.append(time.perf_counter() - t0)
    count("moe_scoring")
    for name in kernels:
        n = moe_score.n_layers * 3 if name == "flash_attention_fwd" else 0
        fail_unless(launches[name]["moe_scoring"] == n,
                    f"MoE scoring launched {name} {launches[name]['moe_scoring']} times, "
                    f"expected {n}")
    fail_unless(all(math.isfinite(v) for v in losses), f"MoE scoring loss not finite: {losses}")
    step = statistics.median(times)
    print(f"MoE scoring: {moe_score.n_layers} layers at Mixtral widths, bf16, flash attention; "
          f"loss {losses[-1]:.5f}; {step * 1e3:.2f} ms per 4x2048 batch (median of 3), "
          f"{n_tok / step:.0f} tokens/s; launches flash "
          f"{launches['flash_attention_fwd']['moe_scoring']} over 3 batches")
    if profile:
        with torch.inference_mode():
            device_breakdown("MoE scoring (one 4x2048 batch)",
                             lambda: moe_llama.loss_fn(sparams, mbatch, moe_score))
    del sparams, mbatch
    torch.cuda.empty_cache()

    # ---------------- ViT phase (main path) ----------------
    vcfg = vit.VIT_B_16
    vopt = parallel.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
    vstate = parallel.create_train_state(gen, lambda g: vit.init_params(g, vcfg, dev), vopt, dev)
    images = torch.randn(64, vcfg.image_size, vcfg.image_size, vcfg.channels, generator=gen,
                         device=dev)
    labels = torch.randint(0, vcfg.num_classes, (64,), generator=gen, device=dev)
    vbatch = {"image": images, "label": labels}
    with torch.inference_mode():
        f32 = dataclasses.replace(vcfg, dtype=torch.float32)
        lg16 = vit.forward(vstate.params, images[:8], vcfg)
        lg32 = vit.forward(vstate.params, images[:8], f32)
    err_vit = (lg16 - lg32).abs().max().item()
    print(f"ViT check (8 images): bf16 vs f32 activations, logits max abs err {err_vit:.3e} "
          f"(max |logit| {lg32.abs().max().item():.3f})")
    fail_unless(lg16.shape == (8, vcfg.num_classes) and err_vit <= VIT_LOGIT_ATOL,
                f"ViT check: logits {tuple(lg16.shape)}, max abs err {err_vit} > {VIT_LOGIT_ATOL}")
    vit_step = parallel.make_train_step(lambda p, b: vit.loss_fn(p, b, vcfg), vopt)
    n_vit = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    vstate, metrics, step_s = timed_steps(vit_step, vstate, vbatch, n_vit)
    peak_mem = torch.cuda.max_memory_allocated()
    times = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = vit.forward(vstate.params, images, vcfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    count("vit")
    n_adamw = len(parallel.tree_leaves(vstate.params)) * (n_vit + 1)
    for name in kernels:
        n = n_adamw if name == "fused_adamw" else 0
        fail_unless(launches[name]["vit"] == n,
                    f"ViT launched {name} {launches[name]['vit']} times, expected {n}")
    losses = [m["loss"].item() for m in metrics]
    fail_unless(all(math.isfinite(v) for v in losses), f"ViT training loss not finite: {losses}")
    fail_unless(logits.shape == (64, vcfg.num_classes) and bool(torch.isfinite(logits).all()),
                f"ViT eval: logits {tuple(logits.shape)} not finite or of the wrong shape")
    n_tok = 1 + vcfg.n_patches
    vit_flops = n_tok * (6.0 * vit.param_count(vcfg) + 12 * vcfg.n_layers * vcfg.dim * n_tok)
    ips = 64 / step_s
    eval_s = statistics.median(times)
    print(f"ViT training: VIT_B_16 ({vit.param_count(vcfg) / 1e6:.2f} M params, f32 params, bf16 "
          f"activations, remat), 64 images of {vcfg.image_size}x{vcfg.image_size}x"
          f"{vcfg.channels} per step; {step_s * 1e3:.2f} ms per step (mean of {n_vit} after a "
          f"warm-up step), {ips:.1f} images/s, MFU {ips * vit_flops / peak_flops:.2%} of "
          f"{peak_flops / 1e12:.0f} TFLOP/s ({vit_flops / 1e9:.2f} GFLOP per image); peak memory "
          f"{peak_mem / 2**30:.2f} GiB; eval forward {eval_s * 1e3:.2f} ms per 64 images (median "
          f"of 3), {64 / eval_s:.1f} images/s; launches fused_adamw "
          f"{n_adamw // (n_vit + 1)} per step, no other kernel")
    print("ViT training losses: " + " ".join(f"{v:.5f}" for v in losses))
    if profile:
        device_breakdown("ViT training (one step)", lambda: vit_step(vstate, vbatch))
        vstate = optimizer_share("ViT training", lambda p, b: vit.loss_fn(p, b, vcfg), vopt,
                                 vstate, vbatch)
    del vstate, vbatch, images, labels, logits, metrics
    torch.cuda.empty_cache()

    record_line = [
        dict(name=name, route="cuda", source=f"ray_tpu_torch/csrc/{src}", replaces=replaces,
             launches=sum(launches[name].values()), launches_by_path=launches[name],
             **record[name])
        for name, (_, src, replaces) in kernels.items()
    ]
    print(f"wall [{smi}]: {time.perf_counter() - t_main:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": record_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
