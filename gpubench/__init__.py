"""gpubench: the benchmark of ``ray_tpu_torch`` on NVIDIA H100 cards.

One run measures one cell (a model configuration under one traffic mix):

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

and prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and last ``checks``: each number that
decided ``correct`` beside its limit.

Everything is found by name, so a configuration, a cell, a traffic mix or
a metric is added as files only:

- ``configs/<config>.json``: the model's sizes as they are run, with the
  source, the keys ``reduced`` from it, the sizes ``assumed`` and the
  deployment it stands for;
- ``workloads/<cell>.json``: config, traffic, chips and a one-line why;
- ``traffic/<traffic>.json``: the job's parameters, read by the one
  generator in ``traffic.py``;
- ``limits/<cell>.json``: the limit of each number ``check.py`` compares;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` over the
  run's record (and optionally a ``probe(ctx)`` the train loop calls in the
  worker after a traced window).

``BENCHMARK.json`` at the root of the checkout says which metrics each
cell reports. The yardstick lives here: the traffic generator, the weights
made from the seed, the FLOP counts, the table of peaks, the trace
reduction, the plain float32 reference (``reference.py``, which imports
nothing of the program) and the comparison that decides ``correct``.
Only ``program.py``, ``loop.py`` and ``harness.py`` touch the program.
"""

import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)

# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
BANNED_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")
