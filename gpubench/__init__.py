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
  source, the keys ``reduced`` from it, the sizes ``assumed``, the
  deployment it stands for, and ``program.family``, which names its
  family;
- ``families/<family>.py``: a model family: the program's model config,
  loss and partition specs, the tree's leaves, the plain float32 reference
  model, the FLOP counts, and optionally the pins the program's first
  steps hand to the reference (``families/__init__.py``);
- ``workloads/<cell>.json``: config, traffic, chips and a one-line why;
  a cell on several cards also its ``mesh``, the axis sizes of the
  workers' mesh (``{"fsdp": 4}``), as many ranks as chips;
- ``traffic/<traffic>.json``: the job's parameters, read by the one
  generator in ``traffic.py``;
- ``limits/<cell>.json``: the limit of each number ``check.py`` compares;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` over the
  run's record (and optionally a ``probe(ctx)`` the train loop calls in the
  worker after a traced window).

``BENCHMARK.json`` at the root of the checkout says which metrics each
cell reports. The yardstick lives here: the traffic generator, the weights
made from the seed, the FLOP counts, the table of peaks, the trace
reduction, the plain float32 reference (``reference.py`` and each
family's ``Model``, which import nothing of the program) and the
comparison that decides ``correct``. Only ``program.py``, ``loop.py``,
``harness.py``, ``calibrate.py`` and the families' ``model_config`` and
``param_specs`` touch the program.
"""

import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)

# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
BANNED_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


def banned_loaded() -> list:
    """The modules this process has loaded whose top-level name is one of
    BANNED_MODULES, sorted."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED_MODULES)
