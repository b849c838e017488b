"""Device ms a step of the kernels launched inside a ``llama.block`` span
that lies inside ``train_step.backward``: the blocks' forward run again by
remat's ``checkpoint``, a part of ``backward_ms_per_step``, over the steps
``phases.probe`` profiles after a traced window."""

from gpubench import phases

probe = phases.probe


def read(run):
    return phases.ms_per_step(run, phases.RECOMPUTE)
