"""Device ms a step of the kernels launched inside the train step's
``train_step.backward`` span (``torch.autograd.grad``, on whichever thread
autograd launches them), the blocks' recompute under remat included, over
the steps ``phases.probe`` profiles after a traced window."""

from gpubench import phases

probe = phases.probe


def read(run):
    return phases.ms_per_step(run, "train_step.backward")
