"""Device ms a step of the kernels launched inside the train step's
``train_step.update`` span (the optimizer: the clip's global norm and
AdamW over every leaf), over the steps ``phases.probe`` profiles after a
traced window."""

from gpubench import phases

probe = phases.probe


def read(run):
    return phases.ms_per_step(run, "train_step.update")
