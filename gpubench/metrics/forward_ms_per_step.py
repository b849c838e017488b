"""Device ms a step of the kernels launched inside the train step's
``train_step.forward`` span (``loss_fn``: the embedding, every block, the
final norm and the fused CE's forward), over the steps ``phases.probe``
profiles after a traced window."""

from gpubench import phases

probe = phases.probe


def read(run):
    return phases.ms_per_step(run, "train_step.forward")
