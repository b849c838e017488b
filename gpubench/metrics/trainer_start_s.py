"""From ``TorchTrainer.fit()`` being called in the driver to the first line
of the train loop in the worker (wall clock, one host): the runtime's hub,
the worker process, its GPU pinning and the process group."""


def read(run):
    return run["trainer_start_s"]
