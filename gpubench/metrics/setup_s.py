"""From the start of the benchmark's process to the start of the window:
the runtime and the trainer's worker, the kernel library, the weights, the
state and the first steps."""


def read(run):
    return run["setup_s"]
