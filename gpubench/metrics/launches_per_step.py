"""Kernel launches in the traced window (``torch.profiler``) over its steps."""


def read(run):
    t = run["trace"]
    if t is None or not t["launches"]:
        return None
    return t["launches"] / run["window"]["steps"]
