"""Device ms a step, in rank 0's traced window, in which an NCCL kernel
runs and no other kernel does: the collectives' time that compute does not
hide (``trace.summarize``'s ``nccl_exposed_s``). Nothing where the window
ran no NCCL kernel."""


def read(run):
    t = run["trace"]
    if t is None or not t["nccl_kernel_s"]:
        return None
    return 1e3 * t["nccl_exposed_s"] / run["window"]["steps"]
