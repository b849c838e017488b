"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB: it bounds the batch a card can train."""


def read(run):
    peak = run["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
