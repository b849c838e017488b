"""Model FLOPs of the window's tokens (``flops.train_flops_per_token``)
over the window's seconds and the bf16 peak of the cell's cards summed, in
percent."""

from gpubench import flops


def read(run):
    peak = run["peaks"]
    if peak is None:
        return None
    w, t = run["window"], run["traffic"]
    done = flops.train_flops_per_token(run["config"], t["seq_len"]) * w["tokens"]
    return 100.0 * done / w["seconds"] / (peak["bf16_flops"] * run["chips"])
