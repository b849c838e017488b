"""Tokens of every step finished in the window over the window's seconds
(host clock; the window ends on a synchronize)."""


def read(run):
    w = run["window"]
    return w["tokens"] / w["seconds"]
