from . import gpu

__all__ = ["gpu"]
