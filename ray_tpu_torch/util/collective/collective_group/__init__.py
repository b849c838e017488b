from .base import BaseGroup

__all__ = ["BaseGroup"]
