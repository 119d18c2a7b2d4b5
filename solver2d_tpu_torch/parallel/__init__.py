from .batch import replicate

__all__ = ["replicate"]
