from .batch import batched_step, replicate

__all__ = ["batched_step", "replicate"]
