from .batch import batch_states, batched_step, replicate

__all__ = ["batch_states", "batched_step", "replicate"]
