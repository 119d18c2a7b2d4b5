from .batch import apply_velocity_deltas, batch_states, batched_step, randomize_velocities, replicate, replicate_state

__all__ = ["apply_velocity_deltas", "batch_states", "batched_step", "randomize_velocities", "replicate",
           "replicate_state"]
