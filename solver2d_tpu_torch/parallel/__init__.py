from .batch import apply_velocity_deltas, batch_states, batched_step, randomize_velocities, replicate, replicate_state
from .sharding import Mesh, ShardedState, make_mesh, metrics_psum_example, shard_state, sharded_step

__all__ = ["Mesh", "ShardedState", "apply_velocity_deltas", "batch_states", "batched_step", "make_mesh",
           "metrics_psum_example", "randomize_velocities", "replicate", "replicate_state", "shard_state",
           "sharded_step"]
