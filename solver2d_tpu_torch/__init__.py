"""solver2d_tpu_torch: batched 2D rigid-body steps in PyTorch, with the
narrowphase (K2) and the fused soft solve (K1) as hand-written CUDA kernels
for Hopper, the JAX package's XLA solvers (all ten) in plain PyTorch on
the per-world step, and its world queries, runtime edits, checks,
checkpoints, handles, settings, timing, debug draw and interactive
testbed, the batched scene compiler, and world batches split over devices
and processes (`parallel`).

The port of the JAX package `solver2d_tpu` (which stays as the reference).
It imports neither JAX nor that package. Entry points create tensors on
`device="cuda"` unless the caller asks for the CPU; on a CPU tensor each
kernel wrapper runs the kernel's plain PyTorch twin.
"""

from .config import BodyType, ShapeType, SimConfig, SolverType
from .models.contact_scenes import pyramid_world
from .models.joint_scenes import bridge
from .models import Scene, build, scene_names
from .parallel.batch import batch_states, batched_step, randomize_velocities, replicate, replicate_state
from .parallel.sharding import make_mesh, shard_state, sharded_step
from .state import Bodies, Contacts, Diagnostics, Joints, Shapes, State, state_from_numpy, to_numpy
from .step import make_step, step_batch
from .world import BodyDef, ShapeDef, World

__version__ = "0.1.0"

__all__ = [
    "Bodies", "BodyDef", "BodyType", "Contacts", "Diagnostics", "Joints", "Scene", "ShapeDef", "ShapeType",
    "Shapes", "SimConfig", "SolverType", "State", "World", "__version__", "batch_states", "batched_step", "bridge",
    "build", "make_mesh", "make_step", "pyramid_world", "randomize_velocities", "replicate", "replicate_state",
    "scene_names", "shard_state", "sharded_step", "state_from_numpy", "step_batch", "to_numpy",
]
