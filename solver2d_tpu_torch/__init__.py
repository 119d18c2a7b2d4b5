"""solver2d_tpu_torch: batched 2D rigid-body steps in PyTorch, with the
narrowphase (K2) and the fused soft solve (K1) as hand-written CUDA kernels
for Hopper, and the JAX package's XLA solvers (eight of its ten) in plain
PyTorch on the per-world step.

The port of the JAX package `solver2d_tpu` (which stays as the reference).
It imports neither JAX nor that package. Entry points create tensors on
`device="cuda"` unless the caller asks for the CPU; on a CPU tensor each
kernel wrapper runs the kernel's plain PyTorch twin.
"""

from .config import BodyType, SimConfig, SolverType
from .models.contact_scenes import pyramid_world
from .models.joint_scenes import bridge
from .models import Scene, build, scene_names
from .parallel.batch import batch_states, batched_step, replicate
from .state import State, state_from_numpy, to_numpy
from .step import step_batch
from .world import World

__all__ = [
    "BodyType", "Scene", "SimConfig", "SolverType", "State", "World", "batch_states", "batched_step", "bridge",
    "build", "pyramid_world", "replicate", "scene_names", "state_from_numpy", "step_batch", "to_numpy",
]
