"""How far the JAX package, and the port beside it, move the boxes of a
resting pyramid.

Runs the reference package (`solver2d_tpu`, on the CPU, op by op) and the
PyTorch port (`solver2d_tpu_torch`, on the CPU) from the same frozen scene
at the configuration of `bench.py` (TGS_Soft, 4 substeps + relax, 9 colors,
bucket cap 896, GJK 10, lane solve), and prints after each step the largest
displacement of a box from its initial position in each, and their largest
position difference. The JAX figure sets `chip_smoke.MAX_DRIFT`, the bound the
port's 512 x base-62 run on the card must stay under.

Usage: python tools/jax_pyramid_drift.py [base] [steps]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from solver2d_tpu.config import SolverType  # noqa: E402
from solver2d_tpu.models.contact_scenes import pyramid_world  # noqa: E402
from solver2d_tpu.parallel import replicate_state  # noqa: E402
from solver2d_tpu.step import step_batch  # noqa: E402
import solver2d_tpu_torch as port  # noqa: E402


def main(base: int = 20, steps: int = 23):
    w, ids = pyramid_world(SolverType.TGS_SOFT, base)
    kw = dict(max_contacts=((4 * len(ids) + 127) // 128) * 128, max_colors=9, gjk_iters=10, contact_bucket_cap=896)
    state, cfg = w.freeze(solve_joints=False, lane_solve=True, narrowphase="lanes", **kw)
    batch = replicate_state(state, 1)
    pbatch = port.replicate(port.state_from_numpy(jax.tree.map(np.asarray, state), device="cpu"), 1)
    _, pcfg = port.pyramid_world(port.SolverType.TGS_SOFT, base)[0].freeze(device="cpu", **kw)
    p0 = np.asarray(batch.bodies.position[0])
    dyn = np.asarray(batch.bodies.type[0]) == 2
    for i in range(steps):
        with jax.disable_jit():
            batch = step_batch(batch, 1.0 / 60.0, cfg)
        pbatch = port.step_batch(pbatch, 1.0 / 60.0, pcfg)
        pos = np.asarray(batch.bodies.position[0])
        ppos = pbatch.bodies.position[0].numpy()
        drift = float(np.linalg.norm((pos - p0)[dyn], axis=-1).max())
        pdrift = float(np.linalg.norm((ppos - p0)[dyn], axis=-1).max())
        print(f"base {base} step {i + 1}: largest box displacement JAX {drift:.6f}, "
              f"port {pdrift:.6f}; largest position difference {np.abs(pos - ppos).max():.3e}; "
              f"color_overflow JAX {int(batch.diag.color_overflow[0])}, "
              f"port {int(pbatch.diag.color_overflow[0])}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(*(int(a) for a in sys.argv[1:3]))
