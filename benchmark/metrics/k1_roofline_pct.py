"""k1_roofline_pct: K1's least time on the inputs of the profiled window's
last launch (its bytes over 3.35 TB/s, `harness.bounds.k1_bytes`), over
its mean device time a launch in that window (`torch.profiler`, by kernel
name), in %."""

from harness import bounds
from refsim.config import SolverType

KERNEL = "fused_solve_kernel"
# K1's entry as the fused route calls it: fused_solve(x, script=..., warm_start=..., ...)
CAPTURE = [("solver2d_tpu_torch.solvers.loops", "fused_solve")]


def read(ctx):
    ms = ctx.kernel_ms(KERNEL)
    got = ctx.captured.get(CAPTURE[0])
    if ms is None or got is None:
        return None
    (x, *_), kwargs = got
    nbytes = bounds.k1_bytes(x, SolverType[ctx.wl["solver"]], bool(kwargs["warm_start"]))
    bound_ms = nbytes / bounds.PEAK_BYTES_S * 1e3
    ctx.log(f"k1_roofline_pct: bound {bound_ms!r} ms by bytes ({nbytes} bytes), kernel {ms!r} ms a launch")
    return 100.0 * bound_ms / ms
