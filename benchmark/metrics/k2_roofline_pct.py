"""k2_roofline_pct: K2's least time on the inputs of the profiled window's
last launch (the larger of its bytes over 3.35 TB/s and its float
operations over 67 TFLOP/s, `harness.bounds`), over its mean device time a
launch in that window (`torch.profiler`, by kernel name), in %."""

from harness import bounds

KERNEL = "collide_kernel"
# K2's entry as the per-world step calls it: collide(geom, sa, sb, pa, pb, cache, gjk_iters)
CAPTURE = [("solver2d_tpu_torch.step", "collide")]


def read(ctx):
    ms = ctx.kernel_ms(KERNEL)
    got = ctx.captured.get(CAPTURE[0])
    if ms is None or got is None:
        return None
    args, kwargs = got
    inputs, gjk_iters = args[:6], kwargs.get("gjk_iters", args[6] if len(args) > 6 else None)
    bound_ms, by, nbytes, ops = bounds.k2_bound(inputs, bounds.k2_ops(bounds.k2_work(inputs, gjk_iters)))
    ctx.log(f"k2_roofline_pct: bound {bound_ms!r} ms by {by} ({nbytes} bytes, {ops!r} float ops), "
            f"kernel {ms!r} ms a launch")
    return 100.0 * bound_ms / ms
