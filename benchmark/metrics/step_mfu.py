"""step_mfu: the whole step's share of the card's peak, in %: the least
time the step could take, the bytes it must move over the memory rate
(3.35 TB/s), over the mean wall time of a step in the measured window.
The bytes: every tensor of the batch's state read once, and every one
that a step can change written once (all but the shapes' geometry and
material and the gravity). The step's float operations are not counted,
so this is a bound by bytes alone, as K1's roofline is. A kernel's
roofline can rise while this share does not; a gain is claimed only
where this share still bounds it."""

from harness.bounds import PEAK_BYTES_S

# state tensors that no step writes
CONSTANT = ("shapes.", "gravity")
KEEP = ("shapes.aabb", "shapes.fat_aabb")


def read(ctx):
    if not ctx.state_bytes or not ctx.step_s:
        return None
    read_b = sum(ctx.state_bytes.values())
    written = sum(n for k, n in ctx.state_bytes.items() if k in KEEP or not k.startswith(CONSTANT))
    mean_step_s = ctx.window_s / len(ctx.step_s)
    return 100.0 * (read_b + written) / PEAK_BYTES_S / mean_step_s
