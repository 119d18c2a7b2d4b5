"""narrowphase_ms: mean ms a step in the narrowphase: K2 over every world's
contact slots (`ops/narrow_cuda.py`) with its inputs' packing and the id
matching (`step.update_manifolds`, `_apply_manifolds`); each call timed on
the host clock between two device syncs in the spans' window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.step', 'update_manifolds'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
