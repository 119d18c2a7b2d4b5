"""coloring_ms: mean ms a step in the colouring (`step._color`): contact and
joint colours (`ops/coloring.py`, first-fit rounds or MIS) and the body maps
(`solvers/common.make_body_map`); each call timed on the host clock between
two device syncs in the spans' window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.step', '_color'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
