"""post_solve_ms: mean ms a step in the post-solve (`step._post_solve`): AABBs,
fat AABBs and diagnostics; each call timed on the host clock between two
device syncs in the spans' window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.step', '_post_solve'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
