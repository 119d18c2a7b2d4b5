"""fused_solve_ms: mean ms a step in the fused solve: the preparation of
contacts and joints and the packing of K1's inputs
(`solvers/loops.prepare_fused`), K1 and the finish (`solve_prepared`); each
call timed on the host clock between two device syncs in the spans' window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.step', 'prepare_fused'),
    ('solver2d_tpu_torch.step', 'solve_prepared'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
