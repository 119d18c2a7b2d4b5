"""xla_solve_ms: mean ms a step in the XLA solve (`solvers/loops.solve_xla`):
the hints from the host, then the coloured passes, replayed from a CUDA
graph (`solvers/graphs.py`); each call timed on the host clock between two
device syncs in the spans' window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.step', 'solve_xla'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
