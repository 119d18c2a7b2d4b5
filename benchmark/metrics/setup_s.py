"""setup_s: seconds from the harness's first line to the first timed step:
imports, CUDA start-up, the kernels' build (the first run of a checkout
only), the scene's freeze, the replicate and jitter, and the warm-up
steps (the XLA route's CUDA-graph capture among them)."""


def read(ctx):
    return ctx.setup_s
