"""broadphase_ms: mean ms a step in the broadphase (`ops/broadphase.py`): the
pair finder of every world and the persistent match of the contact table;
each call timed on the host clock between two device syncs in the spans'
window."""

# the wrapped functions, (module, attribute) as the step looks them up
SPANS = [
    ('solver2d_tpu_torch.ops.broadphase', 'find_pairs_by'),
    ('solver2d_tpu_torch.ops.broadphase', 'match_contacts'),
]


def read(ctx):
    return ctx.span_ms(SPANS)
