"""Device operations (kernels, copies, memsets) in the traced stretch per
proof completed in it: the host's issue work, which sets the pace while the
device idles.  Moves ``prove_s``."""

UNIT = "launches"


def read(ctx):
    if not ctx.ops or not ctx.proofs:
        return None
    return len(ctx.ops) / ctx.proofs
