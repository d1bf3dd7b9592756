"""Mean ms per proof in the program's first commitment: the layer-0 pair
tree of the codeword (``commit_l0``, plain PCS) or the column tree of the
batched codewords (``commit_batch``): ``merkle`` and the SHA-256 kernels.

Read from the program's phase timers (``utils.PhaseTimer``), which
synchronise the device at each mark, so they run only in the traced run's
second stretch.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "commit_l0", "commit_batch")
