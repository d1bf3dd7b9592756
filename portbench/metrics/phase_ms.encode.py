"""Mean ms per proof in the program's ``encode``: the encode: Moebius transform and four-step NTT (ntt, the butterfly and twiddle kernels).

Read from the program's phase timers (``utils.PhaseTimer``), which
synchronise the device at each mark, so they run only in the traced run's
second stretch.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "encode")
