"""Mean ms per proof in the program's ``rounds``: the PCS rounds: partial sums, the round's Fiat-Shamir on the device, table and codeword folds with their Merkle commits, and the one copy that ends them (sumcheck, fri, device_transcript).

Read from the program's phase timers (``utils.PhaseTimer``), which
synchronise the device at each mark, so they run only in the traced run's
second stretch.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "rounds")
