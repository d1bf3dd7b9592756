"""Mean ms per proof in the program's ``queries``: the query openings and their copy to the host (entry: pcs / batched_pcs, FriProverData.open_queries).

Read from the program's phase timers (``utils.PhaseTimer``), which
synchronise the device at each mark, so they run only in the traced run's
second stretch.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "queries")
