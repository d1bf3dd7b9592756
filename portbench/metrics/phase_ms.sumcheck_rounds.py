"""Mean ms per proof in the program's ``sumcheck_rounds``: the SNARK's trace sumcheck: the constraint expressions over ops.FA, the round kernel and the fold (system, sumcheck); only a SNARK has it.

Read from the program's phase timers (``utils.PhaseTimer``), which
synchronise the device at each mark, so they run only in the traced run's
second stretch.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "sumcheck_rounds")
