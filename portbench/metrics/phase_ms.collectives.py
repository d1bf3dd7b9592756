"""Mean ms per proof that rank 0 of a sharded prove spends in the program's
``collective`` phase: its calls of ``parallel.comm.Comm`` (all-to-all,
all-gather, all-reduce, barrier), each from an empty queue (the work queued
before the call is its layer's) until the collective is done on this rank,
the wait for the other ranks included.  The phase is nested in the layers' phases (``encode``,
``commit_l0``, ``rounds``, ``queries``), whose times include it.

Read from the program's phase timers (``utils.span`` under
``collect_phases``), which synchronise the device at each mark, so they run
only in the traced run's second stretch.  A one-card prove has no such
phase.  Moves ``prove_s``."""

from portbench.core.readers import phase_ms

UNIT = "ms"


def read(ctx):
    return phase_ms(ctx, "collective")
