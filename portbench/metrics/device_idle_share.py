"""Share of the traced stretch in which no operation ran on the device, in
%: 1 - (the union of the device's kernel, copy and memset intervals) /
(the stretch's wall time, host clock ending in a synchronise).  The host
sets the pace where it is high.  Moves ``prove_s``."""

from portbench.core import devtrace

UNIT = "%"


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(ctx.ops) / ctx.window_s)
