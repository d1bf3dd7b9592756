"""Share of its bytes roofline that the NTT's two-stage butterfly kernel
(``butterfly2_kernel``, ``csrc/butterfly2.cu`` through ``field/cuda_ops``)
reaches, in %.

Every call makes two stages of one pass over the whole codeword batch that
the encode transforms.  The least bytes such a pass moves are each element
read once and written once: 2 x 16 bytes x (batch) x 2^(log_n + log_blowup),
the batch being the configuration's ``columns`` (1 for a plain PCS).  That
count, from the cell's shapes, over the card's published HBM bandwidth
(``core/peaks.py``), against the calls' device time from the trace.  No
count is read from the build or from a clock, so a kernel that does more
stages a call still reads the same work a call.  Moves ``prove_s``."""

from portbench.core import devtrace, peaks

UNIT = "%"
KERNEL = "butterfly2_kernel"
ELEMENT_BYTES = 16


def bytes_per_call(workload: dict, config: dict) -> int:
    m = 1 << (workload["log_n"] + config["log_blowup"])
    return 2 * ELEMENT_BYTES * config.get("columns", 1) * m


def read(ctx):
    calls = devtrace.calls(ctx.ops, KERNEL)
    if not calls:
        return None
    seconds = sum(c.end - c.start for c in calls)
    least = len(calls) * bytes_per_call(ctx.workload, ctx.config) / peaks.hbm_bytes_per_s(ctx.kind)
    return 100.0 * least / seconds
