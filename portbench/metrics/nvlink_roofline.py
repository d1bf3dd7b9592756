"""Share of its NVLink roofline that rank 0's collectives reach in a sharded
prove, in %.

The least bytes rank 0 must send in a proof (:func:`proof_bytes`, from the
cell's shapes: ``log_n``, the configuration's ``ranks`` and
``num_queries``), at the card's NVLink bandwidth in one direction, over the
device time of rank 0's NCCL kernels (operations whose names start with
``nccl``) in the profiled stretch, times the proofs completed there.  No
count is read from the program or from a clock.  None where no NCCL
operation ran (one card, or gloo).  Moves ``prove_s``."""

UNIT = "%"

# NVIDIA H100 SXM5 data sheet: 900 GB/s of NVLink (fourth generation, 18
# links), both directions together: 450 GB/s one way
NVLINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}
ELEMENT = 16  # bytes of a field element (four 32-bit limbs)
DIGEST = 32


def proof_bytes(log_n: int, ranks: int, num_queries: int) -> int:
    """What rank 0 sends in a PCS proof of 2^log_n rows split over ``ranks``:
    an all-to-all sends the (W - 1)/W of its buffer that is for the others,
    an all-gather its block to W - 1 ranks, an all-reduce (a ring) 2 (W - 1)/W
    of its tensor.

    * the rows' turn from contiguous to cyclic, and the encode's two
      exchanges (the coefficients; the codeword's transposed columns);
    * each sharded tree's leaf digests (32 bytes a leaf, regrouped into
      subtrees) and its subtree root (all-gathered): the first tree, and the
      tree of every fold while the codeword has at least 4 W^2 values;
    * a round's two sums (4 int64 lanes each) while a rank's table block has
      two rows or more; then the table's last W rows (two 16-byte rows a
      rank) all-gathered, and once the codeword falls below 4 W^2 values its
      rank blocks all-gathered;
    * the openings: each of the log_n trees' pair leaves (2 elements) and
      siblings (32 bytes a level) at every query, in one all-reduce."""
    W, n = ranks, log_n
    a2a = lambda b: b * (W - 1) // W  # noqa: E731
    ring = lambda b: 2 * b * (W - 1) // W  # noqa: E731
    rows, code = 1 << n, 2 << n
    total = a2a(ELEMENT * rows // W) * 2 + a2a(ELEMENT * code // W)
    total += a2a(DIGEST * code // 2 // W) + DIGEST * (W - 1)
    tables, codeword = True, True
    for k in range(n):
        block = (rows >> k) // W
        if tables and block < 2:
            total += 2 * ELEMENT * block * (W - 1)
            tables = False
        if tables:
            total += ring(2 * 4 * 8)
        m = code >> k
        if m <= 2:
            continue
        if codeword and m < 4 * W * W:
            total += ELEMENT * m // W * (W - 1)
            codeword = False
        if codeword:
            total += a2a(DIGEST * m // 4 // W) + DIGEST * (W - 1)
    words = sum(2 * 4 + 8 * depth for depth in range(1, n + 1))
    return total + ring(4 * words * num_queries)


def read(ctx):
    ranks = ctx.config.get("ranks")
    peak = NVLINK_BYTES_PER_S.get(ctx.kind)
    nccl = [o for o in ctx.ops if o.name.startswith("nccl")]
    if not ranks or not peak or not nccl or not ctx.proofs:
        return None
    seconds = sum(o.end - o.start for o in nccl)
    least = ctx.proofs * proof_bytes(ctx.workload["log_n"], ranks, ctx.config["num_queries"]) / peak
    return 100.0 * least / seconds
