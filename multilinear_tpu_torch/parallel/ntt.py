"""The sharded encode: Moebius transform, coefficient bit-reversal,
zero-padding and the four-step transform over W ranks, from cyclic
evaluations to a cyclic codeword, with two all-to-alls.

Counterpart of the JAX package's ``fri.encode_mle_for_fri`` on a mesh and
its ``ntt._fourstep_shard_map`` (local sub-NTTs and three all-to-alls).
Notation: n = 2^N evaluations, rank r of W = 2^w holds e[i] for i = r mod W
(local index u = i div W); the codeword has m = 2n = A B values, A = 2^a,
a = ceil(log m / 2), and the four-step transform reads the padded
bit-reversed coefficients as an (A, B) matrix X[alpha, beta] = y[alpha B + beta],
y[j] = coeff[bitrev_N(j)] below n and 0 above (rows alpha >= A/2 are zero).

1. **Moebius, local bits.**  The transform is a product of commuting
   per-bit steps; the bits of u are this rank's, so one ``zm_butterfly``
   pass over the local block does them all.
2. **Exchange 1 = the bit-reversal + the four-step's first all-to-all.**
   Rank r's column block of X (beta in [r B/W, (r+1) B/W)) holds exactly the
   coefficients whose index bits [a-1, a-1+w) read bitrev_w(r) - bits of u,
   so every rank sends each rank the 1/W of its block with that field:
   n/W^2 elements a pair.
3. **Moebius, the rank bits.**  After the exchange the source rank s - the
   low w bits of i - is the leading axis of what arrived, so the last w
   Moebius steps are w ``sub`` passes over its halves.
4. **Placement.**  What arrived is M[hi, lo W + s] with
   X[alpha, beta'] = M[bitrev(beta'), bitrev(alpha)]: two local row gathers
   and a transpose, written under A/2 zero rows.
5. **Column NTTs** along A (``butterfly2`` / ``butterfly_notw``), the row
   bit-reversal, the twiddle pass (``twiddle_mul3``) over this rank's
   columns of the factors Tc and Tf - made from two small power tables, not
   from the domain's whole one.
6. **Exchange 2.**  Rank r' takes the transform's output rows
   k1 = r' mod W: chunk r' of (A/W, B/W) per pair.
7. **Row NTTs** along B and the row bit-reversal give H[k2, k1'] =
   out[k2 A + k1' W + r]: the cyclic block of the codeword, in order.  The
   JAX package's third all-to-all, back to contiguous blocks, is not needed.

Needs a >= w + 1 and log B >= w (:func:`check_sizes`): the field of step 2
lies inside u, and every rank has a column block.
"""

from __future__ import annotations

import torch

from ..config import LOG_BLOWUP
from ..field import cuda_ops, ops
from ..field.scalar import P, pow2_generator
from ..mle import bitrev_indices
from ..ntt import _bitrev_rows, _pease_rows, _pow_table


def split(log_m: int):
    a = (log_m + 1) // 2
    return a, log_m - a


def check_sizes(log_n: int, w: int) -> None:
    """Raise unless a 2^log_n-row encode splits over 2^w ranks."""
    a, b = split(log_n + LOG_BLOWUP)
    if a < w + 1 or b < w:
        raise ValueError(f"2^{log_n} rows are too few to encode over {1 << w} ranks")


def _pow(gen_v: int, e: torch.Tensor, log_n: int, device) -> torch.Tensor:
    """gen^e for int64 exponents e in [0, 2^log_n): two small power tables
    and one ``mul``."""
    lo = log_n // 2
    t_lo = _pow_table(gen_v, lo, device)
    t_hi = _pow_table(pow(gen_v, 1 << lo, P), log_n - lo, device)
    return ops.mul(t_hi[e >> lo], t_lo[e & ((1 << lo) - 1)])


def twiddle_columns(gen_v: int, log_n: int, cols: slice, device):
    """Columns ``cols`` of the four-step factors Tc[k, b] = w^(k S b) and
    Tf[d, b] = w^(d b) (``ntt._twiddle_factors``), exponents mod n."""
    a, _ = split(log_n)
    A, S = 1 << a, 1 << (a // 2)
    n = 1 << log_n
    ib = torch.arange(cols.start, cols.stop, dtype=torch.int64, device=device)

    def factor(rows: int, step: int):
        ir = torch.arange(rows, dtype=torch.int64, device=device) * step
        return _pow(gen_v, (ir[:, None] * ib[None, :]) & (n - 1), log_n, device).contiguous()

    return factor(A // S, S), factor(S, 1)


def fourstep_columns(X: torch.Tensor, gen_v: int, log_n: int, layout) -> torch.Tensor:
    """The four-step transform over the 2^log_n domain of ``gen_v``, sharded:
    ``X`` is this rank's column block (A, B/W, 4) of the input vector read
    as an (A, B) matrix, x[alpha B + beta], or a batch of them (C, A, B/W, 4);
    returns this rank's cyclic block (n/W, 4) (or (C, n/W, 4)) of the
    natural-order output, out[t W + r]: steps 5-7 of the module docstring.
    A batch goes through the same launches and the same exchange."""
    W, r = layout.world, layout.rank
    a, b = split(log_n)
    A, B = 1 << a, 1 << b
    single = X.dim() == 3
    X = X.unsqueeze(0) if single else X
    C = X.shape[0]
    if X.shape[1:] != (A, B // W, 4):
        raise ValueError(f"fourstep_columns: expected a ({A}, {B // W}, 4) column block, got {tuple(X.shape)}")
    dev = X.device
    X = _bitrev_rows(_pease_rows(X, _pow_table(pow(gen_v, B, P), max(a - 1, 0), dev), a), a)
    Tc, Tf = twiddle_columns(gen_v, log_n, slice(r * B // W, (r + 1) * B // W), dev)
    G = cuda_ops.twiddle_mul3(X, Tc, Tf)
    del X
    recv = layout.comm.all_to_all(G.view(C, A // W, W, B // W, 4).permute(2, 0, 1, 3, 4))
    del G
    Y = recv.permute(1, 0, 3, 2, 4).reshape(C, B, A // W, 4)  # (beta, k1')
    del recv
    H = _bitrev_rows(_pease_rows(Y, _pow_table(pow(gen_v, A, P), max(b - 1, 0), dev), b), b)
    H = H.reshape(C, -1, 4)
    return H[0] if single else H


def _moebius_rank_bits(x: torch.Tensor, w: int) -> torch.Tensor:
    """The Moebius steps over the bits of the leading (2^w, ...) axis, in
    place: hi -= lo for each bit."""
    for j in range(w):
        v = x.view((1 << (w - 1 - j), 2, 1 << j, -1, 4))
        ops.sub(v[:, 1], v[:, 0], out=v[:, 1])
    return x


def exchange1_send(coeffs: torch.Tensor, log_n: int, W: int) -> torch.Tensor:
    """Step 2's send buffer: the local coefficients (C, n/W, 4) of C
    polynomials as (W, C, n_hi, n_lo, 4), chunk r the local u whose bits
    [a-1-w, a-1) read bitrev_w(r)."""
    w = W.bit_length() - 1
    a, b = split(log_n + LOG_BLOWUP)
    n_lo, n_hi = 1 << (a - 1 - w), 1 << (b - w)
    x = coeffs.view(coeffs.shape[0], n_hi, W, n_lo, 4).permute(2, 0, 1, 3, 4)
    return x.index_select(0, bitrev_indices(W, coeffs.device))


def exchange1_place(recv: torch.Tensor, log_n: int, W: int) -> torch.Tensor:
    """Steps 3-4: the received (W, C, n_hi, n_lo, 4) coefficients (chunk s
    from rank s) -> this rank's column blocks (C, A, B/W, 4) of the padded
    bit-reversed coefficient matrices."""
    w = W.bit_length() - 1
    a, b = split(log_n + LOG_BLOWUP)
    A = 1 << a
    recv = _moebius_rank_bits(recv.contiguous(), w)
    C, n_hi = recv.shape[1], recv.shape[2]
    M = recv.permute(1, 2, 3, 0, 4).reshape(C, n_hi, A // 2, 4)  # M[hi, lo W + s]
    M = M.index_select(1, bitrev_indices(n_hi, M.device)).index_select(2, bitrev_indices(A // 2, M.device))
    X = torch.zeros((C, A, n_hi, 4), dtype=torch.int32, device=M.device)
    X[:, : A // 2] = M.transpose(1, 2)
    return X


def encode_cyclic(evals: torch.Tensor, layout) -> torch.Tensor:
    """This rank's cyclic block (n/W, 4) of the evaluations -> its cyclic
    block (2n/W, 4) of the Reed-Solomon codeword of the bit-reversed
    coefficients: the sharded ``fri.encode_mle_for_fri``.  A batch of C
    columns, (C, n/W, 4) -> (C, 2n/W, 4), is one pass: the same launches
    and the same two all-to-alls, each carrying all C columns."""
    W = layout.world
    single = evals.dim() == 2
    evals = evals.unsqueeze(0) if single else evals
    log_n = (evals.shape[-2] * W).bit_length() - 1
    check_sizes(log_n, layout.log_world)
    coeffs = cuda_ops.zm_butterfly(evals, add=False)
    recv = layout.comm.all_to_all(exchange1_send(coeffs, log_n, W))
    del coeffs
    X = exchange1_place(recv, log_n, W)
    del recv
    log_m = log_n + LOG_BLOWUP
    code = fourstep_columns(X, pow2_generator(log_m).v, log_m, layout)
    return code[0] if single else code
