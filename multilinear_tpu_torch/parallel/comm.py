"""The few collectives the sharded prover needs, and nothing else.

* :meth:`Comm.exact_sum` - the exact mod-p sum of a round's partial sums;
* :meth:`Comm.all_gather` - the W subtree roots (32 bytes each), and the
  small tail that every rank finishes alone;
* :meth:`Comm.all_to_all` - the regroup of a new tree's leaf digests, the
  two exchanges of the encode, the turn from batch blocks to row blocks;
* :meth:`Comm.all_reduce_sum` - the gather of the opened queries (each entry
  is non-zero on one rank only, so the sum is that rank's value).

**Where the limbs overflow.**  A partial sum arrives as four unreduced int64
lanes per element (``ops.sum_limbs``: up to about 2^63 each for 2^31 rows of
a rank).  Summed raw over W ranks they overflow.  So each rank first reduces
its lanes to the canonical residue (:func:`canonical_lanes`, exact for any
lane in [0, 2^63)), and the ranks sum the four 32-bit limbs of those
residues in int64 lanes: W ranks give lanes below W 2^32, which the round's
Fiat-Shamir kernel reduces as it reduces a single card's sums.  The row limit
of one sum (2^31 rows, ``sumcheck._partial_sums_kernel``) is thus a rank's:
W ranks take W 2^32 rows.

**Backends.**  NCCL when each rank has a card of its own; gloo when the
ranks run on the CPU or share one card (NCCL refuses two ranks on one GPU).
On CUDA tensors gloo takes ``all_reduce`` and ``broadcast`` only (PyTorch's
backend table), so under gloo the other collectives of a CUDA tensor go
through host tensors: one copy to the host and one back, counted in
``stats`` as ``collective_staged_copies``.  The backend is fixed when the
process group is made and never swapped.

Each of the four calls (:meth:`Comm.all_to_all`, :meth:`Comm.all_gather`,
:meth:`Comm.all_reduce_sum`, :meth:`Comm.barrier`) is a ``collective`` span
(``utils.span``), staging copies included.

Counters (``stats``): ``collectives`` (calls), ``collective_bytes`` (the
bytes this rank must get to the other ranks: an all-to-all's chunks for the
others, an all-gather's chunk times W - 1, an all-reduce's tensor times
2 (W - 1) / W, as a ring moves it) and ``collective_staged_copies``.
"""

from __future__ import annotations

import torch

from .. import stats
from ..field import ops
from ..utils import span

# the collectives gloo runs on CUDA tensors itself (broadcast too, which the
# prover does not use); the others are staged through the host
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce"})

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def canonical_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """S+(4,) int64 unreduced limb sums (value sum_i lane_i 2^(32 i), each
    lane in [0, 2^63)) -> the S+(4,) int64 lanes of the canonical residue,
    each below 2^32.

    Each lane is split into its low 32 bits and the rest before any carry
    is added, so nothing overflows whatever the lanes hold; then the wide
    value is carry-normalized into 16-bit limbs and folded mod p as
    ``ops.sum_mod`` does."""
    zero = torch.zeros_like(lanes[..., 0])
    cols = [zero] * 12
    for i in range(4):
        lo = lanes[..., i] & _M32
        hi = lanes[..., i] >> 32  # below 2^31
        cols[2 * i] = cols[2 * i] + (lo & _M16)
        cols[2 * i + 1] = cols[2 * i + 1] + (lo >> 16)
        cols[2 * i + 2] = cols[2 * i + 2] + (hi & _M16)
        cols[2 * i + 3] = cols[2 * i + 3] + (hi >> 16)
    limbs16, _ = ops._carry_normalize(cols, 12)  # the value is below 2^159: no carry out
    canon = ops._join16(ops._reduce_wide16(limbs16))
    return canon.to(torch.int64) & _M32


class Comm:
    """The collectives of one rank; see the module docstring."""

    def __init__(self, world: int, rank: int, backend: str):
        self.world = world
        self.rank = rank
        self.backend = backend

    # -- plumbing --------------------------------------------------------------
    def _staged(self, op: str, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda" and op not in GLOO_CUDA_COLLECTIVES

    def _count(self, nbytes: float) -> None:
        stats.bump("collectives")
        stats.bump("collective_bytes", int(nbytes))

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        stats.bump("collective_staged_copies")
        return t.cpu()

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        stats.bump("collective_staged_copies")
        return t.to(device)

    # -- the collectives -------------------------------------------------------
    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send``: (W, ...) contiguous, chunk r for rank r.  Returns (W, ...)
        with chunk s from rank s."""
        import torch.distributed as dist

        if send.shape[0] != self.world:
            raise ValueError(f"all_to_all: {send.shape[0]} chunks for {self.world} ranks")
        with span("collective"):
            send = send.contiguous()
            self._count(send.numel() * send.element_size() * (self.world - 1) / self.world)
            dev = send.device
            staged = self._staged("all_to_all", send)
            inp = self._to_host(send) if staged else send
            out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp)
            return self._back(out, dev) if staged else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from every rank, stacked by rank: (W,) + t.shape."""
        import torch.distributed as dist

        with span("collective"):
            t = t.contiguous()
            self._count(t.numel() * t.element_size() * (self.world - 1))
            dev = t.device
            staged = self._staged("all_gather", t)
            inp = self._to_host(t) if staged else t
            outs = [torch.empty_like(inp) for _ in range(self.world)]
            dist.all_gather(outs, inp)
            out = torch.stack(outs)
            return self._back(out, dev) if staged else out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks (a new tensor)."""
        import torch.distributed as dist

        with span("collective"):
            out = t.contiguous().clone()
            self._count(out.numel() * out.element_size() * 2 * (self.world - 1) / self.world)
            dev = out.device
            staged = self._staged("all_reduce", out)
            buf = self._to_host(out) if staged else out
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            return self._back(buf, dev) if staged else buf

    def barrier(self) -> None:
        """Wait until every rank has called it (a sharded save returns only
        once rank 0 has written the file)."""
        import torch.distributed as dist

        with span("collective"):
            dist.barrier()

    def exact_sum(self, lanes: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of field values given as unreduced int64
        limb lanes S+(4,): each rank reduces its own to the canonical
        residue, then the ranks add the residues' limbs in int64.  The
        result's lanes are below W 2^32: unreduced lanes whose value is the
        exact sum."""
        return self.all_reduce_sum(canonical_lanes(lanes))
