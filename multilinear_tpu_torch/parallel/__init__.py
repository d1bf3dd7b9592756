"""Multi-GPU proving over ``torch.distributed``: one process per rank.

Counterpart of the JAX package's ``parallel`` (a 1-D ``rows`` mesh whose
hypercube axis, or batch axis, is sharded) and ``dist`` (gathering a
sharded array before the host reads it).  Here W processes each hold one
block; the collectives are ``torch.distributed`` calls between the kernels
(:mod:`.comm`), and the kernels run unchanged on the local blocks.  Every
rank runs the same transcript on the same bytes and ends with the same
proof, byte for byte the single-device proof.

What a caller hands each rank (:class:`ShardLayout`):

* ``shard_rows(x)`` - the rank's contiguous block of the hypercube (or
  codeword) axis: rows ``[r n/W, (r+1) n/W)``, W a power of two;
* ``shard_batch(polys)`` - the rank's contiguous block of whole polynomials
  of a batch: polynomials ``[r B/W, (r+1) B/W)``; W must divide B (the JAX
  package refuses an uneven batch too: its ``device_put`` raises).

Inside the prover the rows live CYCLICALLY: rank r holds the elements whose
index is r mod W, in index order (:func:`to_cyclic`).  In that layout every
pair a round combines - the sumcheck fold's (i, i + h/2), the FRI fold's
(i, i + m/2), the pair leaf's (i, i + m/4) - lies on one rank for every
round, so folds and leaf hashes make no traffic at all.  What crosses ranks
is a round's two partial sums (an exact mod-p sum, :func:`comm.Comm.exact_sum`),
the leaf digests of each new tree (one all-to-all into contiguous subtrees,
:mod:`.merkle`), the W subtree roots, the two all-to-alls of the encode
(:mod:`.ntt`) and the opened queries.  See :mod:`.rounds` for the round and
:mod:`.multihost` for starting the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .comm import Comm


def log2_exact(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


@dataclass
class ShardLayout:
    """Where this rank sits in the default process group: world size W,
    its rank, the device its blocks live on and the backend that moves them
    (``"nccl"`` or ``"gloo"``, chosen once by :func:`.multihost.init`)."""

    world: int
    rank: int
    device: torch.device
    backend: str
    comm: Comm = field(init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")
        self.comm = Comm(self.world, self.rank, self.backend)

    @property
    def log_world(self) -> int:
        return log2_exact(self.world, "the world size")

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of the value axis of an (n, 4) or
        (B, n, 4) tensor, moved to the layout's device."""
        log2_exact(self.world, "the world size of a row-sharded prove")
        n = x.shape[-2]
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        h = n // self.world
        return x[..., self.rank * h : (self.rank + 1) * h, :].to(self.device).contiguous()

    def shard_batch(self, polys: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of whole polynomials of a (B, n, 4)
        batch, moved to the layout's device."""
        B = polys.shape[0]
        if polys.dim() != 3 or B % self.world:
            raise ValueError(f"a batch of {B} polynomials does not split evenly over {self.world} ranks")
        b = B // self.world
        return polys[self.rank * b : (self.rank + 1) * b].to(self.device).contiguous()

    def gather_rows(self, block: torch.Tensor) -> torch.Tensor:
        """The whole (..., n, 4) tensor from every rank's contiguous
        (..., n/W, 4) block, on every rank."""
        g = self.comm.all_gather(block.contiguous())  # (W, ..., n/W, 4)
        return g.movedim(0, -3).reshape(tuple(block.shape[:-2]) + (-1, 4))

    def cyclic_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's cyclic block of the value axis of a whole (..., n, 4)
        tensor - the rows i = rank mod W - moved to the layout's device."""
        if x.shape[-2] % self.world:
            raise ValueError(f"{x.shape[-2]} rows do not split over {self.world} ranks")
        return x[..., self.rank :: self.world, :].to(self.device).contiguous()


def to_cyclic(block: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """Contiguous blocks -> cyclic blocks of the value axis of (..., h, 4),
    one all-to-all: rank s holds rows i = s h + u (h = n/W); rank r receives
    the rows i = r mod W, i.e. row i goes to local index i div W.  Needs h to
    be a multiple of W; the leading axes (a batch of columns) go in the same
    exchange."""
    send = contiguous_to_cyclic_send(block, layout.world)
    return cyclic_from_recv(layout.comm.all_to_all(send))


def contiguous_to_cyclic_send(block: torch.Tensor, W: int) -> torch.Tensor:
    """The all-to-all's send buffer of :func:`to_cyclic`, (W, ..., h/W, 4):
    chunk r holds the local rows u = r mod W (h a multiple of W, so i = u mod W)."""
    h = block.shape[-2]
    if h % W:
        raise ValueError(f"a block of {h} rows does not split over {W} ranks")
    lead = tuple(block.shape[:-2])
    return block.reshape(lead + (h // W, W, 4)).movedim(-2, 0).contiguous()


def cyclic_from_recv(recv: torch.Tensor) -> torch.Tensor:
    """What :func:`to_cyclic` receives, (W, ..., h/W, 4) chunks by source
    rank s (rows i = s h + t' W + r), is in local order t = s h/W + t' once
    the source axis stands before the rows."""
    return recv.movedim(0, -3).reshape(tuple(recv.shape[1:-2]) + (-1, 4))


def gather_cyclic(block: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """Every rank's cyclic block of the value axis, (..., n/W, 4) -> the whole
    (..., n, 4) tensor in natural order, on every rank: global row t W + s is
    row t of rank s."""
    g = layout.comm.all_gather(block.contiguous())  # (W, ..., n/W, 4)
    return g.movedim(0, -2).reshape(tuple(block.shape[:-2]) + (-1, 4)).contiguous()
