"""Starting the ranks: ``torch.distributed.init_process_group`` and the
:class:`ShardLayout` of this process.

Counterpart of the JAX package's ``parallel/multihost.py``.  One code path
serves one host or many, torchrun or explicit arguments:

    # torchrun --nproc-per-node 4 prove.py       (RANK, WORLD_SIZE,
    layout = multihost.init_from_env()            #  MASTER_ADDR/PORT set)
    # or, in each of W processes started some other way:
    layout = multihost.init(rank, W, "tcp://host0:29500")

    evals = layout.shard_rows(all_evals)          # this rank's block
    proof = PCSProof.prove(point, output, evals, Transcript(), layout=layout)
    multihost.shutdown()

Every rank computes the identical proof; which rank writes it out is the
caller's choice.

The backend is chosen here, once, and printed: NCCL when each rank has a
card of its own (``cuda:LOCAL_RANK``), gloo when the ranks run on the CPU or
share one card - NCCL refuses two ranks on one GPU.  Nothing swaps it later.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from . import ShardLayout


def choose(world: int, device: str = "cuda", local_rank: int = 0):
    """(backend, device) for a rank: NCCL on a card of its own when the host
    has a card for every local rank, else gloo (on the CPU, or every rank on
    card 0)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", torch.device("cpu")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.device_count() >= local_world and local_world > 1:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", dev.index or 0)


def init(rank: int, world: int, addr: str, device: str = "cuda", local_rank: Optional[int] = None) -> ShardLayout:
    """Join the process group at ``addr`` (``tcp://host:port``) as ``rank`` of
    ``world`` and return this rank's layout.  ``device``: ``"cuda"`` (the
    default) or ``"cpu"``; ``local_rank``: the rank among this host's
    processes (default: ``rank``, one host)."""
    import torch.distributed as dist

    local_rank = rank if local_rank is None else local_rank
    backend, dev = choose(world, device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world)
    print(f"multilinear_tpu_torch.parallel: rank {rank} of {world}, backend {backend}, device {dev}",
          file=sys.stderr, flush=True)
    return ShardLayout(world=world, rank=rank, device=dev, backend=backend)


def init_from_env(device: str = "cuda") -> ShardLayout:
    """:func:`init` from torchrun's variables: RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT."""
    env = os.environ
    addr = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    return init(int(env["RANK"]), int(env["WORLD_SIZE"]), addr, device,
                local_rank=int(env.get("LOCAL_RANK", 0)))


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
