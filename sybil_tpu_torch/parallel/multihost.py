"""Multi-process runtime: one query, one mesh, N processes.

Port of sybil_tpu/parallel/multihost.py.  `torch.distributed` joins N
processes (one per card, or N local CPU processes in the tests) into one
process group; each process scans its local span of every block batch
(its Dl = D / N data shards, parallel/mesh.py), the shuffle's exchange
runs over the group (NCCL on cuda, gloo on cpu), every process ends with
the same merged result, and process 0 prints it.

Wire-up (any node):
    sybil_tpu_torch query ... -dist-coordinator host0:1234 -dist-pid K \\
        -dist-nproc N
or the SYBIL_DIST_COORDINATOR, SYBIL_DIST_PID and SYBIL_DIST_NPROC
variables.  With -device cuda process K takes card K mod the host's card
count.  Shared or partitioned storage both work: every process scans the
global block list's local span; sample collection re-reads matched blocks
from disk, so it needs the block dirs readable on every process.
"""

from __future__ import annotations

import os

import torch


def init_distributed(flags) -> bool:
    """Join the process group if -dist-coordinator (or the SYBIL_DIST_*
    variables) is set: NCCL for a cuda query, gloo for a cpu one, the
    rank's card made current.  Idempotent; returns True when this process
    is part of a process group."""
    import torch.distributed as dist
    coord = getattr(flags, "dist_coordinator", "") or \
        os.environ.get("SYBIL_DIST_COORDINATOR", "")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    nproc = getattr(flags, "dist_num_processes", 0) or \
        int(os.environ.get("SYBIL_DIST_NPROC", "0"))
    pid = getattr(flags, "dist_process_id", -1)
    if pid < 0:
        pid = int(os.environ.get("SYBIL_DIST_PID", "-1"))
    if nproc < 1 or not 0 <= pid < nproc:
        raise ValueError(f"-dist-pid {pid} and -dist-nproc {nproc} do not "
                         "name a process of the group")
    cuda = torch.device(flags.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coord}", world_size=nproc,
                            rank=pid)
    return True


def is_multiprocess() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_id() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_printer() -> bool:
    """Only one process talks to stdout (every process holds the same
    merged result)."""
    return not is_multiprocess() or process_id() == 0


def fetch(x, group=None):
    """A row array sharded over the processes, this process's span x
    [n, ...] -> the whole array [nproc * n, ...] in process order, on
    x's device (an all-gather; bool travels as uint8)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if x.dtype == torch.bool:
        return fetch(x.to(torch.uint8), group).to(torch.bool)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def shutdown() -> None:
    """Leave the process group, if this process joined one (the CLI's last
    step): every process waits for the others first, so none exits while
    a peer's collectives still talk to it."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
