"""Replicate sharding across processes.

The reference's only scaling mechanism is GNU-Parallel process fan-out over
independent (bootstrap replicate x split time) fits (README.md:110-115,
test.bs/*.sh).  Here the fits are split by rows over the processes of a
``torch.distributed`` group, one process per rank as ``torchrun`` starts
them: each rank fits a contiguous block of the cells in lockstep on its own
device, and the result tables are all-gathered so that every rank holds them
whole and takes the same decisions from them.

The collectives run on gloo over host tensors: the gathered tables are small
(at most a few floats per cell), the sweep's scheduler reads them on the host
anyway, NCCL refuses two ranks on one device, and gloo gathers no CUDA
tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Join the process group; returns it, or None for a single process.

    With no arguments the group is read from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    ``coordinator`` is ``host:port`` of rank 0.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return None
    if not dist.is_initialized():
        if coordinator is None:
            dist.init_process_group("gloo", init_method="env://")
        else:
            dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                    world_size=num_processes, rank=process_id)
    return dist.group.WORLD


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_device(platform: str = "cuda") -> torch.device:
    """The rank's device: ``cuda:(LOCAL_RANK % device count)`` (every rank of
    a one-card machine shares ``cuda:0``), or the CPU for ``platform="cpu"``.
    Raises for CUDA without a card."""
    if platform == "cpu":
        return torch.device("cpu")
    resolve_device(platform)
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def pad_to_multiple(arr: torch.Tensor, multiple: int, fill=0.0):
    """Pad axis 0 to a multiple of the world size with ``fill``; returns
    (padded, original_len)."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr, b
    pad = torch.full((rem, *arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad]), b


def row_block(n_rows: int, world: int, rank_: int) -> slice:
    """The rank's contiguous block of ``n_rows`` rows (a multiple of
    ``world``)."""
    if n_rows % world:
        raise ValueError(f"{n_rows} rows do not split over {world} ranks")
    per = n_rows // world
    return slice(rank_ * per, (rank_ + 1) * per)


def all_gather_rows(t: torch.Tensor, group, n_rows: int) -> torch.Tensor:
    """Every rank's row block of ``t`` concatenated in rank order, padding
    rows past ``n_rows`` dropped, on ``t``'s device and in its dtype.  Every
    rank of ``group`` must call it with blocks of one shape."""
    if group is None:
        return t[:n_rows]
    host = t.detach().cpu().contiguous()
    # flags travel as uint8, a dtype every gloo build gathers
    wire = host.to(torch.uint8) if host.dtype == torch.bool else host
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)[:n_rows]
    return out.to(device=t.device, dtype=t.dtype)
