"""Stage ii over several processes and hosts (port of
`moshpp_tpu/parallel/multihost.py`), on `torch.distributed`.

* `initialize_multihost` joins the process group (idempotent). The default
  group is gloo; where every rank drives a CUDA device of its own, the
  solve's collectives go through an NCCL group beside it. Two ranks on one
  card (which NCCL refuses) or on the CPU gather through gloo, on host
  tensors.
* `global_frame_mesh` is the mesh of this rank's device within the group,
  and `mosh_stageii_solve_multihost` solves a sequence whose frames are
  split over the ranks: each rank passes its own block of frames (the same
  count on every rank), the blocks are all-gathered once, every rank runs
  the global phases on the whole sequence, solves only its own shard of
  each phase, and x (F x D float32, with the iterations) is all-gathered
  after every phase. It returns this rank's frames.
* `distribute_jobs` is the static round robin of a job list over the ranks,
  for many independent sequences (no traffic at all; crash recovery from
  the head's idempotent stage caches).
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from moshpp_torch.parallel.sharding import FrameMesh, _resolve
from moshpp_torch.pipeline.stageii import (StageIIOptions, StageIIProblem,
                                           StageIIResult, mosh_stageii_solve)

# this process's place in the group: its device and the group the solve's
# collectives use (set by initialize_multihost)
_STATE = {}


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise ValueError("initialize_multihost: no CUDA device is visible; "
                         "pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> None:
    """Join the process group of `num_processes` ranks as rank `process_id`,
    with rank 0 listening at `coordinator_address` ("host:port"); with no
    address, from the environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
    `WORLD_SIZE`). `device` is this rank's device (default: the CUDA device
    `LOCAL_RANK`, or 0). A second call returns at once.

    The backend: NCCL where every rank's device is a CUDA device that no
    other rank on its host drives, else gloo (reported by
    `multihost_backend`)."""
    if dist.is_initialized():
        return
    dev = _resolve(device) if device is not None else _default_device()
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group("gloo", **kw)
    places = [None] * dist.get_world_size()
    dist.all_gather_object(places, (socket.gethostname(), str(dev)))
    own_card = (all(d.startswith("cuda") for _, d in places)
                and len(set(places)) == len(places))
    # every rank makes the same choice, so every rank takes part in
    # new_group as it must
    group = None
    if own_card:
        torch.cuda.set_device(dev)      # NCCL's communicator binds to it
        group = dist.new_group(backend="nccl")
    _STATE.update(device=dev, group=group,
                  backend="nccl" if own_card else "gloo")


def multihost_backend() -> str:
    """'nccl' or 'gloo': the backend of the solve's collectives."""
    _check()
    return _STATE["backend"]


def _check():
    if not dist.is_initialized() or not _STATE:
        raise RuntimeError("call initialize_multihost first")


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """`t` of every rank, concatenated along dim 0 in rank order, on t's
    device (NCCL on the device, gloo through host tensors)."""
    n = dist.get_world_size()
    if _STATE["group"] is not None and t.is_cuda:
        out = t.new_empty((n * t.shape[0],) + t.shape[1:])
        dist.all_gather_into_tensor(out, t.contiguous(),
                                    group=_STATE["group"])
        return out
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(t.device)


def global_frame_mesh(axis_name: str = "frames") -> FrameMesh:
    """The mesh of this rank's device within the group: a solve on it
    solves this rank's block of the shards and gathers the others'."""
    _check()
    return FrameMesh((_STATE["device"],), axis_name,
                     process_index=dist.get_rank(),
                     num_processes=dist.get_world_size(),
                     all_gather=_all_gather)


def distribute_jobs(jobs: Sequence[dict],
                    process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[dict]:
    """This rank's jobs of a job list: every num_processes-th from its
    rank on (the group's rank and size when not given; 0 of 1 without a
    group). Replaces the reference's filesystem job claiming with a static
    partition; a rerun skips the stages a crashed run finished."""
    grouped = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if grouped else 0)
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if grouped else 1)
    return [j for i, j in enumerate(jobs) if i % n == pid]


def mosh_stageii_solve_multihost(prob: StageIIProblem,
                                 opts: StageIIOptions,
                                 obs_local: np.ndarray,
                                 mask_local: np.ndarray,
                                 prior=None,
                                 model_type: Optional[str] = None,
                                 *, device) -> StageIIResult:
    """Stage ii of a sequence split over the group's ranks.

    obs_local (F_local, M, 3) / mask_local (F_local, M): this rank's block,
    frames [rank * F_local, (rank + 1) * F_local) of the sequence; every rank
    passes the same F_local (pad the last block with all-missing frames and
    slice them away). `device` is this rank's device, where `prob` and
    `prior` live. Returns this rank's frames as a StageIIResult of numpy
    arrays (host_syncs: this rank's)."""
    _check()
    device = torch.device(device)
    if _resolve(device) != _STATE["device"]:
        raise ValueError(f"device {device} is not this rank's "
                         f"({_STATE['device']})")
    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, tuple(np.shape(obs_local)))
    if len(set(shapes)) != 1:
        raise ValueError(f"every rank must pass the same block shape: "
                         f"{shapes}")
    F_local = shapes[0][0]
    obs = _all_gather(torch.as_tensor(np.asarray(obs_local, np.float32),
                                      device=device))
    mask = _all_gather(torch.as_tensor(np.asarray(mask_local, bool),
                                       device=device).to(torch.float32))
    res = mosh_stageii_solve(prob, opts, obs, mask > 0.5, prior=prior,
                             model_type=model_type,
                             mesh=global_frame_mesh(), device=device)
    mine = slice(dist.get_rank() * F_local, (dist.get_rank() + 1) * F_local)
    return StageIIResult(*[getattr(res, f)[mine].cpu().numpy()
                           for f in StageIIResult._fields[:-1]],
                         host_syncs=res.host_syncs)
