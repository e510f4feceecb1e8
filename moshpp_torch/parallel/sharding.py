"""Stage ii with the frame axis sharded over several devices of one process
(port of `moshpp_tpu/parallel/sharding.py`).

The frame axis of stage ii is data-parallel but for the velocity term of
the smoothing sweeps, which ties a frame to the two before it. The solve
keeps the JAX package's schedule (`moshpp_tpu/pipeline/stageii.py:957-
1031`): each phase's dogleg solve runs on contiguous shards of the frames,
one shard a device, with compaction and termination local to the shard and
no traffic inside the loop; the couplings (the velocity anchors, with their
2-frame halo across shards, the rigid init, the slerps between anchors, the
report and the finalize) run on the global frames on the problem's device.
Here a shard is driven by a host thread of its own (`pipeline/stageii.py::
_Shards`), where the JAX package runs one SPMD program under `shard_map`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from moshpp_torch.pipeline.stageii import (StageIIOptions, StageIIProblem,
                                           StageIIResult, mosh_stageii_solve)


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """The devices of a frame-sharded solve, one per shard, in frame order.
    A device may appear more than once (two shards on one card, or
    `["cpu"] * n` on the host).

    Over processes (`parallel.multihost.global_frame_mesh`), `devices` are
    this process's, its shards are `process_index`'s block of the
    `num_processes` blocks, and `all_gather` concatenates a tensor of every
    process along dim 0, in rank order."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "frames"
    process_index: int = 0
    num_processes: int = 1
    all_gather: Optional[object] = None

    @property
    def num_shards(self) -> int:
        """Shards over all the mesh's processes."""
        return len(self.devices) * self.num_processes

    @property
    def shape(self):
        """{axis_name: shards}, as a JAX mesh's."""
        return {self.axis_name: self.num_shards}


def _resolve(device) -> torch.device:
    """A mesh device as a torch device with its index; raise for a device
    this process does not have."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"mesh device {dev}: only cpu and cuda devices")
    if not torch.cuda.is_available():
        raise ValueError(f"mesh device {dev}: no CUDA device is visible")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"mesh device {dev}: this process sees "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def frame_mesh(devices: Optional[Sequence] = None,
               axis_name: str = "frames") -> FrameMesh:
    """A one-axis mesh over `devices` (torch devices or their names, one a
    shard), by default every visible CUDA device. A device that is not
    there raises a ValueError."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("frame_mesh: no CUDA device is visible; name the "
                             "devices, e.g. frame_mesh(['cpu'] * 2)")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devs = tuple(_resolve(d) for d in devices)
    if not devs:
        raise ValueError("frame_mesh: no device")
    return FrameMesh(devs, axis_name)


def pad_frames(obs: np.ndarray, mask: np.ndarray, multiple: int):
    """Pad the frame axis to a multiple of `multiple` with all-missing
    frames: (obs, mask, the original frame count). The solver's per-frame
    weights follow the observed markers, so such frames converge at once."""
    F = obs.shape[0]
    pad = (-F) % multiple
    if pad == 0:
        return obs, mask, F
    obs_p = np.concatenate([obs, np.zeros((pad,) + obs.shape[1:], obs.dtype)])
    mask_p = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
    return obs_p, mask_p, F


def mosh_stageii_solve_sharded(prob: StageIIProblem,
                               opts: StageIIOptions,
                               obs: np.ndarray,
                               mask: np.ndarray,
                               prior=None,
                               model_type: Optional[str] = None,
                               mesh: Optional[FrameMesh] = None
                               ) -> StageIIResult:
    """Stage ii of all F frames with each phase's solve sharded over `mesh`
    (default: every visible CUDA device); the global phases run on the
    problem's device. Returns a StageIIResult of numpy arrays (host_syncs:
    the sum over the shards).

    Each phase pads its own batch to a multiple of the shards
    (`pipeline/stageii.py::_Shards`); the sequence is not padded, so an
    all-missing frame never becomes an anchor of the first pass."""
    mesh = mesh if mesh is not None else frame_mesh()
    res = mosh_stageii_solve(prob, opts, np.asarray(obs, np.float32),
                             np.asarray(mask, bool), prior=prior,
                             model_type=model_type, mesh=mesh,
                             device=prob.device)
    return StageIIResult(*[getattr(res, f).cpu().numpy()
                           for f in StageIIResult._fields[:-1]],
                         host_syncs=res.host_syncs)
