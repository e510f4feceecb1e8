"""Stage-I frame selection (port of `moshpp_tpu/pipeline/frame_picker.py`;
reference: `frame_picker.py:43-213`): pick ~12 well-observed frames across a
subject's mocap sessions, the same frames from the same seed.

Three strategies with the reference's semantics:
  manual         — explicit `/path/to/mocap.c3d_frameidx` entries
  random         — shuffled pick with recursive availability-threshold
                   relaxation when too few frames qualify
  random_strict  — seeded pick with a hard threshold (raises when starved)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from moshpp_torch.io.mocap import MocapSession

_MAX_SCANNED_FRAMES = 100  # read cap across session files (frame_picker.py:199-201)


def _session(fname, mocap_unit, mocap_rotate, only_subjects, only_markers,
             exclude_markers, labels_map):
    return MocapSession(mocap_fname=fname, mocap_unit=mocap_unit,
                        mocap_rotate=mocap_rotate, only_subjects=only_subjects,
                        only_markers=only_markers, exclude_markers=exclude_markers,
                        labels_map=labels_map)


def load_marker_sessions_manual(mocap_fnames: List[str], mocap_unit: str,
                                mocap_rotate=None, only_subjects=None,
                                only_markers=None, exclude_markers=None,
                                labels_map=None) -> Tuple[list, list]:
    """Entries are `/path/to/mocap_frameidx` (frame_picker.py:43-68)."""
    frames, names = [], []
    for entry in mocap_fnames:
        stem, fid = entry.rsplit("_", 1)
        fid = int(fid)
        assert os.path.exists(stem), FileNotFoundError(stem)
        s = _session(stem, mocap_unit, mocap_rotate, only_subjects,
                     only_markers, exclude_markers, labels_map)
        frames.append(s.markers_asdict()[fid])
        names.append(f"{stem}_{fid:06d}")
    return frames, names


def load_marker_sessions_random(mocap_fnames: List[str], mocap_unit: str,
                                mocap_rotate=None, num_frames: int = 12,
                                only_subjects=None, seed: Optional[int] = None,
                                least_avail_markers: float = 0.1,
                                only_markers=None, exclude_markers=None,
                                labels_map=None) -> Tuple[list, list]:
    """Random pick; threshold relaxes by 0.01 recursively when starved
    (frame_picker.py:136-145)."""
    rng = np.random.default_rng(seed)
    pool: Dict[str, dict] = {}
    for fname in mocap_fnames:
        s = _session(fname, mocap_unit, mocap_rotate, only_subjects,
                     only_markers, exclude_markers, labels_map)
        if not s.read_status:
            continue
        d = s.markers_asdict()
        for fidx in rng.choice(len(s), min(num_frames, len(s)), replace=False):
            pool[f"{fname}_{int(fidx):06d}"] = d[int(fidx)]
        if len(pool) > _MAX_SCANNED_FRAMES:
            break

    keys = list(pool.keys())
    order = rng.permutation(len(keys))
    picked_frames, picked_names = [], []
    for i in order:
        frame = pool[keys[i]]
        valid = [k for k, v in frame.items()
                 if not np.any(np.isnan(v)) and "*" not in k]
        if len(valid) >= least_avail_markers * max(len(frame), 1):
            picked_frames.append(frame)
            picked_names.append(keys[i])
        if len(picked_frames) >= num_frames:
            break
    if len(picked_frames) < num_frames:
        relaxed = least_avail_markers - 0.01
        if relaxed < 0.01:
            raise ValueError(
                f"not enough frames with >= {least_avail_markers * 100:.1f}% markers")
        return load_marker_sessions_random(
            mocap_fnames, mocap_unit=mocap_unit, mocap_rotate=mocap_rotate,
            num_frames=num_frames, only_subjects=only_subjects, seed=seed,
            least_avail_markers=relaxed, only_markers=only_markers,
            exclude_markers=exclude_markers, labels_map=labels_map)
    return picked_frames, picked_names


def load_marker_sessions_random_strict(mocap_fnames: List[str], mocap_unit: str,
                                       mocap_rotate=None, num_frames: int = 12,
                                       only_subjects=None, seed: Optional[int] = None,
                                       least_avail_markers: float = 0.1,
                                       only_markers=None, exclude_markers=None,
                                       labels_map=None) -> Tuple[list, list]:
    """Seeded pick with a hard availability threshold
    (frame_picker.py:149-213)."""
    assert 0.1 <= least_avail_markers <= 1.0
    rng = np.random.default_rng(seed)
    pool: Dict[str, dict] = {}
    for fname in mocap_fnames:
        s = _session(fname, mocap_unit, mocap_rotate, only_subjects,
                     only_markers, exclude_markers, labels_map)
        if not s.read_status:
            continue
        avail = s.availability_mask()
        frac = avail.sum(-1) / max(avail.shape[1], 1)
        d = s.markers_asdict()
        picks = 0
        for fidx in rng.permutation(len(s)):
            if frac[fidx] >= least_avail_markers:
                pool[f"{fname}_{int(fidx):06d}"] = d[int(fidx)]
                picks += 1
            if picks >= num_frames:
                break
        if len(pool) > _MAX_SCANNED_FRAMES:
            break

    if len(pool) < num_frames:
        raise ValueError(
            f"not enough frames with >= {least_avail_markers * 100:.1f}% of markers; "
            f"try frame_picker.type random or a lower least_avail_markers")
    keys = list(pool.keys())
    ids = rng.choice(len(keys), num_frames, replace=False)
    return [pool[keys[i]] for i in ids], [keys[i] for i in ids]


def frames_to_arrays(frames: List[dict], latent_labels: List[str]):
    """Stack picked frames ({label: (3,) position}) into observations
    (F, M, 3) and an availability mask (F, M) aligned to `latent_labels`;
    a label that is missing or NaN in a frame is unavailable there."""
    F, M = len(frames), len(latent_labels)
    obs = np.zeros((F, M, 3))
    mask = np.zeros((F, M), bool)
    for f, frame in enumerate(frames):
        for j, label in enumerate(latent_labels):
            v = frame.get(label)
            if v is not None and not np.any(np.isnan(v)):
                obs[f, j] = v
                mask[f, j] = True
    return obs, mask
