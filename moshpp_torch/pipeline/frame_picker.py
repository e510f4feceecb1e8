"""Stage-i frames as arrays (from `moshpp_tpu/pipeline/frame_picker.py`,
pure numpy). The loaders that pick the frames from a capture read mocap
files through `io/mocap.py` and are not ported yet (ROADMAP Queue 1 item
6).
"""

from __future__ import annotations

from typing import List

import numpy as np


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
