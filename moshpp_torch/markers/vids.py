"""Marker databases (port of `moshpp_tpu/markers/vids.py`): label ->
vertex-id tables, vendor-label aliases, the SMPL-H <-> SMPL-X vertex remaps
and the SMPL-X eyeball mask.

The tables are factual data (which SMPL vertex each standard mocap marker
label sits on), the port's own copies under `moshpp_torch/data/` of the
JAX package's JSON/npz files (tests/test_torch_markers.py holds them
equal).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SMPLX_NUM_VERTS = 10475


@functools.lru_cache(maxsize=None)
def _load_json(name: str):
    with open(os.path.join(_DATA_DIR, name)) as f:
        return json.load(f)


class _LazyDict(dict):
    """A dict filled from `loader` at its first read."""

    def __init__(self, loader):
        super().__init__()
        self._loader = loader
        self._loaded = False

    def _ensure(self):
        if not self._loaded:
            self.update(self._loader())
            self._loaded = True

    def __getitem__(self, k):
        self._ensure()
        return super().__getitem__(k)

    def __contains__(self, k):
        self._ensure()
        return super().__contains__(k)

    def get(self, k, default=None):
        self._ensure()
        return super().get(k, default)

    def keys(self):
        self._ensure()
        return super().keys()

    def items(self):
        self._ensure()
        return super().items()

    def values(self):
        self._ensure()
        return super().values()

    def __iter__(self):
        self._ensure()
        return super().__iter__()

    def __len__(self):
        self._ensure()
        return super().__len__()


# label -> vid per surface model family ('smpl', 'smplh', 'smplx')
all_marker_vids: Dict[str, Dict[str, int]] = _LazyDict(
    lambda: _load_json("marker_vids.json"))

# marker label membership per type: wrist / finger_left / finger_right / face
marker_type_labels: Dict[str, List[str]] = _LazyDict(
    lambda: _load_json("marker_type_labels.json"))

# ~200 vendor-label aliases -> canonical labels
general_labels_map: Dict[str, str] = _LazyDict(
    lambda: _load_json("labels_map.json"))


@functools.lru_cache(maxsize=None)
def _vid_maps():
    d = np.load(os.path.join(_DATA_DIR, "smplh_smplx_vid_map.npz"))
    return d["smplh2smplx"], d["smplx2smplh"]


def smplh2smplx_vids(vids):
    """SMPL(+H) vertex ids (6890-mesh) -> SMPL-X vertex ids (10475-mesh)."""
    table, _ = _vid_maps()
    if np.isscalar(vids):
        return int(table[vids])
    return [int(table[v]) for v in vids]


def smplx2smplh_vids(vids):
    _, table = _vid_maps()
    if np.isscalar(vids):
        return int(table[vids])
    return [int(table[v]) for v in vids]


def smplx_eyeball_vids() -> np.ndarray:
    """SMPL-X eyeball vertex ids, the last 1092 vertices [9383, 10475):
    excluded from the markers' nearest-neighbour frame vertices."""
    return np.arange(9383, SMPLX_NUM_VERTS)


def smplx_eyeball_mask(num_verts: int) -> np.ndarray:
    """(V,) bool mask of the vertices to exclude from the markers' frame
    vertices: the eyeballs on a 10475-vertex SMPL-X mesh, none otherwise."""
    mask = np.zeros(num_verts, dtype=bool)
    if num_verts == SMPLX_NUM_VERTS:
        mask[smplx_eyeball_vids()] = True
    return mask
