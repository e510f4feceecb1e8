"""Marker-layout vid randomization for SOMA-style synthesis (port of
`moshpp_tpu/markers/randomize.py`; the reference's
`marker_layout/edit_tools.py:419-527`): jitter each marker's vertex id within
its n-ring mesh neighbourhood. Host numpy; with the same `seed` the draws are
the JAX package's."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from moshpp_torch.io.model_loader import load_surface_model_arrays


def vertex_adjacency(faces: np.ndarray, num_verts: int):
    """Sorted neighbour list of each vertex from the triangle list (the
    reference's sparse get_vert_connectivity, edit_tools.py:462-479)."""
    nbrs = [set() for _ in range(num_verts)]
    f = np.asarray(faces)
    for i in range(3):
        a, b = f[:, i], f[:, (i + 1) % 3]
        for x, y in zip(a.tolist(), b.tolist()):
            nbrs[x].add(y)
            nbrs[y].add(x)
    return [sorted(s) for s in nbrs]


def find_vertex_neighbours(surface_model_fname: str):
    """get_neighbour(vid, n_ring) -> the sorted vids within n_ring edges of
    vid, vid itself excluded but where a ring returns to it (n_ring 0:
    [vid]) (edit_tools.py:419-451)."""
    model = load_surface_model_arrays(surface_model_fname)
    adj = vertex_adjacency(model["faces"], model["v_template"].shape[0])

    def get_neighbour(vid: int, n_ring: int = 1):
        if n_ring == 0:
            return [vid]
        frontier = {vid}
        seen = set()
        for _ in range(n_ring):
            nxt = set()
            for v in frontier:
                nxt.update(adj[v])
            seen |= nxt
            frontier = nxt
        return sorted(seen)

    return get_neighbour


def randomize_marker_layout_vids(marker_vids: Dict, marker_type_mask: Dict,
                                 surface_model_fname: str, n_ring: int = 1,
                                 enable_rnd_vid_on_face_hands: bool = True,
                                 seed: Optional[int] = None):
    """get_next() -> a new marker_vids OrderedDict, each label's vid drawn
    from its own and its n-ring neighbours (edit_tools.py:482-527). A
    superset layout (list-valued vids) draws from the union over its list.
    With `enable_rnd_vid_on_face_hands` False, the labels outside
    `marker_type_mask["body"]` draw only from their own vids."""
    rng = np.random.default_rng(seed)
    v_neighbors = find_vertex_neighbours(surface_model_fname)

    is_superset = isinstance(next(iter(marker_vids.values())), list)
    body_mask = None
    if not enable_rnd_vid_on_face_hands:
        if "body" not in marker_type_mask:
            raise ValueError("marker_type_mask needs 'body' to keep the face "
                             "and hand markers in place")
        body_mask = {l: bool(b) for l, b in
                     zip(marker_vids.keys(), marker_type_mask["body"])}

    pool = {}
    for label, vids in marker_vids.items():
        vid_list = vids if is_superset else [vids]
        if body_mask is not None and not body_mask[label]:
            pool[label] = list(vid_list)
            continue
        cands = set(vid_list)
        for v in vid_list:
            cands.update(v_neighbors(int(v), n_ring=n_ring))
        pool[label] = sorted(cands)

    def get_next():
        return OrderedDict((l, int(rng.choice(pool[l]))) for l in marker_vids)

    return get_next
