"""Minimal PLY mesh reader/writer (ascii + binary_little_endian).

A copy of `moshpp_tpu/io/ply.py` (that package's `io/__init__.py` imports
its JAX body model, so the port keeps its own). It replaces the psbody.mesh dependency the reference uses for v_template
override meshes (`smpl_fast_derivatives.py:76`), rigid-object loading
(`object_model.py:46`) and marker-layout PLY exports (`edit_tools.py:377`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(fname: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (verts (V,3) float64, faces (F,3) int32 or None)."""
    with open(fname, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    assert header_end >= 0, f"not a ply file: {fname}"
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, elt_t, name)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    verts, faces = None, None
    if fmt == "ascii":
        rows = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(rows[pos:pos + count * width], dtype=np.float64)
                arr = arr.reshape(count, width)
                verts = arr[:, :3]
                pos += count * width
            elif name == "face":
                out = []
                for _ in range(count):
                    n = int(rows[pos]); pos += 1
                    out.append([int(x) for x in rows[pos:pos + n]]); pos += n
                faces = np.array(out, dtype=np.int32)
            else:
                # skip unknown fixed-width elements
                pos += count * len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float64)
            elif name == "face" and props and props[0][0] == "list":
                _, idx_t, elt_t, _ = props[0]
                isz = np.dtype(_PLY_DTYPES[idx_t]).itemsize
                esz = np.dtype(_PLY_DTYPES[elt_t]).itemsize
                out = []
                for _ in range(count):
                    n = int(np.frombuffer(body, "<" + _PLY_DTYPES[idx_t], 1, off)[0])
                    off += isz
                    out.append(np.frombuffer(body, "<" + _PLY_DTYPES[elt_t], n, off).astype(np.int64))
                    off += esz * n
                faces = np.array(out, dtype=np.int32)
            else:
                raise ValueError(f"unsupported ply element {name} in {fname}")
    else:
        raise ValueError(f"unsupported ply format {fmt} in {fname}")

    assert verts is not None, f"no vertex element in {fname}"
    return verts, faces


def write_ply(fname: str, verts: np.ndarray, faces: Optional[np.ndarray] = None,
              vertex_colors: Optional[np.ndarray] = None) -> None:
    """Write a binary_little_endian PLY; colors are float [0,1] -> uchar."""
    verts = np.asarray(verts, dtype=np.float32)
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        if vertex_colors is not None:
            cols = np.clip(np.asarray(vertex_colors) * 255.0, 0, 255).astype(np.uint8)
            dt = np.dtype([("v", "<f4", 3), ("c", "u1", 3)])
            rec = np.empty(len(verts), dtype=dt)
            rec["v"] = verts
            rec["c"] = cols
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        if faces is not None:
            faces = np.asarray(faces, dtype="<i4")
            dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
            rec = np.empty(len(faces), dtype=dt)
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())
