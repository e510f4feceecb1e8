"""C3D motion-capture file codec (read + write), dependency-free: the port
of `moshpp_tpu/io/c3d.py`, byte for byte the same writer.

Replaces the reference's external C++ `ezc3d` dependency
(`tools/mocap_interface.py:41,62,120`) with a vectorized numpy implementation
of the public C3D specification (https://www.c3d.org/): 512-byte blocks, a
parameter section of named groups/params, and a point data section in either
float or scaled-int16 layout. Reading returns all-frames point arrays in one
shot (no per-frame Python loop); a native C++ fast path for bulk decode lives
in `moshpp_torch/native.py` and is used automatically when built.

Intel (84), DEC (85) and MIPS (86) processor float formats are handled for
reading; writing always emits Intel float format.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

BLOCK = 512
# processor-type byte values per spec: 83 + {1: Intel, 2: DEC, 3: MIPS}
_PROC_INTEL, _PROC_DEC, _PROC_MIPS = 84, 85, 86


def _decode_float(raw: np.ndarray, proc: int) -> np.ndarray:
    """Decode 4-byte floats for the given processor type from a uint8 view."""
    if proc == _PROC_INTEL:
        return raw.view("<f4")
    if proc == _PROC_MIPS:
        return raw.view(">f4")
    if proc == _PROC_DEC:
        # DEC float: word-swapped little-endian with exponent bias +1
        b = raw.reshape(-1, 4)
        swapped = np.empty_like(b)
        swapped[:, 0:2] = b[:, 2:4]
        swapped[:, 2:4] = b[:, 0:2]
        vals = swapped.reshape(-1).view("<f4") / 4.0
        return vals
    raise ValueError(f"unknown C3D processor type {proc}")


@dataclass
class C3DParam:
    name: str
    data: object          # np.ndarray, scalar, str or list[str]
    description: str = ""


@dataclass
class C3DGroup:
    name: str
    params: Dict[str, C3DParam] = field(default_factory=dict)
    description: str = ""

    def get(self, name: str, default=None):
        p = self.params.get(name.upper())
        return p.data if p is not None else default


@dataclass
class C3DFile:
    points: np.ndarray          # (frames, markers, 3) float32, NaN = missing
    residuals: np.ndarray       # (frames, markers) float32, -1 = missing
    labels: List[str]
    frame_rate: float
    first_frame: int = 1
    analog: Optional[np.ndarray] = None        # (frames*spf, channels)
    groups: Dict[str, C3DGroup] = field(default_factory=dict)
    decoder: str = "numpy"     # which point decoder read the file: or "native"

    @property
    def num_frames(self) -> int:
        return self.points.shape[0]

    @property
    def num_markers(self) -> int:
        return self.points.shape[1]


def _parse_parameters(buf: bytes) -> Tuple[Dict[str, C3DGroup], int]:
    """Parse the parameter section; returns (groups by name, processor code)."""
    proc = buf[3] if len(buf) > 3 else _PROC_INTEL
    if proc not in (_PROC_INTEL, _PROC_DEC, _PROC_MIPS):
        proc = _PROC_INTEL

    groups_by_id: Dict[int, C3DGroup] = {}
    params_pending: List[Tuple[int, C3DParam]] = []

    pos = 4
    n = len(buf)
    while pos < n - 3:
        nchar = struct.unpack_from("b", buf, pos)[0]
        if nchar == 0:
            break
        gid = struct.unpack_from("b", buf, pos + 1)[0]
        name = buf[pos + 2: pos + 2 + abs(nchar)].decode("ascii", "replace").strip()
        pos2 = pos + 2 + abs(nchar)
        offset = struct.unpack_from("<h" if proc != _PROC_MIPS else ">h", buf, pos2)[0]
        next_pos = pos2 + offset if offset > 0 else n

        if gid < 0:  # group definition
            dlen = buf[pos2 + 2]
            desc = buf[pos2 + 3: pos2 + 3 + dlen].decode("ascii", "replace")
            groups_by_id[-gid] = C3DGroup(name=name.upper(), description=desc)
        else:  # parameter
            p = pos2 + 2
            dtype = struct.unpack_from("b", buf, p)[0]
            ndims = buf[p + 1]
            dims = [buf[p + 2 + i] for i in range(ndims)]
            p += 2 + ndims
            count = int(np.prod(dims)) if dims else 1
            if dtype == -1:  # char
                raw = buf[p: p + count]
                p += count
                if len(dims) >= 2:
                    w = dims[0]
                    data = [raw[i * w:(i + 1) * w].decode("ascii", "replace").strip()
                            for i in range(count // w)]
                    if len(dims) > 2:  # keep flat list; callers index linearly
                        pass
                else:
                    data = raw.decode("ascii", "replace").strip()
            elif dtype == 1:
                data = np.frombuffer(buf, np.int8, count, p).copy()
                p += count
            elif dtype == 2:
                ec = "<" if proc != _PROC_MIPS else ">"
                data = np.frombuffer(buf, ec + "i2", count, p).copy()
                p += 2 * count
            elif dtype == 4:
                raw = np.frombuffer(buf, np.uint8, 4 * count, p)
                data = _decode_float(raw, proc).copy()
                p += 4 * count
            else:
                data = None
            if data is not None and isinstance(data, np.ndarray) and len(dims) > 1 and dtype != -1:
                data = data.reshape(dims[::-1])  # column-major per spec
            if p < n:
                dlen = buf[p] if p < n else 0
                desc = buf[p + 1: p + 1 + dlen].decode("ascii", "replace")
            else:
                desc = ""
            params_pending.append((gid, C3DParam(name=name.upper(), data=data, description=desc)))

        if offset <= 0:
            break
        pos = next_pos

    for gid, param in params_pending:
        grp = groups_by_id.setdefault(gid, C3DGroup(name=f"GROUP{gid}"))
        grp.params[param.name] = param
    return {g.name: g for g in groups_by_id.values()}, proc


def read_c3d(fname: str) -> C3DFile:
    with open(fname, "rb") as f:
        data = f.read()

    param_block = data[0]
    assert data[1] == 0x50, f"not a C3D file: {fname}"
    header = np.frombuffer(data, "<u2", 256 // 2, 0)
    num_points = int(header[1])
    analog_per_frame_total = int(header[2])
    first_frame = int(header[3])
    last_frame = int(header[4])
    data_block = int(header[8])

    param_off = (param_block - 1) * BLOCK
    # number of parameter blocks from byte 2 of the param section
    n_param_blocks = data[param_off + 2]
    param_buf = data[param_off: param_off + max(n_param_blocks, 1) * BLOCK]
    groups, proc = _parse_parameters(param_buf)

    def gparam(group, name, default=None):
        g = groups.get(group)
        return g.get(name, default) if g else default

    scale = gparam("POINT", "SCALE")
    scale = float(np.ravel(scale)[0]) if scale is not None else float(
        _decode_float(np.frombuffer(data, np.uint8, 4, 12), proc)[0])
    rate = gparam("POINT", "RATE")
    rate = float(np.ravel(rate)[0]) if rate is not None else float(
        _decode_float(np.frombuffer(data, np.uint8, 4, 20), proc)[0])

    used = gparam("POINT", "USED")
    if used is not None:
        num_points = int(np.ravel(used)[0])
    frames_p = gparam("POINT", "FRAMES")
    num_frames = last_frame - first_frame + 1
    if frames_p is not None:
        v = int(np.ravel(np.asarray(frames_p, np.int64))[0])
        if v > 0:
            num_frames = v
    # long sequences: POINT:FRAMES saturates at 32767; TRIAL fields carry the
    # real range as (lo, hi) uint16 pairs
    tstart = gparam("TRIAL", "ACTUAL_START_FIELD")
    tend = gparam("TRIAL", "ACTUAL_END_FIELD")
    if tstart is not None and tend is not None:
        ts = np.ravel(np.asarray(tstart, np.int64)) & 0xFFFF
        te = np.ravel(np.asarray(tend, np.int64)) & 0xFFFF
        start = int(ts[0] + (ts[1] << 16))
        end = int(te[0] + (te[1] << 16))
        if end >= start > 0:
            num_frames = end - start + 1
    ds = gparam("POINT", "DATA_START")
    if ds is not None:
        data_block = int(np.ravel(ds)[0])

    analog_used = gparam("ANALOG", "USED", 0)
    analog_used = int(np.ravel(analog_used)[0]) if not isinstance(analog_used, int) else analog_used
    analog_spf = analog_per_frame_total // max(analog_used, 1) if analog_used else 0

    # labels: LABELS + LABELS2 + ... concatenated
    labels: List[str] = []
    i = 0
    while True:
        key = "LABELS" if i == 0 else f"LABELS{i + 1}"
        lab = gparam("POINT", key)
        if lab is None:
            break
        labels.extend(lab if isinstance(lab, list) else [lab])
        i += 1
    labels = labels[:num_points]

    off = (data_block - 1) * BLOCK
    is_float = scale < 0
    ppf = num_points * 4 + analog_per_frame_total  # words (or floats) per frame

    # native fast path (C++/OpenMP bulk decode) when no analog channels
    if analog_per_frame_total == 0 and num_points > 0:
        from moshpp_torch.native import decode_points
        wsize = 4 if is_float else 2
        avail_frames = (len(data) - off) // max(ppf * wsize, 1)
        nf = min(num_frames, avail_frames)
        native = decode_points(data[off:], nf, num_points, ppf, is_float,
                               abs(scale), proc)
        if native is not None:
            points, residuals = native
            if not labels:
                labels = [f"*{i}" for i in range(num_points)]
            return C3DFile(points=points, residuals=residuals, labels=labels,
                           frame_rate=rate, first_frame=first_frame,
                           analog=None, groups=groups, decoder="native")

    if is_float:
        nbytes = num_frames * ppf * 4
        raw = np.frombuffer(data, np.uint8, min(nbytes, len(data) - off), off)
        vals = _decode_float(raw, proc)
        num_frames = len(vals) // ppf
        vals = vals[: num_frames * ppf].reshape(num_frames, ppf)
        pts4 = vals[:, : num_points * 4].reshape(num_frames, num_points, 4)
        points = pts4[..., :3].astype(np.float32)
        residuals = pts4[..., 3].astype(np.float32)
        analog = (vals[:, num_points * 4:].reshape(num_frames * max(analog_spf, 1), -1)
                  if analog_used else None)
    else:
        ec = "<" if proc != _PROC_MIPS else ">"
        nvals = num_frames * ppf
        vals = np.frombuffer(data, ec + "i2", min(nvals, (len(data) - off) // 2), off)
        num_frames = len(vals) // ppf
        vals = vals[: num_frames * ppf].reshape(num_frames, ppf)
        pts4 = vals[:, : num_points * 4].reshape(num_frames, num_points, 4)
        points = pts4[..., :3].astype(np.float32) * abs(scale)
        residuals = pts4[..., 3].astype(np.float32)
        analog = (vals[:, num_points * 4:].astype(np.float32).reshape(
            num_frames * max(analog_spf, 1), -1) if analog_used else None)

    invalid = residuals < 0
    points = points.copy()
    points[invalid] = np.nan

    if not labels:
        labels = [f"*{i}" for i in range(num_points)]

    return C3DFile(points=points, residuals=residuals, labels=labels,
                   frame_rate=rate, first_frame=first_frame,
                   analog=analog, groups=groups)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _param_records(groups: List[Tuple[str, List[Tuple[str, object]]]]) -> bytes:
    """Serialize parameter records (Intel float format)."""
    out = bytearray()
    for gid, (gname, params) in enumerate(groups, start=1):
        rec = bytearray()
        rec += struct.pack("bb", len(gname), -gid)
        rec += gname.encode("ascii")
        rec += struct.pack("<hB", 3, 0)  # offset to next (2 + desc len byte), no desc
        out += rec
        for pname, value in params:
            body = bytearray()
            if isinstance(value, (list, tuple)) and value and isinstance(value[0], str):
                width = max((len(s) for s in value), default=0)
                width = max(width, 1)
                body += struct.pack("bB", -1, 2)
                body += struct.pack("BB", width, len(value))
                for s in value:
                    body += s.ljust(width).encode("ascii")
            elif isinstance(value, str):
                body += struct.pack("bB", -1, 1)
                body += struct.pack("B", len(value))
                body += value.encode("ascii")
            else:
                arr = np.asarray(value)
                if arr.dtype.kind in "iu":
                    if arr.max(initial=0) < 32768 and arr.min(initial=0) >= -32768:
                        dt, code = "<i2", 2
                    else:
                        dt, code = "<f4", 4
                else:
                    dt, code = "<f4", 4
                flat = arr.astype(dt).ravel()
                if arr.ndim == 0:
                    body += struct.pack("bB", code, 0)
                else:
                    body += struct.pack("bB", code, arr.ndim)
                    for d in arr.shape[::-1]:
                        body += struct.pack("B", d)
                body += flat.tobytes()
            body += struct.pack("B", 0)  # no description
            rec = bytearray()
            rec += struct.pack("bb", len(pname), gid)
            rec += pname.encode("ascii")
            rec += struct.pack("<h", 2 + len(body))
            rec += body
            out += rec
    out += struct.pack("bb", 0, 0)  # terminator
    return bytes(out)


def write_c3d(fname: str, points: np.ndarray, labels: List[str],
              frame_rate: float = 120.0,
              residuals: Optional[np.ndarray] = None) -> None:
    """Write an Intel float-format C3D.

    Args:
      points: (frames, markers, 3); NaN rows are written as invalid
        (residual -1), matching the reference's convention
        (mocap_interface.py:67-83).
    """
    points = np.asarray(points, np.float32)
    nf, npts = points.shape[0], points.shape[1]
    nan_mask = np.isnan(points).any(-1)
    if residuals is None:
        residuals = np.where(nan_mask, -1.0, 0.0).astype(np.float32)

    label_strs = [str(l)[:32] for l in labels]
    param_groups = [
        ("POINT", [
            ("USED", np.int16(npts)),
            ("FRAMES", np.int16(min(nf, 32767))),
            ("SCALE", np.float32(-1.0)),
            ("RATE", np.float32(frame_rate)),
            ("DATA_START", np.int16(0)),  # patched below
            ("LABELS", label_strs),
            ("UNITS", "mm"),
        ]),
        ("ANALOG", [("USED", np.int16(0)), ("RATE", np.float32(0.0))]),
        ("TRIAL", [("ACTUAL_START_FIELD",
                    np.asarray([1, 0], np.uint16).view(np.int16)),
                   ("ACTUAL_END_FIELD",
                    np.asarray([nf % 65536, nf // 65536], np.uint16).view(np.int16))]),
    ]
    params = _param_records(param_groups)
    n_param_blocks = (4 + len(params) + BLOCK - 1) // BLOCK
    data_start_block = 2 + n_param_blocks
    # patch DATA_START now that we know the layout
    param_groups[0][1][4] = ("DATA_START", np.int16(data_start_block))
    params = _param_records(param_groups)

    header = np.zeros(256, "<u2")
    header[0] = 2 | (0x50 << 8)          # param pointer block 2, magic 0x50
    header[1] = npts
    header[2] = 0                        # analog words per frame
    header[3] = 1                        # first frame
    header[4] = min(nf, 65535)           # last frame
    header[5] = 0                        # max interpolation gap
    header[6:8] = np.frombuffer(np.float32(-1.0).tobytes(), "<u2")  # scale
    header[8] = data_start_block
    header[9] = 0                        # analog samples per frame
    header[10:12] = np.frombuffer(np.float32(frame_rate).tobytes(), "<u2")

    from moshpp_torch.native import encode_points
    encoded = encode_points(points, residuals)
    if encoded is None:  # numpy fallback
        pdata = np.zeros((nf, npts, 4), np.float32)
        pdata[..., :3] = np.nan_to_num(points)
        pdata[..., 3] = residuals
        pdata[nan_mask, :3] = 0.0
        encoded = pdata.tobytes()

    with open(fname, "wb") as f:
        f.write(header.tobytes())
        pbuf = bytearray(n_param_blocks * BLOCK)
        pbuf[0] = 2           # first param block pointer (unused convention)
        pbuf[1] = 0x50
        pbuf[2] = n_param_blocks
        pbuf[3] = _PROC_INTEL  # processor type byte
        pbuf[4: 4 + len(params)] = params
        f.write(bytes(pbuf))
        f.write(encoded)
