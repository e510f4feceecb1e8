"""ctypes binding of the native C3D point codec (port of
`moshpp_tpu/native/__init__.py`).

`native/c3d_native.cc` (the repo's C++ source, shared with the JAX
package) decodes and encodes C3D point records in bulk, OpenMP-parallel
over frames. It is host code, not a device kernel. It is compiled at first
use with g++ or gcc (`-x c++ -O3 -march=native -fopenmp`) into
`moshpp_torch/kernels/build/native-<key>/` (git-ignored), keyed by the
source and the host's CPU model and flags, so a library built with
`-march=native` on one CPU is never loaded on another. Without a compiler
or the source, `decode_points` and `encode_points` return None and the
callers (`io/c3d.py`) take their numpy paths; `build_log()` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(os.path.dirname(_PKG), "native", "c3d_native.cc")
BUILD_ROOT = os.path.join(_PKG, "kernels", "build")
_lib = None
_load_attempted = False
_build_log = ""


def _host_key() -> str:
    """Hash of the source and the CPU (cpuinfo model name and flags)."""
    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not flags and ln.startswith("flags"):
                    flags = ln.strip()
                if not model and ln.startswith("model name"):
                    model = ln.strip()
                if flags and model:
                    break
    except OSError:
        pass
    h = hashlib.sha1(f"{model}|{flags}".encode())
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:12]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, f"native-{_host_key()}", "libmoshpp_c3d.so")


def _compilers() -> list:
    """C++ compilers on this host, in order: $CXX, g++, c++, and gcc (which
    compiles the source as C++ with `-x c++`; some images carry only gcc)."""
    out = []
    for c in (os.environ.get("CXX"), "g++", "c++", "gcc"):
        path = shutil.which(c) if c else None
        if path and path not in out:
            out.append(path)
    return out


def _build(dst: str) -> bool:
    """Compile the codec into `dst` (about a second) through a temporary
    file and an atomic rename, so that concurrent processes never load a
    half-written library. The compilers' output goes to `build_log()`."""
    global _build_log
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(dst))
    os.close(fd)
    logs = []
    try:
        for cxx in _compilers():
            cmd = [cxx, "-x", "c++", "-O3", "-march=native", "-fPIC",
                   "-fopenmp", "-std=c++17", "-shared", "-o", tmp, SRC_PATH]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                logs.append(f"{' '.join(cmd)}: {e}")
                continue
            logs.append(f"{' '.join(cmd)}: exit {r.returncode}\n{r.stderr}")
            if r.returncode == 0:
                os.replace(tmp, dst)
                return True
        return False
    finally:
        _build_log = "\n".join(logs) or "no C++ compiler found"
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_log() -> str:
    """What the compilers said when this process built the codec ("" when
    it loaded an earlier build)."""
    return _build_log


def _load():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(SRC_PATH):
        return None
    path = library_path()
    if not (os.path.exists(path) or _build(path)):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.moshpp_c3d_decode_points.restype = ctypes.c_int
    lib.moshpp_c3d_decode_points.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.moshpp_c3d_encode_points.restype = ctypes.c_int
    lib.moshpp_c3d_encode_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native codec is built (building it now if need be) and
    loaded."""
    return _load() is not None


def decode_points(data: bytes, n_frames: int, n_points: int, frame_words: int,
                  is_float: bool, scale: float, proc: int):
    """Returns (points (F, P, 3) f32 with NaN for missing, residuals (F, P))
    or None when the native library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    pts = np.empty((n_frames, n_points, 3), np.float32)
    res = np.empty((n_frames, n_points), np.float32)
    rc = lib.moshpp_c3d_decode_points(
        data, len(data), n_frames, n_points, frame_words,
        1 if is_float else 0, float(scale), proc,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return pts, res


def encode_points(points: np.ndarray, residuals: Optional[np.ndarray] = None):
    """Returns Intel-float XYZW record bytes, or None when the native library
    is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    F, P = pts.shape[0], pts.shape[1]
    out = ctypes.create_string_buffer(F * P * 16)
    res_ptr = None
    if residuals is not None:
        residuals = np.ascontiguousarray(residuals, np.float32)
        res_ptr = residuals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.moshpp_c3d_encode_points(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), res_ptr, F, P, out)
    if rc != 0:
        return None
    return out.raw
