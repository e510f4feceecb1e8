"""Hand-written Hopper kernels: build, load and launch counts.

The CUDA sources in `moshpp_torch/csrc/` are compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a`, one nvcc per source started
together, and linked into one shared library with a plain C interface,
loaded with ctypes. The build directory
(`moshpp_torch/kernels/build/`, git-ignored) is keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
Nothing here runs at import time: the CPU-only tests import the package on
hosts without a CUDA toolkit.

Each kernel wrapper adds one to `COUNTS.launches[name]` per launch (the
`fk_smalls` and `marker_rows` wrappers also to `COUNTS.frames[(name, F)]`,
keyed by the launch's frame count); each plain (PyTorch) version adds one to
`COUNTS.plain_cuda[name]` when it runs on CUDA tensors, which only
comparisons against the kernel should do. `COUNTS.frames` also carries the
counters of the work around the kernels (`Counts`). The counts and the
first build are taken under a lock: a solve on a mesh launches from one
host thread a shard.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "libmoshpp_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")


@dataclasses.dataclass
class Counts:
    """Launch counts of the kernel wrappers and of the plain versions run on
    CUDA tensors, keyed by kernel name; `frames` keyed by (name, frames):

    - (kernel, F): launches of `fk_smalls<..>` and `marker_rows<..>` at F
      frames;
    - ("dogleg_direction<cg=I>", N): launches of the fused direction kernel
      with I CG iterations over N systems (`launches["dogleg_direction"]`
      counts them all);
    - ("gn.step", K): iterations of `batched_system_solve` over a batch of
      K frames (the full batch or a compaction bucket);
    - ("gn.active", K): not launches but a sum of frames: the frames still
      active in those iterations. Summed over K it is the frame-iterations,
      the solves' `iterations` summed; sum K x ("gn.step", K) is the rows
      computed;
    - ("gn.graph", K): those iterations that ran as a CUDA graph's replay
      (`solver/graphs.py`). A replay runs no wrapper: it adds the counts
      its capture recorded;
    - ("gn.capture", K): graphs captured, one for each run of replayed
      iterations that captured its graph and zero for one that found it
      made, so that the key shows where nothing was captured.
    """
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    plain_cuda: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    frames: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def reset(self) -> None:
        self.launches.clear()
        self.plain_cuda.clear()
        self.frames.clear()

    def _fields(self):
        return self.launches, self.plain_cuda, self.frames

    def copy(self) -> "Counts":
        return Counts(*[collections.Counter(c) for c in self._fields()])

    def since(self, before: "Counts") -> "Counts":
        """What was counted after `before`, a copy of these counts."""
        return Counts(*[now - then for now, then in
                        zip(self._fields(), before._fields())])

    def add(self, other: "Counts", sign: int = 1) -> None:
        """Add `other` (subtract it with sign -1); a count that reaches 0
        is dropped, as if never counted."""
        for mine, theirs in zip(self._fields(), other._fields()):
            for key, n in theirs.items():
                mine[key] += sign * n
                if not mine[key]:
                    del mine[key]


COUNTS = Counts()
_LOCK = threading.Lock()


def snapshot_counts() -> Counts:
    """A copy of COUNTS."""
    with _LOCK:
        return COUNTS.copy()


def add_counts(delta: Counts, sign: int = 1) -> None:
    """Add `delta` to COUNTS (subtract it with sign -1)."""
    with _LOCK:
        COUNTS.add(delta, sign)


def note_plain(name: str, t: torch.Tensor) -> None:
    """Count a plain-version call that ran on a CUDA tensor."""
    if t.is_cuda:
        with _LOCK:
            COUNTS.plain_cuda[name] += 1


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    built: bool          # False: loaded an existing build
    seconds: float       # nvcc wall time (0 when loaded)
    log: str             # nvcc's output (-Xptxas -v register/smem report)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the default
    toolkit location. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a build of these exact sources exists."""
    nvcc = nvcc_path()
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(lib, False, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = f"tmp{os.getpid()}"
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    # one nvcc per source, all at once, then one link
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(o), str(p)]
            for p, o in zip(cus, objs)]
    cmds.append([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *[str(o) for o in objs]])
    t0 = time.perf_counter()
    log = ""
    for batch in (cmds[:-1], cmds[-1:]):
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in batch]
        outs = [pr.communicate()[0] for pr in procs]
        log += "".join(outs)
        for c, pr, out in zip(batch, procs, outs):
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc={pr.returncode}):\n"
                                   f"{' '.join(c)}\n{out[-8000:]}")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    log_file.write_text(log)
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or none
    return BuildInfo(lib, True, seconds, log)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fk_smalls_launch": [_I, _I, _P, _P, _P, _P, _I, _I,
                         _P, _P, _P, _P, _P, _P,
                         _I, _P, _P, _P, _P, _P],
    "fk_smalls_occupancy": [_I, _I, _I, _I, _I, _P, _P],
    "marker_rows_launch": [_I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _P, _P, _P, _P],
    "marker_rows_fold_launch": [_I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _P, _P, _P, _P, _P, _P],
    "dogleg_direction_launch": [_I, _I, _I, ctypes.c_float, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P],
    "pcg_direction_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dogleg_direction_occupancy": [_I, _I, _P, _P],
    "marker_rows_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fk_smalls_tiled_launch": [_I, _I, _P, _P, _P, _P, _I, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "marker_rows_tiled_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P],
    "marker_rows_tiled_fold_launch": [_I, _I, _I, _I, _I, _I, _I, _I,
                                      _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _P],
    "extras_tangent_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "extras_tangent_occupancy": [_I, _I, _I, _P, _P],
    "extras_cols_launch": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                           _P],
    "extras_cols_occupancy": [_I, _I, _I, _I, _P],
}


def library():
    """(ctypes library, BuildInfo): builds on the first call."""
    with _LOCK:
        return _library()


@functools.lru_cache(maxsize=None)
def _library():
    info = build()
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def launch(fn: str, kernel: str, *args, frames: int = None) -> None:
    """Call launcher `fn` of the library on the current CUDA stream and count
    one launch of `kernel` (and of `kernel` at `frames` frames, if given);
    raise if CUDA reports an error."""
    lib, _ = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}")
    count_launch(kernel, frames)


def count_launch(kernel: str, frames: int = None) -> None:
    """Add one launch of `kernel` (at `frames` frames, if given) to
    COUNTS."""
    with _LOCK:
        COUNTS.launches[kernel] += 1
        if frames is not None:
            COUNTS.frames[(kernel, frames)] += 1


def count_frames(name: str, frames: int, n: int = 1) -> None:
    """Add `n` to COUNTS.frames[(name, frames)], and nothing to the
    launches."""
    with _LOCK:
        COUNTS.frames[(name, frames)] += n


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor):
    """Device pointer of a tensor, or None for an absent optional input."""
    return None if t is None else t.data_ptr()


def check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
