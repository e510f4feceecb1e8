"""The stage-ii benchmark of moshpp_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload smplh.capture16k --seed 7 \
        --seconds 30 --trace 0

One run: set-up (inputs and weights from the seed, the program's kernels
built or loaded, the model and prior files loaded, the subject prepared,
one warm-up solve), a closed loop of whole captures for `--seconds`, the
check of every solve's outputs against the plain reference
(`benchmark/reference/`), and one JSON result as the last line of standard
output: the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`. The compared numbers and their limits end
standard error and the result line (`checks`).

Exits 2 without a CUDA device (no CPU fallback), 3 if JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# kernel caches inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "moshpp_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness.cell import run_cell
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    workdir = tempfile.mkdtemp(prefix="stageii-bench-")
    try:
        result, lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", T0, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
