"""Shared set-up of the benchmark's tests: the benchmark's directory on
sys.path, and its cells cut to a size the CPU runs in seconds (a
642-vertex mesh, 24-frame captures; every width as configured)."""

import os
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import load_cell  # noqa: E402

TINY_VERTS = 642
TINY_FRAMES = 24
# limits at this size: the sound program's largest readings over seeds 1-6
# of both configurations (two 24-frame solves a seed: sim 0.0067 mm, pose
# 0.00023 mrad, fit 0.868 mm, worst marker 2.88 mm), with room; the
# control read at least 2.03 mm and 0.21 mrad
TINY_LIMITS = {"sim_gap_mm": 0.05, "pose_gap_mrad": 0.01, "fit_mm": 1.5,
               "marker_fit_mm": 4.5}


def tiny_cell(name="smplh.capture4k", frames=TINY_FRAMES, pool=2):
    cell = load_cell(name, BENCH)
    cell.config = dict(cell.config, num_verts=TINY_VERTS)
    cell.traffic = dict(cell.traffic, frames=frames, pool=pool)
    cell.limits = dict(TINY_LIMITS)
    return cell


def run_tiny(cell, seed=3, traced=False, hook=None, seconds=0.0):
    """run_cell on the CPU, one solve in the window."""
    from harness.cell import run_cell
    with tempfile.TemporaryDirectory() as wd:
        return run_cell(cell, seed, seconds, traced, "cpu",
                        time.perf_counter(), wd, program_hook=hook)
