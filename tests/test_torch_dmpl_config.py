"""SMPL+H with 8 DMPLs, the benchmark's `smplh_dmpl8` configuration, on the
CPU: the port against the benchmark's plain float64 reference
(`benchmark/reference/`), the cell `smplh_dmpl8.capture4k` cut as the
benchmark's own tests cut theirs (a 642-vertex mesh, 24-frame captures, a
pool of 2; every width as configured), and the DMPL columns of a model file
against the loader's splice of a DMPL eigvec file.

    python -m pytest tests/test_torch_dmpl_config.py -q
"""

import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import faults, judge  # noqa: E402
from harness.cell import run_cell  # noqa: E402
from harness.program import Program  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from harness.world import make_world, reference_markers  # noqa: E402

CELL = "smplh_dmpl8.capture4k"
E = 8
# the benchmark's tiny size and its limits there (benchmark/tests/
# bench_common.py)
TINY = {"num_verts": 642, "frames": 24, "pool": 2}
TINY_LIMITS = {"sim_gap_mm": 0.05, "pose_gap_mrad": 0.01, "fit_mm": 1.5,
               "marker_fit_mm": 4.5}


def tiny_cell():
    cell = load_cell(CELL, BENCH)
    cell.config = dict(cell.config, num_verts=TINY["num_verts"])
    cell.traffic = dict(cell.traffic, frames=TINY["frames"],
                        pool=TINY["pool"])
    cell.limits = dict(TINY_LIMITS)
    return cell


def run_tiny(cell, hook=None):
    with tempfile.TemporaryDirectory() as wd:
        return run_cell(cell, 3, 0.0, False, "cpu", time.perf_counter(), wd,
                        program_hook=hook)


@pytest.fixture
def restore_program():
    saved = faults.saved_program()
    yield
    faults.restore(saved)


@pytest.fixture(scope="module")
def solved():
    """The tiny cell's world and the program's solve of its first
    capture."""
    cell = tiny_cell()
    with tempfile.TemporaryDirectory() as wd:
        w = make_world(cell.config, cell.traffic, 4, "cpu", wd)
        p = Program(w, "cpu")
        out = p.solve(w.obs[0], w.mask)
    return cell, w, p, out


def test_the_program_takes_the_dmpl_route(solved):
    _, w, p, _ = solved
    assert p.opts.optimize_dynamics and p.opts.num_dmpls == E
    assert p.problem.tables.route == "ext"
    assert p.problem.tables.n_extra == E
    assert w.extra_cols() == list(range(16, 24))


def test_sound_program_is_correct_against_the_reference():
    res, lines = run_tiny(tiny_cell())
    assert res["correct"] is True and res["failed"] == 0, lines


def test_solved_dmpls_move_the_reference_markers(solved):
    cell, w, _, out = solved
    F = cell.traffic["frames"]
    assert tuple(out["extra"].shape) == (F, E)
    x = torch.cat([out["trans"], out["pose"], out["extra"]], 1).double()
    x0 = x.clone()
    x0[:, -E:] = 0.0
    m, m0 = (reference_markers(w.reference, v) for v in (x, x0))
    moved = torch.linalg.vector_norm(m - m0, dim=-1)
    assert float(moved.pow(2).mean().sqrt()) > 1e-3        # over a mm
    obs = w.obs[0].double()
    fit = torch.linalg.vector_norm(m - obs, dim=-1).mean()
    fit0 = torch.linalg.vector_norm(m0 - obs, dim=-1).mean()
    assert float(fit) < 0.5 * float(fit0)


@pytest.mark.parametrize("broken", ["control"] + sorted(faults.FAULTS))
def test_control_and_each_fault_are_not_correct(broken, restore_program,
                                                tmp_path):
    cell = tiny_cell()
    if broken != "control":
        res, lines = run_tiny(cell, hook=faults.FAULTS[broken])
        assert res["correct"] is False, lines
        assert res["failed"] >= 1
        return
    w = make_world(cell.config, cell.traffic, 4, "cpu", str(tmp_path))
    outs = [Program(w, "cpu").solve(w.obs[0], w.mask)]
    j = judge.Judge(w)
    sound = judge.checks(j.assess(outs, [0]), cell.limits)
    ctl = judge.checks(j.assess(j.control_outputs(outs), [0]), cell.limits)
    assert judge.passed(sound)
    assert not judge.passed(ctl)


def _solve(model_file, w, dmpl_fname=None):
    from moshpp_torch.io.model_loader import load_surface_model
    from moshpp_torch.pipeline import stageii
    from moshpp_torch.priors.gmm import load_gmm_prior

    cfg = w.cfg
    model = load_surface_model(
        model_file, surface_model_type=cfg["model_type"],
        pose_hand_prior_fname=w.files["hands"],
        use_hands_mean=cfg["use_hands_mean"],
        dof_per_hand=cfg["dof_per_hand"], num_betas=cfg["num_betas"],
        dmpl_fname=dmpl_fname, num_dmpls=E, device="cpu")
    prior = load_gmm_prior(w.files["prior"], npose=cfg["prior"]["dim"],
                           device="cpu")
    opts = stageii.StageIIOptions(num_betas=cfg["num_betas"],
                                  optimize_dynamics=True, num_dmpls=E,
                                  **cfg["solver"])
    prob = stageii.prepare_stageii_problem(model, w.betas, w.latents, opts,
                                           device="cpu")
    res = stageii.mosh_stageii_solve(prob, opts, w.obs[0], w.mask, prior,
                                     cfg["model_type"], device="cpu")
    return model, res


def test_dmpl_columns_in_the_file_equal_the_loaders_splice(tmp_path):
    """A model file with 16 beta columns and a DMPL eigvec file of 8
    components load to the shapedirs and joint_shapedirs of the same model
    with the 24 columns written in, and solve to the same result."""
    cell = tiny_cell()
    cell.traffic = dict(cell.traffic, frames=8, pool=1)
    w = make_world(cell.config, cell.traffic, 5, "cpu", str(tmp_path))
    arrays = dict(np.load(w.files["model"]))
    assert arrays["shapedirs"].shape[-1] == 16 + E
    eig = arrays["shapedirs"][..., 16:]
    betas_only = str(tmp_path / "betas16.npz")
    np.savez(betas_only, **dict(arrays, shapedirs=np.ascontiguousarray(
        arrays["shapedirs"][..., :16])))
    dmpl = str(tmp_path / "dmpl.npz")
    np.savez(dmpl, eigvec=np.concatenate(          # a file of 10 components
        [eig, np.ones_like(eig[..., :2])], axis=-1))
    m_file, r_file = _solve(w.files["model"], w)
    m_splice, r_splice = _solve(betas_only, w, dmpl_fname=dmpl)
    assert torch.equal(m_file.shapedirs, m_splice.shapedirs)
    assert torch.equal(m_file.joint_shapedirs, m_splice.joint_shapedirs)
    for k in ("trans", "pose", "extra", "markers_sim"):
        assert torch.equal(getattr(r_file, k), getattr(r_splice, k)), k
