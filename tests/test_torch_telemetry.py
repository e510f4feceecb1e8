"""Stage-ii telemetry of the port against the JAX package, on the CPU.

(a) `stageii_term_energies` term by term against the JAX function at probe
    points, at E=0 (the golden smplh problem), 8 DMPLs and a small SMPL-X
    face (4 expressions), to 1e-5 of each term's largest value; the term
    and phase names equal JAX's;
(b) `StageIIReport.format_table` gives JAX's string for the same arrays;
(c) `on_phase` is called with JAX's phase names in JAX's order, and the
    report has JAX's phases and terms (the JAX solves run in a fresh
    interpreter started as the module begins), with and without the
    anchor pass;
(d) a solve asked for the report, or given `on_phase`, returns the same
    result bit for bit, with the same host syncs, as one without;
(e) chunked: the report is the chunks' reports weighted by the frames each
    keeps, saved in and read back from the checkpoints; a checkpoint saved
    without the report re-solves when the report is wanted.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from golden_common import build_family_problem
from moshpp_tpu.pipeline import stageii as jax_stageii

from moshpp_torch.pipeline import stageii
from torch_families_common import _probe_aux, port_problem
import test_torch_extras

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
NO_ANCHORS = dict(anchor_stride=8)   # F=4 <= 8: no anchor pass


def jax_phase_runs() -> dict:
    """The JAX package's solves of the golden smplh problem with an on_phase
    hook and the report, with and without the anchor pass: {label: (the
    hook's phase names, the report's phase names, its term names)}."""
    fp = build_family_problem("smplh")
    out = {}
    for label, over in (("anchors", {}), ("no_anchors", NO_ANCHORS)):
        names = []
        _, rep = jax_stageii.mosh_stageii_solve(
            fp["prob"], dataclasses.replace(fp["opts"], **over), fp["obs"],
            fp["mask"], prior=fp["prior"], model_type="smplh",
            return_report=True, on_phase=lambda n, x, s: names.append(n))
        out[label] = (names, tuple(rep.phase_names), tuple(rep.term_names))
    return out


_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_telemetry import jax_phase_runs
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_phase_runs(), f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """`jax_phase_runs()` in a fresh interpreter (tests/golden_common.py
    says why), started as this module's tests begin so that it runs beside
    them; (c) waits for its result."""
    out = tmp_path_factory.mktemp("telemetry") / "jax.pkl"
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(out), REPO,
                             TESTS], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)

    def result() -> dict:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err.decode()[-2000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    yield result
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _problems():
    """{label: (JAX problem dict, the port's (problem, options, prior))} at
    E=0, 8 DMPLs and a 4-expression SMPL-X face."""
    out = {}
    for label, family in (("e0", "smplh"), ("face", "smplx")):
        fp = build_family_problem(family)
        fp["family"] = family
        out[label] = (fp, port_problem(fp))
    fp = test_torch_extras.dmpl_problem()
    fp["family"] = "smplh"
    fp["x_probe"] = np.zeros(3 + fp["prob"].sub_model.pose_dof + 8,
                             np.float32)
    out["dmpl"] = (fp, test_torch_extras.port_problem(fp))
    return out


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.mark.parametrize("label", ["e0", "dmpl", "face"])
def test_term_energies_match_jax(problems, label):
    fp, (prob, opts, prior) = problems[label]
    family = fp["family"]
    x, aux = _probe_aux(fp, 4, np.random.default_rng(8))
    if label == "dmpl":
        x = x + np.random.default_rng(9).normal(size=x.shape).astype(
            np.float32) * 0.1
    en_j = jax_stageii.stageii_term_energies(fp["prob"], fp["opts"],
                                             fp["prior"], family)
    ref = jax.vmap(en_j)(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in aux.items()})
    en_t = stageii.stageii_term_energies(prob, opts, prior, family)
    got = en_t(torch.as_tensor(x), {k: torch.as_tensor(v)
                                    for k, v in aux.items()})
    # JAX's order: its pytree flattening sorts the energies' dict by key
    assert list(got) == list(ref) == sorted(ref)
    assert tuple(got) == stageii.report_term_names(prob, opts, prior, family)
    assert tuple(got) == jax_stageii.report_arrays_spec(
        fp["prob"], fp["opts"], fp["prior"], family)
    for name, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"{label} {name}")
    expect = {"e0": ["poseH"], "dmpl": ["poseH", "dmpl", "dmpl_anchor"],
              "face": ["poseH", "poseF", "expr"]}[label]
    assert set(expect) <= set(got)


def test_names_and_table_match_jax():
    assert stageii.STAGEII_PHASE_NAMES == jax_stageii.STAGEII_PHASE_NAMES
    rng = np.random.default_rng(3)
    terms = ("data", "poseB", "poseH", "velo")
    n = len(jax_stageii.STAGEII_PHASE_NAMES)
    arrays = dict(phase_names=jax_stageii.STAGEII_PHASE_NAMES,
                  term_names=terms,
                  energies_before=rng.uniform(0, 1e4, (n, len(terms))),
                  energies_after=rng.uniform(0, 1e4, (n, len(terms))),
                  iterations=rng.uniform(0, 30, n))
    assert (stageii.StageIIReport(**arrays).format_table()
            == jax_stageii.StageIIReport(**arrays).format_table())


@pytest.mark.parametrize("label", ["anchors", "no_anchors"])
def test_on_phase_and_report_match_jax(problems, jax_runs, label):
    fp, (prob, opts, prior) = problems["e0"]
    if label == "no_anchors":
        opts = dataclasses.replace(opts, **NO_ANCHORS)
    seen = []

    def hook(name, x, sim):
        assert isinstance(x, np.ndarray) and isinstance(sim, np.ndarray)
        # the anchor pass solves the anchor frames only
        assert x.shape[1] == prob.tables.dof and sim.shape[1:] == (10, 3)
        anchor_pass = label == "anchors" and name.startswith(("anneal",
                                                              "anchor"))
        assert x.shape[0] == sim.shape[0] == (3 if anchor_pass else 4)
        seen.append(name)

    res, rep = stageii.mosh_stageii_solve(
        prob, opts, fp["obs"], fp["mask"], prior=prior, model_type="smplh",
        return_report=True, on_phase=hook, device="cpu")
    names, phases, terms = jax_runs()[label]
    assert seen == names
    assert rep.phase_names == phases and rep.term_names == terms
    n = len(phases)
    assert rep.energies_before.shape == rep.energies_after.shape == (
        n, len(terms))
    assert rep.iterations.shape == (n,)
    assert np.all(np.isfinite(rep.energies_after))
    if label == "no_anchors":
        # the anchor slot repeats the last annealed solve, as in JAX
        np.testing.assert_array_equal(rep.energies_after[3],
                                      rep.energies_after[2])
    # the report's last data energy is the solve's own data cost
    data = rep.energies_after[-1, terms.index("data")]
    assert data > 0 and "anneal10" in rep.format_table()


def test_report_leaves_solve_unchanged(problems):
    fp, (prob, opts, prior) = problems["e0"]
    kw = dict(prior=prior, model_type="smplh", device="cpu")
    base = stageii.mosh_stageii_solve(prob, opts, fp["obs"], fp["mask"], **kw)
    with_rep, _ = stageii.mosh_stageii_solve(
        prob, opts, fp["obs"], fp["mask"], return_report=True,
        on_phase=lambda *a: None, **kw)
    for f in stageii.StageIIResult._fields[:-1]:
        assert torch.equal(getattr(base, f), getattr(with_rep, f)), f
    assert base.host_syncs == with_rep.host_syncs


def test_chunked_report_weighting(problems, tmp_path):
    fp, (prob, opts, prior) = problems["e0"]
    obs = np.concatenate([fp["obs"], fp["obs"][::-1], fp["obs"]])   # F=12
    mask = np.concatenate([fp["mask"], fp["mask"][::-1], fp["mask"]])
    ckpt = str(tmp_path / "ckpt")
    copts = dataclasses.replace(opts, chunk_frames=5, chunk_halo=2,
                                checkpoint_dir=ckpt)
    kw = dict(prior=prior, model_type="smplh", device="cpu")
    # a first run without the report leaves checkpoints without it
    plain = stageii.mosh_stageii_solve(prob, copts, obs, mask, **kw)
    files = sorted(os.listdir(ckpt))
    assert files == ["chunk_000000000.npz", "chunk_000000005.npz",
                     "chunk_000000010.npz"]
    res, rep = stageii.mosh_stageii_solve(prob, copts, obs, mask,
                                          return_report=True, **kw)
    assert res.host_syncs > 0            # every chunk re-solved
    for f in stageii.StageIIResult._fields[:-1]:
        assert torch.equal(getattr(plain, f), getattr(res, f)), f
    kept = np.asarray([5, 5, 2], np.float64)
    parts = []
    for name in files:
        with np.load(os.path.join(ckpt, name)) as z:
            assert tuple(z["report_phase_names"]) == rep.phase_names
            parts.append({k: z["report_" + k] for k in (
                "energies_before", "energies_after", "iterations")})
    w = kept / 12.0
    for k in ("energies_before", "energies_after"):
        np.testing.assert_array_equal(
            getattr(rep, k), np.sum(np.stack([p[k] for p in parts])
                                    * w[:, None, None], axis=0))
    np.testing.assert_array_equal(
        rep.iterations,
        np.sum(np.stack([p["iterations"] for p in parts]) * w[:, None], 0))
    # the rerun solves nothing and gives the same result and report
    again, rep2 = stageii.mosh_stageii_solve(prob, copts, obs, mask,
                                             return_report=True, **kw)
    assert again.host_syncs == 0
    for f in stageii.StageIIResult._fields[:-1]:
        assert torch.equal(getattr(again, f), getattr(res, f)), f
    for k in ("energies_before", "energies_after", "iterations"):
        np.testing.assert_array_equal(getattr(rep2, k), getattr(rep, k))


def test_mesh_still_raises(problems):
    """The mesh path is ported (tests/test_torch_parallel.py); a `mesh` that
    is not a `parallel.FrameMesh` still raises, with or without a report."""
    fp, (prob, opts, prior) = problems["e0"]
    for report in (False, True):
        with pytest.raises(TypeError, match="FrameMesh"):
            stageii.mosh_stageii_solve(prob, opts, fp["obs"], fp["mask"],
                                       prior=prior, mesh=object(),
                                       device="cpu", return_report=report)
