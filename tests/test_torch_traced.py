"""The port's traced dogleg solve (`batched_system_solve_traced`) on the CPU.

(a) The twin of tests/test_solver.py::TestTracedSolve on its toy system
    (r = [x - t, 0.5 x0²], N=16, P=3, maxiter 30, e_3 1e-10, delta_0 1):
    the traced x equals the port's plain loop's bit for bit, the trace is
    coherent (f non-increasing, the active flags sum to the iterations, x
    frozen bit for bit once a problem is done), and f, delta, accepted and
    active match the JAX package's traced solve (f and delta to 1e-5 of
    their largest value, the flags equal).
(b) On the golden smplh stage-ii problem tiled to F=32, through the
    direct assembly and the PCG direction: the traced x is bit for bit the
    plain loop's, and the traced solve reads nothing to the host
    (`host_syncs == 0`).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_torch.pipeline import stageii
from moshpp_torch.solver import gauss_newton as gn

torch.set_num_threads(1)

N, P, MAXITER = 16, 3, 30
TRACE_RTOL = 1e-5


@pytest.fixture(scope="module")
def toy():
    """The toy's targets, the port's plain and traced solves and JAX's
    traced solve (numpy)."""
    from moshpp_tpu.solver.gauss_newton import (
        DoglegOptions as JaxOptions, _residual_system as jax_residual_system,
        batched_system_solve_traced as jax_traced)
    targets = np.random.default_rng(42).normal(size=(N, P)).astype(np.float32)
    jsys = jax_residual_system(
        lambda x, t: jnp.concatenate([x - t, 0.5 * (x[:1] ** 2)]), "highest")
    jres, jtrace = jax_traced(jsys, jnp.zeros((N, P)), jnp.asarray(targets),
                              JaxOptions(maxiter=MAXITER, e_3=1e-10,
                                         delta_0=1.0), record_x=True)
    system = gn._residual_system(
        lambda x, t: torch.cat([x - t, 0.5 * (x[:1] ** 2)]), batched_aux=True)
    opts = gn.DoglegOptions(maxiter=MAXITER, e_3=1e-10, delta_0=1.0)
    x0 = torch.zeros((N, P))
    t = torch.as_tensor(targets)
    with gn.fp32_matmul():
        plain = gn.batched_system_solve(system, x0, t, opts,
                                        compact_buckets=())
    traced, trace = gn.batched_system_solve_traced(system, x0, t, opts,
                                                   record_x=True)
    return dict(plain=plain, traced=traced, trace=trace,
                jax_x=np.asarray(jres.x),
                jax_trace={k: np.asarray(v) for k, v in jtrace.items()})


def test_toy_traced_equals_plain(toy):
    plain, traced = toy["plain"], toy["traced"]
    assert torch.equal(traced.x, plain.x)
    assert torch.equal(traced.iterations, plain.iterations)
    assert torch.equal(traced.converged, plain.converged)
    assert traced.host_syncs == 0
    np.testing.assert_allclose(traced.x.numpy(), toy["jax_x"], atol=1e-5)


def test_toy_trace_is_coherent(toy):
    trace, traced = toy["trace"], toy["traced"]
    assert trace["f"].shape == (MAXITER, N)
    assert trace["x"].shape == (MAXITER, N, P)
    f = trace["f"]
    assert bool(torch.all(f[1:] <= f[:-1]))      # a reject keeps f
    assert torch.equal(trace["active"].sum(0).to(torch.int32),
                       traced.iterations)
    assert bool(torch.all(trace["accepted"] <= trace["active"]))
    for n in range(N):
        k = int(traced.iterations[n])
        tail = trace["x"][k - 1:, n]
        assert torch.equal(tail, tail[:1].expand_as(tail)), n
        assert torch.equal(trace["x"][-1, n], traced.x[n])


@pytest.mark.parametrize("key", ["f", "delta", "accepted", "active"])
def test_toy_trace_matches_jax(toy, key):
    ours, ref = toy["trace"][key].numpy(), toy["jax_trace"][key]
    assert ours.shape == ref.shape
    if ours.dtype == bool:
        np.testing.assert_array_equal(ours, ref)
    else:
        # relative to the trace's largest value: near the optimum a
        # shrunk radius is a quarter of a step |p| of rounding size
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=TRACE_RTOL * np.abs(ref).max())


def test_golden_stageii_traced_pcg_bit_for_bit():
    """(b) F=32 frames of the golden smplh problem (its 4 frames tiled),
    step-2 mask, PCG direction, maxiter 25."""
    from golden_common import build_family_problem
    from torch_families_common import port_problem
    fp = dict(build_family_problem("smplh"), family="smplh")
    prob, opts, prior = port_problem(fp)
    F = 32
    obs = torch.as_tensor(np.tile(fp["obs"], (F // 4, 1, 1)))
    maskf = torch.as_tensor(np.tile(fp["mask"], (F // 4, 1))).to(
        torch.float32)
    M = maskf.shape[1]
    Pd = prob.sub_model.pose_dof
    n_obs = maskf.sum(1)
    aux = {"markers": obs, "mask": maskf,
           "wt_data": opts.wt("data") * 46.0 / n_obs,
           "anneal": 1.0 + (M - n_obs) / M * opts.wt("annealing"),
           "wt_pose_scale": torch.ones(F),
           "velo_anchor": torch.zeros(F, Pd), "velo_on": torch.zeros(F)}
    # the frames differ: the tiled copies start from perturbed inits
    x0 = stageii.rigid_init(prob, opts, obs, maskf)
    x0 = x0 + 0.01 * torch.as_tensor(
        np.random.default_rng(5).normal(size=x0.shape).astype(np.float32))
    _, step2 = stageii._param_masks(prob.sub_model, opts, "smplh", "cpu")
    system = stageii.make_stageii_system(prob, opts, prior, "smplh")
    dl = gn.DoglegOptions(maxiter=25, delta_0=0.5, linear_solver="pcg",
                          cg_iters=24)
    with gn.fp32_matmul():
        plain = gn.batched_system_solve(system, x0, aux, dl,
                                        param_mask=step2, e_3=1e-4,
                                        compact_buckets=())
    traced, trace = gn.batched_system_solve_traced(
        system, x0, aux, dl, param_mask=step2, e_3=1e-4, record_x=True)
    assert traced.host_syncs == 0
    assert plain.host_syncs > 0
    assert torch.equal(traced.x, plain.x)
    assert torch.equal(traced.iterations, plain.iterations)
    assert torch.equal(trace["active"].sum(0).to(torch.int32),
                       traced.iterations)
    assert torch.isfinite(trace["f"]).all()
