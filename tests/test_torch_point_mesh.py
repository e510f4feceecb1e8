"""The port's point-to-mesh, scan-to-mesh and robustifier ops against the
JAX package's on the same numpy inputs, on the CPU.

Tolerances: float32 results within 1e-5 of the JAX values (scaled by the
largest magnitude where it exceeds 1), derivatives within 1e-4 of each
case's largest entry; integer results and numpy draws exactly equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moshpp_tpu.models.synthetic import icosphere
from moshpp_tpu.ops.knn import nearest_vertex as jax_nearest_vertex
from moshpp_tpu.ops import point_mesh as jpm
from moshpp_tpu.ops import robustifiers as jrob
from moshpp_tpu.ops import scan2mesh as js2m

from moshpp_torch.ops.knn import nearest_vertex
from moshpp_torch.ops import point_mesh as tpm
from moshpp_torch.ops import robustifiers as trob
from moshpp_torch.ops import scan2mesh as ts2m

torch.set_num_threads(1)
TOL = 1e-5
JAC_TOL = 1e-4


def close(a, b, tol=TOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0, err_msg=what)


# a unit right triangle and one point in each of the seven regions
_TRI = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
_REGION_POINTS = {
    "interior": (0.2, 0.2, 0.5), "a": (-0.5, -0.5, 0.3),
    "b": (1.5, -0.2, 0.1), "c": (-0.2, 1.5, -0.1), "ab": (0.5, -0.5, 0.2),
    "ac": (-0.5, 0.5, 0.2), "bc": (0.8, 0.8, 0.3)}


def _region(bary) -> str:
    """The region of a closest point by its barycentric pattern."""
    on = bary > 1e-7
    if on.all():
        return "interior"
    names = [n for n, o in zip("abc", on) if o]
    return "".join(names)


def triangle_cases():
    """(points, a, b, c) float32 (N, 3) each: the seven regions under
    random rigid motions and scales, random points on random triangles,
    and degenerate triangles (collinear, two and three equal corners)."""
    rng = np.random.default_rng(5)
    pts, tris = [], []
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        s, t = rng.uniform(0.01, 2.0), rng.normal(size=3)
        for p in _REGION_POINTS.values():
            pts.append(s * q @ np.asarray(p) + t)
            tris.append(s * _TRI @ q.T + t)
    for _ in range(60):
        tris.append(rng.normal(size=(3, 3)))
        pts.append(rng.normal(size=3) * 1.5)
    a, b = rng.normal(size=3), rng.normal(size=3)
    for tri in ([a, b, 2 * b - a], [a, a, b], [a, a, a], [a, b, b],
                [a, 0.5 * (a + b), b]):
        for _ in range(4):
            tris.append(np.asarray(tri))
            pts.append(rng.normal(size=3))
    tris = np.asarray(tris, np.float32)
    return (np.asarray(pts, np.float32), tris[:, 0], tris[:, 1], tris[:, 2])


def test_closest_point_all_regions_and_degenerate():
    """The barycentric coordinates of every case, the seven regions all hit
    by the designed cases, each in its intended region."""
    args = triangle_cases()
    ref = np.asarray(jpm.closest_point_on_triangles(*map(jnp.asarray, args)))
    out = tpm.closest_point_on_triangles(*map(torch.as_tensor, args))
    close(out, ref, what="bary")
    designed = [_region(b) for b in ref[:4 * len(_REGION_POINTS)]]
    assert designed == list(_REGION_POINTS) * 4
    assert np.isfinite(out.numpy()).all()


def test_closest_point_jacobian_matches_jax():
    """d bary / d (point, a, b, c) by forward mode: finite everywhere (the
    degenerate triangles included) and equal to JAX's jacfwd."""
    args = triangle_cases()
    jf = jax.vmap(jax.jacfwd(jpm.closest_point_on_triangles,
                             argnums=(0, 1, 2, 3)))
    tf = torch.func.vmap(torch.func.jacfwd(tpm.closest_point_on_triangles,
                                           argnums=(0, 1, 2, 3)))
    ref = jf(*map(jnp.asarray, args))
    out = tf(*map(torch.as_tensor, args))
    for name, o, r in zip(("point", "a", "b", "c"), out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.isfinite(o).all(), name
        scale = np.maximum(np.abs(r).reshape(len(r), -1).max(1), 1.0)
        err = np.abs(o - r).reshape(len(r), -1).max(1) / scale
        assert err.max() <= JAC_TOL, (name, int(err.argmax()), err.max())


@pytest.fixture(scope="module")
def mesh():
    """An icosphere squashed into an ellipsoid, and query points near and
    far from it."""
    v, f = icosphere(2)
    v = (v * np.array([0.3, 0.2, 0.5])).astype(np.float32)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * np.array([0.3, 0.2, 0.5]) * rng.uniform(0.6, 1.4, (40, 1))
           ).astype(np.float32)
    return v, f.astype(np.int64), pts


@pytest.mark.parametrize("prefilter_k", [None, 16])
def test_nearest_and_distances_match_jax(mesh, prefilter_k):
    v, f, pts = mesh
    jv, jf, jp = jnp.asarray(v), jnp.asarray(f), jnp.asarray(pts)
    tv, tf, tp = torch.as_tensor(v), torch.as_tensor(f), torch.as_tensor(pts)
    rn = jpm.nearest_on_mesh(jp, jv, jf, prefilter_k)
    tn = tpm.nearest_on_mesh(tp, tv, tf, prefilter_k)
    close(tn.point, rn.point, what="point")
    close(tn.sq_dist, rn.sq_dist, what="sq_dist")
    # ties (a closest vertex shared by several faces) may pick another face
    # with the same closest point; away from them the faces agree
    assert (tn.tri_idx.numpy() == np.asarray(rn.tri_idx)).mean() > 0.8
    close(tpm.point_to_mesh_distance(tp, tv, tf, prefilter_k),
          jpm.point_to_mesh_distance(jp, jv, jf, prefilter_k), what="dist")
    sd_t = tpm.signed_point_to_mesh_distance(tp, tv, tf, prefilter_k)
    sd_j = jpm.signed_point_to_mesh_distance(jp, jv, jf, prefilter_k)
    close(sd_t, sd_j, what="signed")
    assert (np.sign(sd_t.numpy()) == np.sign(np.asarray(sd_j))).all()
    assert (sd_t.numpy() > 0).any() and (sd_t.numpy() < 0).any()


def test_signed_distance_derivative_matches_jax(mesh):
    """d signed distance / d points: the sign carries no derivative."""
    v, f, pts = mesh
    pts = pts[:12]
    ref = jax.jacfwd(lambda p: jpm.signed_point_to_mesh_distance(
        p, jnp.asarray(v), jnp.asarray(f), None))(jnp.asarray(pts))
    out = torch.func.jacfwd(lambda p: tpm.signed_point_to_mesh_distance(
        p, torch.as_tensor(v), torch.as_tensor(f), None))(torch.as_tensor(pts))
    close(out, ref, tol=JAC_TOL, what="jacobian")


def test_robustifiers_match_jax():
    """Values and derivatives, finite at zero."""
    x = np.concatenate([np.linspace(-2, 2, 41), [0.0, 1e-9, -1e-9]]
                       ).astype(np.float32)
    for name, jf, tf in (
            ("signed_sqrt", jrob.signed_sqrt, trob.signed_sqrt),
            ("gmof", lambda a: jrob.gmof(a, 0.3),
             lambda a: trob.gmof(a, 0.3)),
            ("gmof_normalized", lambda a: jrob.gmof_normalized(a, 0.3),
             lambda a: trob.gmof_normalized(a, 0.3))):
        close(tf(torch.as_tensor(x)), jf(jnp.asarray(x)), what=name)
        dj = jax.vmap(jax.grad(jf))(jnp.asarray(x))
        dt = torch.func.vmap(torch.func.grad(tf))(torch.as_tensor(x))
        assert np.isfinite(dt.numpy()).all(), name
        close(dt, dj, tol=JAC_TOL, what=f"d {name}")


@pytest.mark.parametrize("sample_type", ["vertices", "uniformly-from-vertices",
                                         "edge-midpoints",
                                         "uniformly-at-random"])
def test_sample_from_mesh_same_draws(mesh, sample_type):
    v, f, _ = mesh
    kw = dict(sample_type=sample_type, num_samples=50, seed=11)
    if sample_type == "vertices":
        kw["vertex_indices_to_sample"] = np.arange(0, len(v), 7)
    ref = js2m.sample_from_mesh(v, f, **kw)
    out = ts2m.sample_from_mesh(v, f, **kw)
    np.testing.assert_array_equal(out.vert_ids, ref.vert_ids)
    np.testing.assert_array_equal(out.bary, ref.bary)
    assert out.num_samples == ref.num_samples
    close(out.sample(torch.as_tensor(v)), ref.sample(jnp.asarray(v)))


def test_scan2mesh_objectives_match_jax(mesh):
    """scan_to_mesh (sampled, robustified), mesh_to_scan, pts_to_mesh
    signed and unsigned, clamped_signed_pts_to_mesh."""
    v, f, pts = mesh
    scan_v = (v * 1.05 + 0.01).astype(np.float32)
    sampler_j = js2m.sample_from_mesh(scan_v, f, "uniformly-at-random",
                                      num_samples=60, seed=2)
    sampler_t = ts2m.sample_from_mesh(scan_v, f, "uniformly-at-random",
                                      num_samples=60, seed=2)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    jf = jnp.asarray(f)
    jax_cases = jax.jit(lambda sv, vv, pp: (
        js2m.scan_to_mesh(sv, vv, jf, rho=lambda x: jrob.gmof(x, 0.05),
                          sampler=sampler_j, prefilter_k=None),
        js2m.mesh_to_scan(vv, sv, jf, signed=True),
        js2m.pts_to_mesh(pp, vv, jf, normalize=False),
        js2m.pts_to_mesh(pp, vv, jf, signed=True),
        js2m.clamped_signed_pts_to_mesh(pp, vv, jf, -0.02, 0.05)))(
            jnp.asarray(scan_v), jnp.asarray(v), jnp.asarray(pts))
    T = lambda a: torch.as_tensor(a)
    port_cases = (
        ts2m.scan_to_mesh(T(scan_v), T(v), f,
                          rho=lambda x: trob.gmof(x, 0.05),
                          sampler=sampler_t, prefilter_k=None),
        ts2m.mesh_to_scan(T(v), T(scan_v), f, signed=True),
        ts2m.pts_to_mesh(T(pts), T(v), f, normalize=False),
        ts2m.pts_to_mesh(T(pts), T(v), f, signed=True),
        ts2m.clamped_signed_pts_to_mesh(T(pts), T(v), f, -0.02, 0.05))
    cases = zip(("scan_to_mesh", "mesh_to_scan", "pts_to_mesh",
                 "pts_to_mesh signed", "clamped"), jax_cases, port_cases)
    for name, ref, out in cases:
        assert out.shape == ref.shape, name
        close(out, ref, what=name)


def test_nearest_vertex_matches_jax(mesh):
    v, _, pts = mesh
    ref = jax_nearest_vertex(jnp.asarray(pts), jnp.asarray(v))
    out = nearest_vertex(torch.as_tensor(pts), torch.as_tensor(v))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_knn_orders_ties_as_jax():
    """knn and the prefilter's smallest_k on exact ties: points of an
    integer grid and queries on and between them (every distance exact in
    float32), so that most of the k nearest tie. The port returns JAX's
    order (lower index first) and the same distances, bit for bit."""
    from moshpp_tpu.ops.knn import knn as jax_knn
    from moshpp_torch.ops.knn import knn, smallest_k
    g = np.arange(5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    queries = np.array([[2, 2, 2], [1.5, 2, 2], [1.5, 1.5, 2],
                        [1.5, 1.5, 1.5], [0, 0, 0], [4, 2, 0.5]], np.float32)
    ji, jd = jax_knn(jnp.asarray(queries), jnp.asarray(pts), k=12)
    ti, td = knn(torch.as_tensor(queries), torch.as_tensor(pts), k=12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    d = np.round(np.random.default_rng(0).uniform(0, 4, (6, 50)))
    d = d.astype(np.float32)
    jv, jidx = jax.lax.top_k(-jnp.asarray(d), 20)
    tv, tidx = smallest_k(torch.as_tensor(d), 20)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), -np.asarray(jv))


# float32's unit roundoff
_U = float(np.finfo(np.float32).eps) / 2


def _clear_rows(d64, k, bound):
    """Rows whose k + 1 nearest (float64 distances d64, sorted) are apart
    by more than 2 x `bound` (per entry) between neighbouring ranks."""
    srt = np.sort(d64, axis=1)[:, :k + 1]
    b = np.take_along_axis(bound, np.argsort(d64, axis=1, kind="stable"),
                           axis=1)[:, :k + 1]
    return np.all(np.diff(srt, axis=1) > 2 * (b[:, 1:] + b[:, :-1]), axis=1)


def test_knn_ranks_exactly():
    """The port's knn ranks by dx*dx + dy*dy + dz*dz (a deliberate
    difference from the JAX package's |q|^2 - 2 q.p + |p|^2): on latent
    markers 9.5 mm off a 10242-vertex body's surface, 1 m from the origin,
    it gives the float64 ranking wherever float64's neighbouring ranks are
    apart by more than its own rounding, and the JAX package's wherever
    JAX's are apart by more than the expansion's error bound."""
    from moshpp_tpu.ops.knn import knn as jax_knn
    from moshpp_torch.models.synthetic import icosphere
    from moshpp_torch.ops.knn import knn
    v, _ = icosphere(5)
    rng = np.random.default_rng(4)
    pts = (v * [0.2, 0.15, 0.9] + [0.6, -0.4, 0.5]).astype(np.float32)
    vids = rng.choice(len(pts), 150, replace=False)
    q = (pts[vids] + rng.normal(size=(150, 3)) * 0.0095).astype(np.float32)
    k = 8
    d64 = np.sum((q[:, None, :].astype(np.float64) - pts[None]) ** 2, -1)
    ti, td = knn(torch.as_tensor(q), torch.as_tensor(pts), k=k)
    # the port's error: 3 roundings of each difference, 5 of the sum
    mine = _clear_rows(d64, k, 8 * _U * d64)
    assert mine.mean() > 0.9
    ref = np.argsort(d64, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ti.numpy()[mine], ref[mine])
    np.testing.assert_allclose(td.numpy(), np.sort(d64, 1)[:, :k], rtol=1e-6)
    # the expansion's error: a few roundings of |q|^2 + 2|q||p| + |p|^2
    nq = np.linalg.norm(q, axis=1)[:, None]
    npt = np.linalg.norm(pts, axis=1)[None]
    theirs = _clear_rows(d64, k, 8 * _U * (nq + npt) ** 2)
    ji, _ = jax_knn(jnp.asarray(q), jnp.asarray(pts), k=k)
    assert theirs.any()
    np.testing.assert_array_equal(ti.numpy()[theirs], np.asarray(ji)[theirs])


def test_knn_near_tie_the_expansion_misorders():
    """Two vertices a marker's distance off (~1 cm, 1 m from the origin)
    whose squared distances differ by 1e-10 m^2: inside the expansion's
    rounding, far outside the port's. Among such pairs the JAX package
    puts the farther first for some; the port never does."""
    from moshpp_tpu.ops.knn import knn as jax_knn
    from moshpp_torch.ops.knn import knn, nearest_vertex
    rng = np.random.default_rng(11)
    misordered = 0
    for _ in range(200):
        q = (rng.normal(size=3) * 0.3 + [0.8, 0.4, 0.3]).astype(np.float32)
        u = rng.normal(size=(2, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = (q + u * 0.01).astype(np.float32)
        d64 = np.sum((p.astype(np.float64) - q) ** 2, -1)
        gap = d64[1] - d64[0]
        if not 2e-11 < abs(gap) < 1e-9:
            # move the second point along its ray to a 1e-10 m^2 gap
            r = np.sqrt(d64[0] + 1e-10)
            p[1] = (q + u[1] * r).astype(np.float32)
            d64 = np.sum((p.astype(np.float64) - q) ** 2, -1)
            gap = d64[1] - d64[0]
            if not 2e-11 < abs(gap) < 1e-9:
                continue
        near = int(np.argmin(d64))
        ti, _ = knn(torch.as_tensor(q[None]), torch.as_tensor(p), k=2)
        assert int(ti[0, 0]) == near
        assert int(nearest_vertex(torch.as_tensor(q[None]),
                                  torch.as_tensor(p))[0]) == near
        ji, _ = jax_knn(jnp.asarray(q[None]), jnp.asarray(p), k=2)
        misordered += int(ji[0, 0]) != near
    assert misordered > 0
