"""The plain reference against float64 hand computations at tiny sizes."""

import numpy as np
import torch

import bench_common  # noqa: F401  (puts the benchmark on sys.path)
from reference import (Body, Subject, frame_vertices, marker_coefficients,
                       place_markers, rodrigues, round_tf32)


def _rot_np(r):
    t = np.linalg.norm(r)
    k = r / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def test_rodrigues_matches_closed_form_and_small_angles():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(5, 3))
    got = rodrigues(torch.as_tensor(r)).numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], _rot_np(r[i]), atol=1e-14)
    tiny = torch.tensor([[1e-9, -2e-9, 3e-9]], dtype=torch.float64)
    np.testing.assert_allclose(rodrigues(tiny)[0].numpy(),
                               _rot_np(tiny[0].numpy()), atol=1e-15)


def _two_joint_model():
    """A 2-joint chain, 3 vertices, 2 shape dirs, posedirs on joint 1."""
    rng = np.random.default_rng(1)
    V, J = 3, 2
    model = dict(
        v_template=rng.normal(size=(V, 3)),
        shapedirs=rng.normal(size=(V, 3, 2)) * 0.1,
        posedirs=rng.normal(size=(V, 3, 9)) * 0.05,
        weights=np.array([[1.0, 0.0], [0.3, 0.7], [0.0, 1.0]]),
        J_regressor=np.array([[0.5, 0.5, 0.0], [0.0, 0.2, 0.8]]),
        kintree_table=np.array([[2 ** 32 - 1, 0], [0, 1]]))
    return model


def test_forward_matches_hand_lbs():
    m = _two_joint_model()
    body = Body.from_files(m, None, body_pose_dof=6, dof_per_hand=0,
                           use_hands_mean=False, device="cpu")
    pose = np.array([0.3, -0.2, 0.1, -0.4, 0.5, 0.2])
    trans = np.array([0.1, 0.2, -0.3])
    beta = np.array([0.7, -1.2])
    got = body.forward(torch.as_tensor(pose[None]),
                       torch.as_tensor(trans[None]),
                       torch.as_tensor(beta), [0, 1])[0].numpy()
    # by hand
    vs = m["v_template"] + m["shapedirs"] @ beta
    jt = m["J_regressor"] @ vs
    R0, R1 = _rot_np(pose[:3]), _rot_np(pose[3:])
    vp = vs + m["posedirs"] @ (R1 - np.eye(3)).reshape(-1)
    G0 = np.eye(4)
    G0[:3, :3], G0[:3, 3] = R0, jt[0]
    L1 = np.eye(4)
    L1[:3, :3], L1[:3, 3] = R1, jt[1] - jt[0]
    G1 = G0 @ L1
    want = []
    for v in range(3):
        acc = np.zeros(3)
        for j, G in enumerate((G0, G1)):
            A = G.copy()
            A[:3, 3] -= G[:3, :3] @ jt[j]
            acc += m["weights"][v, j] * (A[:3, :3] @ vp[v] + A[:3, 3])
        want.append(acc + trans)
    np.testing.assert_allclose(got, np.array(want), atol=1e-13)


def test_hand_pca_and_vertex_subset():
    rng = np.random.default_rng(2)
    m = _two_joint_model()
    hands = dict(componentsl=rng.normal(size=(4, 3)),
                 componentsr=rng.normal(size=(4, 3)),
                 hands_meanl=rng.normal(size=3), hands_meanr=rng.normal(size=3))
    # body dofs 0 (joint 0 only as 3 dofs), hands fill joint 1: 3 + 3 = 6
    # axis-angles, but the hand tables give 6: use 2 dofs a hand
    body = Body.from_files(m, hands, body_pose_dof=0, dof_per_hand=2,
                           use_hands_mean=True, device="cpu")
    pose = rng.normal(size=(2, 4))
    fp = body.fullpose(torch.as_tensor(pose)).numpy()
    cl, cr = hands["componentsl"][:2], hands["componentsr"][:2]
    want = np.concatenate([hands["hands_meanl"] + pose[:, :2] @ cl,
                           hands["hands_meanr"] + pose[:, 2:] @ cr], 1)
    np.testing.assert_allclose(fp, want, atol=1e-14)
    full = body.forward(torch.as_tensor(pose), torch.zeros(2, 3),
                        torch.zeros(2), [0, 1])
    sub = body.forward(torch.as_tensor(pose), torch.zeros(2, 3),
                       torch.zeros(2), [0, 1], torch.tensor([2, 0]))
    np.testing.assert_allclose(sub.numpy(), full[:, [2, 0]].numpy(),
                               atol=1e-15)


def test_markers_round_trip_on_the_canonical_body():
    rng = np.random.default_rng(3)
    can = torch.as_tensor(rng.normal(size=(40, 3)))
    lat = can[:5] + torch.as_tensor(rng.normal(size=(5, 3))) * 0.01
    fr = frame_vertices(can, lat)
    # c0, c1 the two nearest, by brute force
    d = ((lat[:, None] - can[None]) ** 2).sum(-1).numpy()
    order = np.argsort(d, axis=1, kind="stable")
    np.testing.assert_array_equal(fr[:, :2].numpy(), order[:, :2])
    co = marker_coefficients(can, lat, fr)
    back = place_markers(can[fr][None], co)[0]
    np.testing.assert_allclose(back.numpy(), lat.numpy(), atol=1e-14)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9, 1.0 + 2 ** -12], dtype=torch.float32)
    got = round_tf32(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                         1.0], dtype=torch.float32)
    assert torch.equal(got, want)


def test_precisions_agree_to_their_rounding():
    m = _two_joint_model()
    mk = lambda p: Body.from_files(m, None, body_pose_dof=6, dof_per_hand=0,
                                   use_hands_mean=False, device="cpu",
                                   precision=p)
    pose = torch.tensor([[0.3, -0.2, 0.1, -0.4, 0.5, 0.2]], dtype=torch.float64)
    args = (torch.zeros(1, 3), torch.tensor([0.5, -0.5]), [0, 1])
    v64 = mk("float64").forward(pose, *args)
    d32 = (mk("float32").forward(pose, *args) - v64).abs().max()
    d19 = (mk("tf32").forward(pose, *args) - v64).abs().max()
    assert d32 < 1e-6 < d19 < 1e-2


def test_subject_markers_follow_the_forward_model():
    m = _two_joint_model()
    body = Body.from_files(m, None, body_pose_dof=6, dof_per_hand=0,
                           use_hands_mean=False, device="cpu")
    can = body.v_template + body.shapedirs @ torch.tensor(
        [0.2, 0.1], dtype=torch.float64)
    lat = can + 0.01
    sub = Subject(body, np.array([0.2, 0.1]), lat.numpy(), [])
    x = torch.zeros(1, 9, dtype=torch.float64)
    np.testing.assert_allclose(sub.markers(x)[0].numpy(), lat.numpy(),
                               atol=1e-12)
