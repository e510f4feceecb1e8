"""The host side of the redesigned `marker_rows` kernels, on the CPU.

(a) `block_diagonal_by_hand` / `hand_blocks`: the hand-PCA components of the
    synthetic SMPL+H, SMPL-X and MANO models are block-diagonal by hand
    (two blocks, two, one), a single nonzero entry planted off the blocks
    makes the kernels take the full product, and a model without hands has
    no hand path at all;
(b) the per-hand product the kernels run on a block-diagonal hc adds, in
    the same order, the same nonzero terms as the full product (the terms
    it skips are exact zeros), so the two agree bit for bit in float32;
(c) `pdt` and `pd64`, the posedirs rows transposed joint-last, are the
    model's rows exactly, and a posedirs width other than 9 (J - 1) is
    refused;
(d) `rows_frames_per_block`, the frames a block of a launch: whole tiles,
    at most ROWS_MAX_TILES of them, every frame covered, and at the solve's
    compaction buckets (F = 128, 512 at M = 46) a grid that covers all 132
    SMs of the H100.

Inputs are made from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from moshpp_torch.models import make_synthetic_model
from moshpp_torch.ops import marker_jac as mj

from test_torch_extras_tables import _tables

torch.set_num_threads(1)


@pytest.mark.parametrize("family,dph,hands", [("smplh", 6, 2), ("smplh", 24, 2),
                                              ("smplx", 6, 2), ("mano", 6, 1),
                                              ("mano", 24, 1)])
def test_block_diagonal_hc_takes_the_hand_blocks(family, dph, hands):
    """A synthetic hc is block-diagonal by hand: one diagonal block a hand,
    each hand's dph components of its 45 axis-angle columns."""
    model, _, tables = _tables(family, dph, 7)
    hc = tables.hc.numpy()
    assert hc.shape == (hands * dph, 45 * hands)
    assert mj.block_diagonal_by_hand(hc, hands) is True
    assert tables.hand_blocks == mj.hand_blocks(hc, hands) == hands


@pytest.mark.parametrize("family,dph", [("smplh", 6), ("smplh", 24),
                                        ("smplx", 24)])
def test_off_block_entry_takes_the_full_product(family, dph):
    """One nonzero entry off the hand blocks (left hand's first component on
    a right-hand column, or the reverse) sends the kernels to the full
    product; the tables of such a model say so."""
    model = make_synthetic_model(family, num_verts=300, seed=4,
                                 dof_per_hand=dph, device="cpu")
    for d, h in ((0, 45), (dph, 44)):
        planted = model.hands_components.clone()
        planted[d, h] = 1e-3
        bad = dataclasses.replace(model, hands_components=planted)
        _, _, tables = _tables(family, dph, 7, model=bad)
        assert mj.block_diagonal_by_hand(planted.numpy(), 2) is False
        assert tables.hand_blocks == 1


@pytest.mark.parametrize("family", ["smpl", "animal_horse"])
def test_no_hands_no_hand_path(family):
    """Without hands there is no hc and no hand path: the detection says
    None and the kernels get one (unused) block."""
    _, _, tables = _tables(family, 0, 7)
    assert tables.hc is None and tables.hand_dof == 0
    assert mj.block_diagonal_by_hand(None, 0) is None
    assert tables.hand_blocks == 1


def _chain(u, hc, lo_h, hi_h, d):
    """The kernel's float32 chain of one component d: v = fma over hc[d, h]
    u[h] for h in [lo_h, hi_h), one rounding a term (fused or not, an exact
    zero term leaves v unchanged)."""
    v = np.float32(0.0)
    for h in range(lo_h, hi_h):
        v = np.float32(v + np.float32(hc[d, h] * u[h]))
    return v


@pytest.mark.parametrize("dph", [6, 24])
def test_per_hand_product_is_the_full_product(dph):
    """On a block-diagonal hc, each component's sum over its own hand's
    columns equals its sum over all 90 columns, bit for bit."""
    _, _, tables = _tables("smplh", dph, 5)
    hc = tables.hc.numpy()
    rng = np.random.default_rng(dph)
    for _ in range(3):
        u = rng.normal(size=90).astype(np.float32)
        for d in range(2 * dph):
            b = d // dph
            assert _chain(u, hc, 45 * b, 45 * (b + 1), d) == \
                _chain(u, hc, 0, 90, d)


@pytest.mark.parametrize("family,dph", [("smpl", 0), ("smplh", 6),
                                        ("smplx", 6), ("mano", 6)])
def test_transposed_posedirs_are_the_model_rows(family, dph):
    """pdt[m, k, c, ab, j - 1] is the posedirs row (c) of marker m's frame
    vertex k at feature 9 (j - 1) + ab, pd64 is pdt widened to float64,
    value for value, and pd3 gives the rows back in feature order."""
    model, idx, t = _tables(family, dph, 7)
    M, J = t.num_markers, t.num_joints
    rows = model.posedirs[idx.stacked.reshape(-1)].reshape(M, 3, 3, -1)
    assert t.feat_n == rows.shape[-1] == 9 * (J - 1)
    assert t.pdt.shape == (M, 3, 3, 9, J - 1) and t.pdt.is_contiguous()
    assert torch.equal(t.pdt, rows.reshape(M, 3, 3, J - 1, 9)
                       .transpose(-1, -2))
    assert torch.equal(t.pd3, rows)
    assert t.pd64.dtype == torch.float64
    assert torch.equal(t.pd64, t.pdt.double())


def test_posedirs_width_is_checked():
    """A posedirs block that is not 9 (J - 1) wide is refused: the kernels
    index it by joint."""
    model = make_synthetic_model("smpl", num_verts=300, seed=4, device="cpu")
    bad = dataclasses.replace(model, posedirs=model.posedirs[..., :-9])
    with pytest.raises(ValueError, match="posedirs width"):
        _tables("smpl", 0, 5, model=bad)


@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("M", [1, 7, 9, 46, 47])
@pytest.mark.parametrize("F", [1, 3, 17, 128, 129, 130, 256, 512, 513, 1024,
                               2048, 4096, 16384])
def test_rows_frames_per_block(F, M, with_jac):
    """Whole tiles a block, between one and ROWS_MAX_TILES, every frame
    covered; on 132 SMs at M = 46 the documented choices, and grids that
    cover every SM from F = 128 up."""
    sms = 132
    fpb = mj.rows_frames_per_block(F, M, sms, with_jac)
    assert fpb % mj.ROWS_TILE_FRAMES == 0
    assert mj.ROWS_TILE_FRAMES <= fpb <= mj.ROWS_TILE_FRAMES * mj.ROWS_MAX_TILES
    blocks = -(-F // fpb)
    assert blocks * fpb >= F > (blocks - 1) * fpb or F < fpb
    grid = blocks * -(-M // mj.ROWS_MARKERS)
    if M == 46 and F >= 128:
        assert grid >= sms
    if M == 46 and with_jac:
        want = {128: 4, 256: 6, 512: 12, 1024: 12, 2048: 16, 4096: 16}
        if F in want:
            assert fpb == want[F]
