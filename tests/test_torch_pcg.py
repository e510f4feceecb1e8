"""The port's plain PCG direction (`moshpp_torch.solver.pcg.
pcg_direction_batched`, the entry point of the Pallas `_pcg_kernel`) against
the JAX package's, run in interpret mode on the CPU.

On CPU tensors the wrapper runs the plain PyTorch version
(`gauss_newton._gn_direction_pcg`), the version the CUDA kernel is held to
on the card. The Pallas kernel's interpret mode takes 10-55 s a case, so
these cases sit in a file of their own, which the test run's workers take
beside tests/test_torch_fold.py.
"""

import pathlib
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.solver.pallas_pcg import pcg_direction_batched as jax_pcg

from moshpp_torch.solver import gauss_newton, pcg

torch.set_num_threads(1)


def _pcg_inputs(D: int):
    """A converging `pcg.direction_test_system` case (Jacobi-scaled cond ~5,
    8 frames) masked and damped as a caller hands it over: (g, B, plin)."""
    g, B, plin, mask, _ = pcg.direction_test_system(8, D, 5.0, seed=D,
                                                    device="cpu")
    gm, Bm = gauss_newton._masked_system(g, B, mask)
    Bd = gauss_newton._damp(Bm, gauss_newton.DoglegOptions(damping=1e-8))
    return gm, Bd, plin * mask


@pytest.mark.parametrize("D,iters", [(17, 20), (17, 48), (117, 20),
                                     (117, 48)])
def test_pcg_matches_pallas(D, iters):
    """p_gn within rtol 1e-4 (atol 1e-6) of the Pallas `_pcg_kernel`'s,
    ok equal, on a system CG solves in these iterations (at D=17, 48 run on
    through the breakdown guards). The Pallas kernel unrolls its CG below
    D=32 (`CG_LOOP_MIN_D`), so D=17 at 48 iterations takes ~50 s to trace
    in interpret mode."""
    args = _pcg_inputs(D)
    p_r, ok_r = jax_pcg(*(jnp.asarray(a.numpy()) for a in args), iters=iters,
                        interpret=True)
    p, ok = pcg.pcg_direction_batched(*args, iters)
    assert ok.dtype == torch.bool and bool(ok.all())
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), rtol=1e-4,
                               atol=1e-6)


def test_pcg_width_guard():
    """The PCG mode shares the direction kernel's shared-memory guard:
    one past the widest D raises on every device, naming the bytes."""
    D = pcg.MAX_DIRECTION_WIDTH + 1
    g, B, plin = _pcg_inputs(D)
    with pytest.raises(ValueError, match=str(pcg.direction_smem_bytes(D))):
        pcg.pcg_direction_batched(g, B, plin, 24)


def test_direction_smem_bytes_matches_kernel_layout():
    """`direction_smem_bytes` counts what csrc/dogleg_direction.cu lays out:
    the static block-sum scratch (kRedBufs x kRedSlots x 32 floats); the
    dynamic vectors and the whole B, or past the block's limit its padded
    rows (`dyn_floats`, `row_len`: the same expressions as `pcg`'s); and the
    launcher's limit (kSmemPerBlock), so the widest D it admits is the
    kernel's, and the whole B is used up to D=239."""
    src = (pathlib.Path(pcg.__file__).parents[1] / "csrc" /
           "dogleg_direction.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))
    assert pcg.SMEM_STATIC == const("kRedBufs") * const("kRedSlots") * 32 * 4
    assert pcg.SMEM_PER_BLOCK == const("kSmemPerBlock")
    assert "__shared__ float red[kRedBufs * kRedSlots * 32];" in src
    assert "return ((D - (d & ~3) - 4 + 31) & ~31) + 4;" in src
    assert "size_t n = 2 * static_cast<size_t>((D + 3) & ~3);" in src
    assert "if (!tri) return n + static_cast<size_t>(D) * D + 3;" in src
    assert "for (int d = 0; d < D; ++d) n += row_len(d, D);" in src
    for D in (1, 17, 117, 206, 239):
        assert pcg.direction_smem_bytes(D) == \
            4 * (2 * (-(-D // 4) * 4) + D * D + 3) + pcg.SMEM_STATIC
    for D in (240, 300, 320):
        rows = [((D - (d & ~3) - 4 + 31) // 32) * 32 + 4 for d in range(D)]
        assert all(r % 32 == 4 and r >= D - (d & ~3)
                   for d, r in enumerate(rows))
        assert pcg.direction_smem_bytes(D) == \
            4 * (sum(rows) + 2 * (-(-D // 4) * 4)) + pcg.SMEM_STATIC
    assert pcg.direction_smem_bytes(pcg.MAX_DIRECTION_WIDTH) <= \
        pcg.SMEM_PER_BLOCK < pcg.direction_smem_bytes(
            pcg.MAX_DIRECTION_WIDTH + 1)
    assert pcg.MAX_DIRECTION_WIDTH >= 240
