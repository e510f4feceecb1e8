"""The port's plain PCG direction (`moshpp_torch.solver.pcg.
pcg_direction_batched`, the entry point of the Pallas `_pcg_kernel`) against
the JAX package's, run in interpret mode on the CPU.

On CPU tensors the wrapper runs the plain PyTorch version
(`gauss_newton._gn_direction_pcg`), the version the CUDA kernel is held to
on the card. The Pallas kernel's interpret mode takes 10-55 s a case, so
these cases sit in a file of their own, which the test run's workers take
beside tests/test_torch_fold.py.
"""

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
    g, B, plin, mask, _ = pcg.direction_test_system(8, D, 5.0, seed=D)
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
    D=241 raises on every device, naming the bytes."""
    g, B, plin = _pcg_inputs(241)
    with pytest.raises(ValueError, match=str(pcg.direction_smem_bytes(241))):
        pcg.pcg_direction_batched(g, B, plin, 24)
