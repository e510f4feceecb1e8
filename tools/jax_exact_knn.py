"""Give the JAX package the port's exact knn ranking, in this process.

    from jax_exact_knn import use_exact_knn
    use_exact_knn()        # before anything is traced

`moshpp_torch/ops/knn.py` ranks by dx*dx + dy*dy + dz*dz, the JAX package
by |q|^2 - 2 q.p + |p|^2, whose cancellation leaves near-ties to the
device's rounding. The reference tools (tools/stagei_reference.py,
tools/head_reference.py) and the CPU tests that hold stage i or the head to
the JAX package replace `moshpp_tpu.ops.knn._sq_dists` by the port's form;
`knn`, `nearest_vertex` and `select_frame_indices` look it up at call time,
so the substitution reaches stage i and stage ii. No file of the JAX package
changes.

The form is evaluated in numpy through `jax.pure_callback`, not in `jnp`:
under `jit` XLA's CPU backend contracts dx*dx + dy*dy into a fused
multiply-add, which rounds once where numpy and PyTorch round twice, so a
jitted `jnp` form differs from the port's matrix in the last bit of ~20 %
of its entries. Numpy's elementwise float32 operations round as PyTorch's
do on the CPU and the card, so the callback's matrix is the port's bit for
bit. Call it once, first: a function traced before the call keeps the
expansion in JAX's caches.
"""

from __future__ import annotations

import importlib

import numpy as np


def sq_dists_np(queries, points) -> np.ndarray:
    """The port's `_sq_dists` in numpy float32."""
    d = (np.asarray(queries, np.float32)[:, None, :]
         - np.asarray(points, np.float32)[None, :, :])
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def exact_sq_dists(queries, points):
    """A drop-in for `moshpp_tpu.ops.knn._sq_dists` (traceable, vmappable)."""
    import jax
    import jax.numpy as jnp
    shape = jax.ShapeDtypeStruct((queries.shape[0], points.shape[0]),
                                 jnp.float32)
    return jax.pure_callback(sq_dists_np, shape, queries, points,
                             vmap_method="sequential")


def use_exact_knn() -> None:
    """Replace the JAX package's knn distance matrix by the port's."""
    mod = importlib.import_module("moshpp_tpu.ops.knn")
    mod._sq_dists = exact_sq_dists
