"""Operations and bytes that the fused dogleg direction needs
(`dogleg_direction<false, ..>`): for each of N systems of width D, from
the raw normal equations B, the masked gradient g, the warm start, the
mask and the trust radius, I iterations of Jacobi-preconditioned CG on the
masked and damped system, the dogleg step and its predicted reduction.

The count is of what these inputs need at I iterations, whatever kernel
computes it, at the float32 rate (an FMA is 2). Per system:

- I + 3 products with the masked, damped B (the warm start's residual,
  one a CG iteration, the Cauchy point's B g and the prediction's B p):
  each 2 D^2 for the product and 6 D for the mask on the way in and out,
  the identity on the masked unknowns and the damping;
- set-up, 13 D: the masked diagonal and the damping from its mean (4),
  the Jacobi inverse (1), the warm residual (1), its square and the
  gradient's (4), z = r / diag (1), r.z (2);
- each CG iteration beyond its product, 11 D: p.Bp (2), x and r updated
  (4), z (1), r.z (2), the new direction (2);
- the tail, 23 D: g.x and |x|^2 (4), g.Bg and |g|^2 (4), the Cauchy point
  (1), its difference from the GN point (1), the three products of the
  segment (6), the segment's point (2), the mask (1), g.p and p.Bp (4).

Bytes: B (D^2), g, the warm start and the mask (3 D) and the radius read
once; the step, the GN point (2 D) and the prediction written once. A
system whose CG stops early (its breakdown guards) needs fewer
iterations than I; the count takes I.
"""

from __future__ import annotations


def system_flops(D: int, iters: int) -> float:
    """Operations of one system at width D and `iters` CG iterations."""
    return (iters + 3) * (2 * D * D + 6 * D) + 13 * D + 11 * iters * D \
        + 23 * D


def system_bytes(D: int) -> float:
    """Bytes of one system: inputs read once, outputs written once."""
    return 4.0 * (D * D + 3 * D + 1 + 2 * D + 1)


def launch(D: int, systems: int, iters: int):
    """(operations, bytes) of one launch over `systems` systems."""
    return systems * system_flops(D, iters), systems * system_bytes(D)
