// dogleg_direction: the fused batched dogleg direction of the stage-ii
// Gauss-Newton solver.
//
// Replaces the Pallas TPU kernel `_direction_kernel` of
// moshpp_tpu/solver/pallas_pcg.py (entry `dogleg_direction_batched`). Plain
// version: moshpp_torch/solver/pcg.dogleg_direction_plain, the torch chain
// _masked_system -> _damp -> _gn_direction_pcg -> _dogleg_geometry -> pred.
//
// Per frame, from the RAW normal equations B (symmetric) and the pre-masked
// gradient g: parameter masking and Tikhonov damping folded into the matvec,
//   B_md v = mask * (B (mask * v)) + (1 - mask) * v + lam * v,
// lam from the masked diagonal; warm-started Jacobi-PCG for `iters`
// iterations with the reference's breakdown guards; the dogleg step (GN
// inside the radius, scaled Cauchy point, or the segment blend); and the
// predicted model reduction -(2 g.p + p B_md p).
//
// Precision: float32 throughout, as the TPU kernel. The stage-ii systems
// reach cond ~1e7 (1.4e7 measured at the rigid init of the bench problem),
// where the CG iterates are chaotic in the rounding of every sum: after 24
// iterations a 1e-15 relative perturbation of B moves p_gn by ~2% even in
// float64. Two implementations that sum in different orders therefore agree
// elementwise only on well-conditioned systems; chip_smoke.py checks the
// kernel there, and on the real systems checks what the dogleg relies on.
//
// What bounds it: B is D*D floats a frame (54.8 KB at D=117, 224 MB at
// F=4096), the only large read; the CG is ~2 D^2 flops an iteration and a
// chain of dependent block reductions. Design: one block per frame, one
// thread per unknown. B is staged ONCE into dynamic shared memory (above the
// 48 KB default, so the launcher raises the cap), every matvec then reads
// B's leading index from shared memory (thread d walks column d, so the
// warp's loads fall in distinct banks), and dot products are warp shuffles
// plus one shared-memory fold. When the CG recurrence stops (the breakdown
// guards), the block leaves the loop: further iterations would change
// nothing.

#include "common.cuh"

namespace {

using namespace moshpp;

struct Frame {
  const float* B;   // shared, D*D
  float* v;         // shared, D
  int D;
  bool own;         // thread holds unknown d = threadIdx.x
  float md, lam;
};

// B_md v for this thread's entry; every thread of the block must call it.
__device__ __forceinline__ float matvec(const Frame& fr, float vd) {
  const int d = threadIdx.x;
  __syncthreads();                       // earlier readers of v are done
  if (fr.own) fr.v[d] = vd * fr.md;
  __syncthreads();
  if (!fr.own) return 0.f;
  float acc = 0.f;
  for (int e = 0; e < fr.D; ++e)
    acc = fmaf(fr.B[e * fr.D + d], fr.v[e], acc);
  return fr.md * acc + (1.f - fr.md) * vd + fr.lam * vd;
}

__global__ void dogleg_direction_kernel(int D, int iters, float damping,
                                        const float* __restrict__ g,
                                        const float* __restrict__ B,
                                        const float* __restrict__ plin,
                                        const float* __restrict__ mask,
                                        const float* __restrict__ delta,
                                        float* __restrict__ p_out,
                                        float* __restrict__ pgn_out,
                                        float* __restrict__ pred_out) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int n = blockIdx.x;
  const int d = threadIdx.x;
  const bool own = d < D;
  const size_t DD = static_cast<size_t>(D) * D;

  float* sv = smem;                              // D floats
  float* sB = smem + D;                          // D*D floats
  const float* Bn = B + n * DD;
  for (size_t i = d; i < DD; i += blockDim.x) sB[i] = Bn[i];

  const size_t row = static_cast<size_t>(n) * D + d;
  const float gd = own ? g[row] : 0.f;          // pre-masked
  const float md = own ? mask[row] : 0.f;
  const float pl = own ? plin[row] * md : 0.f;
  const float dl = delta[n];
  __syncthreads();

  // damping from the masked diagonal (matches _damp on the masked B)
  const float diag_m = own ? md * sB[d * D + d] + (1.f - md) : 0.f;
  const float lam = damping * (block_sum(diag_m, red) / D + 1.f);
  const Frame fr{sB, sv, D, own, md, lam};
  const float dinv = own ? 1.f / fmaxf(diag_m + lam, 1e-12f) : 0.f;

  // warm start only if it reduces the residual vs x0 = 0
  const float rhs = -gd;
  const float r_warm = rhs - matvec(fr, pl);
  const bool finite = __syncthreads_and(!own || isfinite(pl));
  const bool use_warm =
      (block_sum(r_warm * r_warm, red) < block_sum(rhs * rhs, red)) && finite;
  float x = use_warm ? pl : 0.f;
  float r = use_warm ? r_warm : rhs;
  float z = dinv * r;
  float p = z;
  float rz = block_sum(r * z, red);
  const float rz0 = fmaxf(rz, 1e-30f);
  bool active = rz > 0.f;

  for (int it = 0; it < iters && active; ++it) {
    const float Bp = matvec(fr, p);
    const float pBp = block_sum(p * Bp, red);
    const bool step_ok = (pBp > 1e-30f) && (rz > 1e-12f * rz0);
    const float alpha = step_ok ? rz / (pBp > 0.f ? pBp : 1.f) : 0.f;
    x += alpha * p;
    r -= alpha * Bp;
    z = dinv * r;
    const float rz_new = block_sum(r * z, red);
    const float beta = step_ok ? rz_new / (rz > 0.f ? rz : 1.f) : 0.f;
    p = step_ok ? z + beta * p : p;
    rz = step_ok ? rz_new : rz;
    active = step_ok;
  }

  const bool x_finite = __syncthreads_and(!own || isfinite(x));
  const bool ok = (block_sum(gd * x, red) < 0.f) && x_finite;
  const float pgn = ok ? x : 0.f;

  // ---- dogleg geometry (gauss_newton._dogleg_geometry) --------------------
  const float gn_norm = ok ? sqrtf(block_sum(pgn * pgn, red)) : INFINITY;
  const float Bg = matvec(fr, gd);
  const float gBg = block_sum(gd * Bg, red) + 1e-30f;
  const float gg = block_sum(gd * gd, red);
  const float psd = -(gg / gBg) * gd;
  const float sd_norm = sqrtf(block_sum(psd * psd, red));
  const float dd = pgn - psd;
  const float a = block_sum(dd * dd, red) + 1e-30f;
  const float b2 = 2.f * block_sum(psd * dd, red);
  const float c = block_sum(psd * psd, red) - dl * dl;
  const float disc = fmaxf(b2 * b2 - 4.f * a * c, 0.f);
  const float t = fminf(fmaxf((-b2 + sqrtf(disc)) / (2.f * a), 0.f), 1.f);
  const float seg = psd + t * dd;
  float step;
  if (gn_norm <= dl && ok)
    step = pgn;
  else if (sd_norm >= dl)
    step = psd * (dl / (sd_norm + 1e-30f));
  else
    step = ok ? seg : psd;
  step *= md;

  // predicted model reduction for the rho accept test
  const float Bs = matvec(fr, step);
  const float pred = -(2.f * block_sum(gd * step, red) + block_sum(step * Bs, red));
  if (own) {
    p_out[row] = step;
    pgn_out[row] = pgn;
  }
  if (d == 0) pred_out[n] = pred;
}

}  // namespace

extern "C" int dogleg_direction_launch(int N, int D, int iters, float damping,
                                       const float* g, const float* B,
                                       const float* plin, const float* mask,
                                       const float* delta, float* p,
                                       float* pgn, float* pred, void* stream) {
  if (N < 1 || D < 1 || D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((D + 31) / 32) * 32;
  const size_t bytes = (static_cast<size_t>(D) * D + D) * sizeof(float);
  cudaError_t err = allow_smem(dogleg_direction_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dogleg_direction_kernel<<<N, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      D, iters, damping, g, B, plin, mask, delta, p, pgn, pred);
  return static_cast<int>(cudaGetLastError());
}
