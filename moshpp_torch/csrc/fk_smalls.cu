// fk_smalls<WITH_JAC, EXT, TILED>: per-frame, per-joint quantities of the
// stage-ii marker model.
//
// Replaces the Pallas TPU kernels of moshpp_tpu/ops/pallas_marker_jac.py
// (bodies `_smalls_impl` and `_sim_smalls_impl`):
//   <true, false, false>  `_smalls_kernel`        <false, ...>  `_sim_smalls_kernel`
//   <true, true, false>   `_smalls_kernel_ext`    <false, ...>  `_sim_smalls_kernel_ext`
//   <true, false, true>   `_smalls_kernel_tiled`  <false, ...>  `_sim_smalls_kernel_tiled`
// Plain versions: moshpp_torch/ops/lbs_jacobian.joint_smalls (through
// ops/marker_jac.fk_smalls_plain and fk_smalls_tiled_plain).
//
// Per frame: quaternion Rodrigues R and its hand derivative dR for every
// joint, forward kinematics over the tree, the skinning translation
// A_tr = G_tr - G_rot j, the pose-blend features R - I and, with the
// Jacobian, the path generators W_rot = Q dR R^T Q^T and W_tr, Q being the
// parent's global rotation.
//
// With EXT the problem has E <= 16 extra shape dims (DMPL or expression
// coefficients x_e, one row of `extra` a frame) that shift the rest joints:
// each thread adds sum_e x_e dtrel_e to its parent-relative offset (3E FMAs)
// before the tree walk and sum_e x_e djnt_e to its rest joint. With the
// Jacobian it also emits datr[f][e][j] = dA_tr_j/dx_e. G_tr is linear in the
// rest offsets, so dG_tr_e[j] = sum over k on the root->j path of
// Q_k dtrel_e[k]; the thread walks its ancestor bitmask and reads each
// Q_k = G_rot[parent(k)] from the shared transforms the tree walk left
// behind (the TPU kernel does this chain sum as one (J, J) mask product).
//
// With TILED (the tiled extras route, any E) the wrapper has already summed
// the shifts: jshift[f] = [sum_e x_e dtrel_e; sum_e x_e djnt_e] (2, J, 3),
// two matmuls, so this program has no E loop and is the same at every E.
// With the Jacobian it emits Q (F, J, 3, 3) for extras_tangent.cu, which
// computes datr, in place of datr.
// The E = 0 instantiations carry none of this code.
//
// What bounds it: writes. A frame writes 75 floats per joint with the
// Jacobian (15.6 KB at J=52, 64 MB at F=4096), 24 more with E=8 or 9 more
// (Q) when TILED; the arithmetic is a few thousand flops per joint. Design:
// one thread per (frame, joint), 4 frames of 64 threads per block. The tree
// walk reads each parent's transform from shared memory, one depth level per
// barrier, instead of the TPU kernel's one-hot (J, J) products. Outputs are
// frame-major, so the marker kernel reads one frame's quantities as
// contiguous rows.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kJT = 64;   // threads per frame: joints, J <= 64
constexpr int kFPB = 4;   // frames per block
constexpr int kMaxExtra = 16;

template <bool WITH_JAC, bool EXT, bool TILED>
__global__ void __launch_bounds__(kJT * kFPB)
fk_smalls_kernel(const float* __restrict__ theta,
                 const int* __restrict__ parents,
                 const int* __restrict__ depth, int max_depth,
                 const float* __restrict__ jnts,
                 const float* __restrict__ trel, int F, int J,
                 float* __restrict__ grot, float* __restrict__ atr,
                 float* __restrict__ feat, float* __restrict__ wrot,
                 float* __restrict__ wtr, float* __restrict__ dr, int E,
                 const float* __restrict__ extra,
                 const float* __restrict__ djnt,
                 const float* __restrict__ dtrel,
                 const unsigned long long* __restrict__ ancmask,
                 float* __restrict__ datr,
                 const float* __restrict__ jshift, float* __restrict__ qout) {
  static_assert(!(EXT && TILED), "one extras route at a time");
  __shared__ float G[kFPB][kJT][12];   // global rotation (9) + translation (3)
  const int lf = threadIdx.y;
  const int j = threadIdx.x;
  const int f = blockIdx.x * kFPB + lf;
  const bool live = f < F && j < J;

  float R[9], q[6], dR[27], tr[3], jn[3];
  int par = -1, dep = 0;
  if (live) {
    const float* th = theta + (static_cast<size_t>(f) * J + j) * 3;
    const float v[3] = {th[0], th[1], th[2]};
    rodrigues(v, R, q);
    if (WITH_JAC) rodrigues_grad(v, q, dR);
    par = parents[j];
    dep = depth[j];
#pragma unroll
    for (int c = 0; c < 3; ++c) tr[c] = trel[j * 3 + c];
    if constexpr (EXT) {
      // the frame's rest geometry: offsets along the extra directions
#pragma unroll
      for (int c = 0; c < 3; ++c) jn[c] = jnts[j * 3 + c];
      const float* ex = extra + static_cast<size_t>(f) * E;
      for (int e = 0; e < E; ++e) {
        const float xe = ex[e];
        const float* dt = dtrel + (j * E + e) * 3;
        const float* dj = djnt + (j * E + e) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          tr[c] = fmaf(xe, dt[c], tr[c]);
          jn[c] = fmaf(xe, dj[c], jn[c]);
        }
      }
    }
    if constexpr (TILED) {
      // the frame's rest geometry: the wrapper's summed shifts
      const float* sh = jshift + static_cast<size_t>(f) * 6 * J + j * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tr[c] += sh[c];
        jn[c] = jnts[j * 3 + c] + sh[3 * J + c];
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) G[lf][j][i] = R[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) G[lf][j][9 + c] = tr[c];
  }
  // level by level: parents (depth lev-1) are final before their children
  for (int lev = 1; lev <= max_depth; ++lev) {
    __syncthreads();
    if (live && dep == lev) {
      const float* Gp = G[lf][par];
      float nr[9], nt[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          nr[a * 3 + b] = Gp[a * 3] * R[b] + Gp[a * 3 + 1] * R[3 + b] +
                          Gp[a * 3 + 2] * R[6 + b];
        nt[a] = Gp[a * 3] * tr[0] + Gp[a * 3 + 1] * tr[1] +
                Gp[a * 3 + 2] * tr[2] + Gp[9 + a];
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) G[lf][j][i] = nr[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) G[lf][j][9 + c] = nt[c];
    }
  }
  __syncthreads();
  if (!live) return;

  const size_t fj = static_cast<size_t>(f) * J + j;
  float Gr[9], Gt[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) Gr[i] = G[lf][j][i];
#pragma unroll
  for (int c = 0; c < 3; ++c) Gt[c] = G[lf][j][9 + c];
  if constexpr (!EXT && !TILED) {
#pragma unroll
    for (int c = 0; c < 3; ++c) jn[c] = jnts[j * 3 + c];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) grot[fj * 9 + i] = Gr[i];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    atr[fj * 3 + a] = Gt[a] - (Gr[a * 3] * jn[0] + Gr[a * 3 + 1] * jn[1] +
                               Gr[a * 3 + 2] * jn[2]);
  if (j >= 1) {
    float* ft = feat + (static_cast<size_t>(f) * (J - 1) + (j - 1)) * 9;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) ft[a * 3 + b] = R[a * 3 + b] - (a == b ? 1.f : 0.f);
  }
  if (!WITH_JAC) return;

  // parent transform (root: identity)
  float Q[9], bb[3];
  if (par < 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) Q[i] = (i % 4 == 0) ? 1.f : 0.f;
    bb[0] = bb[1] = bb[2] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) Q[i] = G[lf][par][i];
#pragma unroll
    for (int c = 0; c < 3; ++c) bb[c] = G[lf][par][9 + c];
  }
  if constexpr (TILED) {
#pragma unroll
    for (int i = 0; i < 9; ++i) qout[fj * 9 + i] = Q[i];
  }
  // dRRt[a][c][t] = sum_b dR[a][b][t] R[c][b];  u[a][t] = -sum_b dRRt[a][b][t] trel[b]
  float dRRt[27], u[9];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        dRRt[(a * 3 + c) * 3 + t] = dR[(a * 3 + 0) * 3 + t] * R[c * 3 + 0] +
                                    dR[(a * 3 + 1) * 3 + t] * R[c * 3 + 1] +
                                    dR[(a * 3 + 2) * 3 + t] * R[c * 3 + 2];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      u[a * 3 + t] = -(dRRt[(a * 3 + 0) * 3 + t] * tr[0] +
                       dRRt[(a * 3 + 1) * 3 + t] * tr[1] +
                       dRRt[(a * 3 + 2) * 3 + t] * tr[2]);
  // W_rot = Q dRRt Q^T, W_tr = -W_rot bb + Q u
  float tmp[27];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        tmp[(a * 3 + c) * 3 + t] = Q[a * 3] * dRRt[(0 * 3 + c) * 3 + t] +
                                   Q[a * 3 + 1] * dRRt[(1 * 3 + c) * 3 + t] +
                                   Q[a * 3 + 2] * dRRt[(2 * 3 + c) * 3 + t];
  float W[27];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        W[(a * 3 + d) * 3 + t] = tmp[(a * 3 + 0) * 3 + t] * Q[d * 3] +
                                 tmp[(a * 3 + 1) * 3 + t] * Q[d * 3 + 1] +
                                 tmp[(a * 3 + 2) * 3 + t] * Q[d * 3 + 2];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    wrot[fj * 27 + i] = W[i];
    dr[fj * 27 + i] = dR[i];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      wtr[fj * 9 + a * 3 + t] =
          -(W[(a * 3 + 0) * 3 + t] * bb[0] + W[(a * 3 + 1) * 3 + t] * bb[1] +
            W[(a * 3 + 2) * 3 + t] * bb[2]) +
          (Q[a * 3] * u[0 * 3 + t] + Q[a * 3 + 1] * u[1 * 3 + t] +
           Q[a * 3 + 2] * u[2 * 3 + t]);

  if constexpr (EXT) {
    // datr_e[j] = sum_{k on root->j} Q_k dtrel_e[k] - G_rot[j] djnt_e[j],
    // one extra dim at a time so only 3 sums live in registers
    const unsigned long long anc = ancmask[j];
    float* out = datr + (static_cast<size_t>(f) * E * J + j) * 3;
    for (int e = 0; e < E; ++e) {
      const float* dj = djnt + (j * E + e) * 3;
      float a0 = -(Gr[0] * dj[0] + Gr[1] * dj[1] + Gr[2] * dj[2]);
      float a1 = -(Gr[3] * dj[0] + Gr[4] * dj[1] + Gr[5] * dj[2]);
      float a2 = -(Gr[6] * dj[0] + Gr[7] * dj[1] + Gr[8] * dj[2]);
      for (unsigned long long bits = anc; bits; bits &= bits - 1) {
        const int k = __ffsll(static_cast<long long>(bits)) - 1;
        const float* dt = dtrel + (k * E + e) * 3;
        const int pk = parents[k];
        if (pk < 0) {
          a0 += dt[0];
          a1 += dt[1];
          a2 += dt[2];
        } else {
          const float* Qk = G[lf][pk];
          a0 += Qk[0] * dt[0] + Qk[1] * dt[1] + Qk[2] * dt[2];
          a1 += Qk[3] * dt[0] + Qk[4] * dt[1] + Qk[5] * dt[2];
          a2 += Qk[6] * dt[0] + Qk[7] * dt[1] + Qk[8] * dt[2];
        }
      }
      float* o = out + static_cast<size_t>(e) * J * 3;
      o[0] = a0;
      o[1] = a1;
      o[2] = a2;
    }
  }
}

template <bool EXT, bool TILED>
void launch(bool with_jac, dim3 grid, dim3 block, cudaStream_t s,
            const float* theta, const int* parents, const int* depth,
            int max_depth, const float* jnts, const float* trel, int F, int J,
            float* grot, float* atr, float* feat, float* wrot, float* wtr,
            float* dr, int E, const float* extra, const float* djnt,
            const float* dtrel, const unsigned long long* ancmask,
            float* datr, const float* jshift, float* q) {
  if (with_jac)
    fk_smalls_kernel<true, EXT, TILED><<<grid, block, 0, s>>>(
        theta, parents, depth, max_depth, jnts, trel, F, J, grot, atr, feat,
        wrot, wtr, dr, E, extra, djnt, dtrel, ancmask, datr, jshift, q);
  else
    fk_smalls_kernel<false, EXT, TILED><<<grid, block, 0, s>>>(
        theta, parents, depth, max_depth, jnts, trel, F, J, grot, atr, feat,
        nullptr, nullptr, nullptr, E, extra, djnt, dtrel, nullptr, nullptr,
        jshift, nullptr);
}

}  // namespace

extern "C" int fk_smalls_launch(int with_jac, const float* theta,
                                const int* parents, const int* depth,
                                int max_depth, const float* jnts,
                                const float* trel, int F, int J, float* grot,
                                float* atr, float* feat, float* wrot,
                                float* wtr, float* dr, int E,
                                const float* extra, const float* djnt,
                                const float* dtrel,
                                const unsigned long long* ancmask,
                                float* datr, void* stream) {
  if (J < 1 || J > kJT || F < 1 || E < 0 || E > kMaxExtra)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kJT, kFPB);
  const dim3 grid((F + kFPB - 1) / kFPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0)
    launch<true, false>(with_jac != 0, grid, block, s, theta, parents, depth,
                        max_depth, jnts, trel, F, J, grot, atr, feat, wrot,
                        wtr, dr, E, extra, djnt, dtrel, ancmask, datr,
                        nullptr, nullptr);
  else
    launch<false, false>(with_jac != 0, grid, block, s, theta, parents,
                         depth, max_depth, jnts, trel, F, J, grot, atr, feat,
                         wrot, wtr, dr, 0, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The tiled route: jshift (F, 2, J, 3) in; with the Jacobian q (F, J, 3, 3)
// out.
extern "C" int fk_smalls_tiled_launch(int with_jac, const float* theta,
                                      const int* parents, const int* depth,
                                      int max_depth, const float* jnts,
                                      const float* trel, int F, int J,
                                      float* grot, float* atr, float* feat,
                                      float* wrot, float* wtr, float* dr,
                                      const float* jshift, float* q,
                                      void* stream) {
  if (J < 1 || J > kJT || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kJT, kFPB);
  const dim3 grid((F + kFPB - 1) / kFPB);
  launch<false, true>(with_jac != 0, grid, block,
                      static_cast<cudaStream_t>(stream), theta, parents,
                      depth, max_depth, jnts, trel, F, J, grot, atr, feat,
                      wrot, wtr, dr, 0, nullptr, nullptr, nullptr, nullptr,
                      nullptr, jshift, q);
  return static_cast<int>(cudaGetLastError());
}
