// fk_smalls<WITH_JAC>: per-frame, per-joint quantities of the stage-ii
// marker model.
//
// Replaces the Pallas TPU kernels `_smalls_kernel` (WITH_JAC) and
// `_sim_smalls_kernel` (primal only) of moshpp_tpu/ops/pallas_marker_jac.py
// (bodies `_smalls_impl` and `_sim_smalls_impl`). Plain version:
// moshpp_torch/ops/lbs_jacobian.joint_smalls.
//
// Per frame: quaternion Rodrigues R and its hand derivative dR for every
// joint, forward kinematics over the tree, the skinning translation
// A_tr = G_tr - G_rot j, the pose-blend features R - I and, with the
// Jacobian, the path generators W_rot = Q dR R^T Q^T and W_tr, Q being the
// parent's global rotation.
//
// What bounds it: writes. A frame writes 75 floats per joint with the
// Jacobian (15.6 KB at J=52, 64 MB at F=4096); the arithmetic is a few
// thousand flops per joint. Design: one thread per (frame, joint), 4 frames
// of 64 threads per block. The tree walk reads each parent's transform from
// shared memory, one depth level per barrier, instead of the TPU kernel's
// one-hot (J, J) products. Outputs are frame-major, so the marker kernel
// reads one frame's quantities as contiguous rows.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kJT = 64;   // threads per frame: joints, J <= 64
constexpr int kFPB = 4;   // frames per block

template <bool WITH_JAC>
__global__ void __launch_bounds__(kJT * kFPB)
fk_smalls_kernel(const float* __restrict__ theta,
                 const int* __restrict__ parents,
                 const int* __restrict__ depth, int max_depth,
                 const float* __restrict__ jnts,
                 const float* __restrict__ trel, int F, int J,
                 float* __restrict__ grot, float* __restrict__ atr,
                 float* __restrict__ feat, float* __restrict__ wrot,
                 float* __restrict__ wtr, float* __restrict__ dr) {
  __shared__ float G[kFPB][kJT][12];   // global rotation (9) + translation (3)
  const int lf = threadIdx.y;
  const int j = threadIdx.x;
  const int f = blockIdx.x * kFPB + lf;
  const bool live = f < F && j < J;

  float R[9], q[6], dR[27], tr[3];
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
#pragma unroll
  for (int i = 0; i < 9; ++i) grot[fj * 9 + i] = Gr[i];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    atr[fj * 3 + a] = Gt[a] - (Gr[a * 3] * jnts[j * 3] +
                               Gr[a * 3 + 1] * jnts[j * 3 + 1] +
                               Gr[a * 3 + 2] * jnts[j * 3 + 2]);
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
}

}  // namespace

extern "C" int fk_smalls_launch(int with_jac, const float* theta,
                                const int* parents, const int* depth,
                                int max_depth, const float* jnts,
                                const float* trel, int F, int J, float* grot,
                                float* atr, float* feat, float* wrot,
                                float* wtr, float* dr, void* stream) {
  if (J < 1 || J > kJT || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kJT, kFPB);
  const dim3 grid((F + kFPB - 1) / kFPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_jac)
    fk_smalls_kernel<true><<<grid, block, 0, s>>>(
        theta, parents, depth, max_depth, jnts, trel, F, J, grot, atr, feat,
        wrot, wtr, dr);
  else
    fk_smalls_kernel<false><<<grid, block, 0, s>>>(
        theta, parents, depth, max_depth, jnts, trel, F, J, grot, atr, feat,
        nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}
