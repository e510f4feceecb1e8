// extras_tangent: the joint tangents of the tiled extras route,
//   datr[f][e][j] = dA_tr_j / dx_e
//                 = sum over k on the root->j path of Q_k dtrel_e[k]
//                   - G_rot[j] djnt_e[j],
// G_tr being linear in the rest offsets (Q_k = G_rot[parent(k)], identity at
// a root; dtrel/djnt the (J, E, 3) parent-relative and absolute rest-joint
// directions of the E extra shape dims).
//
// Replaces the Pallas TPU kernel `_extras_tangent_kernel` of
// moshpp_tpu/ops/pallas_marker_jac.py, which computes the chain sum as one
// (J, J) ancestor-mask product per 8-extra chunk. Plain version:
// moshpp_torch/ops/marker_jac.extras_tangent_plain.
//
// What bounds it: writes. datr is F*E*J*3 floats (216 MB at F=4096, E=80,
// J=55, >= 65 us at 3.35 TB/s); the chain sums are ~9 FMAs per ancestor,
// ~40 us of float32 issue for SMPL-X's chains. Design: one block per frame.
// The frame's Q and G_rot (J x 18 floats) are staged in shared memory once;
// each thread takes (e, j) pairs in datr's own order, so a warp writes
// consecutive joints of one extra dim, and walks j's 64-bit ancestor mask
// reading Q_k from shared memory: no (J, J) product. The direction tables
// (J x E x 3 floats each) are read through L1.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 256;
constexpr int kMaxJ = 64;

__global__ void __launch_bounds__(kThreads)
extras_tangent_kernel(int J, int E, const float* __restrict__ q,
                      const float* __restrict__ grot,
                      const float* __restrict__ dtrel,
                      const float* __restrict__ djnt,
                      const unsigned long long* __restrict__ ancmask,
                      float* __restrict__ datr) {
  __shared__ float s_Q[kMaxJ * 9];
  __shared__ float s_G[kMaxJ * 9];
  __shared__ unsigned long long s_anc[kMaxJ];
  const int f = blockIdx.x;
  const size_t f9 = static_cast<size_t>(f) * J * 9;
  for (int i = threadIdx.x; i < 9 * J; i += blockDim.x) {
    s_Q[i] = q[f9 + i];
    s_G[i] = grot[f9 + i];
  }
  for (int i = threadIdx.x; i < J; i += blockDim.x) s_anc[i] = ancmask[i];
  __syncthreads();

  float* out = datr + static_cast<size_t>(f) * E * J * 3;
  for (int it = threadIdx.x; it < E * J; it += blockDim.x) {
    const int e = it / J, j = it - e * J;
    const float* dj = djnt + (static_cast<size_t>(j) * E + e) * 3;
    const float* Gj = s_G + j * 9;
    float a0 = -(Gj[0] * dj[0] + Gj[1] * dj[1] + Gj[2] * dj[2]);
    float a1 = -(Gj[3] * dj[0] + Gj[4] * dj[1] + Gj[5] * dj[2]);
    float a2 = -(Gj[6] * dj[0] + Gj[7] * dj[1] + Gj[8] * dj[2]);
    for (unsigned long long bits = s_anc[j]; bits; bits &= bits - 1) {
      const int k = __ffsll(static_cast<long long>(bits)) - 1;
      const float* dt = dtrel + (static_cast<size_t>(k) * E + e) * 3;
      const float* Qk = s_Q + k * 9;
      a0 += Qk[0] * dt[0] + Qk[1] * dt[1] + Qk[2] * dt[2];
      a1 += Qk[3] * dt[0] + Qk[4] * dt[1] + Qk[5] * dt[2];
      a2 += Qk[6] * dt[0] + Qk[7] * dt[1] + Qk[8] * dt[2];
    }
    out[it * 3] = a0;
    out[it * 3 + 1] = a1;
    out[it * 3 + 2] = a2;
  }
}

}  // namespace

extern "C" int extras_tangent_launch(int F, int J, int E, const float* q,
                                     const float* grot, const float* dtrel,
                                     const float* djnt,
                                     const unsigned long long* ancmask,
                                     float* datr, void* stream) {
  if (F < 1 || J < 1 || J > kMaxJ || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  extras_tangent_kernel<<<F, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      J, E, q, grot, dtrel, djnt, ancmask, datr);
  return static_cast<int>(cudaGetLastError());
}
