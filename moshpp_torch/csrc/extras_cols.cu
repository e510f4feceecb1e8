// extras_cols: the E extra Jacobian columns of the tiled extras route,
//   jm[f][m][c][D-E+e] = sum_k [ sum_d U_k[c][d] (sum_j w_k[j] datr_e[j][d])
//                               + sum_z V_k[c][z] dv_e[k][z] ],
// k running over the marker's 3 frame vertices, U = the local frame's
// derivative blocks dms and V = dms T_rot (uv, from marker_rows<jac,tiled>),
// w the frame vertices' skinning weights, dv their E rest directions.
//
// Replaces the Pallas TPU kernel `_extras_cols_kernel` of
// moshpp_tpu/ops/pallas_marker_jac.py (8-extra chunks, then a concatenate
// onto jm); here the columns go straight into the last E columns of the jm
// buffer marker_rows wrote. Plain version:
// moshpp_torch/ops/marker_jac.extras_cols_plain.
//
// What bounds it: bytes. Per frame the dense product w . datr is
// (3M x J) . (J x 3E), 1.82 M MACs at M=46, J=55, E=80, but skinning
// weights are sparse (a frame vertex has a few joints), so the sums skip
// zero weights and the arithmetic is small; the datr read (216 MB at
// F=4096) and the jm columns' write (181 MB) bound it, >= 0.12 ms at
// 3.35 TB/s. Design: one block per (frame, chunk of 16 extra dims). The
// chunk of datr (16 x J x 3 floats) is staged in shared memory once; a
// thread takes (marker, extra) pairs, extra fastest, so a warp covers two
// markers: the weights and uv are near-broadcast reads through L1, datr is
// read from shared memory at a word stride of 3J between a warp's extra
// dims (odd at SMPL-X's J=55, so no bank conflicts there), and
// the jm writes of a warp are two runs of 16 consecutive columns.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 256;
constexpr int kEC = 16;     // extra dims per block
constexpr int kMaxJ = 64;

__global__ void __launch_bounds__(kThreads)
extras_cols_kernel(int M, int J, int E, int D,
                   const float* __restrict__ datr,
                   const float* __restrict__ uv,
                   const float* __restrict__ w3,
                   const float* __restrict__ dv, float* __restrict__ jm) {
  __shared__ float s_datr[kEC * kMaxJ * 3];
  const int f = blockIdx.x;
  const int e0 = blockIdx.y * kEC;
  const int ec = min(kEC, E - e0);
  const float* src = datr + (static_cast<size_t>(f) * E + e0) * J * 3;
  for (int i = threadIdx.x; i < ec * J * 3; i += blockDim.x) s_datr[i] = src[i];
  __syncthreads();

  for (int it = threadIdx.x; it < M * kEC; it += blockDim.x) {
    const int m = it / kEC, el = it % kEC;
    if (el >= ec) continue;
    const int e = e0 + el;
    // wd[k][d] = sum_j w[m][k][j] datr_e[j][d]
    float wd[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) wd[i] = 0.f;
    const float* de = s_datr + el * J * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* wk = w3 + (static_cast<size_t>(m) * 3 + k) * J;
      for (int j = 0; j < J; ++j) {
        const float w = __ldg(wk + j);
        if (w != 0.f) {
          wd[k * 3] = fmaf(w, de[j * 3], wd[k * 3]);
          wd[k * 3 + 1] = fmaf(w, de[j * 3 + 1], wd[k * 3 + 1]);
          wd[k * 3 + 2] = fmaf(w, de[j * 3 + 2], wd[k * 3 + 2]);
        }
      }
    }
    const float* u = uv + (static_cast<size_t>(f) * M + m) * 54;
    const float* dvm = dv + static_cast<size_t>(m) * 9 * E;   // [k][e][z]
    float* row = jm + (static_cast<size_t>(f) * M + m) * 3 * D + (D - E) + e;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* Uk = u + k * 9 + c * 3;
        const float* Vk = u + 27 + k * 9 + c * 3;
        const float* dz = dvm + (static_cast<size_t>(k) * E + e) * 3;
        v += Uk[0] * wd[k * 3] + Uk[1] * wd[k * 3 + 1] + Uk[2] * wd[k * 3 + 2];
        v += Vk[0] * dz[0] + Vk[1] * dz[1] + Vk[2] * dz[2];
      }
      row[static_cast<size_t>(c) * D] = v;
    }
  }
}

}  // namespace

extern "C" int extras_cols_launch(int F, int M, int J, int E, int D,
                                  const float* datr, const float* uv,
                                  const float* w3, const float* dv,
                                  float* jm, void* stream) {
  if (F < 1 || M < 1 || J < 1 || J > kMaxJ || E < 1 || D < E ||
      (E + kEC - 1) / kEC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(F, (E + kEC - 1) / kEC);
  extras_cols_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      M, J, E, D, datr, uv, w3, dv, jm);
  return static_cast<int>(cudaGetLastError());
}
