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
// What bounds it: bytes. Reading datr (216 MB at F=4096, E=80, J=55) and
// uv (41 MB) and writing jm's extra columns (181 MB) take >= 0.13 ms at
// 3.35 TB/s; skinning weights are sparse (1-4 joints a frame vertex), so
// the arithmetic is small. What held the first design back: a thread
// looped over all J weights of each frame vertex to find the few nonzero
// ones (2.5 G loads a call), each (frame, 16-extra chunk) block re-read uv
// and dv through L1, and a block wrote 64 bytes of a row. What bounds this
// one is the issue of shared-memory and L1 loads: a (frame, marker) needs
// its 54 uv floats and its weight lists in every lane, then 3 datr floats
// a nonzero weight and 9 dv floats for each extra dim.
// Design:
//   - the nonzero weights come as lists made once from the tables
//     (`wnz_j`, `wnz_w`, zero-padded to the largest count K): the sums loop
//     over K, ascending joints, a padded zero adding an exact zero, so each
//     sum is the dense one over J skipping zeros;
//   - a block owns up to 96 extra dims (three a lane, so a warp's uv and
//     weight loads serve a marker's whole E=80: with one extra dim a lane
//     the kernel took 0.3582 against 0.3078 ms at F=4096 on an H100 SXM at
//     700 W), a tile of at
//     most 48 markers and its weight lists, and walks frames;
//   - a frame's datr chunk (contiguous in device memory) and the tile's uv
//     rows are staged by cp.async into one of two buffers while the block
//     works on the other frame's; datr rows at an odd word stride
//     (conflict-free reads at any J; at odd J the chunk stays contiguous
//     and goes in 16-byte copies), uv rows padded to 56 floats and read as
//     broadcast float4;
//   - dv is read through L1 from `dvt` (M, 3, 3, E), the extra dims last,
//     so a warp reads 32 consecutive floats;
//   - a warp takes a marker, its lanes the extra dims, and writes each of
//     the marker's 3 rows as runs of consecutive columns (128 bytes for 32
//     lanes). Float4 stores would need 4 consecutive extra dims a lane,
//     whose datr reads then conflict 4-way.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJ = 64;
constexpr int kSlots = 3;                  // extra dims a lane
constexpr int kMaxChunk = 32 * kSlots;     // extra dims a block
constexpr int kMaxTile = 48;               // markers a block
constexpr int kUV = 54;                    // uv floats a marker
constexpr int kUVRow = 56;                 // padded to whole float4s

// datr rows at an odd word stride: a warp's 32 extra dims read one joint
// from 32 banks
__host__ __device__ inline int datr_stride(int J) { return 3 * J | 1; }

// Offsets in floats of the dynamic shared-memory regions (16-byte aligned);
// datr and uv twice, a buffer each for the frame in work and the next.
struct Layout {
  int wj, ww, datr, dbuf, uv, ubuf, total;
  __host__ __device__ Layout(int J, int ec, int mt, int K) {
    wj = 0;                                  // int [mi][k][K]
    ww = wj + round4(mt * 3 * K);            // [mi][k][K]
    datr = ww + round4(mt * 3 * K);          // [el][j*3+d], row stride odd
    dbuf = round4(ec * datr_stride(J));
    uv = datr + 2 * dbuf;                    // [mi][56]
    ubuf = mt * kUVRow;
    total = uv + 2 * ubuf;
  }
};

struct Config {
  int nch, ec, nmt, mt, gx;
  size_t smem;
};

// Balanced marker tiles and extra-dim chunks, and one frame-walking block
// of each (chunk, tile) for every SM (one block an SM fits).
Config config(int F, int M, int J, int E, int K) {
  Config c;
  c.nmt = (M + kMaxTile - 1) / kMaxTile;
  c.mt = (M + c.nmt - 1) / c.nmt;
  // more chunks where long weight lists leave too little room for datr
  for (c.nch = (E + kMaxChunk - 1) / kMaxChunk;; ++c.nch) {
    c.ec = (E + c.nch - 1) / c.nch;
    c.smem = static_cast<size_t>(Layout(J, c.ec, c.mt, K).total) *
             sizeof(float);
    if (c.smem <= kSmemLimit || c.ec == 1) break;
  }
  const int per = c.nch * c.nmt;
  const int fill = (sm_count() + per - 1) / per;
  c.gx = F < fill ? F : fill;
  return c;
}

__global__ void __launch_bounds__(kThreads, 1)
extras_cols_kernel(int F, int M, int J, int E, int D, int K, int ec, int nch,
                   int mt, const float* __restrict__ datr,
                   const float* __restrict__ uv,
                   const int* __restrict__ wnz_j,
                   const float* __restrict__ wnz_w,
                   const float* __restrict__ dvt, float* __restrict__ jm) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(J, ec, mt, K);
  const int chunk = blockIdx.y % nch, tile = blockIdx.y / nch;
  const int e0 = chunk * ec, cnt = min(ec, E - e0);
  const int m0 = tile * mt, mcnt = min(mt, M - m0);
  const int J3 = 3 * J, Sd = datr_stride(J);
  int* s_wj = reinterpret_cast<int*>(smem + L.wj);
  float* s_ww = smem + L.ww;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the tile's weight lists, kept while the block walks frames
  for (int i = threadIdx.x; i < mcnt * 3 * K; i += kThreads) {
    s_wj[i] = wnz_j[static_cast<size_t>(m0) * 3 * K + i];
    s_ww[i] = wnz_w[static_cast<size_t>(m0) * 3 * K + i];
  }
  // frame f's datr chunk and uv rows into buffer b, as one cp.async group
  auto stage = [&](int f, int b) {
    const float* df = datr + (static_cast<size_t>(f) * E + e0) * J3;
    float* sd = smem + L.datr + b * L.dbuf;
    if (Sd == J3 && (reinterpret_cast<uintptr_t>(df) & 15) == 0) {
      // odd J: the rows are contiguous in shared memory too, so 16-byte
      // copies that bypass L1 (0.3019 against 0.3178 ms at F=4096 on an
      // H100 SXM at 700 W, the face problem's J=55)
      const int n = cnt * J3;
      for (int i = threadIdx.x; i < n / 4; i += kThreads)
        cp_async16(sd + 4 * i, df + 4 * i);
      for (int i = (n & ~3) + threadIdx.x; i < n; i += kThreads)
        cp_async4(sd + i, df + i);
    } else {
      for (int el = warp; el < cnt; el += kWarps)
        for (int r = lane; r < J3; r += 32)
          cp_async4(sd + el * Sd + r, df + static_cast<size_t>(el) * J3 + r);
    }
    const float* uf = uv + (static_cast<size_t>(f) * M + m0) * kUV;
    float* su = smem + L.uv + b * L.ubuf;
    for (int mi = warp; mi < mcnt; mi += kWarps)
      for (int r = lane; r < kUV; r += 32)
        cp_async4(su + mi * kUVRow + r, uf + mi * kUV + r);
    cp_async_commit();
  };

  int b = 0;
  if (blockIdx.x < F) stage(blockIdx.x, 0);
  for (int f = blockIdx.x; f < F; f += gridDim.x, b ^= 1) {
    if (f + gridDim.x < F) {
      stage(f + gridDim.x, b ^ 1);
      cp_async_wait_one();       // this frame's group; the next's may fly
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* sd = smem + L.datr + b * L.dbuf;
    const float* su = smem + L.uv + b * L.ubuf;
    for (int mi = warp; mi < mcnt; mi += kWarps) {
      // wd[q][k][d] = sum_j w[m][k][j] datr_e[j][d], e = e0 + lane + 32 q,
      // over the nonzero weights
      float wd[kSlots][9];
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
#pragma unroll
        for (int i = 0; i < 9; ++i) wd[q][i] = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int* jj = s_wj + (mi * 3 + k) * K;
        const float* ww = s_ww + (mi * 3 + k) * K;
        for (int t = 0; t < K; ++t) {
          const float w = ww[t];
          const int j3 = jj[t] * 3;
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int el = lane + 32 * q;
            if (el < cnt) {
              const float* dj = sd + el * Sd + j3;
              wd[q][k * 3] = fmaf(w, dj[0], wd[q][k * 3]);
              wd[q][k * 3 + 1] = fmaf(w, dj[1], wd[q][k * 3 + 1]);
              wd[q][k * 3 + 2] = fmaf(w, dj[2], wd[q][k * 3 + 2]);
            }
          }
        }
      }
      float u[kUVRow];
      const float4* u4 = reinterpret_cast<const float4*>(su + mi * kUVRow);
#pragma unroll
      for (int i = 0; i < kUVRow / 4; ++i) {
        const float4 v = u4[i];
        u[4 * i] = v.x;
        u[4 * i + 1] = v.y;
        u[4 * i + 2] = v.z;
        u[4 * i + 3] = v.w;
      }
      const size_t m = m0 + mi;
      float* row = jm + (static_cast<size_t>(f) * M + m) * 3 * D + (D - E) + e0;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int el = lane + 32 * q;
        if (el >= cnt) continue;
        float dz[9];
#pragma unroll
        for (int i = 0; i < 9; ++i)
          dz[i] = __ldg(dvt + (m * 9 + i) * E + e0 + el);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float* Uk = u + k * 9 + c * 3;
            const float* Vk = u + 27 + k * 9 + c * 3;
            const float* z = dz + k * 3;
            v += Uk[0] * wd[q][k * 3] + Uk[1] * wd[q][k * 3 + 1] +
                 Uk[2] * wd[q][k * 3 + 2];
            v += Vk[0] * z[0] + Vk[1] * z[1] + Vk[2] * z[2];
          }
          row[static_cast<size_t>(c) * D + el] = v;
        }
      }
    }
    __syncthreads();             // buffer b is free for frame f + 2 gridDim.x
  }
}

}  // namespace

// Blocks an SM of the launch at these widths and its shared memory a block
// (0 blocks for widths the kernel does not take).
extern "C" int extras_cols_occupancy(int M, int J, int E, int K,
                                     int* smem_bytes) {
  if (M < 1 || J < 1 || J > kMaxJ || E < 1 || K < 1 || K > J) return 0;
  const Config c = config(1, M, J, E, K);
  *smem_bytes = static_cast<int>(c.smem);
  if (c.smem > kSmemLimit ||
      allow_smem(extras_cols_kernel, c.smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, extras_cols_kernel, kThreads, c.smem) != cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int extras_cols_launch(int F, int M, int J, int E, int D, int K,
                                  const float* datr, const float* uv,
                                  const int* wnz_j, const float* wnz_w,
                                  const float* dvt, float* jm, void* stream) {
  if (F < 1 || M < 1 || J < 1 || J > kMaxJ || E < 1 || D < E || K < 1 ||
      K > J)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config c = config(F, M, J, E, K);
  if (c.smem > kSmemLimit || c.nch * c.nmt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(extras_cols_kernel, c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  extras_cols_kernel<<<dim3(c.gx, c.nch * c.nmt), kThreads, c.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      F, M, J, E, D, K, c.ec, c.nch, c.mt, datr, uv, wnz_j, wnz_w, dvt, jm);
  return static_cast<int>(cudaGetLastError());
}
