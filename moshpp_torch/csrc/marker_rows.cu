// marker_rows<WITH_JAC>: simulated markers and, with the Jacobian, their
// exact (trans, pose) Jacobian rows.
//
// Replaces the Pallas TPU kernels `_marker_kernel` (WITH_JAC) and
// `_sim_marker_kernel` (primal only) of moshpp_tpu/ops/pallas_marker_jac.py
// (bodies `_marker_impl` and `_sim_marker_impl`). Plain version:
// moshpp_torch/ops/marker_jac.marker_rows_plain.
//
// Per (frame, marker): skin the marker's 3 frame vertices (pose blend,
// weighted transforms), rebuild the marker in its local frame, and with the
// Jacobian push the per-vertex pose columns
//   J[v, :, (j,t)] = Wrot_{j,t} S_vj + s_vj Wtr_{j,t} + T_rot dvp_{j,t}
// through the frame's hand-derived 3x3 blocks and the hand-PCA chain.
//
// Precision: the frame vertices and the local frame (marker position and
// its 3x3 derivative blocks) are computed in float64 from the float32
// inputs, the Jacobian columns in float32. Frame vertices can be nearly
// collinear (|e1 x e2| down to ~6e-9 m^2 on the 10242-vertex synthetic
// body), and there the frame derivative amplifies float32 rounding of the
// vertices by orders of magnitude; the plain version does the same, so the
// two agree to the Jacobian's own float32 noise.
//
// What bounds it: not bytes (the jm write, F*M*3*D floats, is 264.5 MB at
// F=4096, M=46, D=117, >= 0.08 ms) but latency: per frame the block runs
// phases separated by barriers, some of them serial (the float64 local
// frame on one thread, the hand-PCA dot products), so throughput comes from
// how many blocks an SM holds to overlap them. Design: a block owns one
// marker and a tile of frames. Per frame it stages that frame's joint
// quantities in shared memory, reduces the pose blend with warp shuffles,
// computes the ancestor sums per (vertex, joint) and the Jacobian per column
// (j, t), and writes each (frame, marker) jm row of 3 x D floats with
// consecutive threads on consecutive columns. The marker's posedirs rows
// (9 x 459) and the hand-PCA components are read through L1, not staged:
// that keeps shared memory near 24 KB a block so registers, not shared
// memory, bound the blocks an SM holds (5 instead of 3 at 128 threads and
// 96 registers). The marker's local-frame chain is folded into the columns
// before the hand-PCA product, so that product runs on 3 rows instead of 9.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 128;
constexpr int kFramesPerBlock = 16;
constexpr int kSmall = 80;   // vp 9, Trot 27, dms 27, vsh 9, cf 3 (floats)

// Offsets (in floats) of the dynamic shared-memory regions.
struct Layout {
  int w, s, grot, atr, feat, wrot, wtr, dr, z, S, U, small, total;
  __host__ __device__ Layout(bool jac, int J, int featN) {
    int o = 0;
    w = o;    o += 3 * J;
    s = o;    o += jac ? 3 * J : 0;
    grot = o; o += 9 * J;
    atr = o;  o += 3 * J;
    feat = o; o += featN;
    wrot = o; o += jac ? 27 * J : 0;
    wtr = o;  o += jac ? 9 * J : 0;
    dr = o;   o += jac ? 27 * J : 0;
    z = o;    o += jac ? 9 * J : 0;
    S = o;    o += jac ? 9 * J : 0;
    U = o;    o += jac ? 9 * J : 0;
    small = o; o += kSmall;
    total = o;
  }
};

// Marker position and, with the Jacobian, dms[k][c][d] = d sim_c / d v_kd
// from the frame vertices v[k] (float64; eps-guarded normalizations).
template <bool WITH_JAC>
__device__ void local_frame(const double v[3][3], const float cf[3],
                            float sim[3], float dms[27]) {
  const double eps = static_cast<double>(kEps);
  double e1[3], e2[3];
  for (int b = 0; b < 3; ++b) {
    e1[b] = v[1][b] - v[0][b];
    e2[b] = v[2][b] - v[0][b];
  }
  // one float64 division per norm: the rest multiply by the reciprocal
  const double r1 = 1.0 / sqrt(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2] + eps);
  const double f1[3] = {e1[0] * r1, e1[1] * r1, e1[2] * r1};
  const double cz[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                        e1[2] * e2[0] - e1[0] * e2[2],
                        e1[0] * e2[1] - e1[1] * e2[0]};
  const double r2 = 1.0 / sqrt(cz[0] * cz[0] + cz[1] * cz[1] + cz[2] * cz[2] + eps);
  const double f2[3] = {cz[0] * r2, cz[1] * r2, cz[2] * r2};
  const double f3[3] = {f1[1] * f2[2] - f1[2] * f2[1],
                        f1[2] * f2[0] - f1[0] * f2[2],
                        f1[0] * f2[1] - f1[1] * f2[0]};
  const double c1 = cf[0], c2 = cf[1], c3 = cf[2];
  for (int b = 0; b < 3; ++b)
    sim[b] = static_cast<float>(v[0][b] + c1 * f1[b] + c2 * f2[b] + c3 * f3[b]);
  if (!WITH_JAC) return;
  double M1[9], M2[9], C1[9], C2[9], S1[9], S2[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      M1[a * 3 + b] = ((a == b ? 1.0 : 0.0) - f1[a] * f1[b]) * r1;
      M2[a * 3 + b] = ((a == b ? 1.0 : 0.0) - f2[a] * f2[b]) * r2;
    }
  // C1 = -[e2]x (d cz / d e1), C2 = [e1]x (d cz / d e2), S1 = [f1]x, S2 = [f2]x
  C1[0] = 0.0;    C1[1] = e2[2];  C1[2] = -e2[1];
  C1[3] = -e2[2]; C1[4] = 0.0;    C1[5] = e2[0];
  C1[6] = e2[1];  C1[7] = -e2[0]; C1[8] = 0.0;
  C2[0] = 0.0;    C2[1] = -e1[2]; C2[2] = e1[1];
  C2[3] = e1[2];  C2[4] = 0.0;    C2[5] = -e1[0];
  C2[6] = -e1[1]; C2[7] = e1[0];  C2[8] = 0.0;
  S1[0] = 0.0;    S1[1] = -f1[2]; S1[2] = f1[1];
  S1[3] = f1[2];  S1[4] = 0.0;    S1[5] = -f1[0];
  S1[6] = -f1[1]; S1[7] = f1[0];  S1[8] = 0.0;
  S2[0] = 0.0;    S2[1] = -f2[2]; S2[2] = f2[1];
  S2[3] = f2[2];  S2[4] = 0.0;    S2[5] = -f2[0];
  S2[6] = -f2[1]; S2[7] = f2[0];  S2[8] = 0.0;
  double A1[9], A2[9], B1[9], B2[9], N1[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      double x1 = 0.0, x2 = 0.0, x3 = 0.0;
      for (int k = 0; k < 3; ++k) {
        x1 += M2[a * 3 + k] * C1[k * 3 + b];
        x2 += M2[a * 3 + k] * C2[k * 3 + b];
        x3 += S2[a * 3 + k] * M1[k * 3 + b];
      }
      A1[a * 3 + b] = x1;
      A2[a * 3 + b] = x2;
      N1[a * 3 + b] = x3;
    }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      double x1 = 0.0, x2 = 0.0;
      for (int k = 0; k < 3; ++k) {
        x1 += S1[a * 3 + k] * A1[k * 3 + b];
        x2 += S1[a * 3 + k] * A2[k * 3 + b];
      }
      B1[a * 3 + b] = x1;
      B2[a * 3 + b] = x2;
    }
  for (int i = 0; i < 9; ++i) {
    const double d1 = c1 * M1[i] + c2 * A1[i] + c3 * (B1[i] - N1[i]);
    const double d2 = c2 * A2[i] + c3 * B2[i];
    dms[9 + i] = static_cast<float>(d1);
    dms[18 + i] = static_cast<float>(d2);
    dms[i] = static_cast<float>((i % 4 == 0 ? 1.0 : 0.0) - d1 - d2);
  }
}

template <bool WITH_JAC>
__global__ void __launch_bounds__(kThreads)
marker_rows_kernel(int F, int M, int J, int featN, int body_dof, int D,
                   const float* __restrict__ grot,
                   const float* __restrict__ atr,
                   const float* __restrict__ feat,
                   const float* __restrict__ wrot,
                   const float* __restrict__ wtr,
                   const float* __restrict__ dr,
                   const float* __restrict__ trans,
                   const float* __restrict__ w3, const float* __restrict__ s3,
                   const float* __restrict__ vsh3,
                   const float* __restrict__ pd3,
                   const float* __restrict__ cf,
                   const unsigned long long* __restrict__ ancmask,
                   const float* __restrict__ hc, float* __restrict__ sim,
                   float* __restrict__ jm) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_anc[64];
  __shared__ double s_vpd[9];    // [k][c] posed rest position, float64
  __shared__ double s_Td[36];    // [k][12]: T_rot (9) then T_tr (3), float64
  const int J3 = 3 * J;
  const int nhand = J3 - body_dof;   // full-pose hand columns
  const Layout L(WITH_JAC, J, featN);
  float* s_w = smem + L.w;
  float* s_s = smem + L.s;
  float* s_grot = smem + L.grot;
  float* s_atr = smem + L.atr;
  float* s_feat = smem + L.feat;
  float* s_wrot = smem + L.wrot;
  float* s_wtr = smem + L.wtr;
  float* s_dr = smem + L.dr;
  float* s_z = smem + L.z;     // [k][j][b]
  float* s_S = smem + L.S;     // [k][j][b]
  float* s_U = smem + L.U;     // [c][col]
  float* s_vp = smem + L.small;          // [k][c], float32 rounding of s_vpd
  float* s_Trot = s_vp + 9;              // [k][a][c], rounding of s_Td
  float* s_dms = s_Trot + 27;            // [k][c][d]
  float* s_vsh = s_dms + 27;             // [k][c]
  float* s_cf = s_vsh + 9;               // [3]

  const int m = blockIdx.y;
  const float* pd = pd3 + static_cast<size_t>(m) * 9 * featN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // ---- the marker's tables, once per block ---------------------------------
  for (int i = tid; i < J3; i += blockDim.x) {
    s_w[i] = w3[static_cast<size_t>(m) * J3 + i];
    if (WITH_JAC) s_s[i] = s3[static_cast<size_t>(m) * J3 + i];
  }
  if (WITH_JAC) {
    for (int i = tid; i < J; i += blockDim.x) s_anc[i] = ancmask[i];
  }
  if (tid < 9) s_vsh[tid] = vsh3[m * 9 + tid];
  if (tid < 3) s_cf[tid] = cf[m * 3 + tid];

  const int f_begin = static_cast<int>(blockIdx.x) * kFramesPerBlock;
  const int f_end = min(F, f_begin + kFramesPerBlock);
  for (int f = f_begin; f < f_end; ++f) {
    // ---- stage the frame's joint quantities --------------------------------
    __syncthreads();
    const size_t fJ = static_cast<size_t>(f) * J;
    for (int i = tid; i < 9 * J; i += blockDim.x) s_grot[i] = grot[fJ * 9 + i];
    for (int i = tid; i < J3; i += blockDim.x) s_atr[i] = atr[fJ * 3 + i];
    for (int i = tid; i < featN; i += blockDim.x)
      s_feat[i] = feat[static_cast<size_t>(f) * featN + i];
    if (WITH_JAC) {
      for (int i = tid; i < 27 * J; i += blockDim.x) {
        s_wrot[i] = wrot[fJ * 27 + i];
        s_dr[i] = dr[fJ * 27 + i];
      }
      for (int i = tid; i < 9 * J; i += blockDim.x) s_wtr[i] = wtr[fJ * 9 + i];
    }
    __syncthreads();

    // ---- pose blend vp[k][c] and the weighted transforms T_rot, T_tr --------
    for (int r = warp; r < 9; r += nwarps) {
      double acc = 0.0;
      for (int p = lane; p < featN; p += 32)
        acc += static_cast<double>(pd[r * featN + p]) * s_feat[p];
      acc = warp_sum(acc);
      if (lane == 0) {
        s_vpd[r] = s_vsh[r] + acc;
        s_vp[r] = static_cast<float>(s_vsh[r] + acc);
      }
    }
    if (tid < 36) {
      const int k = tid / 12, e = tid % 12;
      double acc = 0.0;
      if (e < 9) {
        for (int j = 0; j < J; ++j)
          acc += static_cast<double>(s_w[k * J + j]) * s_grot[j * 9 + e];
        s_Trot[k * 9 + e] = static_cast<float>(acc);
      } else {
        for (int j = 0; j < J; ++j)
          acc += static_cast<double>(s_w[k * J + j]) * s_atr[j * 3 + e - 9];
      }
      s_Td[k * 12 + e] = acc;
    }
    __syncthreads();

    // ---- marker from its frame vertices (one thread, float64) ---------------
    if (tid == 0) {
      double v[3][3];
      for (int k = 0; k < 3; ++k)
        for (int b = 0; b < 3; ++b)
          v[k][b] = s_Td[k * 12 + b * 3] * s_vpd[k * 3] +
                    s_Td[k * 12 + b * 3 + 1] * s_vpd[k * 3 + 1] +
                    s_Td[k * 12 + b * 3 + 2] * s_vpd[k * 3 + 2] +
                    s_Td[k * 12 + 9 + b] + static_cast<double>(trans[f * 3 + b]);
      float out[3];
      local_frame<WITH_JAC>(v, s_cf, out, s_dms);
      float* dst = sim + (static_cast<size_t>(f) * M + m) * 3;
      dst[0] = out[0];
      dst[1] = out[1];
      dst[2] = out[2];
    }
    if (!WITH_JAC) continue;

    // ---- z[k][j] = A_rot[j] v_posed[k] + A_tr[j] ------------------------------
    for (int it = tid; it < J3; it += blockDim.x) {
      const int k = it / J, j = it % J;
      for (int b = 0; b < 3; ++b)
        s_z[(k * J + j) * 3 + b] = s_grot[j * 9 + b * 3] * s_vp[k * 3] +
                                   s_grot[j * 9 + b * 3 + 1] * s_vp[k * 3 + 1] +
                                   s_grot[j * 9 + b * 3 + 2] * s_vp[k * 3 + 2] +
                                   s_atr[j * 3 + b];
    }
    __syncthreads();

    // ---- S[k][j] = sum over joints j' below j of w[k][j'] z[k][j'] -----------
    for (int it = tid; it < J3; it += blockDim.x) {
      const int k = it / J, j = it % J;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int jp = 0; jp < J; ++jp) {
        const float wk = s_w[k * J + jp];
        if (wk != 0.f && ((s_anc[jp] >> j) & 1ull)) {
          const float* zz = s_z + (k * J + jp) * 3;
          a0 += wk * zz[0];
          a1 += wk * zz[1];
          a2 += wk * zz[2];
        }
      }
      s_S[(k * J + j) * 3] = a0;
      s_S[(k * J + j) * 3 + 1] = a1;
      s_S[(k * J + j) * 3 + 2] = a2;
    }
    __syncthreads();

    // ---- full-pose columns (j, t), folded through the marker frame ----------
    for (int col = tid; col < J3; col += blockDim.x) {
      const int j = col / 3, t = col % 3;
      float U0 = 0.f, U1 = 0.f, U2 = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float* Sk = s_S + (k * J + j) * 3;
        const float sk = s_s[k * J + j];
        float Jf[3];
        for (int a = 0; a < 3; ++a)
          Jf[a] = s_wrot[j * 27 + (a * 3 + 0) * 3 + t] * Sk[0] +
                  s_wrot[j * 27 + (a * 3 + 1) * 3 + t] * Sk[1] +
                  s_wrot[j * 27 + (a * 3 + 2) * 3 + t] * Sk[2] +
                  sk * s_wtr[j * 9 + a * 3 + t];
        if (j >= 1 && featN > 0) {
          float dvp[3];
          for (int c = 0; c < 3; ++c) {
            const float* pdr = pd + (k * 3 + c) * featN + (j - 1) * 9;
            float acc = 0.f;
            for (int ab = 0; ab < 9; ++ab) acc += pdr[ab] * s_dr[j * 27 + ab * 3 + t];
            dvp[c] = acc;
          }
          for (int a = 0; a < 3; ++a)
            Jf[a] += s_Trot[k * 9 + a * 3] * dvp[0] +
                     s_Trot[k * 9 + a * 3 + 1] * dvp[1] +
                     s_Trot[k * 9 + a * 3 + 2] * dvp[2];
        }
        const float* dk = s_dms + k * 9;
        U0 += dk[0] * Jf[0] + dk[1] * Jf[1] + dk[2] * Jf[2];
        U1 += dk[3] * Jf[0] + dk[4] * Jf[1] + dk[5] * Jf[2];
        U2 += dk[6] * Jf[0] + dk[7] * Jf[1] + dk[8] * Jf[2];
      }
      s_U[col] = U0;
      s_U[J3 + col] = U1;
      s_U[2 * J3 + col] = U2;
    }
    __syncthreads();

    // ---- jm row: trans identity, body columns, hand-PCA chain ---------------
    // A thread owns column d of all three rows: a hand column's three dot
    // products share each component load and run as independent chains.
    float* row = jm + (static_cast<size_t>(f) * M + m) * 3 * D;
    for (int d = tid; d < D; d += blockDim.x) {
      float v0, v1, v2;
      if (d < 3) {
        v0 = d == 0 ? 1.f : 0.f;
        v1 = d == 1 ? 1.f : 0.f;
        v2 = d == 2 ? 1.f : 0.f;
      } else if (d - 3 < body_dof) {
        v0 = s_U[d - 3];
        v1 = s_U[J3 + d - 3];
        v2 = s_U[2 * J3 + d - 3];
      } else {
        const float* hrow = hc + (d - 3 - body_dof) * nhand;
        const float* U0 = s_U + body_dof;
        v0 = v1 = v2 = 0.f;
        for (int h = 0; h < nhand; ++h) {
          const float hv = hrow[h];
          v0 = fmaf(hv, U0[h], v0);
          v1 = fmaf(hv, U0[J3 + h], v1);
          v2 = fmaf(hv, U0[2 * J3 + h], v2);
        }
      }
      row[d] = v0;
      row[D + d] = v1;
      row[2 * D + d] = v2;
    }
  }
}

}  // namespace

extern "C" int marker_rows_launch(
    int with_jac, int F, int M, int J, int featN, int body_dof, int hand_dof,
    int D, const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pd3,
    const float* cf, const unsigned long long* ancmask, const float* hc,
    float* sim, float* jm, void* stream) {
  if (F < 1 || M < 1 || M > 65535 || J < 1 || J > 64 ||
      D != 3 + body_dof + hand_dof)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(with_jac != 0, J, featN);
  const size_t bytes = static_cast<size_t>(L.total) * sizeof(float);
  // frame tiles fastest: blocks resident on one SM tend to share a marker,
  // whose posedirs rows then stay in L1
  const dim3 grid((F + kFramesPerBlock - 1) / kFramesPerBlock, M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_jac) {
    err = allow_smem(marker_rows_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    marker_rows_kernel<true><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, D, grot, atr, feat, wrot, wtr, dr,
        trans, w3, s3, vsh3, pd3, cf, ancmask, hc, sim, jm);
  } else {
    err = allow_smem(marker_rows_kernel<false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    marker_rows_kernel<false><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, D, grot, atr, feat, nullptr,
        nullptr, nullptr, trans, w3, nullptr, vsh3, pd3, cf, nullptr, nullptr,
        sim, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
