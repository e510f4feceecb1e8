// marker_rows<WITH_JAC, EXT, TILED, FOLD>: simulated markers and, with the
// Jacobian, their exact (trans, pose, extras) Jacobian rows.
//
// Replaces the Pallas TPU kernels of moshpp_tpu/ops/pallas_marker_jac.py
// (bodies `_marker_impl` and `_sim_marker_impl`):
//   <true, false, false, false>  `_marker_kernel`        <false, ...>  `_sim_marker_kernel`
//   <true, true, false, false>   `_marker_kernel_ext`    <false, ...>  `_sim_marker_kernel_ext`
//   <true, false, true, false>   `_marker_kernel_tiled`  <false, ...>  `_sim_marker_kernel_tiled`
//   <true, false, false, true>   `_marker_jac_w_kernel`
//   <true, true, false, true>    `_marker_jac_w_kernel_ext`
//   <true, false, true, true>    `_marker_jac_w_kernel_tiled`
// Plain versions: moshpp_torch/ops/marker_jac.marker_rows_plain,
// marker_rows_tiled_plain, marker_rows_fold_plain and
// marker_rows_tiled_fold_plain.
//
// Per (frame, marker): skin the marker's 3 frame vertices (pose blend,
// weighted transforms), rebuild the marker in its local frame, and with the
// Jacobian push the per-vertex pose columns
//   J[v, :, (j,t)] = Wrot_{j,t} S_vj + s_vj Wtr_{j,t} + T_rot dvp_{j,t}
// through the frame's hand-derived 3x3 blocks and the hand-PCA chain.
//
// With EXT the problem has E <= 16 extra shape dims x_e: the rest position
// of each frame vertex moves by sum_e x_e dv_e before skinning (fk_smalls
// already moved the joints), and with the Jacobian each vertex gets E more
// columns d v/dx_e = sum_j w_j datr_e[j] + T_rot dv_e, folded through the
// same local-frame blocks as the pose columns: the jm row grows from
// 3 x (3+P) to 3 x (3+P+E) floats.
//
// With TILED (the tiled extras route, any E) the wrapper has summed the
// vertex shift, vpshift[f][m] = sum_e x_e dv_e (3 verts x 3), which joins
// the float64 pose-blend sum; the program has no E loop. It writes jm's
// first 3+P columns of the (F, M, 3, D) buffer and, with the Jacobian, the
// marker's chain factors uv[f][m] = [U = dms (k, c, d); V = dms T_rot
// (k, c, z)] (54 floats), from which extras_cols.cu writes the last E
// columns.
//
// With FOLD (the stage-ii system's `fold_weights`; the Jacobian only) the
// kernel also reads the observed markers obs (F, M, 3) and the data weights
// w (F, M), and writes the Gauss-Newton data rows themselves: the weighted
// residual (sim - obs) w in place of sim, and jm w in place of jm, so the
// system skips its (F, M, 3, D) weighting pass. Each multiply by w comes
// after its entry is final, as the Pallas kernel's `out * wrow`: the folded
// trans, pose and inline-extras columns are the unfolded kernel's times w
// bit for bit (nvcc contracts only a multiply that feeds an add). Under
// TILED the 54 uv floats are weighted too, so extras_cols writes weighted
// extra columns; those alone differ from the unfolded ones in rounding.
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
// F=4096, M=46, D=117, >= 0.08 ms) nor operations (~84 K float32 and ~13 K
// float64 a (frame, marker), 0.31 ms at F=4096), but latency: the work of
// one (frame, marker) is a chain of small dependent phases. A first design
// (one marker and one frame at a time a block, six barriers a frame, the
// float64 local frame on one thread) spent ~8 K SM cycles a (frame, marker).
//
// Design: tile-at-a-time, phase-major. A block owns kTM markers and
// kFramesPerBlock frames, walked as tiles of kTF frames x kTM markers
// (kPairs (frame, marker) pairs). Each phase runs for the whole tile
// before the next barrier, four barriers a tile (two without the
// Jacobian):
//   1. pose blend, a register-tiled float64 product (one warp a (marker,
//      vertex): 3 posedirs rows x kTF frames a lane, posedirs through L1,
//      featN split over the lanes and summed by shuffles); the weighted
//      transforms T_rot, T_tr, one (pair, vertex, entry) a thread, over the
//      vertex's nonzero skinning weights only (a list made once a block by
//      warp ballots; a zero weight adds an exact zero, so the sum is
//      unchanged);
//   2. the float64 local frames, one pair a thread, side by side (EXT: the
//      vertex columns Je from the block's far end);
//   3. the pose columns, one (marker, joint) a thread for the tile's
//      frames: the ancestor sums S over the vertex's nonzero weights (z on
//      the fly), then Wrot S + s Wtr + T_rot dvp through the frame blocks;
//      body columns are written straight to jm, hand columns kept for 4
//      (TILED: the uv factors, EXT: the extra columns UE, from the far end);
//   4. the hand-PCA chain, a register-tiled float32 product (3 rows of one
//      pair x 2 components a thread, hc staged transposed once a block),
//      the trans identity and the inline extra columns.
// The marker tables (skinning weights, ancestor masks, hc) are staged once
// a block; a tile's joint quantities (grot, atr, feat, extras; with the
// Jacobian wrot, wtr, dr) once a tile with cp.async, the next tile's issued
// right after the last phase that reads the current one (3, or 1 without
// the Jacobian), so the copy overlaps the tile's last phase.
// Bytes a call from L2, counted from the loops (F=4096, M=46, J=52): a
// frame's joint quantities (75 J + featN floats, 17.4 KB) are staged once
// a marker tile, 0.86 GB (the first design staged them once a marker,
// 3.3 GB); a marker's posedirs rows (9 featN floats, 16.5 KB) are read
// through L1 once a tile by the blend and once a frame by the pose
// columns, 4.7 GB of L1 reads of which L2 serves the misses (the first
// design: 6.2 GB of L1 reads).

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 256;
constexpr int kTF = 2;                        // frames a tile
constexpr int kTM = 4;                        // markers a tile (and a block)
constexpr int kPairs = kTF * kTM;             // (frame, marker) pairs a tile
constexpr int kTilesPerBlock = 8;
constexpr int kFramesPerBlock = kTF * kTilesPerBlock;
constexpr int kMaxExtra = 16;
constexpr int kHandCols = 2;                  // hand-PCA components a thread

// Offsets (in floats, each region 16-byte aligned) of the dynamic
// shared-memory regions; absent regions are empty. The float64 regions
// come first.
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 3) & ~3;
  return at;
}

struct Layout {
  int vpd, Td, w, s, vsh, cf, dv, hcT, grot, atr, feat, ex, datr, wrot, wtr,
      dr, vp, Trot, dms, Uh, Je, UE, total;
  __host__ __device__ Layout(bool jac, int J, int featN, int E, int nhand,
                             int hand_dof) {
    int o = 0;
    vpd = take(o, 2 * kPairs * 9);           // double [q][k][c]
    Td = take(o, 2 * kPairs * 36);           // double [q][k][12]
    // the block's markers
    w = take(o, kTM * 3 * J);                // [mi][k][j]
    s = take(o, jac ? kTM * 3 * J : 0);
    vsh = take(o, kTM * 9);
    cf = take(o, kTM * 3);
    dv = take(o, kTM * 9 * E);               // [mi][k][e][c]
    hcT = take(o, jac ? nhand * hand_dof : 0);   // [h][d]
    // a tile's frames
    grot = take(o, kTF * 9 * J);
    atr = take(o, kTF * 3 * J);
    feat = take(o, kTF * featN);
    ex = take(o, kTF * E);
    datr = take(o, jac ? kTF * 3 * E * J : 0);   // [fi][e][j][a]
    wrot = take(o, jac ? kTF * 27 * J : 0);
    wtr = take(o, jac ? kTF * 9 * J : 0);
    dr = take(o, jac ? kTF * 27 * J : 0);
    // a tile's pairs, q = fi * kTM + mi
    vp = take(o, kPairs * 9);                // float rounding of vpd
    Trot = take(o, kPairs * 27);             // [q][k][a][c]
    dms = take(o, kPairs * 27);              // [q][k][c][d]
    Uh = take(o, jac && hand_dof ? kPairs * 3 * nhand : 0);   // [q][c][h]
    Je = take(o, jac ? kPairs * 9 * E : 0);  // [q][e][k][a]
    UE = take(o, jac ? kPairs * 3 * E : 0);  // [q][c][e]
    total = o;
  }
};

// Queue the copy of n floats from global src to shared dst, all threads of
// the block: 16 bytes a copy where both ends are 16-byte aligned.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

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

// FOLD: the (frame, marker) data weight, read where it is applied so that it
// holds no register through the frame's phases; 1 (and unread) otherwise.
template <bool FOLD>
__device__ __forceinline__ float weight(const float* __restrict__ wrow,
                                        size_t fm) {
  if constexpr (FOLD) return wrow[fm];
  else return 1.f;
}

// A finished entry times the weight under FOLD; the unfolded programs carry
// no multiply.
template <bool FOLD>
__device__ __forceinline__ float weighted(float v, float w) {
  if constexpr (FOLD) return v * w;
  else return v;
}

template <bool WITH_JAC, bool EXT, bool TILED, bool FOLD>
__global__ void __launch_bounds__(kThreads, WITH_JAC ? 2 : 3)
marker_rows_kernel(int F, int M, int J, int featN, int body_dof,
                   int hand_dof, int D,
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
                   float* __restrict__ jm, int E,
                   const float* __restrict__ extra,
                   const float* __restrict__ datr,
                   const float* __restrict__ dv,
                   const float* __restrict__ vpshift,
                   float* __restrict__ uv,
                   const float* __restrict__ obs,
                   const float* __restrict__ wrow) {
  static_assert(!(EXT && TILED), "one extras route at a time");
  static_assert(!FOLD || WITH_JAC, "the weights fold into the Jacobian rows");
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_anc[64];
  __shared__ unsigned char s_nzj[kTM * 3][64];   // nonzero-weight joints
  __shared__ int s_nzc[kTM * 3];
  const int J3 = 3 * J;
  const int nhand = J3 - body_dof;   // full-pose hand columns
  const int Ex = EXT ? E : 0;
  const Layout L(WITH_JAC, J, featN, Ex, nhand, hand_dof);
  double* s_vpd = reinterpret_cast<double*>(smem + L.vpd);
  double* s_Td = reinterpret_cast<double*>(smem + L.Td);
  float* s_w = smem + L.w;
  float* s_s = smem + L.s;
  float* s_vsh = smem + L.vsh;
  float* s_cf = smem + L.cf;
  float* s_dv = smem + L.dv;
  float* s_hcT = smem + L.hcT;
  float* s_grot = smem + L.grot;
  float* s_atr = smem + L.atr;
  float* s_feat = smem + L.feat;
  float* s_ex = smem + L.ex;
  float* s_datr = smem + L.datr;
  float* s_wrot = smem + L.wrot;
  float* s_wtr = smem + L.wtr;
  float* s_dr = smem + L.dr;
  float* s_vp = smem + L.vp;
  float* s_Trot = smem + L.Trot;
  float* s_dms = smem + L.dms;
  float* s_Uh = smem + L.Uh;
  float* s_Je = smem + L.Je;
  float* s_UE = smem + L.UE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m0 = static_cast<int>(blockIdx.y) * kTM;
  const int nm = min(kTM, M - m0);
  const int f_begin = static_cast<int>(blockIdx.x) * kFramesPerBlock;
  const int f_end = min(F, f_begin + kFramesPerBlock);

  // a tile's joint quantities, queued as one cp.async group
  auto load_tile = [&](int f0) {
    const int nf = min(kTF, f_end - f0);
    const size_t fJ = static_cast<size_t>(f0) * J;
    stage(s_grot, grot + fJ * 9, nf * 9 * J);
    stage(s_atr, atr + fJ * 3, nf * 3 * J);
    stage(s_feat, feat + static_cast<size_t>(f0) * featN, nf * featN);
    if constexpr (EXT) {
      stage(s_ex, extra + static_cast<size_t>(f0) * E, nf * E);
      if (WITH_JAC) stage(s_datr, datr + fJ * 3 * E, nf * 3 * E * J);
    }
    if constexpr (WITH_JAC) {
      stage(s_wrot, wrot + fJ * 27, nf * 27 * J);
      stage(s_wtr, wtr + fJ * 9, nf * 9 * J);
      stage(s_dr, dr + fJ * 27, nf * 27 * J);
    }
    cp_async_commit();
  };

  // ---- the block's markers, once ---------------------------------------------
  const size_t mJ3 = static_cast<size_t>(m0) * J3;
  stage(s_w, w3 + mJ3, nm * J3);
  if (WITH_JAC) stage(s_s, s3 + mJ3, nm * J3);
  stage(s_vsh, vsh3 + static_cast<size_t>(m0) * 9, nm * 9);
  stage(s_cf, cf + static_cast<size_t>(m0) * 3, nm * 3);
  if constexpr (EXT) stage(s_dv, dv + static_cast<size_t>(m0) * 9 * E, nm * 9 * E);
  if (WITH_JAC) {
    for (int i = tid; i < J; i += blockDim.x) s_anc[i] = ancmask[i];
    for (int i = tid; i < nhand * hand_dof; i += blockDim.x) {
      const int h = i / hand_dof, d = i % hand_dof;
      s_hcT[i] = hc[d * nhand + h];
    }
  }
  // each vertex's nonzero skinning weights, in joint order
  for (int r = warp; r < nm * 3; r += nwarps) {
    const float* wr = w3 + mJ3 + static_cast<size_t>(r) * J;
    int cnt = 0;
    for (int jb = 0; jb < J; jb += 32) {
      const int j = jb + lane;
      const bool nz = j < J && wr[j] != 0.f;
      const unsigned b = __ballot_sync(0xffffffffu, nz);
      if (nz) s_nzj[r][cnt + __popc(b & ((1u << lane) - 1u))] =
          static_cast<unsigned char>(j);
      cnt += __popc(b);
    }
    if (lane == 0) s_nzc[r] = cnt;
  }
  load_tile(f_begin);

  for (int f0 = f_begin; f0 < f_end; f0 += kTF) {
    const int nf = min(kTF, f_end - f0);
    const int npairs = nf * kTM;
    cp_async_wait_all();
    __syncthreads();

    // ---- 1. pose blend vp[q][k][c] and the weighted transforms T_rot, T_tr -
    // one warp a (marker, vertex): 3 posedirs rows x kTF frames a lane
    for (int g = warp; g < nm * 3; g += nwarps) {
      const int mi = g / 3, k = g % 3;
      const float* pdr = pd3 + (static_cast<size_t>(m0 + mi) * 9 + k * 3) * featN;
      double acc[3][kTF];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int fi = 0; fi < kTF; ++fi) acc[c][fi] = 0.0;
      for (int p = lane; p < featN; p += 32) {
        const double a0 = __ldg(pdr + p);
        const double a1 = __ldg(pdr + featN + p);
        const double a2 = __ldg(pdr + 2 * featN + p);
#pragma unroll
        for (int fi = 0; fi < kTF; ++fi) {
          const double fv = s_feat[fi * featN + p];
          acc[0][fi] += a0 * fv;
          acc[1][fi] += a1 * fv;
          acc[2][fi] += a2 * fv;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int fi = 0; fi < kTF; ++fi) acc[c][fi] = warp_sum(acc[c][fi]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int fi = 0; fi < kTF; ++fi) {
          if (lane != c * kTF + fi || fi >= nf) continue;
          const int f = f0 + fi, q = fi * kTM + mi, r = k * 3 + c;
          double a = acc[c][fi];
          if constexpr (EXT) {
            // the frame's extras move the rest position: sum_e x_e dv_e
            for (int e = 0; e < E; ++e)
              a += static_cast<double>(s_ex[fi * E + e]) *
                   s_dv[((mi * 3 + k) * E + e) * 3 + c];
          }
          if constexpr (TILED)
            a += static_cast<double>(
                vpshift[(static_cast<size_t>(f) * M + m0 + mi) * 9 + r]);
          s_vpd[q * 9 + r] = s_vsh[mi * 9 + r] + a;
          s_vp[q * 9 + r] = static_cast<float>(s_vsh[mi * 9 + r] + a);
        }
    }
    // T_rot (9) and T_tr (3) of each (pair, vertex), float64
    for (int it = tid; it < kPairs * 36; it += blockDim.x) {
      const int q = it / 36, k = (it / 12) % 3, e = it % 12;
      const int fi = q / kTM, mi = q % kTM;
      if (fi >= nf || mi >= nm) continue;
      const int r = mi * 3 + k;
      const float* wk = s_w + r * J;
      double acc = 0.0;
      for (int n = 0; n < s_nzc[r]; ++n) {
        const int j = s_nzj[r][n];
        acc += static_cast<double>(wk[j]) *
               (e < 9 ? s_grot[(fi * J + j) * 9 + e]
                      : s_atr[(fi * J + j) * 3 + e - 9]);
      }
      if (e < 9) s_Trot[q * 27 + k * 9 + e] = static_cast<float>(acc);
      s_Td[q * 36 + k * 12 + e] = acc;
    }
    __syncthreads();
    if (!WITH_JAC && f0 + kTF < f_end) load_tile(f0 + kTF);

    // ---- 2. the markers from their frame vertices, one pair a thread -------
    for (int q = tid; q < kPairs; q += blockDim.x) {
      const int fi = q / kTM, mi = q % kTM;
      if (fi >= nf || mi >= nm) continue;
      const int f = f0 + fi;
      const double* Td = s_Td + q * 36;
      const double* vpd = s_vpd + q * 9;
      double v[3][3];
      for (int k = 0; k < 3; ++k)
        for (int b = 0; b < 3; ++b)
          v[k][b] = Td[k * 12 + b * 3] * vpd[k * 3] +
                    Td[k * 12 + b * 3 + 1] * vpd[k * 3 + 1] +
                    Td[k * 12 + b * 3 + 2] * vpd[k * 3 + 2] +
                    Td[k * 12 + 9 + b] + static_cast<double>(trans[f * 3 + b]);
      float out[3];
      local_frame<WITH_JAC>(v, s_cf + mi * 3, out, s_dms + q * 27);
      const size_t fm = static_cast<size_t>(f) * M + m0 + mi;
      float* dst = sim + fm * 3;
      if constexpr (FOLD) {
        // the weighted residual (sim - obs) w
        const float* ob = obs + fm * 3;
        const float w = wrow[fm];
        dst[0] = (out[0] - ob[0]) * w;
        dst[1] = (out[1] - ob[1]) * w;
        dst[2] = (out[2] - ob[2]) * w;
      } else {
        dst[0] = out[0];
        dst[1] = out[1];
        dst[2] = out[2];
      }
    }
    if constexpr (EXT && WITH_JAC) {
      // vertex columns Je[q][e][k][a] = sum_j w[k][j] datr[e][j][a]
      // + sum_c T_rot[k][a][c] dv[k][e][c], from the block's far end
      for (int it = blockDim.x - 1 - tid; it < npairs * 9 * E;
           it += blockDim.x) {
        const int q = it / (9 * E), rem = it % (9 * E);
        const int e = rem / 9, k = (rem / 3) % 3, a = rem % 3;
        const int fi = q / kTM, mi = q % kTM;
        if (mi >= nm) continue;
        const int r = mi * 3 + k;
        float acc = 0.f;
        for (int n = 0; n < s_nzc[r]; ++n) {
          const int j = s_nzj[r][n];
          acc = fmaf(s_w[r * J + j], s_datr[((fi * E + e) * J + j) * 3 + a], acc);
        }
        const float* Tr = s_Trot + q * 27 + k * 9 + a * 3;
        const float* dk = s_dv + ((mi * 3 + k) * E + e) * 3;
        s_Je[q * 9 * E + rem] = acc + Tr[0] * dk[0] + Tr[1] * dk[1] + Tr[2] * dk[2];
      }
    }
    if constexpr (WITH_JAC) {
      __syncthreads();

      // ---- 3. full-pose columns, one (marker, joint) a thread -----------------
      for (int it = tid; it < nm * J; it += blockDim.x) {
        const int mi = it / J, j = it % J;
        const int m = m0 + mi;
        const unsigned long long jbit = 1ull << j;
        for (int fi = 0; fi < nf; ++fi) {
          const int q = fi * kTM + mi;
          const float* g = s_grot + fi * 9 * J;
          const float* at = s_atr + fi * 3 * J;
          const float* wr = s_wrot + (fi * J + j) * 27;
          const float* wt = s_wtr + (fi * J + j) * 9;
          const float* drj = s_dr + (fi * J + j) * 27;
          float U[3][3];
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int t = 0; t < 3; ++t) U[c][t] = 0.f;
          for (int k = 0; k < 3; ++k) {
            // S = sum over the vertex's weighted joints below j of w z
            const int r = mi * 3 + k;
            const float* vk = s_vp + q * 9 + k * 3;
            float S0 = 0.f, S1 = 0.f, S2 = 0.f;
            for (int n = 0; n < s_nzc[r]; ++n) {
              const int jp = s_nzj[r][n];
              if (!(s_anc[jp] & jbit)) continue;
              const float wk = s_w[r * J + jp];
              const float* gj = g + jp * 9;
              const float z0 = gj[0] * vk[0] + gj[1] * vk[1] + gj[2] * vk[2] +
                               at[jp * 3];
              const float z1 = gj[3] * vk[0] + gj[4] * vk[1] + gj[5] * vk[2] +
                               at[jp * 3 + 1];
              const float z2 = gj[6] * vk[0] + gj[7] * vk[1] + gj[8] * vk[2] +
                               at[jp * 3 + 2];
              S0 += wk * z0;
              S1 += wk * z1;
              S2 += wk * z2;
            }
            const float sk = s_s[r * J + j];
            float dvp[3][3];   // [c][t]
            const bool blend = j >= 1 && featN > 0;
            if (blend) {
              for (int c = 0; c < 3; ++c) {
                const float* pdr =
                    pd3 + (static_cast<size_t>(m) * 9 + k * 3 + c) * featN + (j - 1) * 9;
                float pv[9];
#pragma unroll
                for (int ab = 0; ab < 9; ++ab) pv[ab] = __ldg(pdr + ab);
#pragma unroll
                for (int t = 0; t < 3; ++t) {
                  float acc = 0.f;
#pragma unroll
                  for (int ab = 0; ab < 9; ++ab) acc += pv[ab] * drj[ab * 3 + t];
                  dvp[c][t] = acc;
                }
              }
            }
            const float* Tk = s_Trot + q * 27 + k * 9;
            const float* dk = s_dms + q * 27 + k * 9;
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              float Jf[3];
#pragma unroll
              for (int a = 0; a < 3; ++a)
                Jf[a] = wr[(a * 3 + 0) * 3 + t] * S0 + wr[(a * 3 + 1) * 3 + t] * S1 +
                        wr[(a * 3 + 2) * 3 + t] * S2 + sk * wt[a * 3 + t];
              if (blend) {
#pragma unroll
                for (int a = 0; a < 3; ++a)
                  Jf[a] += Tk[a * 3] * dvp[0][t] + Tk[a * 3 + 1] * dvp[1][t] +
                           Tk[a * 3 + 2] * dvp[2][t];
              }
              U[0][t] += dk[0] * Jf[0] + dk[1] * Jf[1] + dk[2] * Jf[2];
              U[1][t] += dk[3] * Jf[0] + dk[4] * Jf[1] + dk[5] * Jf[2];
              U[2][t] += dk[6] * Jf[0] + dk[7] * Jf[1] + dk[8] * Jf[2];
            }
          }
          // body columns to jm, hand columns to the hand-PCA phase
          const size_t fm = static_cast<size_t>(f0 + fi) * M + m;
          float* row = jm + fm * 3 * D;
          const float w = weight<FOLD>(wrow, fm);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int col = 3 * j + t;
            if (col < body_dof) {
#pragma unroll
              for (int c = 0; c < 3; ++c)
                row[c * D + 3 + col] = weighted<FOLD>(U[c][t], w);
            } else if (hand_dof > 0) {
#pragma unroll
              for (int c = 0; c < 3; ++c)
                s_Uh[(q * 3 + c) * nhand + col - body_dof] = U[c][t];
            }
          }
        }
      }
      if constexpr (TILED) {
        // the chain factors for extras_cols: U[k][c][d] = dms, then
        // V[k][c][z] = sum_d dms[k][c][d] T_rot[k][d][z]; FOLD weights them,
        // so that extras_cols writes weighted columns
        for (int it = blockDim.x - 1 - tid; it < npairs * 54; it += blockDim.x) {
          const int q = it / 54, x = it % 54;
          const int fi = q / kTM, mi = q % kTM;
          if (mi >= nm) continue;
          const size_t fm = static_cast<size_t>(f0 + fi) * M + m0 + mi;
          const float w = weight<FOLD>(wrow, fm);
          const float* dq = s_dms + q * 27;
          float val;
          if (x < 27) {
            val = dq[x];
          } else {
            const int k = (x - 27) / 9, c = ((x - 27) / 3) % 3, z = x % 3;
            const float* dk = dq + k * 9 + c * 3;
            const float* Tk = s_Trot + q * 27 + k * 9;
            val = dk[0] * Tk[z] + dk[1] * Tk[3 + z] + dk[2] * Tk[6 + z];
          }
          uv[fm * 54 + x] = weighted<FOLD>(val, w);
        }
      }
      if constexpr (EXT) {
        // extra columns through the marker frame: UE[q][c][e]
        // = sum_k sum_d dms[k][c][d] Je[e][k][d]
        for (int it = blockDim.x - 1 - tid; it < npairs * 3 * E; it += blockDim.x) {
          const int q = it / (3 * E), c = (it / E) % 3, e = it % E;
          if (q % kTM >= nm) continue;
          float acc = 0.f;
          for (int k = 0; k < 3; ++k) {
            const float* dk = s_dms + q * 27 + k * 9 + c * 3;
            const float* je = s_Je + q * 9 * E + (e * 3 + k) * 3;
            acc += dk[0] * je[0] + dk[1] * je[1] + dk[2] * je[2];
          }
          s_UE[it] = acc;
        }
      }
      __syncthreads();
      if (f0 + kTF < f_end) load_tile(f0 + kTF);

      // ---- 4. hand-PCA chain, trans identity and inline extra columns ---------
      // kHandCols components of the three rows of one pair a thread
      const int ngrp = (hand_dof + kHandCols - 1) / kHandCols;
      for (int it = tid; it < npairs * ngrp; it += blockDim.x) {
        const int q = it / ngrp, d0 = (it % ngrp) * kHandCols;
        const int fi = q / kTM, mi = q % kTM;
        if (mi >= nm) continue;
        const float* u = s_Uh + q * 3 * nhand;
        float v[3][kHandCols];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int x = 0; x < kHandCols; ++x) v[c][x] = 0.f;
        const bool two = d0 + 1 < hand_dof;
        for (int h = 0; h < nhand; ++h) {
          const float* hr = s_hcT + h * hand_dof + d0;
          const float h0 = hr[0], h1 = two ? hr[1] : 0.f;
          const float u0 = u[h], u1 = u[nhand + h], u2 = u[2 * nhand + h];
          v[0][0] = fmaf(h0, u0, v[0][0]);
          v[1][0] = fmaf(h0, u1, v[1][0]);
          v[2][0] = fmaf(h0, u2, v[2][0]);
          v[0][1] = fmaf(h1, u0, v[0][1]);
          v[1][1] = fmaf(h1, u1, v[1][1]);
          v[2][1] = fmaf(h1, u2, v[2][1]);
        }
        const size_t fm = static_cast<size_t>(f0 + fi) * M + m0 + mi;
        float* row = jm + fm * 3 * D + 3 + body_dof + d0;
        const float w = weight<FOLD>(wrow, fm);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          row[c * D] = weighted<FOLD>(v[c][0], w);
          if (two) row[c * D + 1] = weighted<FOLD>(v[c][1], w);
        }
      }
      // the trans identity and the inline extra columns, from the far end
      for (int it = blockDim.x - 1 - tid; it < npairs * (3 + Ex); it += blockDim.x) {
        const int q = it / (3 + Ex), x = it % (3 + Ex);
        const int fi = q / kTM, mi = q % kTM;
        if (mi >= nm) continue;
        const size_t fm = static_cast<size_t>(f0 + fi) * M + m0 + mi;
        float* row = jm + fm * 3 * D;
        const float w = weight<FOLD>(wrow, fm);
        if (x < 3) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            row[c * D + x] = weighted<FOLD>(c == x ? 1.f : 0.f, w);
        } else {
          const int e = x - 3;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            row[c * D + D - Ex + e] = weighted<FOLD>(s_UE[(q * 3 + c) * Ex + e], w);
        }
      }
    }
  }
}

template <bool EXT, bool TILED, bool FOLD>
cudaError_t launch(bool with_jac, cudaStream_t s, int F, int M, int J,
                   int featN, int body_dof, int hand_dof, int D,
                   const float* grot, const float* atr, const float* feat,
                   const float* wrot, const float* wtr, const float* dr,
                   const float* trans, const float* w3, const float* s3,
                   const float* vsh3, const float* pd3, const float* cf,
                   const unsigned long long* ancmask, const float* hc,
                   float* sim, float* jm, int E, const float* extra,
                   const float* datr, const float* dv, const float* vpshift,
                   float* uv, const float* obs, const float* wrow) {
  // frame ranges fastest: blocks resident on one SM tend to share a marker
  // tile, whose posedirs rows then stay in L1
  const dim3 grid((F + kFramesPerBlock - 1) / kFramesPerBlock,
                  (M + kTM - 1) / kTM);
  const int nhand = 3 * J - body_dof;
  const size_t bytes =
      static_cast<size_t>(Layout(with_jac, J, featN, EXT ? E : 0, nhand,
                                 hand_dof).total) * sizeof(float);
  cudaError_t err;
  if (with_jac) {
    err = allow_smem(marker_rows_kernel<true, EXT, TILED, FOLD>, bytes);
    if (err != cudaSuccess) return err;
    marker_rows_kernel<true, EXT, TILED, FOLD><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, hand_dof, D, grot, atr, feat, wrot, wtr, dr,
        trans, w3, s3, vsh3, pd3, cf, ancmask, hc, sim, jm, E, extra, datr,
        dv, vpshift, uv, obs, wrow);
  } else if constexpr (FOLD) {
    return cudaErrorInvalidValue;
  } else {
    err = allow_smem(marker_rows_kernel<false, EXT, TILED, false>, bytes);
    if (err != cudaSuccess) return err;
    marker_rows_kernel<false, EXT, TILED, false><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, hand_dof, D, grot, atr, feat, nullptr,
        nullptr, nullptr, trans, w3, nullptr, vsh3, pd3, cf, nullptr, nullptr,
        sim, nullptr, E, extra, nullptr, dv, vpshift, nullptr, nullptr,
        nullptr);
  }
  return cudaGetLastError();
}

// The inline routes (E = 0 or E <= 16 extras); FOLD also takes obs and w.
template <bool FOLD>
int rows_launch(bool with_jac, int F, int M, int J, int featN, int body_dof,
                int hand_dof, int D, const float* grot, const float* atr,
                const float* feat, const float* wrot, const float* wtr,
                const float* dr, const float* trans, const float* w3,
                const float* s3, const float* vsh3, const float* pd3,
                const float* cf, const unsigned long long* ancmask,
                const float* hc, float* sim, float* jm, int E,
                const float* extra, const float* datr, const float* dv,
                const float* obs, const float* wrow, void* stream) {
  if (F < 1 || M < 1 || M > 65535 || J < 1 || J > 64 || E < 0 ||
      E > kMaxExtra || D != 3 + body_dof + hand_dof + E ||
      (FOLD && (obs == nullptr || wrow == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      E > 0 ? launch<true, false, FOLD>(with_jac, s, F, M, J, featN,
                                        body_dof, hand_dof, D, grot, atr, feat,
                                        wrot, wtr, dr, trans, w3, s3, vsh3,
                                        pd3, cf, ancmask, hc, sim, jm, E,
                                        extra, datr, dv, nullptr, nullptr,
                                        obs, wrow)
            : launch<false, false, FOLD>(with_jac, s, F, M, J, featN,
                                         body_dof, hand_dof, D, grot, atr, feat,
                                         wrot, wtr, dr, trans, w3, s3, vsh3,
                                         pd3, cf, ancmask, hc, sim, jm, 0,
                                         nullptr, nullptr, nullptr, nullptr,
                                         nullptr, obs, wrow);
  return static_cast<int>(err);
}

// The tiled route: vpshift (F, M, 3, 3) in; with the Jacobian jm's first
// D - E columns (row stride D) and uv (F, M, 54) out.
template <bool FOLD>
int tiled_launch(bool with_jac, int F, int M, int J, int featN, int body_dof,
                 int hand_dof, int D, int E, const float* grot,
                 const float* atr, const float* feat, const float* wrot,
                 const float* wtr, const float* dr, const float* trans,
                 const float* w3, const float* s3, const float* vsh3,
                 const float* pd3, const float* cf,
                 const unsigned long long* ancmask, const float* hc,
                 const float* vpshift, float* sim, float* jm, float* uv,
                 const float* obs, const float* wrow, void* stream) {
  if (F < 1 || M < 1 || M > 65535 || J < 1 || J > 64 || E < 1 ||
      D != 3 + body_dof + hand_dof + E ||
      (FOLD && (obs == nullptr || wrow == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false, true, FOLD>(
      with_jac, static_cast<cudaStream_t>(stream), F, M, J, featN, body_dof,
      hand_dof, D, grot, atr, feat, wrot, wtr, dr, trans, w3, s3, vsh3,
      pd3, cf, ancmask, hc, sim, jm, E, nullptr, nullptr, nullptr, vpshift,
      uv, obs, wrow));
}

}  // namespace

// Blocks an SM of one instantiation (route 0 none, 1 inline extras, 2
// tiled) at these widths, and its shared memory a block (dynamic and
// static); 0 for a combination there is no kernel of.
extern "C" int marker_rows_occupancy(int with_jac, int route, int fold,
                                     int J, int featN, int body_dof,
                                     int hand_dof, int E, int* smem_bytes) {
  const void* fn = nullptr;
  const bool jac = with_jac != 0;
#define MOSHPP_PICK(X, T, F)                                                   \
  if (route == (X ? 1 : T ? 2 : 0) && fold == F)                               \
    fn = jac ? reinterpret_cast<const void*>(marker_rows_kernel<true, X, T, F>) \
             : (F ? nullptr                                                    \
                  : reinterpret_cast<const void*>(marker_rows_kernel<false, X, T, false>));
  MOSHPP_PICK(false, false, false)
  MOSHPP_PICK(true, false, false)
  MOSHPP_PICK(false, true, false)
  MOSHPP_PICK(false, false, true)
  MOSHPP_PICK(true, false, true)
  MOSHPP_PICK(false, true, true)
#undef MOSHPP_PICK
  cudaFuncAttributes a;
  if (fn == nullptr || cudaFuncGetAttributes(&a, fn) != cudaSuccess) return 0;
  const size_t bytes =
      static_cast<size_t>(Layout(jac, J, featN, route == 1 ? E : 0,
                                 3 * J - body_dof, hand_dof).total) * sizeof(float);
  *smem_bytes = static_cast<int>(bytes + a.sharedSizeBytes);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    bytes) != cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int marker_rows_launch(
    int with_jac, int F, int M, int J, int featN, int body_dof, int hand_dof,
    int D, const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pd3,
    const float* cf, const unsigned long long* ancmask, const float* hc,
    float* sim, float* jm, int E, const float* extra, const float* datr,
    const float* dv, void* stream) {
  return rows_launch<false>(with_jac != 0, F, M, J, featN, body_dof, hand_dof,
                            D, grot, atr, feat, wrot, wtr, dr, trans, w3, s3,
                            vsh3, pd3, cf, ancmask, hc, sim, jm, E, extra,
                            datr, dv, nullptr, nullptr, stream);
}

// FOLD: obs (F, M, 3) and w (F, M) in; rw (F, M, 3) and jw (F, M, 3, D) out.
extern "C" int marker_rows_fold_launch(
    int F, int M, int J, int featN, int body_dof, int hand_dof, int D,
    const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pd3,
    const float* cf, const unsigned long long* ancmask, const float* hc,
    float* rw, float* jw, int E, const float* extra, const float* datr,
    const float* dv, const float* obs, const float* wrow, void* stream) {
  return rows_launch<true>(true, F, M, J, featN, body_dof, hand_dof, D, grot,
                           atr, feat, wrot, wtr, dr, trans, w3, s3, vsh3, pd3,
                           cf, ancmask, hc, rw, jw, E, extra, datr, dv, obs,
                           wrow, stream);
}

extern "C" int marker_rows_tiled_launch(
    int with_jac, int F, int M, int J, int featN, int body_dof, int hand_dof,
    int D, int E, const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pd3,
    const float* cf, const unsigned long long* ancmask, const float* hc,
    const float* vpshift, float* sim, float* jm, float* uv, void* stream) {
  return tiled_launch<false>(with_jac != 0, F, M, J, featN, body_dof,
                             hand_dof, D, E, grot, atr, feat, wrot, wtr, dr,
                             trans, w3, s3, vsh3, pd3, cf, ancmask, hc,
                             vpshift, sim, jm, uv, nullptr, nullptr, stream);
}

// The tiled route with FOLD: rw, jw's first D - E columns and the weighted
// uv out.
extern "C" int marker_rows_tiled_fold_launch(
    int F, int M, int J, int featN, int body_dof, int hand_dof, int D, int E,
    const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pd3,
    const float* cf, const unsigned long long* ancmask, const float* hc,
    const float* vpshift, float* rw, float* jw, float* uv, const float* obs,
    const float* wrow, void* stream) {
  return tiled_launch<true>(true, F, M, J, featN, body_dof, hand_dof, D, E,
                            grot, atr, feat, wrot, wtr, dr, trans, w3, s3,
                            vsh3, pd3, cf, ancmask, hc, vpshift, rw, jw, uv,
                            obs, wrow, stream);
}
