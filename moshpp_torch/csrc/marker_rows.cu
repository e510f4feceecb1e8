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
// inputs, the Jacobian columns in float32 on the CUDA cores. Frame vertices
// can be nearly collinear (|e1 x e2| down to ~6e-9 m^2 on the 10242-vertex
// synthetic body), and there the frame derivative amplifies float32
// rounding of the vertices by orders of magnitude; the plain version does
// the same, so the two agree to the Jacobian's own float32 noise. The
// kernel groups the pose-blend columns as sum_k (dms_k T_rot_k) dvp_k where
// the plain version takes dms_k (T_rot_k dvp_k): the same terms, rounded
// in another order.
//
// What bounds it: not bytes (the jm write, F*M*3*D floats, is 264.5 MB at
// F=4096, M=46, D=117, >= 0.08 ms) nor operations (~64 K float32 and ~13 K
// float64 a (frame, marker), 0.31 ms at F=4096), but how the chain of small
// dependent phases of one (frame, marker) keeps the SM's pipes fed. The
// previous design (tiles of 2 frames x 4 markers, 8 pairs between
// barriers) left most of the block idle in every phase: the float64 local
// frames on 8 threads, the pose blend on 12 warp-items for 8 warps, the
// hand-PCA chain on 192 threads of 90-long chains against the full hc
// (half of it exact zeros), and the pose columns read each posedirs row
// through L1 with a 36-byte stride between lanes (a clock64 split at
// F=4096: blend and transforms 28 %, local frame 6 %, pose columns 46 %,
// hand chain 19 %), while small launches left SMs empty (F=128: 96 blocks
// for 132 SMs).
//
// Design: a block owns kTM = 8 markers and a range of frames chosen by the
// wrapper from F and the SM count (`marker_jac.rows_frames_per_block`: the
// most tiles a block that keep the grid within 5 % of whole waves, so that
// the compaction buckets' launches cover every SM), walked as tiles of
// kTF = 2 frames, 16 (frame, marker) pairs, two blocks an SM (three
// without the Jacobian). Each phase runs for the whole tile before the
// next barrier, and every phase has at least a warp of items:
//   1. the weighted transforms T_rot, T_tr, one (pair, vertex, entry) a
//      thread over the vertex's nonzero skinning weights only (lists made
//      once a block by warp ballots; a zero weight adds an exact zero), and
//      the tile's features in float64, in the order of a posedirs row of
//      `pd64`; then the pose blend, one warp a marker: its 9 posedirs rows
//      x kTF frames a lane over the features, then reduce-scattered over
//      the warp (20 float64 shuffles, not 90). `pd64` holds the posedirs
//      rows in float64 (the float32 values, exactly): a float32-to-float64
//      conversion issues at a quarter of the float64 FMA's rate, and a lane
//      would convert one for every two products;
//   2. the float64 local frames, two threads a pair (a warp for the tile):
//      both take the frame axes, one the first-vertex block d1, the other
//      d2, swapped by a shuffle; each writes its share of dms and of
//      Q_k = dms_k T_rot_k (the chain factor V of the tiled route, written
//      as uv there). EXT: the vertex columns Je from the block's far end,
//      datr read from global memory (a few entries an item) so that shared
//      memory leaves L1 room;
//   3. the pose columns, one (marker, joint, frame) a thread (832 items for
//      256 threads), the two frames of a (marker, joint) on neighbouring
//      lanes so that their loads of the posedirs rows (`pdt`, transposed
//      joint-last, [m][k][c][ab][j-1]: coalesced over joints) are one
//      request: the blend part sum_{k,c} Q_kc dvp_kc with dvp = posedirs
//      (3x9) dr (9x3), and the ancestor part dms (Wrot S + s Wtr) only for
//      the (marker, joint) items with a vertex weighted below the joint
//      (s != 0; else S and s are zero), which a list made once a block
//      packs into whole warps of the threads with the fewest items; body
//      columns straight to jm, hand columns kept for 4;
//   4. the hand-PCA chain, a register-tiled float32 product: 3 rows of one
//      pair x 4 components a thread, over the hand's own block of hc when
//      the wrapper found hc block-diagonal by hand (`hand_blocks`, 2 for
//      SMPL+H and SMPL-X: 45 x 24 a hand, 192 items), else over the full
//      hc; the skipped terms are exact zeros, so the sums are the full
//      product's bit for bit. The trans identity and the inline extra
//      columns UE = dms Je from the far end.
// The marker tables (skinning weights, ancestor masks, hc blocks) are
// staged once a block; a tile's joint quantities (grot, atr, feat, extras;
// with the Jacobian wrot, wtr, dr) once a tile with cp.async, the next
// tile's issued right after the last phase that reads the current one (3,
// or 1 without the Jacobian), so the copy overlaps the tile's last phase.
// Prefetching the posedirs rows into L1 ahead of their loads was measured
// and dropped: the prefetch instructions cost more issue slots than the
// latency they hid.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kThreads = 256;
constexpr int kTF = 2;                        // frames a tile
constexpr int kTM = 8;                        // markers a tile (and a block)
constexpr int kPairs = kTF * kTM;             // (frame, marker) pairs a tile
constexpr int kMaxExtra = 16;
constexpr int kHandCols = 4;                  // hand-PCA components a thread
static_assert(2 * kPairs % 32 == 0, "phase 2 takes whole warps");

// Offsets (in floats, each region 16-byte aligned) of the dynamic
// shared-memory regions; absent regions are empty. The float64 regions
// come first.
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 3) & ~3;
  return at;
}

struct Layout {
  int vpd, Td, w, s, vsh, cf, dv, hcT, grot, atr, feat, ex, wrot, wtr,
      dr, vp, Trot, dms, Q, Uh, featT, Je, total;
  // hcT: the staged hand-PCA blocks (hand_blocks x rows x padded columns)
  __host__ __device__ Layout(bool jac, int J, int featN, int E, int nhand,
                             int hcT_n) {
    int o = 0;
    vpd = take(o, 2 * kPairs * 9);           // double [q][k][c]
    Td = take(o, 2 * kPairs * 36);           // double [q][k][12]
    // the block's markers
    w = take(o, kTM * 3 * J);                // [mi][k][j]
    s = take(o, jac ? kTM * 3 * J : 0);
    vsh = take(o, kTM * 9);
    cf = take(o, kTM * 3);
    dv = take(o, kTM * 9 * E);               // [mi][k][e][c]
    hcT = take(o, jac ? hcT_n : 0);          // [b][h][d]
    // a tile's frames
    grot = take(o, kTF * 9 * J);
    atr = take(o, kTF * 3 * J);
    feat = take(o, kTF * featN);
    ex = take(o, kTF * E);
    wrot = take(o, jac ? kTF * 27 * J : 0);
    wtr = take(o, jac ? kTF * 9 * J : 0);
    dr = take(o, jac ? kTF * 27 * J : 0);
    // a tile's pairs, q = fi * kTM + mi
    vp = take(o, kPairs * 9);                // float rounding of vpd
    Trot = take(o, kPairs * 27);             // [q][k][a][c]
    dms = take(o, jac ? kPairs * 27 : 0);    // [q][k][c][d]
    Q = take(o, jac ? kPairs * 36 : 0);      // [q][k*3+c][c'], padded to 4
    // the hand columns (phases 3-4) and the tile's features in float64, in
    // the order of a `pdt` row (phase 1) share one region
    const int uh = jac ? kPairs * 3 * nhand : 0, ft = 2 * kTF * featN;
    Uh = featT = take(o, uh > ft ? uh : ft); // [q][c][h] / double [fi][x]
    Je = take(o, jac ? kPairs * 9 * E : 0);  // [q][e][k][a]
    total = o;
  }
};

// Floats of the staged hand-PCA blocks: `nblk` diagonal blocks of hc
// (hand_dof, nhand), each stored transposed with its columns padded to 4.
__host__ __device__ inline int hand_block_floats(int hand_dof, int nhand,
                                                 int nblk) {
  return hand_dof ? nhand * round4(hand_dof / nblk) : 0;
}

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

// One level of a warp's reduce-scatter: the lanes with `bit` set keep the
// upper half of their n values (the lower half without), send the other
// half to the lane `bit` away and add what it sends; n odd pads a zero.
template <int N>
__device__ __forceinline__ void scatter_level(double v[], int lane, int bit) {
  constexpr int H = (N + 1) / 2;
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const double lo = v[i], hi = i + H < N ? v[i + H] : 0.0;
    const double got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, bit);
    v[i] = (up ? hi : lo) + got;
  }
}

// Sums over the warp of each lane's 18 values: 20 float64 shuffles (a
// butterfly of each value would take 90). Returns the sum this lane ends
// with and sets `idx` to its value index (18 and above: padding).
__device__ __forceinline__ double warp_scatter18(double v[18], int lane,
                                                 int& idx) {
  scatter_level<18>(v, lane, 16);
  scatter_level<9>(v, lane, 8);
  scatter_level<5>(v, lane, 4);
  scatter_level<3>(v, lane, 2);
  scatter_level<2>(v, lane, 1);
  // the kept part's offset and its count of real (unpadded) values
  int pos = 0, n = 9;
  const int half[4] = {5, 3, 2, 1}, bit[4] = {8, 4, 2, 1};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if (lane & bit[l]) {
      pos += half[l];
      n -= half[l];
    } else {
      n = min(n, half[l]);
    }
  }
  idx = n >= 1 ? (lane & 16 ? 9 : 0) + pos : 18;
  return v[0];
}

// The marker's local frame from its frame vertices v[k] (float64;
// eps-guarded normalizations): edges, axes and their reciprocal norms.
struct Frame {
  double e1[3], e2[3], f1[3], f2[3], f3[3], r1, r2;
};

__device__ void frame_axes(const double v[3][3], Frame& fr) {
  const double eps = static_cast<double>(kEps);
  for (int b = 0; b < 3; ++b) {
    fr.e1[b] = v[1][b] - v[0][b];
    fr.e2[b] = v[2][b] - v[0][b];
  }
  const double* e1 = fr.e1;
  const double* e2 = fr.e2;
  // one float64 reciprocal square root per norm: the rest multiply by it
  fr.r1 = rsqrt(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2] + eps);
  for (int b = 0; b < 3; ++b) fr.f1[b] = e1[b] * fr.r1;
  const double cz[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                        e1[2] * e2[0] - e1[0] * e2[2],
                        e1[0] * e2[1] - e1[1] * e2[0]};
  fr.r2 = rsqrt(cz[0] * cz[0] + cz[1] * cz[1] + cz[2] * cz[2] + eps);
  for (int b = 0; b < 3; ++b) fr.f2[b] = cz[b] * fr.r2;
  const double* f1 = fr.f1;
  const double* f2 = fr.f2;
  fr.f3[0] = f1[1] * f2[2] - f1[2] * f2[1];
  fr.f3[1] = f1[2] * f2[0] - f1[0] * f2[2];
  fr.f3[2] = f1[0] * f2[1] - f1[1] * f2[0];
}

__device__ void marker_position(const Frame& fr, const double v0[3],
                                const float cf[3], float sim[3]) {
  const double c1 = cf[0], c2 = cf[1], c3 = cf[2];
  for (int b = 0; b < 3; ++b)
    sim[b] = static_cast<float>(v0[b] + c1 * fr.f1[b] + c2 * fr.f2[b] +
                                c3 * fr.f3[b]);
}

// One of the two vertex blocks of the marker position's derivative:
// h = 0 gives d1 = d sim / d v1, h = 1 gives d2 = d sim / d v2 (each 3x3,
// [c][d]); d sim / d v0 = I - d1 - d2.
__device__ void frame_block(const Frame& fr, const float cf[3], int h,
                            double d[9]) {
  const double* e1 = fr.e1;
  const double* e2 = fr.e2;
  const double* f1 = fr.f1;
  const double* f2 = fr.f2;
  const double c1 = cf[0], c2 = cf[1], c3 = cf[2];
  double M1[9], M2[9], C[9], S1[9], A[9], B[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      M1[a * 3 + b] = ((a == b ? 1.0 : 0.0) - f1[a] * f1[b]) * fr.r1;
      M2[a * 3 + b] = ((a == b ? 1.0 : 0.0) - f2[a] * f2[b]) * fr.r2;
    }
  if (h == 0) {
    // C1 = -[e2]x (d cz / d e1)
    C[0] = 0.0;    C[1] = e2[2];  C[2] = -e2[1];
    C[3] = -e2[2]; C[4] = 0.0;    C[5] = e2[0];
    C[6] = e2[1];  C[7] = -e2[0]; C[8] = 0.0;
  } else {
    // C2 = [e1]x (d cz / d e2)
    C[0] = 0.0;    C[1] = -e1[2]; C[2] = e1[1];
    C[3] = e1[2];  C[4] = 0.0;    C[5] = -e1[0];
    C[6] = -e1[1]; C[7] = e1[0];  C[8] = 0.0;
  }
  // S1 = [f1]x
  S1[0] = 0.0;    S1[1] = -f1[2]; S1[2] = f1[1];
  S1[3] = f1[2];  S1[4] = 0.0;    S1[5] = -f1[0];
  S1[6] = -f1[1]; S1[7] = f1[0];  S1[8] = 0.0;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      double x = 0.0;
      for (int k = 0; k < 3; ++k) x += M2[a * 3 + k] * C[k * 3 + b];
      A[a * 3 + b] = x;
    }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      double x = 0.0;
      for (int k = 0; k < 3; ++k) x += S1[a * 3 + k] * A[k * 3 + b];
      B[a * 3 + b] = x;
    }
  if (h == 0) {
    // N1 = [f2]x M1
    double N1[9];
    const double S2[9] = {0.0, -f2[2], f2[1], f2[2], 0.0, -f2[0],
                          -f2[1], f2[0], 0.0};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double x = 0.0;
        for (int k = 0; k < 3; ++k) x += S2[a * 3 + k] * M1[k * 3 + b];
        N1[a * 3 + b] = x;
      }
    for (int i = 0; i < 9; ++i)
      d[i] = c1 * M1[i] + c2 * A[i] + c3 * (B[i] - N1[i]);
  } else {
    for (int i = 0; i < 9; ++i) d[i] = c2 * A[i] + c3 * B[i];
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
                   const float* __restrict__ pdt,
                   const double* __restrict__ pd64,
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
                   const float* __restrict__ wrow, int frames_per_block,
                   int nblk) {
  static_assert(!(EXT && TILED), "one extras route at a time");
  static_assert(!FOLD || WITH_JAC, "the weights fold into the Jacobian rows");
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_anc[64];
  __shared__ unsigned char s_nzj[kTM * 3][64];   // nonzero-weight joints
  __shared__ int s_nzc[kTM * 3];
  __shared__ unsigned short s_items[kTM * 64];   // phase 3's (mi, j) order
  __shared__ int s_nanc;   // ancestor items' first position << 16 | count
  const int J3 = 3 * J;
  const int nhand = J3 - body_dof;   // full-pose hand columns
  const int Ex = EXT ? E : 0;
  const int Jm1 = J - 1;             // a posedirs row: 9 blocks of J - 1
  // hand-PCA blocks: rows d of block b are b * nd + [0, nd), its full-pose
  // columns b * nh + [0, nh)
  const int nh = nhand / nblk, nd = hand_dof / nblk, nd4 = round4(nd);
  const Layout L(WITH_JAC, J, featN, Ex, nhand,
                 hand_block_floats(hand_dof, nhand, nblk));
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
  float* s_wrot = smem + L.wrot;
  float* s_wtr = smem + L.wtr;
  float* s_dr = smem + L.dr;
  float* s_vp = smem + L.vp;
  float* s_Trot = smem + L.Trot;
  float* s_dms = smem + L.dms;
  float* s_Q = smem + L.Q;
  float* s_Uh = smem + L.Uh;
  double* s_featT = reinterpret_cast<double*>(smem + L.featT);
  float* s_Je = smem + L.Je;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m0 = static_cast<int>(blockIdx.y) * kTM;
  const int nm = min(kTM, M - m0);
  const int f_begin = static_cast<int>(blockIdx.x) * frames_per_block;
  const int f_end = min(F, f_begin + frames_per_block);

  // a tile's joint quantities, queued as one cp.async group
  auto load_tile = [&](int f0) {
    const int nf = min(kTF, f_end - f0);
    const size_t fJ = static_cast<size_t>(f0) * J;
    stage(s_grot, grot + fJ * 9, nf * 9 * J);
    stage(s_atr, atr + fJ * 3, nf * 3 * J);
    stage(s_feat, feat + static_cast<size_t>(f0) * featN, nf * featN);
    if constexpr (EXT) stage(s_ex, extra + static_cast<size_t>(f0) * E, nf * E);
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
  if constexpr (EXT)
    stage(s_dv, dv + static_cast<size_t>(m0) * 9 * E, nm * 9 * E);
  if (WITH_JAC) {
    for (int i = tid; i < J; i += blockDim.x) s_anc[i] = ancmask[i];
    // the hand blocks transposed, [b][h][d], d padded to nd4 with zeros
    for (int i = tid; i < nblk * nh * nd4 && hand_dof; i += blockDim.x) {
      const int d = i % nd4, bh = i / nd4, b = bh / nh, h = bh % nh;
      const size_t at = static_cast<size_t>(b * nd + d) * nhand + b * nh + h;
      s_hcT[i] = d < nd ? hc[at] : 0.f;
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
  // phase 3's (marker, joint) items in the order the threads take them:
  // those with an ancestor part (a vertex weighted below the joint: s != 0)
  // packed into whole warps of threads that take no second item, the rest
  // around them
  if (WITH_JAC && warp == nwarps - 1) {
    // lanes take (item, frame) pairs: the threads with the fewest rounds
    // start at lane x, ancestor items from the next whole warp
    const int nitem = nm * J, lanes = nitem * kTF;
    const int rounds = (lanes + kThreads - 1) / kThreads;
    const int x = (lanes - (rounds - 1) * kThreads + 31) / 32 * 32;
    const int a0 = rounds > 1 && x < kThreads ? x / kTF : 0;
    int pos[2] = {a0, 0};   // next ancestor item, next other item
    int na = 0;
    for (int mi = 0; mi < nm; ++mi) {
      const float* sr = s3 + mJ3 + static_cast<size_t>(mi) * J3;
      for (int jb = 0; jb < J; jb += 32) {
        const int j = jb + lane;
        const bool anc = j < J && (sr[j] != 0.f || sr[J + j] != 0.f ||
                                   sr[2 * J + j] != 0.f);
        na += __popc(__ballot_sync(0xffffffffu, anc));
      }
    }
    for (int mi = 0; mi < nm; ++mi) {
      const float* sr = s3 + mJ3 + static_cast<size_t>(mi) * J3;
      for (int jb = 0; jb < J; jb += 32) {
        const int j = jb + lane;
        const bool anc = j < J && (sr[j] != 0.f || sr[J + j] != 0.f ||
                                   sr[2 * J + j] != 0.f);
        for (int side = 0; side < 2; ++side) {
          const bool take = j < J && anc == (side == 0);
          const unsigned b = __ballot_sync(0xffffffffu, take);
          // the other items skip the ancestor items' span
          int at = pos[side] + __popc(b & ((1u << lane) - 1u));
          if (side == 1 && at >= a0) at += na;
          if (take) s_items[at] = static_cast<unsigned short>(mi * 64 + j);
          pos[side] += __popc(b);
        }
      }
    }
    if (lane == 0) s_nanc = a0 * 65536 + na;
  }
  load_tile(f_begin);

  for (int f0 = f_begin; f0 < f_end; f0 += kTF) {
    const int nf = min(kTF, f_end - f0);
    cp_async_wait_all();
    __syncthreads();

    // ---- 1. weighted transforms T_rot, T_tr and pose blend vp --------------
    // T_rot (9) and T_tr (3) of each (pair, vertex, entry), float64
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
    // the tile's features in float64, feature p = 9 jj + ab at x = ab Jm1 +
    // jj, the order of a `pdt` row
    for (int fi = 0; fi < nf; ++fi)
      for (int p = tid; p < featN; p += blockDim.x)
        s_featT[fi * featN + (p % 9) * Jm1 + p / 9] =
            static_cast<double>(s_feat[fi * featN + p]);
    __syncthreads();
    // one warp a marker: its 9 posedirs rows x kTF frames a lane, streamed,
    // then reduce-scattered over the warp
    static_assert(kTF == 2, "the reduce-scatter takes 9 rows x 2 frames");
    for (int mi = warp; mi < nm; mi += nwarps) {
      const double* pdr = pd64 + static_cast<size_t>(m0 + mi) * 9 * featN;
      double acc[18];   // [fi * 9 + k * 3 + c]
#pragma unroll
      for (int i = 0; i < 18; ++i) acc[i] = 0.0;
#pragma unroll(WITH_JAC ? 2 : 1)
      for (int x = lane; x < featN; x += 32) {
        const double f0v = s_featT[x], f1v = s_featT[featN + x];
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          const double a = __ldg(pdr + r * featN + x);
          acc[r] += a * f0v;
          acc[9 + r] += a * f1v;
        }
      }
      int idx;
      const double sum = warp_scatter18(acc, lane, idx);
      {
        const int fi = idx / 9, r = idx % 9, k = r / 3, c = r % 3;
        if (idx < 18 && fi < nf) {
          const int f = f0 + fi, q = fi * kTM + mi;
          double a = sum;
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
    }
    __syncthreads();
    if (!WITH_JAC && f0 + kTF < f_end) load_tile(f0 + kTF);

    // ---- 2. the markers from their frame vertices --------------------------
    // the tile's pairs, two threads a pair with the Jacobian (one without);
    // whole warps take part, the lanes of absent pairs on the staged data
    // of present ones, and write nothing
    const int per = WITH_JAC ? 2 : 1;
    for (int t = tid; t < per * kPairs; t += blockDim.x) {
      const int q = t / per, h = t % per;
      int fi = q / kTM, mi = q % kTM;
      const bool ok = fi < nf && mi < nm;
      const int qq = ok ? q : 0;     // pair 0 is always present
      if (!ok) fi = 0, mi = 0;
      const int f = f0 + fi;
      const double* Td = s_Td + qq * 36;
      const double* vpd = s_vpd + qq * 9;
      double v[3][3];
      for (int k = 0; k < 3; ++k)
        for (int b = 0; b < 3; ++b)
          v[k][b] = Td[k * 12 + b * 3] * vpd[k * 3] +
                    Td[k * 12 + b * 3 + 1] * vpd[k * 3 + 1] +
                    Td[k * 12 + b * 3 + 2] * vpd[k * 3 + 2] +
                    Td[k * 12 + 9 + b] + static_cast<double>(trans[f * 3 + b]);
      Frame fr;
      frame_axes(v, fr);
      const size_t fm = static_cast<size_t>(f) * M + m0 + mi;
      if (h == 0 && ok) {
        float out[3];
        marker_position(fr, v[0], s_cf + mi * 3, out);
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
      if constexpr (WITH_JAC) {
        double d[9];
        frame_block(fr, s_cf + mi * 3, h, d);
        // this thread's vertex blocks: k = 0, 1 (h = 0) or 2 (h = 1)
        float dk[2][9];
        const int k0 = h == 0 ? 0 : 2, nk = h == 0 ? 2 : 1;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const double o = __shfl_xor_sync(0xffffffffu, d[i], 1);
          const double d1 = h == 0 ? d[i] : o, d2 = h == 0 ? o : d[i];
          const double d0 = (i % 4 == 0 ? 1.0 : 0.0) - d1 - d2;
          dk[0][i] = static_cast<float>(h == 0 ? d0 : d2);
          dk[1][i] = static_cast<float>(d1);
        }
        if (ok) {
          const float w = weight<FOLD>(wrow, fm);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (kk >= nk) continue;
            const int k = k0 + kk;
            const float* Tk = s_Trot + q * 27 + k * 9;
            for (int i = 0; i < 9; ++i) s_dms[q * 27 + k * 9 + i] = dk[kk][i];
            // Q_k[c'][c] = sum_a dms_k[c'][a] T_rot_k[a][c]
            for (int c = 0; c < 3; ++c)
              for (int cp = 0; cp < 3; ++cp) {
                const float x = dk[kk][cp * 3] * Tk[c] +
                                dk[kk][cp * 3 + 1] * Tk[3 + c] +
                                dk[kk][cp * 3 + 2] * Tk[6 + c];
                s_Q[(q * 9 + k * 3 + c) * 4 + cp] = x;
                if constexpr (TILED)
                  uv[fm * 54 + 27 + k * 9 + cp * 3 + c] = weighted<FOLD>(x, w);
              }
            if constexpr (TILED)
              for (int i = 0; i < 9; ++i)
                uv[fm * 54 + k * 9 + i] = weighted<FOLD>(dk[kk][i], w);
          }
        }
      }
    }
    if constexpr (EXT && WITH_JAC) {
      // vertex columns Je[q][e][k][a] = sum_j w[k][j] datr[e][j][a]
      // + sum_c T_rot[k][a][c] dv[k][e][c], from the block's far end (datr
      // from global memory: a few entries an item, so that shared memory
      // leaves L1 room for the posedirs rows)
      for (int it = blockDim.x - 1 - tid; it < kPairs * 9 * E;
           it += blockDim.x) {
        const int q = it / (9 * E), rem = it % (9 * E);
        const int e = rem / 9, k = (rem / 3) % 3, a = rem % 3;
        const int fi = q / kTM, mi = q % kTM;
        if (fi >= nf || mi >= nm) continue;
        const int r = mi * 3 + k;
        float acc = 0.f;
        for (int n = 0; n < s_nzc[r]; ++n) {
          const int j = s_nzj[r][n];
          const size_t at =
              ((static_cast<size_t>(f0 + fi) * E + e) * J + j) * 3 + a;
          acc = fmaf(s_w[r * J + j], __ldg(datr + at), acc);
        }
        const float* Tr = s_Trot + q * 27 + k * 9 + a * 3;
        const float* dk = s_dv + ((mi * 3 + k) * E + e) * 3;
        s_Je[q * 9 * E + rem] = acc + Tr[0] * dk[0] + Tr[1] * dk[1] + Tr[2] * dk[2];
      }
    }
    if constexpr (WITH_JAC) {
      __syncthreads();

      // ---- 3. full-pose columns, one (marker, joint, frame) a thread --------
      // the two frames of a (marker, joint) on neighbouring lanes, whose
      // posedirs loads are one request
      const int a_lo = s_nanc >> 16, a_hi = a_lo + (s_nanc & 65535);
      for (int it = tid; it < nm * J * kTF; it += blockDim.x) {
        const int ii = it / kTF, fi = it % kTF;
        const int mi = s_items[ii] >> 6, j = s_items[ii] & 63;
        const bool anc = ii >= a_lo && ii < a_hi;
        const bool live = fi < nf;
        const int m = m0 + mi, q = fi * kTM + mi;
        float U[3][3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int t = 0; t < 3; ++t) U[c][t] = 0.f;
        // ancestor part: dms_k (Wrot S + s Wtr) for the vertices with a
        // weighted joint below j (s = 0 and S = 0 for the others); the
        // frame's Wrot, Wtr of j read once for the three vertices
        if (anc && live) {
          const unsigned long long jbit = 1ull << j;
          const float* g = s_grot + fi * 9 * J;
          const float* at = s_atr + fi * 3 * J;
          float wr[27], wt[9];
#pragma unroll
          for (int i = 0; i < 27; ++i) wr[i] = s_wrot[(fi * J + j) * 27 + i];
#pragma unroll
          for (int i = 0; i < 9; ++i) wt[i] = s_wtr[(fi * J + j) * 9 + i];
          for (int k = 0; k < 3; ++k) {
            const int r = mi * 3 + k;
            const float sk = s_s[r * J + j];
            if (sk == 0.f) continue;
            const float* vk = s_vp + q * 9 + k * 3;
            // S = sum over the vertex's weighted joints below j of w z
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
            const float* dk = s_dms + q * 27 + k * 9;
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              float Jf[3];
#pragma unroll
              for (int a = 0; a < 3; ++a)
                Jf[a] = wr[(a * 3 + 0) * 3 + t] * S0 + wr[(a * 3 + 1) * 3 + t] * S1 +
                        wr[(a * 3 + 2) * 3 + t] * S2 + sk * wt[a * 3 + t];
#pragma unroll
              for (int c = 0; c < 3; ++c)
                U[c][t] += dk[c * 3] * Jf[0] + dk[c * 3 + 1] * Jf[1] +
                           dk[c * 3 + 2] * Jf[2];
            }
          }
        }
        // blend part: sum_{k,c} Q_kc dvp_kc, dvp_kc[t] = sum_ab
        // posedirs[k][c][j-1, ab] dr[j][ab][t], the 9 posedirs loads of a
        // (k, c) issued ahead of the products that use them
        if (j >= 1 && featN > 0) {
          float drj[27];
#pragma unroll
          for (int i = 0; i < 27; ++i)
            drj[i] = live ? s_dr[(fi * J + j) * 27 + i] : 0.f;
          const float* pt = pdt + static_cast<size_t>(m) * 9 * featN + (j - 1);
          const float4* qrow = reinterpret_cast<const float4*>(s_Q) + q * 9;
#pragma unroll 3
          for (int kc = 0; kc < 9; ++kc) {
            float pv[9];
#pragma unroll
            for (int ab = 0; ab < 9; ++ab)
              pv[ab] = __ldg(pt + kc * featN + ab * Jm1);
            float dvp[3];
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              float acc = 0.f;
#pragma unroll
              for (int ab = 0; ab < 9; ++ab) acc += pv[ab] * drj[ab * 3 + t];
              dvp[t] = acc;
            }
            const float4 qc = qrow[kc];
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              U[0][t] += qc.x * dvp[t];
              U[1][t] += qc.y * dvp[t];
              U[2][t] += qc.z * dvp[t];
            }
          }
        }
        // body columns to jm, hand columns to the hand-PCA phase
        if (live) {
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
      __syncthreads();
      if (f0 + kTF < f_end) load_tile(f0 + kTF);

      // ---- 4. hand-PCA chain, trans identity and inline extra columns ---------
      // kHandCols components of the three rows of one pair a thread, over
      // its hand block's nh full-pose columns
      const int ngrp = (nd + kHandCols - 1) / kHandCols;
      const int nitem = hand_dof > 0 ? kPairs * nblk * ngrp : 0;
      for (int it = tid; it < nitem; it += blockDim.x) {
        const int q = it / (nblk * ngrp), bg = it % (nblk * ngrp);
        const int b = bg / ngrp, d0 = (bg % ngrp) * kHandCols;
        const int fi = q / kTM, mi = q % kTM;
        if (fi >= nf || mi >= nm) continue;
        const float* u = s_Uh + q * 3 * nhand + b * nh;
        const float4* hb =
            reinterpret_cast<const float4*>(s_hcT + b * nh * nd4 + d0);
        const int stride4 = nd4 / 4;
        float v[3][kHandCols];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int x = 0; x < kHandCols; ++x) v[c][x] = 0.f;
        for (int h = 0; h < nh; ++h) {
          const float4 c4 = hb[h * stride4];
          const float hx[kHandCols] = {c4.x, c4.y, c4.z, c4.w};
          const float u0 = u[h], u1 = u[nhand + h], u2 = u[2 * nhand + h];
#pragma unroll
          for (int x = 0; x < kHandCols; ++x) {
            v[0][x] = fmaf(hx[x], u0, v[0][x]);
            v[1][x] = fmaf(hx[x], u1, v[1][x]);
            v[2][x] = fmaf(hx[x], u2, v[2][x]);
          }
        }
        const size_t fm = static_cast<size_t>(f0 + fi) * M + m0 + mi;
        float* row = jm + fm * 3 * D + 3 + body_dof + b * nd + d0;
        const float w = weight<FOLD>(wrow, fm);
        const int nx = min(kHandCols, nd - d0);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int x = 0; x < kHandCols; ++x)
            if (x < nx) row[c * D + x] = weighted<FOLD>(v[c][x], w);
      }
      // the trans identity and the inline extra columns UE[c][e] =
      // sum_k sum_d dms[k][c][d] Je[e][k][d], from the far end
      for (int it = blockDim.x - 1 - tid; it < kPairs * (3 + Ex);
           it += blockDim.x) {
        const int q = it / (3 + Ex), x = it % (3 + Ex);
        const int fi = q / kTM, mi = q % kTM;
        if (fi >= nf || mi >= nm) continue;
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
          for (int c = 0; c < 3; ++c) {
            float acc = 0.f;
            for (int k = 0; k < 3; ++k) {
              const float* dk = s_dms + q * 27 + k * 9 + c * 3;
              const float* je = s_Je + q * 9 * E + (e * 3 + k) * 3;
              acc += dk[0] * je[0] + dk[1] * je[1] + dk[2] * je[2];
            }
            row[c * D + D - Ex + e] = weighted<FOLD>(acc, w);
          }
        }
      }
    }
  }
}

size_t smem_bytes(bool with_jac, int J, int featN, int body_dof, int hand_dof,
                  int E, int nblk) {
  const int nhand = 3 * J - body_dof;
  return static_cast<size_t>(Layout(with_jac, J, featN, E, nhand,
                                    hand_block_floats(hand_dof, nhand, nblk))
                                 .total) *
         sizeof(float);
}

template <bool EXT, bool TILED, bool FOLD>
cudaError_t launch(bool with_jac, cudaStream_t s, int F, int M, int J,
                   int featN, int body_dof, int hand_dof, int D,
                   const float* grot, const float* atr, const float* feat,
                   const float* wrot, const float* wtr, const float* dr,
                   const float* trans, const float* w3, const float* s3,
                   const float* vsh3, const float* pdt, const double* pd64,
                   const float* cf, const unsigned long long* ancmask,
                   const float* hc,
                   float* sim, float* jm, int E, const float* extra,
                   const float* datr, const float* dv, const float* vpshift,
                   float* uv, const float* obs, const float* wrow,
                   int frames_per_block, int nblk) {
  // frame ranges fastest: blocks resident on one SM tend to share a marker
  // tile, whose posedirs rows then stay in L1
  const dim3 grid((F + frames_per_block - 1) / frames_per_block,
                  (M + kTM - 1) / kTM);
  const size_t bytes =
      smem_bytes(with_jac, J, featN, body_dof, hand_dof, EXT ? E : 0, nblk);
  cudaError_t err;
  if (with_jac) {
    err = allow_smem(marker_rows_kernel<true, EXT, TILED, FOLD>, bytes);
    if (err != cudaSuccess) return err;
    marker_rows_kernel<true, EXT, TILED, FOLD><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, hand_dof, D, grot, atr, feat, wrot, wtr, dr,
        trans, w3, s3, vsh3, pdt, pd64, cf, ancmask, hc, sim, jm, E, extra,
        datr, dv, vpshift, uv, obs, wrow, frames_per_block, nblk);
  } else if constexpr (FOLD) {
    return cudaErrorInvalidValue;
  } else {
    err = allow_smem(marker_rows_kernel<false, EXT, TILED, false>, bytes);
    if (err != cudaSuccess) return err;
    marker_rows_kernel<false, EXT, TILED, false><<<grid, kThreads, bytes, s>>>(
        F, M, J, featN, body_dof, hand_dof, D, grot, atr, feat, nullptr,
        nullptr, nullptr, trans, w3, nullptr, vsh3, pdt, pd64, cf, nullptr,
        nullptr, sim, nullptr, E, extra, nullptr, dv, vpshift, nullptr,
        nullptr, nullptr, frames_per_block, nblk);
  }
  return cudaGetLastError();
}

// The widths every launcher checks: the posedirs rows 9 (J - 1) wide or
// absent, the hand blocks dividing the hand dofs and columns.
bool widths_ok(int F, int M, int J, int featN, int body_dof, int hand_dof,
               int frames_per_block, int nblk) {
  const int nhand = 3 * J - body_dof;
  return F >= 1 && M >= 1 && M <= 65535 * kTM && J >= 1 && J <= 64 &&
         (featN == 0 || featN == 9 * (J - 1)) && frames_per_block >= 1 &&
         nblk >= 1 && nhand >= 0 && hand_dof % nblk == 0 &&
         nhand % nblk == 0;
}

// The inline routes (E = 0 or E <= 16 extras); FOLD also takes obs and w.
template <bool FOLD>
int rows_launch(bool with_jac, int F, int M, int J, int featN, int body_dof,
                int hand_dof, int D, const float* grot, const float* atr,
                const float* feat, const float* wrot, const float* wtr,
                const float* dr, const float* trans, const float* w3,
                const float* s3, const float* vsh3, const float* pdt,
                const double* pd64, const float* cf,
                const unsigned long long* ancmask, const float* hc,
                float* sim, float* jm, int E,
                const float* extra, const float* datr, const float* dv,
                const float* obs, const float* wrow, int frames_per_block,
                int nblk, void* stream) {
  if (!widths_ok(F, M, J, featN, body_dof, hand_dof, frames_per_block, nblk) ||
      E < 0 || E > kMaxExtra || D != 3 + body_dof + hand_dof + E ||
      (FOLD && (obs == nullptr || wrow == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      E > 0 ? launch<true, false, FOLD>(with_jac, s, F, M, J, featN,
                                        body_dof, hand_dof, D, grot, atr, feat,
                                        wrot, wtr, dr, trans, w3, s3, vsh3,
                                        pdt, pd64, cf, ancmask, hc, sim, jm, E,
                                        extra, datr, dv, nullptr, nullptr,
                                        obs, wrow, frames_per_block, nblk)
            : launch<false, false, FOLD>(with_jac, s, F, M, J, featN,
                                         body_dof, hand_dof, D, grot, atr, feat,
                                         wrot, wtr, dr, trans, w3, s3, vsh3,
                                         pdt, pd64, cf, ancmask, hc, sim, jm, 0,
                                         nullptr, nullptr, nullptr, nullptr,
                                         nullptr, obs, wrow, frames_per_block,
                                         nblk);
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
                 const float* pdt, const double* pd64, const float* cf,
                 const unsigned long long* ancmask, const float* hc,
                 const float* vpshift, float* sim, float* jm, float* uv,
                 const float* obs, const float* wrow, int frames_per_block,
                 int nblk, void* stream) {
  if (!widths_ok(F, M, J, featN, body_dof, hand_dof, frames_per_block, nblk) ||
      E < 1 || D != 3 + body_dof + hand_dof + E ||
      (FOLD && (obs == nullptr || wrow == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false, true, FOLD>(
      with_jac, static_cast<cudaStream_t>(stream), F, M, J, featN, body_dof,
      hand_dof, D, grot, atr, feat, wrot, wtr, dr, trans, w3, s3, vsh3,
      pdt, pd64, cf, ancmask, hc, sim, jm, E, nullptr, nullptr, nullptr,
      vpshift, uv, obs, wrow, frames_per_block, nblk));
}

}  // namespace

// The program's tile: markers a block and frames a tile (the wrapper's
// frames-a-block rule, ops/marker_jac.rows_frames_per_block, mirrors them).
extern "C" int marker_rows_tile(int* markers, int* frames) {
  *markers = kTM;
  *frames = kTF;
  return kThreads;
}

// Blocks an SM of one instantiation (route 0 none, 1 inline extras, 2
// tiled) at these widths with `hand_blocks` hand-PCA blocks, and its shared
// memory a block (dynamic and static); 0 for a combination there is no
// kernel of.
extern "C" int marker_rows_occupancy(int with_jac, int route, int fold,
                                     int J, int featN, int body_dof,
                                     int hand_dof, int E, int hand_blocks,
                                     int* smem_bytes_out) {
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
  if (fn == nullptr || hand_blocks < 1 ||
      cudaFuncGetAttributes(&a, fn) != cudaSuccess)
    return 0;
  const size_t bytes = smem_bytes(jac, J, featN, body_dof, hand_dof,
                                  route == 1 ? E : 0, hand_blocks);
  *smem_bytes_out = static_cast<int>(bytes + a.sharedSizeBytes);
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
    const float* w3, const float* s3, const float* vsh3, const float* pdt,
    const double* pd64, const float* cf, const unsigned long long* ancmask,
    const float* hc, float* sim, float* jm, int E, const float* extra,
    const float* datr, const float* dv, int frames_per_block, int hand_blocks,
    void* stream) {
  return rows_launch<false>(with_jac != 0, F, M, J, featN, body_dof, hand_dof,
                            D, grot, atr, feat, wrot, wtr, dr, trans, w3, s3,
                            vsh3, pdt, pd64, cf, ancmask, hc, sim, jm, E, extra,
                            datr, dv, nullptr, nullptr, frames_per_block,
                            hand_blocks, stream);
}

// FOLD: obs (F, M, 3) and w (F, M) in; rw (F, M, 3) and jw (F, M, 3, D) out.
extern "C" int marker_rows_fold_launch(
    int F, int M, int J, int featN, int body_dof, int hand_dof, int D,
    const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pdt,
    const double* pd64, const float* cf, const unsigned long long* ancmask,
    const float* hc, float* rw, float* jw, int E, const float* extra,
    const float* datr, const float* dv, const float* obs, const float* wrow,
    int frames_per_block, int hand_blocks, void* stream) {
  return rows_launch<true>(true, F, M, J, featN, body_dof, hand_dof, D, grot,
                           atr, feat, wrot, wtr, dr, trans, w3, s3, vsh3, pdt,
                           pd64, cf, ancmask, hc, rw, jw, E, extra, datr, dv,
                           obs, wrow, frames_per_block, hand_blocks, stream);
}

extern "C" int marker_rows_tiled_launch(
    int with_jac, int F, int M, int J, int featN, int body_dof, int hand_dof,
    int D, int E, const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pdt,
    const double* pd64, const float* cf, const unsigned long long* ancmask,
    const float* hc, const float* vpshift, float* sim, float* jm, float* uv,
    int frames_per_block, int hand_blocks, void* stream) {
  return tiled_launch<false>(with_jac != 0, F, M, J, featN, body_dof,
                             hand_dof, D, E, grot, atr, feat, wrot, wtr, dr,
                             trans, w3, s3, vsh3, pdt, pd64, cf, ancmask, hc,
                             vpshift, sim, jm, uv, nullptr, nullptr,
                             frames_per_block, hand_blocks, stream);
}

// The tiled route with FOLD: rw, jw's first D - E columns and the weighted
// uv out.
extern "C" int marker_rows_tiled_fold_launch(
    int F, int M, int J, int featN, int body_dof, int hand_dof, int D, int E,
    const float* grot, const float* atr, const float* feat,
    const float* wrot, const float* wtr, const float* dr, const float* trans,
    const float* w3, const float* s3, const float* vsh3, const float* pdt,
    const double* pd64, const float* cf, const unsigned long long* ancmask,
    const float* hc, const float* vpshift, float* rw, float* jw, float* uv,
    const float* obs, const float* wrow, int frames_per_block, int hand_blocks,
    void* stream) {
  return tiled_launch<true>(true, F, M, J, featN, body_dof, hand_dof, D, E,
                            grot, atr, feat, wrot, wtr, dr, trans, w3, s3,
                            vsh3, pdt, pd64, cf, ancmask, hc, vpshift, rw, jw,
                            uv, obs, wrow, frames_per_block, hand_blocks,
                            stream);
}
