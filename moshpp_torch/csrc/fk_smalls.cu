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
// and sum_e x_e djnt_e to its rest joint. With the Jacobian it also emits
// datr[f][e][j] = dA_tr_j/dx_e = S_e[j] - G_rot[j] djnt_e[j], S being the
// scan down the tree S_e[j] = S_e[parent(j)] + Q_j dtrel_e[j] (as
// extras_tangent.cu sums it; the TPU kernel takes the chain sum as one
// (J, J) mask product).
//
// With TILED (the tiled extras route, any E) the wrapper has already summed
// the shifts: jshift[f] = [sum_e x_e dtrel_e; sum_e x_e djnt_e] (2, J, 3),
// two matmuls, so this program has no E loop and is the same at every E.
// With the Jacobian it emits Q (F, J, 3, 3) for extras_tangent.cu, which
// computes datr, in place of datr.
// The E = 0 instantiations carry none of this code.
//
// What bounds it: writes. A frame writes 21 floats a joint without the
// Jacobian (grot 9, atr 3, feat 9) and 84 with it (wrot 27, wtr 9, dr 27
// more): 17.4 KB a frame and 71.4 MB a call at J=52, F=4096; with EXT and
// the Jacobian 3E more (datr), with TILED and the Jacobian 9 more (q); the
// arithmetic is about a thousand flops a joint. The first design (a thread a
// (frame, joint) storing its own records at strides of 12-108 bytes, so that
// every warp store touched ~32 sectors, and a tree walk of one block-wide
// barrier a depth level) ran at 4-11x that bound. Here:
//   - a block takes nf consecutive frames (1-4, ops/marker_jac's
//     fk_frames_per_block), a thread each (frame, joint), packed without
//     idle lanes between frames;
//   - each thread writes its records into shared memory in the global
//     layout of the block's frames (strides of 27, 9 and 3 floats: no bank
//     conflicts), each output region shifted to share its destination's
//     alignment; after one barrier the block writes each output's
//     contiguous range with 16-byte stores (scalar ones at the ragged ends);
//   - the tree walk has no barrier: after the local transforms are in
//     shared memory, each thread composes its own root path, the ancestors
//     in index order (parents precede children), with the same products in
//     the same order as a walk level by level, so G is bit for bit the
//     first design's; the walk leaves Q and b (the parent's transform) in
//     registers, and with EXT the scan's sums S_e along the same path;
//   - with EXT the block first copies dtrel and djnt into shared memory at
//     an odd row stride (read through L1 at a lane stride of 3E floats,
//     every warp load touched a sector a lane), and the frames a block are
//     4 at every F, so that the copy serves 4 frames.
// On that card (PERF.md §6) `<jac>` and `<jac,tiled>` run at 1.5-1.6x
// the bound, held by residency: 20-23 KB of staging a frame allow ~10
// frames an SM; `<jac,ext>` at 2.4x, held to 2 blocks an SM by 128
// registers and 110 KB a block; the `<sim,..>` twins at 1.8-2.9x, where
// ~4.5 us of launch and one block's chain of latencies (the F=128 time)
// add to ~8.5 us of writes at F=4096.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kMaxJ = 64;
constexpr int kMaxThreads = 256;  // a block: nf * J threads, rounded to warps
constexpr int kMaxFrames = 4;     // frames a block
constexpr int kMaxExtra = 16;
constexpr int kLocal = 12;        // floats a joint of a local transform: R, t

// Outputs in staging order; the last is q (TILED) or datr (EXT).
enum { kGrot, kAtr, kFeat, kWrot, kWtr, kDr, kSide, kMaxOuts };

__host__ __device__ constexpr int n_outs(bool jac, bool side) {
  return jac ? (side ? 7 : 6) : 3;
}

// Floats of output o a frame (E > 0: the side output is datr).
__host__ __device__ inline int frame_width(int o, int J, int E) {
  switch (o) {
    case kGrot: return 9 * J;
    case kAtr: return 3 * J;
    case kFeat: return 9 * (J - 1);
    case kWrot: return 27 * J;
    case kWtr: return 9 * J;
    case kDr: return 27 * J;
    default: return E > 0 ? 3 * E * J : 9 * J;
  }
}

// Row stride of the staged extra-direction tables: 3E floats made odd, so
// that lanes on consecutive joints read distinct banks.
__host__ __device__ inline int ext_stride(int E) { return (3 * E) | 1; }

// Floats of dynamic shared memory a block: the local transforms
// [nf * J][12]; with E > 0 (EXT) dtrel and djnt [J][ext_stride]; then one
// region an output, 16-byte aligned, with 3 floats of room for the shift to
// its destination's alignment (the kernel computes the same offsets).
int smem_floats(int outs, int nf, int J, int E) {
  int at = nf * J * kLocal + (E > 0 ? 2 * round4(J * ext_stride(E)) : 0);
  for (int o = 0; o < outs; ++o) at += round4(nf * frame_width(o, J, E) + 3);
  return at;
}

struct Outs {
  float* p[kMaxOuts];
};

__device__ __forceinline__ void load_local(const float* L, float R[9],
                                           float t[3]) {
  const float4 a = *reinterpret_cast<const float4*>(L);
  const float4 b = *reinterpret_cast<const float4*>(L + 4);
  const float4 c = *reinterpret_cast<const float4*>(L + 8);
  R[0] = a.x; R[1] = a.y; R[2] = a.z; R[3] = a.w;
  R[4] = b.x; R[5] = b.y; R[6] = b.z; R[7] = b.w;
  R[8] = c.x; t[0] = c.y; t[1] = c.z; t[2] = c.w;
}

// The block writes n floats to dst from shared src, where src[shift + i]
// holds dst[i] and shift is dst's misalignment in floats: a scalar head,
// 16-byte stores, a scalar tail.
__device__ __forceinline__ void store_out(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n, int shift) {
  const int t = threadIdx.x;
  const int head = min((4 - shift) & 3, n);
  const int body = (n - head) >> 2;
  src += shift;
  if (t < head) dst[t] = src[t];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int v = t; v < body; v += blockDim.x) d4[v] = s4[v];
  const int tail = head + 4 * body + t;
  if (tail < n) dst[tail] = src[tail];
}

template <bool WITH_JAC, bool EXT, bool TILED>
__global__ void __launch_bounds__(kMaxThreads)
fk_smalls_kernel(const float* __restrict__ theta,
                 const unsigned long long* __restrict__ ancmask,
                 const float* __restrict__ jnts,
                 const float* __restrict__ trel, int F, int J, int nf,
                 Outs out, int E, const float* __restrict__ extra,
                 const float* __restrict__ djnt,
                 const float* __restrict__ dtrel,
                 const float* __restrict__ jshift) {
  static_assert(!(EXT && TILED), "one extras route at a time");
  constexpr int kOuts = n_outs(WITH_JAC, EXT || TILED);
  extern __shared__ __align__(16) float smem[];
  const int f0 = blockIdx.x * nf;
  const int nfb = min(nf, F - f0);
  const int lf = threadIdx.x / J;
  const int j = threadIdx.x - lf * J;
  const int f = f0 + lf;
  const bool live = lf < nfb;

  int at = nf * J * kLocal;
  // EXT: the block's copy of the extra directions, rows of ext_stride(E)
  const int es = EXT ? ext_stride(E) : 0;
  float* s_dt = smem + at;
  float* s_dj = s_dt + round4(J * es);
  if constexpr (EXT) {
    at += 2 * round4(J * es);
    for (int i = threadIdx.x; i < J * 3 * E; i += blockDim.x) {
      const int jj = i / (3 * E), r = i - jj * 3 * E;
      s_dt[jj * es + r] = dtrel[i];
      s_dj[jj * es + r] = djnt[i];
    }
  }
  // each output's region (smem_floats' offsets) and this thread's frame's
  // slot in it, shifted to the alignment of the block's destination range
  int base[kOuts], shift[kOuts], slot[kOuts];
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int w = frame_width(o, J, EXT ? E : 0);
    const float* dst = out.p[o] + static_cast<size_t>(f0) * w;
    base[o] = at;
    at += round4(nf * w + 3);
    shift[o] = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    slot[o] = base[o] + shift[o] + lf * w;
  }

  float v[3], R[9], q[6], tr[3], jn[3];
  unsigned long long anc = 0;
  if (live) {
    anc = ancmask[j];   // in flight across the barriers
    const float* th = theta + (static_cast<size_t>(f) * J + j) * 3;
    v[0] = th[0];
    v[1] = th[1];
    v[2] = th[2];
    rodrigues(v, R, q);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tr[c] = trel[j * 3 + c];
      jn[c] = jnts[j * 3 + c];
    }
  }
  if constexpr (EXT) {
    __syncthreads();   // the tables
    if (live) {
      // the frame's rest geometry: offsets along the extra directions
      const float* ex = extra + static_cast<size_t>(f) * E;
      for (int e = 0; e < E; ++e) {
        const float xe = ex[e];
        const float* dt = s_dt + j * es + e * 3;
        const float* dj = s_dj + j * es + e * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          tr[c] = fmaf(xe, dt[c], tr[c]);
          jn[c] = fmaf(xe, dj[c], jn[c]);
        }
      }
    }
  }
  if (live) {
    if constexpr (TILED) {
      // the frame's rest geometry: the wrapper's summed shifts
      const float* sh = jshift + static_cast<size_t>(f) * 6 * J + j * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tr[c] += sh[c];
        jn[c] += sh[3 * J + c];
      }
    }
    float* Lj = smem + threadIdx.x * kLocal;
    *reinterpret_cast<float4*>(Lj) = make_float4(R[0], R[1], R[2], R[3]);
    *reinterpret_cast<float4*>(Lj + 4) = make_float4(R[4], R[5], R[6], R[7]);
    *reinterpret_cast<float4*>(Lj + 8) = make_float4(R[8], tr[0], tr[1], tr[2]);
  }
  __syncthreads();

  if (live) {
    // the root path, ancestors in index order: G = L_root L_k ... L_j; Q, b
    // the transform before the last product (identity and 0 at a root)
    const float* Lf = smem + lf * J * kLocal;
    unsigned long long bits = anc;
    int k = __ffsll(static_cast<long long>(bits)) - 1;
    bits &= bits - 1;
    float Gr[9], Gt[3];
    load_local(Lf + k * kLocal, Gr, Gt);
    float Q[9], bb[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Q[i] = (i % 4 == 0) ? 1.f : 0.f;
    bb[0] = bb[1] = bb[2] = 0.f;
    float S[EXT && WITH_JAC ? 3 * kMaxExtra : 1];
    if constexpr (EXT && WITH_JAC) {
      const float* dt = s_dt + k * es;
#pragma unroll
      for (int e = 0; e < kMaxExtra; ++e)
        if (e < E) {
          S[e * 3] = dt[e * 3];
          S[e * 3 + 1] = dt[e * 3 + 1];
          S[e * 3 + 2] = dt[e * 3 + 2];
        }
    }
    while (bits) {
      k = __ffsll(static_cast<long long>(bits)) - 1;
      bits &= bits - 1;
#pragma unroll
      for (int i = 0; i < 9; ++i) Q[i] = Gr[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) bb[c] = Gt[c];
      float Rk[9], tk[3];
      load_local(Lf + k * kLocal, Rk, tk);
      if constexpr (EXT && WITH_JAC) {
        const float* dt = s_dt + k * es;
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e)
          if (e < E) {
            const float d0 = dt[e * 3], d1 = dt[e * 3 + 1], d2 = dt[e * 3 + 2];
            const float s0 = Q[0] * d0 + Q[1] * d1 + Q[2] * d2;
            const float s1 = Q[3] * d0 + Q[4] * d1 + Q[5] * d2;
            const float s2 = Q[6] * d0 + Q[7] * d1 + Q[8] * d2;
            S[e * 3] = s0 + S[e * 3];
            S[e * 3 + 1] = s1 + S[e * 3 + 1];
            S[e * 3 + 2] = s2 + S[e * 3 + 2];
          }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          Gr[a * 3 + b] = Q[a * 3] * Rk[b] + Q[a * 3 + 1] * Rk[3 + b] +
                          Q[a * 3 + 2] * Rk[6 + b];
        Gt[a] = Q[a * 3] * tk[0] + Q[a * 3 + 1] * tk[1] +
                Q[a * 3 + 2] * tk[2] + bb[a];
      }
    }

#pragma unroll
    for (int i = 0; i < 9; ++i) smem[slot[kGrot] + j * 9 + i] = Gr[i];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      smem[slot[kAtr] + j * 3 + a] =
          Gt[a] - (Gr[a * 3] * jn[0] + Gr[a * 3 + 1] * jn[1] +
                   Gr[a * 3 + 2] * jn[2]);
    if (j >= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          smem[slot[kFeat] + (j - 1) * 9 + a * 3 + b] =
              R[a * 3 + b] - (a == b ? 1.f : 0.f);
    }
    if constexpr (WITH_JAC && TILED) {
#pragma unroll
      for (int i = 0; i < 9; ++i) smem[slot[kSide] + j * 9 + i] = Q[i];
    }
    if constexpr (WITH_JAC && EXT) {
      // datr_e[j] = S_e[j] - G_rot[j] djnt_e[j], laid out [e][j][3]
#pragma unroll
      for (int e = 0; e < kMaxExtra; ++e)
        if (e < E) {
          const float* dj = s_dj + j * es + e * 3;
          const float d0 = dj[0], d1 = dj[1], d2 = dj[2];
          float* o = smem + slot[kSide] + (e * J + j) * 3;
          o[0] = S[e * 3] - (Gr[0] * d0 + Gr[1] * d1 + Gr[2] * d2);
          o[1] = S[e * 3 + 1] - (Gr[3] * d0 + Gr[4] * d1 + Gr[5] * d2);
          o[2] = S[e * 3 + 2] - (Gr[6] * d0 + Gr[7] * d1 + Gr[8] * d2);
        }
    }

    if constexpr (WITH_JAC) {
      float dR[27];
      rodrigues_grad(v, q, dR);
#pragma unroll
      for (int i = 0; i < 27; ++i) smem[slot[kDr] + j * 27 + i] = dR[i];
      // dRRt[a][c][t] = sum_b dR[a][b][t] R[c][b];
      // u[a][t] = -sum_b dRRt[a][b][t] trel[b]
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
      for (int i = 0; i < 27; ++i) smem[slot[kWrot] + j * 27 + i] = W[i];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          smem[slot[kWtr] + j * 9 + a * 3 + t] =
              -(W[(a * 3 + 0) * 3 + t] * bb[0] +
                W[(a * 3 + 1) * 3 + t] * bb[1] +
                W[(a * 3 + 2) * 3 + t] * bb[2]) +
              (Q[a * 3] * u[0 * 3 + t] + Q[a * 3 + 1] * u[1 * 3 + t] +
               Q[a * 3 + 2] * u[2 * 3 + t]);
    }
  }
  __syncthreads();

  // the block's frames are one contiguous range of every output
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int w = frame_width(o, J, EXT ? E : 0);
    store_out(out.p[o] + static_cast<size_t>(f0) * w, smem + base[o],
              nfb * w, shift[o]);
  }
}

struct Config {
  int threads;
  size_t smem;
};

// Threads and shared memory a block of nf frames; threads 0 for a launch
// the kernel does not take.
Config config(bool jac, int route, int J, int E, int nf) {
  Config c{0, 0};
  if (J < 1 || J > kMaxJ || nf < 1 || nf > kMaxFrames || E < 0 ||
      E > kMaxExtra || (route == 1) != (E > 0))
    return c;
  const int threads = (nf * J + 31) / 32 * 32;
  c.smem = static_cast<size_t>(smem_floats(n_outs(jac, route != 0), nf, J,
                                           E)) * sizeof(float);
  if (threads > kMaxThreads || c.smem > kSmemLimit) return c;
  c.threads = threads;
  return c;
}

// route 0: no extras, 1: EXT (E inline dims), 2: TILED
template <bool WITH_JAC>
const void* kernel_of(int route) {
  if (route == 1) return reinterpret_cast<const void*>(
      fk_smalls_kernel<WITH_JAC, true, false>);
  if (route == 2) return reinterpret_cast<const void*>(
      fk_smalls_kernel<WITH_JAC, false, true>);
  return reinterpret_cast<const void*>(fk_smalls_kernel<WITH_JAC, false, false>);
}

const void* kernel_of(bool jac, int route) {
  return jac ? kernel_of<true>(route) : kernel_of<false>(route);
}

int launch(bool jac, int route, int nf, const float* theta,
           const unsigned long long* ancmask, const float* jnts,
           const float* trel, int F, int J, const Outs& out, int E,
           const float* extra, const float* djnt, const float* dtrel,
           const float* jshift, void* stream) {
  const Config c = config(jac, route, J, E, nf);
  if (F < 1 || c.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* k = kernel_of(jac, route);
  cudaError_t err = allow_smem(k, c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Outs o = out;
  void* args[] = {&theta, &ancmask, &jnts, &trel, &F, &J, &nf, &o,
                  &E, &extra, &djnt, &dtrel, &jshift};
  err = cudaLaunchKernel(k, dim3((F + nf - 1) / nf), dim3(c.threads), args,
                         c.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks an SM of a launch of nf frames a block (route 0: no extras, 1:
// E <= 16 inline extra dims, 2: tiled), and its shared memory and threads a
// block (0 blocks for a launch the kernel does not take).
extern "C" int fk_smalls_occupancy(int with_jac, int route, int J, int E,
                                   int nf, int* smem_bytes, int* threads) {
  const Config c = config(with_jac != 0, route, J, E, nf);
  *smem_bytes = static_cast<int>(c.smem);
  *threads = c.threads;
  if (c.threads == 0) return 0;
  const void* k = kernel_of(with_jac != 0, route);
  if (allow_smem(k, c.smem) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, c.threads,
                                                    c.smem) != cudaSuccess)
    return 0;
  return blocks;
}

// theta (F, J, 3) in, nf frames a block; E > 0: extra (F, E), djnt and
// dtrel (J, E, 3) in and, with the Jacobian, datr (F, E, J, 3) out.
extern "C" int fk_smalls_launch(int with_jac, int nf, const float* theta,
                                const unsigned long long* ancmask,
                                const float* jnts, const float* trel, int F,
                                int J, float* grot, float* atr, float* feat,
                                float* wrot, float* wtr, float* dr, int E,
                                const float* extra, const float* djnt,
                                const float* dtrel, float* datr,
                                void* stream) {
  const Outs out{{grot, atr, feat, wrot, wtr, dr, datr}};
  return launch(with_jac != 0, E > 0 ? 1 : 0, nf, theta, ancmask, jnts, trel,
                F, J, out, E, extra, djnt, dtrel, nullptr, stream);
}

// The tiled route: jshift (F, 2, J, 3) in; with the Jacobian q (F, J, 3, 3)
// out.
extern "C" int fk_smalls_tiled_launch(int with_jac, int nf,
                                      const float* theta,
                                      const unsigned long long* ancmask,
                                      const float* jnts, const float* trel,
                                      int F, int J, float* grot, float* atr,
                                      float* feat, float* wrot, float* wtr,
                                      float* dr, const float* jshift,
                                      float* q, void* stream) {
  const Outs out{{grot, atr, feat, wrot, wtr, dr, q}};
  return launch(with_jac != 0, 2, nf, theta, ancmask, jnts, trel, F, J, out,
                0, nullptr, nullptr, nullptr, jshift, stream);
}
