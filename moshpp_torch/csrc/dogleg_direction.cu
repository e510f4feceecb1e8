// dogleg_direction<PCG>: the fused batched dogleg direction of the stage-ii
// Gauss-Newton solver, and (PCG) the plain Jacobi-PCG direction.
//
// Replaces the Pallas TPU kernels of moshpp_tpu/solver/pallas_pcg.py:
//   <false>  `_direction_kernel` (entry `dogleg_direction_batched`). Plain
//            version: moshpp_torch/solver/pcg.dogleg_direction_plain, the
//            torch chain _masked_system -> _damp -> _gn_direction_pcg ->
//            _dogleg_geometry -> pred.
//   <true>   `_pcg_kernel` (entry `pcg_direction_batched`). Plain version:
//            pcg.pcg_direction_plain (gauss_newton._gn_direction_pcg). B and
//            g arrive masked and damped by the caller, so this mode drops the
//            mask, the damping, the dogleg geometry and pred, and writes the
//            CG iterate p_gn (zero where not ok) and the ok flag.
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
// chain of dependent block reductions. Each matvec moves B through the
// SM's shared-memory port once: with one thread an unknown walking its
// column (consecutive threads, consecutive words) and the vector entry a
// broadcast, two wavefronts for every 32 entries, 2.65 K cycles a frame an
// iteration at D=206. The first design ran near that port (4 K cycles
// there) but staged B with blocking loads, one element a thread in flight
// (2.5 ms of its 4.2 ms at D=206, F=4096, 24 iterations, on an H100), and
// spent six block barriers an iteration and eleven dependent block sums in
// the tail.
//
// Design: one block a frame, one thread an unknown, the column walk kept.
// B is staged with cp.async, 16 bytes a copy where source and copy share
// their alignment (the copy is shifted by up to 3 floats to make it so), all
// of it in flight at once. The vector alternates between two buffers and
// the block sums between two scratch rows, so each costs one barrier: three
// an iteration. Sums that do not depend on each other are fused into one
// multi-value block sum: the warm start's two into one, the tail's eleven
// into four. When the CG recurrence stops (the breakdown guards), the block
// leaves the loop: further iterations would change nothing.
//
// Measured and not kept (PERF.md): k lanes an unknown (k = 4 at
// D=117, 2 at D=206) over B's upper triangle, and one lane an unknown over
// the triangle's padded rows below, at two blocks an SM at D=206: both read
// the same bytes through the same port, with more address arithmetic, and
// ran 1.2-2.7x slower an iteration. The padded rows (TRI) stay for the
// widths whose whole B does not fit a block, D = 240..320: row d holds
// B[d][d & ~3 ..] zero-padded to a length of 4 modulo 32 floats, which the
// thread reads as float4 from its diagonal on, and below it reads its
// column from the rows above.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kRedBufs = 2;      // block-sum scratch rows, used in turn
constexpr int kRedSlots = 3;     // values one fused block sum carries
constexpr size_t kSmemPerBlock = 232448;

// Row d of the stored B starts at column a(d) = d & ~3 and is padded to
// row_len(d) floats: the least length >= D - a(d) that is 4 modulo 32.
__host__ __device__ __forceinline__ int row_len(int d, int D) {
  return ((D - (d & ~3) - 4 + 31) & ~31) + 4;
}

// Dynamic shared memory in floats: the two vectors (D rounded up to 4,
// zero-padded), then the full B (3 floats of room to align its copy) or,
// TRI, the stored rows 0..D-1.
__host__ __device__ __forceinline__ size_t dyn_floats(int D, bool tri) {
  size_t n = 2 * static_cast<size_t>((D + 3) & ~3);
  if (!tri) return n + static_cast<size_t>(D) * D + 3;
  for (int d = 0; d < D; ++d) n += row_len(d, D);
  return n;
}

constexpr size_t kStaticBytes = kRedBufs * kRedSlots * 32 * sizeof(float);

// The whole B where it fits a block, else its padded rows.
__host__ __device__ __forceinline__ bool use_tri(int D) {
  return dyn_floats(D, false) * sizeof(float) + kStaticBytes > kSmemPerBlock;
}

struct Frame {
  const float* T;   // shared, B or (TRI) its padded rows
  float* v0;        // shared, the matvec's vector, in turn
  float* v1;
  int D, base;      // base: offset of this thread's row
  bool own;         // d < D
  float md, lam;
};

// Sums of the N values over the block's unknowns, returned to every thread;
// one barrier. Every warp folds the partials in the same order, so all
// threads see the same bits.
template <int N>
__device__ __forceinline__ void block_sums(float (&x)[N], float* red,
                                           int& turn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  float* r = red + (turn & 1) * kRedSlots * 32;
  ++turn;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = warp_sum(x[i]);
    if (lane == 0) r[i * 32 + warp] = x[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = warp_sum(lane < nwarps ? r[i * 32 + lane] : 0.f);
}

__device__ __forceinline__ float block_sum1(float v, float* red, int& turn) {
  float x[1] = {v};
  block_sums(x, red, turn);
  return x[0];
}

// Row d of B times v: B[e][d] down column d (consecutive threads,
// consecutive words; the vector entry a broadcast).
__device__ __forceinline__ float column_dot(const Frame& fr, const float* v) {
  const int D = fr.D;
  const float* col = fr.T + threadIdx.x;
  float acc = 0.f;
  for (int e = 0; e < D; ++e) acc = fmaf(col[e * D], v[e], acc);
  return acc;
}

// The same on the padded rows: below a = d & ~3, B[e][d] from rows e..e+3,
// which start at column e; from a on, row d as float4, zero-padded past D
// as the vector is. Four chains, summed at the end.
__device__ __forceinline__ float rows_dot(const Frame& fr, const float* v) {
  const int D = fr.D, d = threadIdx.x, a = d & ~3;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int base = 0;
  for (int e = 0; e < a; e += 4) {
    const int len = row_len(e, D);
    const float4 ve = *reinterpret_cast<const float4*>(v + e);
    const float* col = fr.T + base + d - e;
    acc0 = fmaf(col[0], ve.x, acc0);
    acc1 = fmaf(col[len], ve.y, acc1);
    acc2 = fmaf(col[2 * len], ve.z, acc2);
    acc3 = fmaf(col[3 * len], ve.w, acc3);
    base += 4 * len;
  }
  const float4* row = reinterpret_cast<const float4*>(fr.T + fr.base);
  for (int e = a; e < D; e += 4) {
    const float4 b = row[(e - a) >> 2];
    const float4 ve = *reinterpret_cast<const float4*>(v + e);
    acc0 = fmaf(b.x, ve.x, acc0);
    acc1 = fmaf(b.y, ve.y, acc1);
    acc2 = fmaf(b.z, ve.z, acc2);
    acc3 = fmaf(b.w, ve.w, acc3);
  }
  return (acc0 + acc1) + (acc2 + acc3);
}

// B_md v for this thread's unknown (PCG: B v); every thread of the block
// must call it. One barrier: the buffer written here was last read two
// matvecs ago, and a block sum lies between.
template <bool PCG, bool TRI>
__device__ __forceinline__ float matvec(const Frame& fr, float vd, int& turn) {
  float* v = (turn & 1) ? fr.v1 : fr.v0;
  ++turn;
  const int d = threadIdx.x;
  if (fr.own) {
    if constexpr (PCG) v[d] = vd;
    else v[d] = vd * fr.md;
  }
  __syncthreads();
  const float acc = !fr.own ? 0.f : TRI ? rows_dot(fr, v) : column_dot(fr, v);
  if constexpr (PCG) return acc;
  else return fr.md * acc + (1.f - fr.md) * vd + fr.lam * vd;
}

template <bool PCG, bool TRI>
__global__ void __launch_bounds__(320)
dogleg_direction_kernel(int D, int iters, float damping,
                        const float* __restrict__ g,
                        const float* __restrict__ B,
                        const float* __restrict__ plin,
                        const float* __restrict__ mask,
                        const float* __restrict__ delta,
                        float* __restrict__ p_out,
                        float* __restrict__ pgn_out,
                        float* __restrict__ pred_out,
                        bool* __restrict__ ok_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedBufs * kRedSlots * 32];
  const int n = blockIdx.x;
  const int d = threadIdx.x;
  const bool own = d < D;
  const int lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;

  const int Dv = (D + 3) & ~3;
  float* sv = smem;
  for (int i = D + threadIdx.x; i < Dv; i += blockDim.x) {
    sv[i] = 0.f;
    sv[Dv + i] = 0.f;
  }
  const float* Bn = B + static_cast<size_t>(n) * D * D;
  float* sT = smem + 2 * Dv;
  int base = 0;                          // TRI: this thread's row offset
  if constexpr (!TRI) {
    // B by cp.async, 16 bytes a copy: shifted by up to 3 floats so that
    // source and copy share their alignment
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(Bn) >> 2) & 3);
    sT += shift;
    const int DD = D * D;
    const int head = min(DD, (4 - shift) & 3);
    for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(sT + i, Bn + i);
    const int n4 = (DD - head) >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(sT + head + 4 * i, Bn + head + 4 * i);
    for (int i = head + 4 * n4 + threadIdx.x; i < DD; i += blockDim.x)
      cp_async4(sT + i, Bn + i);
  } else {
    // the stored rows, a warp a row: B[e][a(e)..D-1], then zeros
    int rows = 0;                        // floats of the rows above
    for (int e = 0; e < D; ++e) {
      const int len = row_len(e, D), a = e & ~3;
      if (e == d) base = rows;
      if (e % nwarps == (threadIdx.x >> 5)) {
        const float* src = Bn + static_cast<size_t>(e) * D + a;
        float* dst = sT + rows;
        for (int c = lane; c < len; c += 32) {
          if (a + c < D) cp_async4(dst + c, src + c);
          else dst[c] = 0.f;
        }
      }
      rows += len;
    }
  }
  cp_async_commit();
  // this thread's diagonal entry
  const int diag = TRI ? base + (d & 3) : d * D + d;

  const size_t row = static_cast<size_t>(n) * D + d;
  const float gd = own ? g[row] : 0.f;          // pre-masked
  int turn = 0, vturn = 0;
  // PCG: no mask, no damping, no radius; B's own diagonal preconditions
  float md, pl, dl, diag_m, lam;
  if constexpr (PCG) {
    md = own ? 1.f : 0.f;
    pl = own ? plin[row] : 0.f;
    dl = 0.f;
    cp_async_wait_all();
    __syncthreads();
    diag_m = own ? sT[diag] : 0.f;
    lam = 0.f;
  } else {
    md = own ? mask[row] : 0.f;
    pl = own ? plin[row] * md : 0.f;
    dl = delta[n];
    cp_async_wait_all();
    __syncthreads();
    // damping from the masked diagonal (matches _damp on the masked B)
    diag_m = own ? md * sT[diag] + (1.f - md) : 0.f;
    lam = damping * (block_sum1(diag_m, red, turn) / D + 1.f);
  }
  const Frame fr{sT, sv, sv + Dv, D, base, own, md, lam};
  const float dinv = own ? 1.f / fmaxf(diag_m + lam, 1e-12f) : 0.f;

  // warm start only if it reduces the residual vs x0 = 0
  const float rhs = -gd;
  const float r_warm = rhs - matvec<PCG, TRI>(fr, pl, vturn);
  const bool finite = __syncthreads_and(!own || isfinite(pl));
  float warm[2] = {r_warm * r_warm, rhs * rhs};
  block_sums(warm, red, turn);
  const bool use_warm = (warm[0] < warm[1]) && finite;
  float x = use_warm ? pl : 0.f;
  float r = use_warm ? r_warm : rhs;
  float z = dinv * r;
  float p = z;
  float rz = block_sum1(r * z, red, turn);
  const float rz0 = fmaxf(rz, 1e-30f);
  bool active = rz > 0.f;

  for (int it = 0; it < iters && active; ++it) {
    const float Bp = matvec<PCG, TRI>(fr, p, vturn);
    const float pBp = block_sum1(p * Bp, red, turn);
    const bool step_ok = (pBp > 1e-30f) && (rz > 1e-12f * rz0);
    const float alpha = step_ok ? rz / (pBp > 0.f ? pBp : 1.f) : 0.f;
    x += alpha * p;
    r -= alpha * Bp;
    z = dinv * r;
    const float rz_new = block_sum1(r * z, red, turn);
    const float beta = step_ok ? rz_new / (rz > 0.f ? rz : 1.f) : 0.f;
    p = step_ok ? z + beta * p : p;
    rz = step_ok ? rz_new : rz;
    active = step_ok;
  }

  // g.x, |x|^2 and the count of non-finite entries in one sum
  float fin[3] = {gd * x, x * x, isfinite(x) ? 0.f : 1.f};
  block_sums(fin, red, turn);
  const bool ok = (fin[0] < 0.f) && fin[2] == 0.f;
  const float pgn = ok ? x : 0.f;
  if constexpr (PCG) {
    if (own) pgn_out[row] = pgn;
    if (d == 0) ok_out[n] = ok;
    return;
  }

  // ---- dogleg geometry (gauss_newton._dogleg_geometry) --------------------
  const float gn_norm = ok ? sqrtf(fin[1]) : INFINITY;
  const float Bg = matvec<PCG, TRI>(fr, gd, vturn);
  float gb[2] = {gd * Bg, gd * gd};
  block_sums(gb, red, turn);
  const float gBg = gb[0] + 1e-30f;
  const float gg = gb[1];
  const float psd = -(gg / gBg) * gd;
  const float dd = pgn - psd;
  float seg3[3] = {psd * psd, dd * dd, psd * dd};
  block_sums(seg3, red, turn);
  const float sd_norm = sqrtf(seg3[0]);
  const float a = seg3[1] + 1e-30f;
  const float b2 = 2.f * seg3[2];
  const float c = seg3[0] - dl * dl;
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
  const float Bs = matvec<PCG, TRI>(fr, step, vturn);
  float pr[2] = {gd * step, step * Bs};
  block_sums(pr, red, turn);
  const float pred = -(2.f * pr[0] + pr[1]);
  if (own) {
    p_out[row] = step;
    pgn_out[row] = pgn;
  }
  if (d == 0) pred_out[n] = pred;
}

template <bool PCG>
int direction_launch(int N, int D, int iters, float damping, const float* g,
                     const float* B, const float* plin, const float* mask,
                     const float* delta, float* p, float* pgn, float* pred,
                     bool* ok, cudaStream_t stream) {
  const bool tri = use_tri(D);
  const size_t bytes = dyn_floats(D, tri) * sizeof(float);
  if (N < 1 || D < 1 || bytes + kStaticBytes > kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (D + 31) / 32 * 32;
  const auto kernel = tri ? dogleg_direction_kernel<PCG, true>
                          : dogleg_direction_kernel<PCG, false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, threads, bytes, stream>>>(D, iters, damping, g, B, plin, mask,
                                        delta, p, pgn, pred, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dogleg_direction_launch(int N, int D, int iters, float damping,
                                       const float* g, const float* B,
                                       const float* plin, const float* mask,
                                       const float* delta, float* p,
                                       float* pgn, float* pred, void* stream) {
  return direction_launch<false>(N, D, iters, damping, g, B, plin, mask, delta,
                                 p, pgn, pred, nullptr,
                                 static_cast<cudaStream_t>(stream));
}

// PCG: g, plin (N, D) and B (N, D, D), masked and damped by the caller, in;
// p_gn (N, D) and ok (N,) out.
extern "C" int pcg_direction_launch(int N, int D, int iters, const float* g,
                                    const float* B, const float* plin,
                                    float* pgn, bool* ok, void* stream) {
  return direction_launch<true>(N, D, iters, 0.f, g, B, plin, nullptr, nullptr,
                                nullptr, pgn, nullptr, ok,
                                static_cast<cudaStream_t>(stream));
}

// Blocks an SM of either mode at width D, and the launcher's shared memory
// a block (dynamic and static) and threads; 0 where it refuses D.
extern "C" int dogleg_direction_occupancy(int pcg, int D, int* smem_bytes,
                                          int* threads) {
  if (D < 1) return 0;
  const bool tri = use_tri(D);
  const size_t bytes = dyn_floats(D, tri) * sizeof(float);
  const void* fn =
      pcg ? (tri ? reinterpret_cast<const void*>(dogleg_direction_kernel<true, true>)
                 : reinterpret_cast<const void*>(dogleg_direction_kernel<true, false>))
          : (tri ? reinterpret_cast<const void*>(dogleg_direction_kernel<false, true>)
                 : reinterpret_cast<const void*>(dogleg_direction_kernel<false, false>));
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      bytes + a.sharedSizeBytes > kSmemPerBlock)
    return 0;
  *threads = (D + 31) / 32 * 32;
  *smem_bytes = static_cast<int>(bytes + a.sharedSizeBytes);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, *threads,
                                                    bytes) != cudaSuccess)
    return 0;
  return blocks;
}
