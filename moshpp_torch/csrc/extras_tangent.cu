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
// J=55, >= 65 us at 3.35 TB/s). The chain sums are a scan down the tree,
//   S_e[j] = S_e[parent(j)] + Q_j dtrel_e[j],  datr = S - G_rot[j] djnt_e[j],
// 18 FMAs a (frame, extra, joint); parents precede their children
// (prepare_marker_jac_tables checks it), so one pass over j in index order
// sees every parent's S first. What held the first design back (a thread a
// (extra, joint) walking its ancestor mask: work in the sum of the chain
// depths, lanes diverging on chains of 1-15 joints, stores at a 12-byte
// stride, direction tables through L1 every frame) the design here removes:
//   - the extra dims are cut into balanced chunks of at most 32
//     (blockIdx.y); a block stages its chunk of dtrel and djnt in shared
//     memory once, by cp.async (all its copies in flight together: plain
//     loads in that loop took 0.0258 against 0.0158 ms at F=128 on an H100
//     SXM at 700 W), and
//     keeps it while it walks frames;
//   - a warp takes one frame at a time, a lane one extra dim, and scans the
//     joints in index order with S in the warp's shared-memory slot (the
//     frame's chunk of datr, laid out as in device memory); a second pass
//     subtracts G_rot djnt in place; the lanes never diverge, and Q and
//     G_rot (staged a frame by cp.async, rows padded to 12 floats; the
//     next frame's copy runs beside this frame's stores: 0.1368 against
//     0.1430 ms at F=4096 on that card) are broadcast float4 reads;
//   - the warp then writes its frame's chunk, contiguous in datr, with
//     16-byte stores (the slot shifted to share the destination's alignment,
//     scalar stores at the two ragged ends);
//   - warps work alone (no block barrier after the tables), as many an SM
//     as shared memory allows, so one warp's stores overlap another's scan;
//     for small F fewer warps a block, so the grid still covers the SMs.

#include "common.cuh"

namespace {

using namespace moshpp;

constexpr int kMaxJ = 64;
constexpr int kMaxChunk = 32;      // extra dims a block (a lane each)
constexpr int kMaxWarps = 8;
constexpr int kQG = 24;            // floats a joint in a slot: Q, G_rot rows of 12
constexpr size_t kSmemPerSM = 233472;   // 228 KB an SM
constexpr size_t kSmemReserved = 1024;  // the runtime's share of each block

// Offsets in floats of the dynamic shared-memory regions (16-byte aligned).
struct Layout {
  int dt, dj, par, slots, slot_qg, slot_out, slot, total;
  __host__ __device__ Layout(int J, int ec, int warps) {
    dt = 0;                                  // [j][el][3]
    dj = dt + round4(J * ec * 3);
    par = dj + round4(J * ec * 3);           // int [j]
    slots = par + round4(J);
    slot_qg = 0;                             // [j][Q 12 | G 12]
    slot_out = J * kQG;                      // [el][j][3], shifted 0-3
    slot = slot_out + round4(ec * J * 3 + 3);
    total = slots + warps * slot;
  }
};

struct Config {
  int nch, ec, warps, gx;
  size_t smem;
};

// The launch of F frames: chunks of the extras, warps a block (as many as
// shared memory holds, fewer when F is too small to give every SM blocks),
// frame-walking blocks per chunk (enough to fill every SM once).
Config config(int F, int J, int E) {
  Config c;
  c.nch = (E + kMaxChunk - 1) / kMaxChunk;
  c.ec = (E + c.nch - 1) / c.nch;
  const Layout base(J, c.ec, 0);
  const size_t slot = static_cast<size_t>(base.slot) * sizeof(float);
  const size_t fixed = static_cast<size_t>(base.slots) * sizeof(float);
  int warps = static_cast<int>((kSmemLimit - fixed) / slot);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int sms = sm_count();
  const int spread = static_cast<int>(
      (static_cast<long long>(F) * c.nch) / sms);
  if (spread < warps) warps = spread < 1 ? 1 : spread;
  c.warps = warps;
  c.smem = static_cast<size_t>(Layout(J, c.ec, warps).total) * sizeof(float);
  int bps = static_cast<int>(kSmemPerSM / (c.smem + kSmemReserved));
  const int by_threads = 2048 / (32 * warps);
  bps = bps < 1 ? 1 : (bps > by_threads ? by_threads : bps);
  const int groups = (F + warps - 1) / warps;
  const int fill = (sms * bps + c.nch - 1) / c.nch;
  c.gx = groups < fill ? groups : fill;
  return c;
}

// The scan of one lane (extra dim): S over the joints in index order, then
// datr = S - G_rot djnt in place. restrict: the slot's rows and the tables
// never alias, so loads of the next joint may pass the last store.
__device__ __forceinline__ void scan(int J, int ec, const float* __restrict__ qg,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ dj,
                                     const int* __restrict__ par,
                                     float* __restrict__ o) {
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(qg + j * kQG);
    const float4 b = *reinterpret_cast<const float4*>(qg + j * kQG + 4);
    const float4 c = *reinterpret_cast<const float4*>(qg + j * kQG + 8);
    const float* d = dt + j * ec * 3;
    const float d0 = d[0], d1 = d[1], d2 = d[2];
    float s0 = a.x * d0 + a.y * d1 + a.z * d2;
    float s1 = a.w * d0 + b.x * d1 + b.y * d2;
    float s2 = b.z * d0 + b.w * d1 + c.x * d2;
    const int p = par[j];
    if (p >= 0) {
      s0 += o[p * 3];
      s1 += o[p * 3 + 1];
      s2 += o[p * 3 + 2];
    }
    o[j * 3] = s0;
    o[j * 3 + 1] = s1;
    o[j * 3 + 2] = s2;
  }
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(qg + j * kQG + 12);
    const float4 b = *reinterpret_cast<const float4*>(qg + j * kQG + 16);
    const float4 c = *reinterpret_cast<const float4*>(qg + j * kQG + 20);
    const float* d = dj + j * ec * 3;
    const float d0 = d[0], d1 = d[1], d2 = d[2];
    o[j * 3] -= a.x * d0 + a.y * d1 + a.z * d2;
    o[j * 3 + 1] -= a.w * d0 + b.x * d1 + b.y * d2;
    o[j * 3 + 2] -= b.z * d0 + b.w * d1 + c.x * d2;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
extras_tangent_kernel(int F, int J, int E, int ec, const float* __restrict__ q,
                      const float* __restrict__ grot,
                      const float* __restrict__ dtrel,
                      const float* __restrict__ djnt,
                      const int* __restrict__ parents,
                      float* __restrict__ datr) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const Layout L(J, ec, warps);
  const int e0 = blockIdx.y * ec;
  const int cnt = min(ec, E - e0);
  float* s_dt = smem + L.dt;
  float* s_dj = smem + L.dj;
  int* s_par = reinterpret_cast<int*>(smem + L.par);
  // the block's chunk of the direction tables, kept while it walks frames
  for (int i = threadIdx.x; i < J * cnt * 3; i += blockDim.x) {
    const int j = i / (cnt * 3), r = i - j * cnt * 3;
    const size_t g = (static_cast<size_t>(j) * E + e0) * 3 + r;
    cp_async4(s_dt + j * ec * 3 + r, dtrel + g);
    cp_async4(s_dj + j * ec * 3 + r, djnt + g);
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) s_par[j] = parents[j];
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qg = smem + L.slots + warp * L.slot + L.slot_qg;
  float* out = smem + L.slots + warp * L.slot + L.slot_out;
  const int n = cnt * J * 3;                 // the frame's chunk of datr
  // frame f's Q and G_rot into the warp's slot, as one cp.async group
  auto stage = [&](int f) {
    const float* qf = q + static_cast<size_t>(f) * J * 9;
    const float* gf = grot + static_cast<size_t>(f) * J * 9;
    for (int i = lane; i < J * 9; i += 32) {
      const int j = i / 9, r = i - j * 9;
      cp_async4(qg + j * kQG + r, qf + i);
      cp_async4(qg + j * kQG + 12 + r, gf + i);
    }
    cp_async_commit();
  };
  const int step = gridDim.x * warps;
  if (blockIdx.x * warps + warp < F) stage(blockIdx.x * warps + warp);
  for (int f = blockIdx.x * warps + warp; f < F; f += step) {
    float* dst = datr + (static_cast<size_t>(f) * E + e0) * J * 3;
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    cp_async_wait_all();
    __syncwarp();
    if (lane < cnt)
      scan(J, ec, qg, s_dt + lane * 3, s_dj + lane * 3, s_par,
           out + shift + lane * J * 3);
    __syncwarp();
    if (f + step < F) stage(f + step);   // the scan is done with Q and G_rot
    // out[shift + i] holds dst[i]: scalar head, 16-byte body, scalar tail
    const int head = min((4 - shift) & 3, n);
    const int body = (n - head) >> 2;
    const float* src = out + shift;
    if (lane < head) dst[lane] = src[lane];
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    for (int v = lane; v < body; v += 32) d4[v] = s4[v];
    const int tail = head + 4 * body + lane;
    if (tail < n) dst[tail] = src[tail];
    __syncwarp();
  }
}

}  // namespace

// Blocks an SM of the launch at F frames, and its shared memory a block and
// warps a block (0 blocks for widths the kernel does not take).
extern "C" int extras_tangent_occupancy(int F, int J, int E, int* smem_bytes,
                                        int* warps) {
  if (F < 1 || J < 1 || J > kMaxJ || E < 1) return 0;
  const Config c = config(F, J, E);
  *smem_bytes = static_cast<int>(c.smem);
  *warps = c.warps;
  if (allow_smem(extras_tangent_kernel, c.smem) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, extras_tangent_kernel, c.warps * 32, c.smem) != cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int extras_tangent_launch(int F, int J, int E, const float* q,
                                     const float* grot, const float* dtrel,
                                     const float* djnt, const int* parents,
                                     float* datr, void* stream) {
  if (F < 1 || J < 1 || J > kMaxJ || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config c = config(F, J, E);
  if (c.smem > kSmemLimit || c.nch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(extras_tangent_kernel, c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  extras_tangent_kernel<<<dim3(c.gx, c.nch), c.warps * 32, c.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      F, J, E, c.ec, q, grot, dtrel, djnt, parents, datr);
  return static_cast<int>(cudaGetLastError());
}
