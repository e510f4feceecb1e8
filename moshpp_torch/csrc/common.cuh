// Shared helpers of the Hopper kernels (built for sm_90a, see
// moshpp_torch/kernels/__init__.py). Every launcher is a plain C function that
// launches on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace moshpp {

constexpr float kEps = 1e-12f;   // ops/rodrigues._EPS and marker_transform._EPS

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Quaternion Rodrigues, identical to ops/rodrigues.rodrigues (incl. the
// +eps guard). R row-major; q = (w, x, y, z, s, theta).
__device__ __forceinline__ void rodrigues(const float v[3], float R[9],
                                          float q[6]) {
  const float theta = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + kEps);
  const float half = 0.5f * theta;
  const float w = cosf(half);
  const float s = sinf(half) / theta;
  const float x = v[0] * s, y = v[1] * s, z = v[2] * s;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
  q[0] = w; q[1] = x; q[2] = y; q[3] = z; q[4] = s; q[5] = theta;
}

// dR[(a*3+b)*3+t] = dR_ab/dv_t: the hand derivative of `rodrigues`
// (pallas_marker_jac._rodrigues_grad_rows).
__device__ __forceinline__ void rodrigues_grad(const float v[3],
                                               const float q[6],
                                               float dR[27]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3], s = q[4], th = q[5];
  const float g = (0.5f * w - s) / (th * th);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float vt = v[t];
    const float dw = -0.5f * s * vt;
    const float dx = g * v[0] * vt + (t == 0 ? s : 0.f);
    const float dy = g * v[1] * vt + (t == 1 ? s : 0.f);
    const float dz = g * v[2] * vt + (t == 2 ? s : 0.f);
    const float dxx = 2.f * x * dx, dyy = 2.f * y * dy, dzz = 2.f * z * dz;
    const float dxy = dx * y + x * dy;
    const float dxz = dx * z + x * dz;
    const float dyz = dy * z + y * dz;
    const float dwx = dw * x + w * dx;
    const float dwy = dw * y + w * dy;
    const float dwz = dw * z + w * dz;
    dR[0 * 3 + t] = -2.f * (dyy + dzz);
    dR[1 * 3 + t] = 2.f * (dxy - dwz);
    dR[2 * 3 + t] = 2.f * (dxz + dwy);
    dR[3 * 3 + t] = 2.f * (dxy + dwz);
    dR[4 * 3 + t] = -2.f * (dxx + dzz);
    dR[5 * 3 + t] = 2.f * (dyz - dwx);
    dR[6 * 3 + t] = 2.f * (dxz - dwy);
    dR[7 * 3 + t] = 2.f * (dyz + dwx);
    dR[8 * 3 + t] = -2.f * (dxx + dyy);
  }
}

// cp.async: copies from global to shared memory that run beside the
// block's work; a commit closes a group, wait_all waits for every group.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait for every group but the last committed one
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr size_t kSmemLimit = 232448;   // 227 KB, the most a block may use

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The current device's SM count, queried once a device.
inline int sm_count() {
  static int count[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) dev = 0;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 1;
  }
  return count[dev];
}

// Raise the dynamic shared-memory cap of `kernel` when `bytes` is above the
// 48 KB default (Hopper allows up to 227 KB a block).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace moshpp
