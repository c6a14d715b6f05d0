// Shared helpers for the ttv kernels (bf16 / fp32 element access).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace ttv {

// ------------------------------------------------------ per-device state
// A kernel's function attributes and the occupancy it reaches belong to one
// device.  A launcher keeps what it has set or measured in a table indexed
// by the ordinal of the calling thread's current device, which
// ops/_native.launch makes the device of the tensors.  Two threads may both
// set an entry the first time; the attribute they set is the same.
constexpr int kMaxDevices = 64;

struct PerDevice {
  std::atomic<int> v[kMaxDevices];  // zero at first: declare it static
};

inline cudaError_t current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) return cudaErrorInvalidDevice;
  return e;
}

// Let kernel ``fn`` use ``bytes`` of dynamic shared memory on the current
// device; ``allowed`` is the launcher's table of what each device allows.
inline cudaError_t allow_smem(const void* fn, int bytes, PerDevice& allowed) {
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess || allowed.v[dev].load(std::memory_order_relaxed) >= bytes) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  int cur = allowed.v[dev].load(std::memory_order_relaxed);
  while (cur < bytes && !allowed.v[dev].compare_exchange_weak(cur, bytes)) {
  }
  return cudaSuccess;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like XLA's convert
}

// 8 consecutive elements <-> fp32 registers (16-byte aligned for bf16,
// 32-byte for fp32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace ttv
