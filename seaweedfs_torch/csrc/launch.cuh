// Host-side launch helpers shared by the port's kernels: the device
// switch, and per-device facts cached after their first query, so that a
// launch costs no driver call it does not need (degraded reads launch
// hundreds of one-row kernels from many threads).

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace swlaunch {

// the H100's per-block dynamic shared-memory ceiling
constexpr int kSmemLimit = 232448;

// Make `device` current for this thread; no driver call when it already
// is.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

struct Cache {
  std::mutex mu;
  std::map<int, int> sms;                                   // device
  std::map<std::tuple<int, const void*>, bool> smem_set;    // device, fn
  std::map<std::tuple<int, const void*, int, size_t>, int> occupancy;
};

inline Cache& cache() {
  static Cache c;
  return c;
}

// Streaming multiprocessors of the current device (queried once).
inline int sm_count(int device) {
  Cache& c = cache();
  std::lock_guard<std::mutex> lock(c.mu);
  auto it = c.sms.find(device);
  if (it != c.sms.end()) return it->second;
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || n < 1)
    n = 1;
  c.sms[device] = n;
  return n;
}

// Let `fn` take up to kSmemLimit bytes of dynamic shared memory on the
// current device: one cudaFuncSetAttribute per (device, kernel).
inline cudaError_t allow_smem(const void* fn, int device) {
  Cache& c = cache();
  std::lock_guard<std::mutex> lock(c.mu);
  auto key = std::make_tuple(device, fn);
  if (c.smem_set.count(key)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) c.smem_set[key] = true;
  return err;
}

// Blocks of `threads` threads and `smem` bytes that one SM holds at once
// (queried once per shape; at least 1).
inline int blocks_per_sm(const void* fn, int threads, size_t smem,
                         int device) {
  Cache& c = cache();
  std::lock_guard<std::mutex> lock(c.mu);
  auto key = std::make_tuple(device, fn, threads, smem);
  auto it = c.occupancy.find(key);
  if (it != c.occupancy.end()) return it->second;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                    smem) != cudaSuccess ||
      n < 1)
    n = 1;
  c.occupancy[key] = n;
  return n;
}

}  // namespace swlaunch
