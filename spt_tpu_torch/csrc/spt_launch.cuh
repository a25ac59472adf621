// Host-side launch helpers shared by every C entry: the shared-memory
// opt-in, the persistent grids' occupancy query and the cooperative launch.
//
// The opt-ins (cudaFuncSetAttribute) and queries (the occupancy
// calculator) are made once per kernel, device and size and cached, so a
// launch made while a stream is captured into a CUDA graph (the port's
// captured frame step, engine/renderer.py) runs nothing but the launch:
// the capture runs in the global mode, which refuses calls that are not
// stream work where they could race with it.  The caller warms every
// (kernel, size) up before it captures.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace spt {

namespace launch_cache {

// One cached value: a kernel's opt-in or query result on a device, for
// `threads` threads and `smem` bytes of dynamic shared memory a block
// (threads < 0 names a per-kernel opt-in).
struct Entry {
  const void* fn;
  int dev;
  int threads;
  size_t smem;
  int value;
};

inline std::mutex& mutex() {
  static std::mutex m;
  return m;
}

inline std::vector<Entry>& entries() {
  static std::vector<Entry> v;
  return v;
}

inline Entry* find(const void* fn, int dev, int threads, size_t smem) {
  for (Entry& e : entries())
    if (e.fn == fn && e.dev == dev && e.threads == threads && e.smem == smem) return &e;
  return nullptr;
}

}  // namespace launch_cache

// Opt-in ids of launch_cache entries.
constexpr int kOptInSmem = -1;
constexpr int kOptInClusters = -2;

// Dynamic shared memory above the default 48 KiB needs an opt-in per
// kernel; it is raised to the largest size asked for on the device so far
// (a launch may take less than its kernel's opt-in) and made only when a
// size passes it.  Returns the launch error to report, or cudaSuccess.
template <class K>
inline cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_cache::mutex());
  launch_cache::Entry* e = launch_cache::find(fn, dev, kOptInSmem, 0);
  if (e != nullptr && static_cast<size_t>(e->value) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (e != nullptr) {
    e->value = static_cast<int>(bytes);
  } else {
    launch_cache::entries().push_back({fn, dev, kOptInSmem, 0, static_cast<int>(bytes)});
  }
  return cudaSuccess;
}

// Clusters past the portable 8 blocks need an opt-in per kernel, made once
// a device.
template <class K>
inline cudaError_t allow_large_clusters(K kernel) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_cache::mutex());
  if (launch_cache::find(fn, dev, kOptInClusters, 0) != nullptr) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) launch_cache::entries().push_back({fn, dev, kOptInClusters, 0, 1});
  return err;
}

// The blocks of `kernel` an SM holds at once with `threads` threads and
// `smem` bytes of dynamic shared memory each, times the SMs: the
// persistent grid, queried once a (kernel, device, threads, smem).
template <class K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* blocks) {
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_cache::mutex());
  if (const launch_cache::Entry* e = launch_cache::find(fn, dev, threads, smem)) {
    *blocks = e->value;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = sms * per_sm;
  if (err == cudaSuccess) launch_cache::entries().push_back({fn, dev, threads, smem, *blocks});
  return err;
}

// A cooperative launch (the grid barrier needs every block resident) of
// kernel(args...) as cudaLaunchKernelEx with the cooperative attribute,
// the form a stream capture records as a kernel node, in a graph and in
// the body of a conditional node alike.
template <class... Params, class... Args>
inline cudaError_t launch_cooperative(void (*kernel)(Params...), int grid, int threads,
                                      size_t smem, cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

}  // namespace spt
