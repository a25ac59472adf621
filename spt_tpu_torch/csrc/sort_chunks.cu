// sort_chunks: sort a uint32 key and up to 16 payload planes within fixed
// chunks, one block per chunk.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_sort.py:70-108
// (`_sort_kernel`, launched by `sort_chunks` :111, pallas_call :131).  The
// TPU kernel runs a bitonic network over the key and every operand stacked
// in VMEM.  Here the network runs in dynamic shared memory over (uint32
// key, uint16 local lane) pairs only — 6 B a lane: 48 KiB at a chunk of
// 8192, 192 KiB at the condensed chunk of 32768, under the 227 KB a block
// may opt in to (an 8-byte pair would need 256 KiB) — and then each payload
// plane is gathered once through the permutation: one read and one write
// of every plane, the traffic the TPU kernel was built for
// (pallas_sort.py:1-16).  Keys ascend; dead lanes (0xFFFFFFFF) land last;
// the order among equal keys is not stable, as in the TPU kernel.  Keys
// arrive as int64 words holding uint32 values (the port's convention); the
// lane ids come out as int64 global lane indices.
//
// What bounds it on an H100: the network is log2(chunk)(log2(chunk)+1)/2
// shared-memory passes with a block-wide barrier each (120 at 32768); the
// global traffic is one read of the key and the planes and one write of
// them, a few MB per call at the mesh path's widths.  Barrier latency and
// shared-memory bandwidth bound it, not device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOps = 16;
constexpr int kMaxChunk = 32768;
constexpr int kMaxThreads = 1024;

struct SortIO {
  const long long* key;
  long long *o_key, *o_lane;
  const void* in[kMaxOps];
  void* out[kMaxOps];
  int bytes[kMaxOps];
  int n_ops, chunk;
};

__global__ void __launch_bounds__(kMaxThreads) sort_chunks_kernel(SortIO io) {
  extern __shared__ uint32_t skey[];
  const int chunk = io.chunk;
  uint16_t* slane = reinterpret_cast<uint16_t*>(skey + chunk);
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    skey[i] = static_cast<uint32_t>(io.key[base + i]);
    slane[i] = static_cast<uint16_t>(i);
  }
  __syncthreads();

  for (int size = 2; size <= chunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < chunk / 2; p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const uint32_t a = skey[i], b = skey[j];
        const bool ascending = (i & size) == 0;
        if (ascending ? (a > b) : (a < b)) {
          skey[i] = b;
          skey[j] = a;
          const uint16_t t = slane[i];
          slane[i] = slane[j];
          slane[j] = t;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    io.o_key[base + i] = skey[i];
    io.o_lane[base + i] = base + slane[i];
  }
  for (int k = 0; k < io.n_ops; ++k) {
    if (io.bytes[k] == 8) {
      const long long* src = static_cast<const long long*>(io.in[k]) + base;
      long long* dst = static_cast<long long*>(io.out[k]) + base;
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) dst[i] = src[slane[i]];
    } else {
      const uint32_t* src = static_cast<const uint32_t*>(io.in[k]) + base;
      uint32_t* dst = static_cast<uint32_t*>(io.out[k]) + base;
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) dst[i] = src[slane[i]];
    }
  }
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_sort.py:111 (sort_chunks, pallas_call :131).
// `ins`/`outs`/`bytes`: host arrays of n_ops plane pointers and element
// sizes (4 or 8).  Returns the CUDA error of the launch (0: accepted);
// allocates nothing and does not synchronise.
int spt_sort_chunks(const long long* key, long long* o_key, long long* o_lane,
                    const void* const* ins, void* const* outs, const int* bytes, int n_ops,
                    int n, int chunk, void* stream) {
  if (chunk < 2 || chunk > kMaxChunk || (chunk & (chunk - 1)) != 0 || n % chunk != 0 ||
      n_ops < 0 || n_ops > kMaxOps)
    return static_cast<int>(cudaErrorInvalidValue);
  SortIO io;
  io.key = key;
  io.o_key = o_key;
  io.o_lane = o_lane;
  for (int k = 0; k < n_ops; ++k) {
    if (bytes[k] != 4 && bytes[k] != 8) return static_cast<int>(cudaErrorInvalidValue);
    io.in[k] = ins[k];
    io.out[k] = outs[k];
    io.bytes[k] = bytes[k];
  }
  io.n_ops = n_ops;
  io.chunk = chunk;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(uint32_t) + sizeof(uint16_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = chunk / 2 < kMaxThreads ? chunk / 2 : kMaxThreads;
  sort_chunks_kernel<<<n / chunk, threads, smem, static_cast<cudaStream_t>(stream)>>>(io);
  return static_cast<int>(cudaGetLastError());
}

int spt_sort_kernel_info(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sort_chunks_kernel);
  if (err == cudaSuccess) {
    *num_regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
