// sort_chunks: a stable sort of a uint32 key and up to 16 payload planes
// within fixed chunks, one thread-block cluster per chunk, one launch.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_sort.py:70-108
// (`_sort_kernel`, launched by `sort_chunks` :111, pallas_call :131).  The
// TPU kernel runs a bitonic network over the key and every operand stacked
// in VMEM, one grid step per chunk.  One block per chunk would leave most
// of the H100's 132 SMs idle (2 blocks for the condensed frame's 65 536
// lanes in chunks of 32 768), so here a cluster of C blocks sorts a chunk
// (C = chunk / kBlockKeys, at most 16: 16 at 32 768, 8 at 8192, 1 up to
// 1024), each block owning a contiguous tile of chunk / C keys.
//
// The sort is a least-significant-digit radix sort of (uint32 key, local
// lane) pairs packed in 8 bytes, 8 bits a pass, four passes:
// - each block ranks its tile in shared memory, stably: warp w holds the
//   tile's keys [w * 32 * kItems, (w + 1) * 32 * kItems) and ranks them in
//   index order, kItems rounds of 32 lanes, __match_any_sync finding the
//   lanes of a round that share a digit and a per-warp digit count carried
//   from round to round; per digit, an exclusive sum over the warps;
// - the block publishes its digit histogram; after a cluster barrier every
//   block reads the others' through distributed shared memory and takes its
//   offsets: the chunk's keys of smaller digits plus those of its digit in
//   lower-ranked blocks;
// - each block stores its pairs straight into the owning block's other
//   buffer through distributed shared memory, and a second cluster barrier
//   ends the pass.  A pass whose digit is one value over the whole chunk
//   (an all-dead chunk, say) leaves the order as it is and is skipped after
//   its histogram.
// Keys ascend; dead lanes (0xFFFFFFFF) land last; equal keys keep their
// input order (the TPU kernel's order among them is not specified).  Each
// block then writes its tile's keys and lane ids and gathers every payload
// plane for its tile (reads at src[chunk base + lane], coalesced writes), so
// the planes' traffic is spread over the cluster's SMs; a chunk's planes
// (about 2.4 MB at 32 768 lanes) stay in the 50 MB L2 for those reads.  Keys
// arrive as int64 words holding uint32 values (the port's convention); the
// lane ids come out as int64 global lane indices.
//
// What bounds it on an H100: the bytes are one read and one write of the key
// and of every plane, a few MB a call at the mesh path's widths; ranking is a
// few integer operations a key a pass.  What is left is latency: up to eight
// cluster barriers a sort, the distributed-shared-memory scatter, and the
// gathers' scattered reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOps = 16;
constexpr int kMaxChunk = 32768;
constexpr int kItems = 4;                       // keys a thread ranks a pass
constexpr int kBlockKeys = 1024;                // a block's tile below the cap
constexpr int kMaxCluster = 16;                 // the H100's non-portable limit
constexpr int kMaxTile = kMaxChunk / kMaxCluster > kBlockKeys ? kMaxChunk / kMaxCluster
                                                              : kBlockKeys;
constexpr int kMaxThreads = kMaxTile / kItems;
constexpr int kPlaneBatch = 4;                  // planes gathered together
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kPasses = 32 / kDigitBits;

struct SortIO {
  const long long* key;
  long long *o_key, *o_lane;
  const void* in[kMaxOps];
  void* out[kMaxOps];
  int bytes[kMaxOps];
  int n_ops, chunk;
};

// The launch shape of a chunk: blocks per cluster, keys and threads a block,
// dynamic shared bytes (two pair buffers, the warps' digit counts, two
// published histograms, the digit offsets and totals, a flag).
struct Shape {
  int cluster, tile, threads;
  size_t smem;
};

Shape shape_of(int chunk) {
  Shape s;
  const int c = chunk / kBlockKeys;
  s.cluster = c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
  s.tile = chunk / s.cluster;
  s.threads = s.tile / kItems < 32 ? 32 : s.tile / kItems;
  s.smem = 2 * static_cast<size_t>(s.tile) * sizeof(uint64_t) +
           static_cast<size_t>(s.threads / 32 + 4) * kDigits * sizeof(uint32_t) + 16;
  return s;
}

// out[k][i] = in[k][lane of item i] for this thread's items of the tile, a
// batch of kPlaneBatch planes at a time: every load of a batch is issued
// before its stores, so a thread has kPlaneBatch * kItems scattered reads in
// flight rather than kItems.
__device__ __forceinline__ void gather_planes(const SortIO& io, long long base, int tile_lo,
                                              const int (&lanes)[kItems], int tile) {
  const int tid = static_cast<int>(threadIdx.x), nthreads = static_cast<int>(blockDim.x);
  for (int k0 = 0; k0 < io.n_ops; k0 += kPlaneBatch) {
    unsigned long long x[kPlaneBatch][kItems];
#pragma unroll
    for (int b = 0; b < kPlaneBatch; ++b) {
      const int k = k0 + b;
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (k >= io.n_ops || tid + q * nthreads >= tile) continue;
        if (io.bytes[k] == 8)
          x[b][q] = __ldg(static_cast<const unsigned long long*>(io.in[k]) + base + lanes[q]);
        else
          x[b][q] = __ldg(static_cast<const unsigned int*>(io.in[k]) + base + lanes[q]);
      }
    }
#pragma unroll
    for (int b = 0; b < kPlaneBatch; ++b) {
      const int k = k0 + b;
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int i = tid + q * nthreads;
        if (k >= io.n_ops || i >= tile) continue;
        if (io.bytes[k] == 8)
          static_cast<unsigned long long*>(io.out[k])[base + tile_lo + i] = x[b][q];
        else
          static_cast<unsigned int*>(io.out[k])[base + tile_lo + i] =
              static_cast<unsigned int>(x[b][q]);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) sort_chunks_kernel(SortIO io) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = io.chunk;
  const int tile = chunk / csize;
  const int tile_lo = rank * tile;
  const long long base = static_cast<long long>(blockIdx.x / csize) * chunk;
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int nthreads = static_cast<int>(blockDim.x), warps = nthreads >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);              // [2][tile] (key << 32 | lane)
  uint32_t* whist = reinterpret_cast<uint32_t*>(buf + 2 * tile);  // [warps][kDigits]
  uint32_t* bhist = whist + warps * kDigits;                      // [2][kDigits], published
  uint32_t* dbase = bhist + 2 * kDigits;                          // [kDigits]
  uint32_t* total = dbase + kDigits;                              // [kDigits]
  int* one_digit = reinterpret_cast<int*>(total + kDigits);

  for (int i = tid; i < tile; i += nthreads)
    buf[i] = (static_cast<uint64_t>(static_cast<uint32_t>(io.key[base + tile_lo + i])) << 32) |
             static_cast<uint32_t>(tile_lo + i);

  const unsigned lower = (1u << lane) - 1u;
  uint32_t* wh = whist + warp * kDigits;
  int cur = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 32 + pass * kDigitBits;
    const uint64_t* src = buf + cur * tile;
    uint64_t* dst = buf + (cur ^ 1) * tile;
    // alternate histograms: a block may run ahead into the next pass while
    // the others still read this one (a skipped pass has no second barrier)
    uint32_t* hist = bhist + (pass & 1) * kDigits;
    for (int i = tid; i < warps * kDigits; i += nthreads) whist[i] = 0;
    __syncthreads();

    // rank within the warp, in index order: earlier rounds, then lower lanes
    uint64_t v[kItems];
    int dig[kItems];
    uint32_t rk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int idx = (warp * kItems + j) * 32 + lane;
      const bool valid = idx < tile;
      v[j] = valid ? src[idx] : 0;
      const int d = valid ? static_cast<int>((v[j] >> shift) & (kDigits - 1)) : kDigits;
      dig[j] = d;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const uint32_t seen = valid ? wh[d] : 0;
      rk[j] = seen + __popc(peers & lower);
      __syncwarp();
      if (valid && (peers & lower) == 0) wh[d] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit: the lower warps' count (in place), the block's total
    for (int d = tid; d < kDigits; d += nthreads) {
      uint32_t s = 0;
      for (int w = 0; w < warps; ++w) {
        const uint32_t c = whist[w * kDigits + d];
        whist[w * kDigits + d] = s;
        s += c;
      }
      hist[d] = s;
    }
    cluster.sync();  // every block's histogram is out

    for (int d = tid; d < kDigits; d += nthreads) {
      uint32_t c[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        c[r] = r < csize ? *cluster.map_shared_rank(hist + d, r) : 0;
      uint32_t below = 0, all = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        below += r < rank ? c[r] : 0;
        all += c[r];
      }
      dbase[d] = below;
      total[d] = all;
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the chunk's digit totals, kDigits / 32 a lane
      constexpr int kPer = kDigits / 32;
      uint32_t t[kPer], s = 0;
      bool whole = false;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        t[q] = total[lane * kPer + q];
        s += t[q];
        whole |= t[q] == static_cast<uint32_t>(chunk);
      }
      uint32_t incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      uint32_t run = incl - s;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        dbase[lane * kPer + q] += run;
        run += t[q];
      }
      whole = __any_sync(0xffffffffu, whole);
      if (lane == 0) *one_digit = whole;
    }
    __syncthreads();
    if (*one_digit) continue;  // a stable pass over one digit keeps the order

#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (dig[j] == kDigits) continue;
      const uint32_t pos = dbase[dig[j]] + wh[dig[j]] + rk[j];
      const int owner = static_cast<int>(pos) / tile;
      cluster.map_shared_rank(dst, owner)[pos - owner * tile] = v[j];
    }
    cluster.sync();  // every pair is in its place
    cur ^= 1;
  }
  // this block reads no other block's shared memory from here on; it waits
  // for the others at its end, so that none exits while another may read
  // its histograms
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");

  const uint64_t* fin = buf + cur * tile;
  int lanes[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = tid + q * nthreads;
    lanes[q] = 0;
    if (i < tile) {
      const uint64_t x = fin[i];
      lanes[q] = static_cast<int>(x & 0xffffffffu);
      io.o_key[base + tile_lo + i] = static_cast<long long>(x >> 32);
      io.o_lane[base + tile_lo + i] = base + lanes[q];
    }
  }
  gather_planes(io, base, tile_lo, lanes, tile);
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The opt-ins a shape needs: dynamic shared memory past 48 KiB, clusters
// past the portable 8 blocks.
cudaError_t configure(const Shape& s) {
  cudaError_t err = cudaSuccess;
  if (s.smem > 48 * 1024)
    err = cudaFuncSetAttribute(sort_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.smem));
  if (err == cudaSuccess && s.cluster > 8)
    err = cudaFuncSetAttribute(sort_chunks_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t launch_config(const Shape& s, int n_chunks, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_chunks * s.cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(s.threads));
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(s.cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool chunk_ok(int chunk) { return chunk >= 2 && chunk <= kMaxChunk && (chunk & (chunk - 1)) == 0; }

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_sort.py:111 (sort_chunks, pallas_call :131).
// `ins`/`outs`/`bytes`: host arrays of n_ops plane pointers and element
// sizes (4 or 8).  One launch of n / chunk clusters.  Returns the CUDA error
// of the launch (0: accepted); allocates nothing and does not synchronise.
int spt_sort_chunks(const long long* key, long long* o_key, long long* o_lane,
                    const void* const* ins, void* const* outs, const int* bytes, int n_ops,
                    int n, int chunk, void* stream) {
  if (!chunk_ok(chunk) || n < 0 || n % chunk != 0 || n_ops < 0 || n_ops > kMaxOps)
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
  const Shape s = shape_of(chunk);
  cudaError_t err = configure(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(s, n / chunk, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, sort_chunks_kernel, io);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape at `chunk` (blocks per cluster, threads and dynamic shared
// bytes a block), the clusters of that shape the device holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot run), and the kernel's
// registers per thread and local (spill) bytes.
int spt_sort_kernel_info(int chunk, int* cluster, int* threads, int* smem, int* active_clusters,
                         int* num_regs, int* local_bytes) {
  if (!chunk_ok(chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(chunk);
  cudaError_t err = configure(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(s, 1, nullptr, &attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, sort_chunks_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, sort_chunks_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cluster = s.cluster;
  *threads = s.threads;
  *smem = static_cast<int>(s.smem);
  *active_clusters = active;
  *num_regs = attrs.numRegs;
  *local_bytes = static_cast<int>(attrs.localSizeBytes);
  return 0;
}

}  // extern "C"
