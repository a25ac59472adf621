// fused_frame: the wavefront depth loop of one sample.
//
// Replaces the Pallas TPU kernel spt_tpu/ops/pallas_bounce.py:1090-1322
// (`_frame_kernel`, launched by `fused_frame` :1207) in four forms:
// - small (accel mode None): brute-force loops over at most 192 primitives
//   with every table in shared memory (RolledTracer), a kernel of its own
//   (small_frame_kernel, below);
// - resident: the cluster tracer over tri_pack in global memory, with the
//   small tables (materials, lights, emitters, spheres, cluster boxes and
//   visit orders) in shared memory (ClusterTracer, spt_tracers.cuh);
// - instanced: the TLAS/BLAS tracer over the shared BLAS tri_pack in global
//   memory, with the instance rows and the BLAS boxes and visit orders in
//   shared memory (InstTracer);
// - stream: the two-level supercluster tracer (K8) over a tri_pack of any
//   size in global memory, with only the super boxes and visit orders in
//   shared memory and the cluster boxes and orders read from global memory
//   (StreamTracer; the TPU form runs pallas_stream's tiles in the kernel,
//   pallas_bounce.py:634-655).
// Each form is two kernels of the same code (spt_common.cuh, "The placement
// of the tables"): one copies the tables into every block's shared memory,
// the other (small_frame_global_kernel, fused_frame_global_kernel<1..3>)
// reads them from global memory, for the scenes whose tables do not fit a
// block (a thousand lights, thousands of instances), which the TPU kernel
// holds in VMEM.
// It computes bounces [start_bounce, max_depth) of
// spt_tpu_torch.integrators.transport (trace_bounce + shade_core) for every
// lane and hands back what the deferred environment term needs: final
// direction and throughput, radiance, the missed-ever flag and the rays
// per bounce.  A textured scene samples its texture table in-kernel (K6,
// spt_common.cuh sample_texture) in every form.  No in-kernel environment
// term.
//
// What bounds it on an H100: the path state is 58 B a lane in (12 float
// planes, the int64 RNG word, two byte flags) and 37 B out (9 float
// planes, the missed byte), 95 B (the mesh forms add 4 B a live lane for
// their queue, and copy a dead lane through in 74 B) — about 197 MB at
// 1920x1080, some 59 us at 3.35 TB/s — so device memory is not the
// limit.  Per-thread ALU work (ray-primitive tests per bounce), its
// divergence across a warp (lanes die at different bounces and take
// different scatter branches) and the latency of dependent float chains
// are; in the mesh forms, the walks' tests of each opened cluster and the
// wait for its rows (spt_tracers.cuh).
//
// The whole-frame form (whole_frame_kernel, whole_frame_global_kernel) is
// the small form run from a lane index to the render state's accumulation:
// the masked frame at spp 1 under the procedural sky in one launch.  Where
// the small form loads a lane's path state it makes the lane's primary ray
// (load_path on a Primary: transport.primary_lanes, the camera and the
// frame index read through pointers, so a captured launch sees each
// replay's), and where it writes what the deferred environment term needs
// it adds the sky term to a missed path (procedural_sky: env.procedural_sky_v)
// and the path's radiance into the accumulation (WholeIO::store:
// wavefront._wavefront_masked, render_wavefront and state.accumulate_, op
// for op).  Its lane reads and writes the accumulation's 12 B, where the
// small form's reads 58 B of path state and writes 37 B (and the PyTorch
// glue around it made some 200 passes over the lanes).
//
// Both kinds of kernel are persistent: a grid of as many blocks as the SMs
// hold at once loads the tables into shared memory once per block, and
// each warp takes lanes from a counter in global memory and refills the
// threads whose paths ended (spt_queue.cuh run_paths):
// - lane refill: at the top of its bounce loop a warp hands the next lanes
//   of its chunk to its threads whose paths ended once enough of them are
//   free, so a warp whose paths die early keeps working on new ones instead
//   of idling beside its longest path.  Each path runs exactly the
//   arithmetic it runs alone (its own bounce index and is_last) and writes
//   its outputs at its own lane, so only which thread computes a path
//   changes, never a bit of its result;
// - the rays per bounce counted in the kernel: a block histograms how many
//   bounces its paths ran (warp-aggregated shared atomics) and adds the
//   suffix sums to the int64 output, one atomic a block and bounce; the
//   path state is read in the dtypes the port keeps it in (the RNG word as
//   int64, the flags as bytes), so the wrapper converts nothing.
//
// The small form (small_frame_kernel) takes every lane in turn, in chunks
// of kChunk on all 32 threads of a warp.  Small chunks keep the warps' ends
// together (chunks of 512 lanes took 2.7x the time of 32 on default).
// Refilling at 8 free threads is the compromise measured over the three
// small configs: at 4, cornell gains 3 % and hdr loses 3 %; at 16, hdr
// gains 3 % and cornell loses 11 %; refilling only whole warps takes 1.29x
// on cornell.  6 blocks of 128 threads per SM: the launch bound caps it at
// 80 registers, and it spills (56 B stored, 76 B loaded a thread, 72 B of
// stack); 5 blocks (93 registers, no spill) took 3 %, 5 % and 5 % more time
// on default, cornell and hdr, 8 (64 registers) more on two of them.  Its
// triangle and sphere rows are float4s (spt_tracers.cuh tri_test /
// sph_test).
//
// The mesh forms (fused_frame_kernel<1..3>) are built for what the sorted
// frame hands them: the last bounce of a few thousand live lanes among
// 65 536-196 608, packed at the head of each sort chunk, where a grid of
// one thread per lane left most SMs idle and had every block load the
// tables only to copy dead lanes through.  They are queue kernels
// (spt_queue.cuh, shared with fused_bounce's resident form): a coalesced
// sweep copies the dead lanes through and queues the live ones, a grid
// barrier, then warps take queued lanes `take` at a time and run each path
// on 32 / take threads in step (twins walking each ray as a group:
// spt_tracers.cuh group_walk, a window of box tests at once, the 64 tests
// of each opened cluster spread over the group, the instanced tracer's
// instance scan split over it), or at take 32 (a dense call: every lane of
// bounce 0, the unsorted route) one path a thread with the warp's lockstep
// walk.  The queue's counters follow the rays per bounce in the caller's
// buffer.
// The constants were chosen on the card with frame_sweep.py (PERF.md): a
// warp refills only once all its paths have ended, since refilling at 8
// free threads mixes a primary ray into a warp of later bounces and took
// 11-25 % more time on the grids' dense calls; a launch bound of 3 blocks
// per SM (155-165 registers, 32 B of spill) took 25-42 % more on the
// grids' sorted calls; a floor of 2 lanes a warp took 1.3x on the mesh
// scene's 1207 live lanes.

#include "spt_queue.cuh"

namespace {

using namespace spt;

struct FrameIO {
  PathIn in;
  float *o_dx, *o_dy, *o_dz, *o_tx, *o_ty, *o_tz, *o_rx, *o_ry, *o_rz;
  uint8_t* o_missed;
  // (max_depth + 3), zeroed by the caller: the rays per bounce, then the
  // counters of lanes handed out, of lanes queued (mesh forms) and of the
  // blocks at the grid barrier (mesh forms: gridDim.x once it is passed)
  unsigned long long* counts;
  int* queue;  // mesh forms: (n) the live lanes' ids; small form: null
  int n, start_bounce, max_depth;

  // run_paths: bounces [start_bounce, max_depth), the rays counted
  static constexpr bool kCountsRays = true;
  __device__ unsigned long long* handed() const { return counts + max_depth; }
  __device__ int first() const { return start_bounce; }
  __device__ int stop() const { return max_depth; }
  __device__ bool last(int bounce) const { return bounce == max_depth - 1; }
  __device__ void store(int i, const Path& p) const {
    o_dx[i] = p.d.x;
    o_dy[i] = p.d.y;
    o_dz[i] = p.d.z;
    o_tx[i] = p.thr.x;
    o_ty[i] = p.thr.y;
    o_tz[i] = p.thr.z;
    o_rx[i] = p.rad.x;
    o_ry[i] = p.rad.y;
    o_rz[i] = p.rad.z;
    o_missed[i] = p.missed;
  }
};

// The whole-frame form's path state at refill: a lane's primary ray.
struct Primary {
  // position, forward, right, up, half_width, half_height (14 floats)
  const float* camera;
  const int* frame_index;  // the render state's RNG epoch
  int width, row0, jitter;
  float inv_w, inv_h;  // 1 / width, 1 / height, rounded as the host rounds them
};

// transport.primary_lanes for lane i at spp 1, op for op as PyTorch runs it
// on the card: the pixel's RNG seed (rng.seed_paths), the jitter's two
// draws, x and y (a division by a Python scalar is a multiplication by its
// reciprocal there), Camera.ray_directions_v and vec3.safe_normalize; the
// origin is position + 0, the throughput 1, the radiance 0, alive, emission
// counted.
__device__ __forceinline__ Path load_path(const Primary& in, int i, int bounce) {
  const int pixel = in.row0 * in.width + i;
  const float px = static_cast<float>(pixel % in.width);
  const float py = static_cast<float>(pixel / in.width);
  Path p;
  p.rng = wang_hash((static_cast<uint32_t>(pixel) + 1u) ^
                    (static_cast<uint32_t>(*in.frame_index) * 9781u + 1u));
  float ju = 0.5f, jv = 0.5f;
  if (in.jitter) {
    ju = next_float(p.rng);
    jv = next_float(p.rng);
  }
  const float x = (px + ju) * in.inv_w;
  const float y = (py + jv) * in.inv_h;
  const float nx = (x - 0.5f) * 2.0f;
  const float ny = -(y - 0.5f) * 2.0f;
  const float* c = in.camera;
  const float hw = c[12], hh = c[13];
  p.d = safe_normalize(v3(c[3] + nx * (hw * c[6]) + ny * (hh * c[9]),
                          c[4] + nx * (hw * c[7]) + ny * (hh * c[10]),
                          c[5] + nx * (hw * c[8]) + ny * (hh * c[11])));
  p.o = v3(c[0] + 0.0f, c[1] + 0.0f, c[2] + 0.0f);
  p.thr = v3(1.0f, 1.0f, 1.0f);
  p.rad = v3(0.0f, 0.0f, 0.0f);
  p.alive = true;
  p.emok = true;
  p.missed = false;
  p.bounce = bounce;
  p.nb = 0;
  return p;
}

// torch.clamp as PyTorch runs it on the card: a NaN passes through.
__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// env.procedural_sky_v of a normalized direction, op for op (math3d.smoothstep
// with edges 0 and 1, the powers through powf as torch.pow by a scalar).
__device__ __forceinline__ V3 procedural_sky(V3 d, V3 sun) {
  float t = 0.5f * (d.y + 1.0f);
  t = torch_clamp((t - 0.0f) * (1.0f / (1.0f - 0.0f)), 0.0f, 1.0f);
  t = t * t * (3.0f - 2.0f * t);
  V3 sky = v3(F32(0.7) * (1.0f - t) + F32(0.2) * t, F32(0.8) * (1.0f - t) + F32(0.4) * t,
              F32(0.9) * (1.0f - t) + F32(0.8) * t);
  float sun_dot = d.x * sun.x + d.y * sun.y + d.z * sun.z;
  sun_dot = isnan(sun_dot) ? sun_dot : fmaxf(sun_dot, 0.0f);
  const float glow = powf(sun_dot, 64.0f) + powf(sun_dot, 8.0f) * F32(0.3);
  sky = v3(sky.x + glow * 1.0f, sky.y + glow * F32(0.9), sky.z + glow * F32(0.7));
  return scale(sky, F32(0.8));
}

// The samples a pixel of the whole-frame form's frame (cfg.spp).
constexpr float kWholeSpp = 1.0f;

// The whole-frame form's IO: bounces [0, max_depth) of primary rays made at
// refill, each ended path's radiance added into the accumulation.
struct WholeIO {
  Primary in;
  float* accum;  // (n, 3) the band's sums of radiance
  // (max_depth + 3), zeroed by the caller: the rays per bounce, then the
  // lanes handed out (FrameIO's layout)
  unsigned long long* counts;
  int n, max_depth;
  V3 sun;  // env.SUN_DIRECTION in float32
  static constexpr int start_bounce = 0;
  static constexpr int* queue = nullptr;  // every lane in turn: no queue

  static constexpr bool kCountsRays = true;
  __device__ unsigned long long* handed() const { return counts + max_depth; }
  __device__ int first() const { return 0; }
  __device__ int stop() const { return max_depth; }
  __device__ bool last(int bounce) const { return bounce == max_depth - 1; }
  // the deferred sky term of a missed path (_wavefront_masked: radiance +
  // where(missed, throughput * sky(safe_normalize(direction)), 0)), the
  // sample's mean (render_wavefront: (0 + radiance) / spp) and its fold into
  // the sums (accumulate_: accum + mean * spp)
  __device__ void store(int i, const Path& p) const {
    V3 r;
    if (p.missed) {
      const V3 env = procedural_sky(safe_normalize(p.d), sun);
      r = v3(p.rad.x + p.thr.x * env.x, p.rad.y + p.thr.y * env.y, p.rad.z + p.thr.z * env.z);
    } else {
      r = v3(p.rad.x + 0.0f, p.rad.y + 0.0f, p.rad.z + 0.0f);
    }
    const float inv_spp = 1.0f / kWholeSpp;
    float* a = accum + 3 * static_cast<size_t>(i);
    a[0] = a[0] + ((0.0f + r.x) * inv_spp) * kWholeSpp;
    a[1] = a[1] + ((0.0f + r.y) * inv_spp) * kWholeSpp;
    a[2] = a[2] + ((0.0f + r.z) * inv_spp) * kWholeSpp;
  }
};

// The small form's launch shape and refill, chosen on the card with
// frame_sweep.py (PERF.md).
constexpr int kSmallBlock = 128;     // threads a block
constexpr int kSmallMinBlocks = 6;   // __launch_bounds__ blocks per SM
constexpr int kRefillMin = 8;        // free threads at which a warp refills
constexpr int kChunk = 32;           // lanes a warp takes from the counter at once
static_assert(kSmallBlock % 32 == 0, "the refill works on whole warps");

// The mesh forms', chosen on the card with frame_sweep.py (PERF.md).
constexpr int kFrameMinBlocks = 4;   // __launch_bounds__ blocks per SM

// Dynamic shared memory of a fused_frame block: the tables (the shared
// placement; and, in a mesh form, the visit orders and the warps' staging
// buffers), then the histogram of bounces run (0 .. max_depth -
// start_bounce).
__host__ __device__ inline size_t frame_smem(const SceneArgs& sc, int span, bool global) {
  const size_t tables =
      sc.pack == nullptr
          ? (global ? 0 : sizeof(float) * static_cast<size_t>(small_table_words(sc)))
          : smem_bytes(sc, global);
  return tables + sizeof(int) * static_cast<size_t>(span + 1);
}

// Adds the block's histogram of bounces run to the rays per bounce: a path
// that ran nb bounces was live at bounces start .. start + nb - 1.
template <class IO>
__device__ inline void add_rays(const IO& io, const int* hist) {
  const int span = io.max_depth - io.start_bounce;
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    unsigned long long live = 0;
    for (int k = j + 1; k <= span; ++k) live += static_cast<unsigned long long>(hist[k]);
    if (live != 0) atomicAdd(io.counts + io.start_bounce + j, live);
  }
}

// Each form is defined once as a macro and instantiated twice: NAME with
// GLOBAL false copies the tables into shared memory, the *_global_kernel
// with GLOBAL true reads them from global memory (spt_common.cuh
// load_tables).  A macro, not a common inlined body, so that each kernel's
// body is its own text and the shared kernels compile to the code they had
// before the global ones existed (a common body changed the stream form's
// SASS and local bytes).  The small form's IO is FrameIO, the whole-frame
// form's WholeIO: the same loop, instantiated apart.
#define SPT_SMALL_FRAME_KERNEL(NAME, GLOBAL, IO)                                    \
  __global__ void __launch_bounds__(kSmallBlock, kSmallMinBlocks)                   \
      NAME(IO io, SceneArgs sc, ShadeArgs sa) {                                     \
    extern __shared__ __align__(16) float small_smem[];                             \
    const int span = io.max_depth - io.start_bounce;                                \
    int* hist = reinterpret_cast<int*>(small_smem + (GLOBAL ? 0 : small_table_words(sc))); \
    for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;              \
    /* the loader's barrier covers hist */                                          \
    const Tables tb = load_small_tables<GLOBAL>(small_smem, sc);                    \
    run_paths<false>(io, tb, RolledTracer{&tb}, sa, hist, io.n, kChunk, 32, kRefillMin); \
    add_rays(io, hist);                                                             \
  }

SPT_SMALL_FRAME_KERNEL(small_frame_kernel, false, FrameIO)
SPT_SMALL_FRAME_KERNEL(small_frame_global_kernel, true, FrameIO)
SPT_SMALL_FRAME_KERNEL(whole_frame_kernel, false, WholeIO)
SPT_SMALL_FRAME_KERNEL(whole_frame_global_kernel, true, WholeIO)

// The mesh forms.  kMode: 1 resident (ClusterTracer), 2 instanced
// (InstTracer), 3 stream (StreamTracer).
#define SPT_FUSED_FRAME_KERNEL(NAME, GLOBAL)                                        \
  template <int kMode>                                                              \
  __global__ void __launch_bounds__(kBlock, kFrameMinBlocks)                        \
      NAME(FrameIO io, SceneArgs sc, ShadeArgs sa) {                                \
    extern __shared__ __align__(16) float smem[];                                   \
    unsigned long long* queued = io.counts + io.max_depth + 1;                      \
    /* dead lanes' outputs are their inputs, missed 0 */                            \
    sweep_queue(io.in.alive, io.n, io.start_bounce < io.max_depth, queued, io.queue, \
                [&](int i) {                                                        \
                  io.o_dx[i] = io.in.dx[i];                                         \
                  io.o_dy[i] = io.in.dy[i];                                         \
                  io.o_dz[i] = io.in.dz[i];                                         \
                  io.o_tx[i] = io.in.tx[i];                                         \
                  io.o_ty[i] = io.in.ty[i];                                         \
                  io.o_tz[i] = io.in.tz[i];                                         \
                  io.o_rx[i] = io.in.rx[i];                                         \
                  io.o_ry[i] = io.in.ry[i];                                         \
                  io.o_rz[i] = io.in.rz[i];                                         \
                  io.o_missed[i] = 0;                                               \
                });                                                                 \
    grid_barrier(queued + 1);                                                       \
    int live;                                                                       \
    const int take = queue_take(queued, live);                                      \
    if (take == 0) return;                                                          \
                                                                                    \
    const int span = io.max_depth - io.start_bounce;                                \
    int* hist = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + smem_bytes(sc, GLOBAL)); \
    for (int k = threadIdx.x; k <= span; k += blockDim.x) hist[k] = 0;              \
    /* the loader's barrier covers hist */                                          \
    const Tables tb = load_tables<GLOBAL>(smem, sc);                                \
    run_queue<kMode>(io, tb, sc, sa, hist, live, take);                             \
    add_rays(io, hist);                                                             \
  }

SPT_FUSED_FRAME_KERNEL(fused_frame_kernel, false)
SPT_FUSED_FRAME_KERNEL(fused_frame_global_kernel, true)

// One launch of a form in the placement `global`: Shared is the kernel of
// the shared placement, Global that of the global one.
template <class Shared, class Global>
inline cudaError_t launch_frame(Shared shared, Global global_form, bool global, FrameIO& io,
                                SceneArgs& sc, ShadeArgs& sa, size_t smem, cudaStream_t st) {
  return global ? launch_queue(global_form, io, sc, sa, smem, st)
                : launch_queue(shared, io, sc, sa, smem, st);
}

}  // namespace

extern "C" {

// Replaces spt_tpu/ops/pallas_bounce.py:1207 (fused_frame, pallas_call
// :1298): bounces [start_bounce, max_depth) of lanes whose RNG words are
// int64 and flags bytes, writing `missed` as bytes and adding the rays per
// bounce into counts[0 .. max_depth) of the zeroed (max_depth + 3) int64
// `counts` (the rest are the kernel's counters).  A null `pack` selects the
// small form, n_inst > 0 the instanced one, `cbox` (with `corder`) the
// stream one, else the resident one; a mesh form needs `queue`, (n) int32
// scratch.  `global_tables` nonzero selects the global placement of the
// tables (spt_common.cuh; the small form's `tables` then 16-byte aligned),
// else the shared one, refused when a block's shared memory cannot hold
// it.  One persistent launch on `stream` (cooperative in the mesh forms);
// returns the CUDA error of the launch (0: accepted).  Allocates nothing
// and does not synchronise.
int spt_fused_frame(const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tx, const float* ty,
                    const float* tz, const float* rx, const float* ry, const float* rz,
                    const long long* rng, const uint8_t* alive, const uint8_t* emok,
                    float* o_dx, float* o_dy, float* o_dz, float* o_tx, float* o_ty, float* o_tz,
                    float* o_rx, float* o_ry, float* o_rz, uint8_t* o_missed,
                    unsigned long long* counts, int* queue, const float* tables, int n_tris,
                    int n_sphs, int n_mats, int n_lights, int n_emit, int flags,
                    const float* pack, int pack_w, int n_clusters, int cluster_size,
                    int n_inst, int n_meshes, const int* tex, int tex_res, const float* cbox,
                    const uint16_t* corder, int global_tables, int n, int start_bounce,
                    int max_depth,
                    int rr_after, float hit_eps, float ray_offset_dir, float firefly_clamp,
                    void* stream) {
  FrameIO io{{ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz, rng, alive, emok},
             o_dx, o_dy, o_dz, o_tx, o_ty, o_tz, o_rx, o_ry, o_rz, o_missed, counts, queue,
             n, start_bounce, max_depth};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
               pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
               cbox, corder};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const bool small = pack == nullptr;
  const bool global = global_tables != 0;
  if (n_mats < 1 || start_bounce < 0 || start_bounce > max_depth ||
      (!small && queue == nullptr) || (cbox != nullptr && corder == nullptr) ||
      (small && global && reinterpret_cast<uintptr_t>(tables) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = frame_smem(sc, max_depth - start_bounce, global);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (small) {
    void (*kernel)(FrameIO, SceneArgs, ShadeArgs) = small_frame_kernel;
    if (global) kernel = small_frame_global_kernel;
    int blocks = 0;
    err = resident_blocks(kernel, kSmallBlock, smem, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    // no more blocks than the lanes give each warp a chunk
    const int lanes_a_block = kChunk * (kSmallBlock / 32);
    const int grid = max(1, min(blocks, (n + lanes_a_block - 1) / lanes_a_block));
    kernel<<<grid, kSmallBlock, smem, st>>>(io, sc, sa);
  } else if (n_inst > 0) {
    err = launch_frame(fused_frame_kernel<2>, fused_frame_global_kernel<2>, global, io, sc, sa,
                       smem, st);
  } else if (cbox != nullptr) {
    err = launch_frame(fused_frame_kernel<3>, fused_frame_global_kernel<3>, global, io, sc, sa,
                       smem, st);
  } else {
    err = launch_frame(fused_frame_kernel<1>, fused_frame_global_kernel<1>, global, io, sc, sa,
                       smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The whole-frame form (whole_frame_kernel): the masked frame at spp 1 under
// the procedural sky of the band of n = width x rows lanes from row `row0`,
// from each lane's primary ray (the camera, 14 floats, and the int32 frame
// index read on the device) to its radiance added into the (n, 3) `accum`;
// the rays per bounce are added into counts[0 .. max_depth) of the zeroed
// (max_depth + 3) int64 `counts`, as spt_fused_frame's.  `jitter` nonzero
// draws the subpixel offset; `sun` is env.SUN_DIRECTION in float32.  The
// scene arguments are the small form's (`global_tables` as there).  One
// persistent launch on `stream`; returns the CUDA error of the launch (0:
// accepted).  Allocates nothing and does not synchronise.
int spt_whole_frame(const float* camera, const int* frame_index, float* accum,
                    unsigned long long* counts, const float* tables, int n_tris, int n_sphs,
                    int n_mats, int n_lights, int n_emit, int flags, const int* tex, int tex_res,
                    int global_tables, int n, int width, int height, int row0, int max_depth,
                    int jitter, float sun_x, float sun_y, float sun_z, int rr_after,
                    float hit_eps, float ray_offset_dir, float firefly_clamp, void* stream) {
  // PyTorch divides a tensor by a Python scalar as a multiplication by the
  // scalar's reciprocal, taken on the host in float
  const float inv_w = 1.0f / static_cast<float>(width);
  const float inv_h = 1.0f / static_cast<float>(height);
  WholeIO io{{camera, frame_index, width, row0, jitter, inv_w, inv_h},
             accum, counts, n, max_depth, V3{sun_x, sun_y, sun_z}};
  SceneArgs sc{tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, nullptr,
               0, 0, 0, 0, 1, tex, tex_res, nullptr, nullptr};
  ShadeArgs sa{rr_after, flags, hit_eps, ray_offset_dir, firefly_clamp};
  const bool global = global_tables != 0;
  if (n_mats < 1 || max_depth < 0 || width < 1 || height < 1 || row0 < 0 ||
      n % width != 0 || camera == nullptr || frame_index == nullptr ||
      (global && reinterpret_cast<uintptr_t>(tables) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = frame_smem(sc, max_depth, global);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  void (*kernel)(WholeIO, SceneArgs, ShadeArgs) = whole_frame_kernel;
  if (global) kernel = whole_frame_global_kernel;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, kSmallBlock, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more blocks than the lanes give each warp a chunk
  const int lanes_a_block = kChunk * (kSmallBlock / 32);
  const int grid = max(1, min(blocks, (n + lanes_a_block - 1) / lanes_a_block));
  kernel<<<grid, kSmallBlock, smem, static_cast<cudaStream_t>(stream)>>>(io, sc, sa);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes and blocks per SM at `smem`
// bytes of dynamic shared memory of the small (mode 0), resident (1),
// instanced (2) or stream (3) form in the shared placement, or of the same
// form in the global one (mode 4 + form); the whole-frame form's: 8 shared,
// 9 global.
int spt_fused_frame_kernel_info(int mode, int smem, int* num_regs, int* local_bytes,
                                int* blocks) {
  switch (mode) {
    case 1: return kernel_info(fused_frame_kernel<1>, smem, num_regs, local_bytes, blocks);
    case 2: return kernel_info(fused_frame_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 3: return kernel_info(fused_frame_kernel<3>, smem, num_regs, local_bytes, blocks);
    case 4:
      return kernel_info(small_frame_global_kernel, smem, num_regs, local_bytes, blocks,
                         kSmallBlock);
    case 5: return kernel_info(fused_frame_global_kernel<1>, smem, num_regs, local_bytes, blocks);
    case 6: return kernel_info(fused_frame_global_kernel<2>, smem, num_regs, local_bytes, blocks);
    case 7: return kernel_info(fused_frame_global_kernel<3>, smem, num_regs, local_bytes, blocks);
    case 8:
      return kernel_info(whole_frame_kernel, smem, num_regs, local_bytes, blocks, kSmallBlock);
    case 9:
      return kernel_info(whole_frame_global_kernel, smem, num_regs, local_bytes, blocks,
                         kSmallBlock);
    default:
      return kernel_info(small_frame_kernel, smem, num_regs, local_bytes, blocks, kSmallBlock);
  }
}

const char* spt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
