// K2: batched flow-field integration (min-plus relaxation), for 64x64
// chunks and for whole maps, as one thread-block-cluster kernel.
//
// Replaces the Pallas kernel `integrate_pallas` / `_integrate_kernel` of
// permafrost_engine_tpu/ops/flowfield_pallas.py, and the whole-map
// `ff.integrate` the JAX package runs on XLA for its chase fields
// (nav/service.py there); the plain PyTorch version it is held against is
// ops/flowfield.integrate_plain.
//
// What it computes, per field of H x W (both multiples of 64): Jacobi
// 8-neighbour min-plus sweeps of integ[t] = min(integ[t], integ[n] +
// step(t, n)) with orthogonal steps costing cost[t] and diagonal steps
// cost[t] * f32(sqrt 2) (allowed only when both orthogonal tiles are
// passable), tiles outside the field at INF_COST, run in bundles of 8 sweeps
// until a bundle changes nothing or `max_iters` sweeps ran; then seeds are
// re-imposed: out = seed & passable ? seed_cost : integ.
//
// What bounds it on an H100: the latency of dependent sweeps, not bytes or
// flops. A 256x256 field reads 128 KB of costs and seeds and writes 256 KB,
// and a sweep is ~1 M operations, but the sweeps run one after another (hundreds
// to the fixed point, up to 4*max(H, W)) and each needs every neighbour's
// previous value. A 256x256 f32 field (256 KB) does not fit one block's
// 227 KB of shared memory, and one block per 64x64 chunk leaves SMs idle at
// the path's 68-192 chunks.
//
// Design: one cluster of P blocks per field. Block `rank` owns a strip of
// H/P rows x W columns and keeps it in shared memory for the whole solve,
// double-buffered, with one halo row above and below and a halo column on
// each side (INF_COST where the field ends). Each thread owns M consecutive
// rows of one column (a warp: 32 neighbouring columns), keeps their current
// values and step costs in registers, and streams the three columns of its
// window out of shared memory once per sweep. After a sweep the blocks at
// the strip edges store their new boundary rows straight into the
// neighbouring blocks' halo rows through distributed shared memory
// (cluster.map_shared_rank), and one cluster barrier ends the sweep: the
// only synchronisation per sweep. The bundle's "changed" flag is OR-reduced
// per block with __syncthreads_or, pushed by threads 0..P-1 into every
// block's flag table, and read after the same barrier, so every block of a
// cluster stops after the same bundle. Device memory is touched once on the
// way in and once on the way out. The cut (ops/flowfield_cuda.plan) is
// 16-row strips: 64x64 chunks as P = 4 blocks of 256 threads (4 rows each),
// a 256x256 map as P = 16 blocks (a non-portable cluster size) of 512
// threads (8 rows each), the fastest cuts measured on the H100. There a
// sweep costs ~1.4 us: ~0.65 us is the cluster barrier with its DSMEM
// stores, ~0.75 us the block's own sweep (the latency of its dependent
// loads and mins); neither is bytes or flops.
//
// Rounding: the diagonal step is __fmul_rn(cost, sqrt2) and every add is
// __fadd_rn, and the file is built with -fmad=false, so nothing is contracted
// into an FMA: each value rounds exactly where the JAX and PyTorch versions
// round, and the field is bit-equal to them. min is exact, so the order of
// the eight candidates does not matter. The sweep schedule, including the
// cap, is the Jacobi one of the reference: a Gauss-Seidel or wavefront order
// would give a different field whenever the cap binds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BUNDLE = 8;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;
constexpr uint8_t BLOCKED = 255;
constexpr float INF_COST = 3.0e38f;
constexpr float SQRT2_F = 1.41421353816986083984375f;   // f32(sqrt 2)

__device__ __forceinline__ bool passable_at(const uint8_t* cost, int h, int w,
                                            int r, int c) {
  return r >= 0 && r < h && c >= 0 && c < w
         && cost[(size_t)r * w + c] != BLOCKED;
}

// the initial value of tile (r, c): its seed cost where seeded and passable
__device__ __forceinline__ float initial_at(const uint8_t* cost,
                                            const uint8_t* seed,
                                            const float* seed_cost, int h,
                                            int w, int r, int c) {
  if (r < 0 || r >= h) return INF_COST;
  const size_t i = (size_t)r * w + c;
  if (cost[i] == BLOCKED || seed[i] == 0) return INF_COST;
  return seed_cost != nullptr ? seed_cost[i] : 0.0f;
}

template <int M>
__global__ void __launch_bounds__(MAX_THREADS)
integrate_kernel(const uint8_t* __restrict__ cost_all,
                 const uint8_t* __restrict__ seed_all,
                 const float* __restrict__ seed_cost_all,
                 float* __restrict__ out_all, int h, int w, int p,
                 int max_iters) {
  extern __shared__ float smem[];
  __shared__ int bundle_changed[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  const size_t off = (size_t)(blockIdx.x / p) * h * w;
  const uint8_t* cost = cost_all + off;
  const uint8_t* seed = seed_all + off;
  const float* seed_cost = seed_cost_all != nullptr ? seed_cost_all + off
                                                    : nullptr;
  float* out = out_all + off;

  const int rows = h / p;             // strip rows
  const int sw = w + 2;               // padded row stride
  const int plane = (rows + 2) * sw;  // one buffer: strip + halo
  float* const buf0 = smem;
  float* const buf1 = smem + plane;

  const int t = threadIdx.x;
  const int c = t % w;
  const int lr0 = (t / w) * M;        // first local row of this thread
  const int r0 = rank * rows + lr0;   // its global row
  const bool top = lr0 == 0;
  const bool bottom = lr0 + M == rows;

  for (int i = t; i < 2 * plane; i += blockDim.x) smem[i] = INF_COST;
  __syncthreads();

  // this block's halo rows of the first buffer start as the neighbours'
  // initial values; the second buffer's are written by the neighbours
  if (top) buf0[c + 1] = initial_at(cost, seed, seed_cost, h, w, r0 - 1, c);
  if (bottom)
    buf0[(rows + 1) * sw + c + 1] =
        initial_at(cost, seed, seed_cost, h, w, r0 + M, c);

  float cur[M];     // this thread's tiles, current values
  float step[M];    // orthogonal step cost, INF_COST where blocked
  uint64_t diag = 0;   // 4 bits per tile: NW NE SW SE diagonal allowed
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = r0 + m;
    const uint8_t cm = cost[(size_t)r * w + c];
    step[m] = cm != BLOCKED ? (float)cm : INF_COST;
    const bool pn = passable_at(cost, h, w, r - 1, c);
    const bool ps = passable_at(cost, h, w, r + 1, c);
    const bool pw = passable_at(cost, h, w, r, c - 1);
    const bool pe = passable_at(cost, h, w, r, c + 1);
    diag |= (uint64_t)((pn && pw) | ((pn && pe) << 1) | ((ps && pw) << 2)
                       | ((ps && pe) << 3)) << (4 * m);
    cur[m] = initial_at(cost, seed, seed_cost, h, w, r, c);
    buf0[(lr0 + m + 1) * sw + c + 1] = cur[m];
  }

  // where this block's edge rows go: the halo rows of the neighbours'
  // buffers (the same offsets in their shared memory)
  float* const up = rank > 0 ? cluster.map_shared_rank(smem, rank - 1)
                             : nullptr;
  float* const down = rank < p - 1 ? cluster.map_shared_rank(smem, rank + 1)
                                   : nullptr;
  // every block of the cluster is running and has initialised its buffers
  cluster.sync();

  int src = 0;
  for (int sweep = 0; sweep < max_iters; sweep += BUNDLE) {
    bool changed = false;
    for (int s = 0; s < BUNDLE; ++s) {
      const int dst = src ^ 1;
      const float* a = src ? buf1 : buf0;
      float* b = dst ? buf1 : buf0;
      // the window: west, centre, east of the rows above (u), at (m) and
      // below (d) the current tile; the centre column is in registers
      const float* col = a + lr0 * sw + c;
      float uw = col[0], uc = col[1], ue = col[2];
      float mw = col[sw], mc = cur[0], me = col[sw + 2];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* below = col + (m + 2) * sw;
        const float dw = below[0], de = below[2];
        const float dc = m + 1 < M ? cur[m + 1] : below[1];
        const float so = step[m];
        float best = INF_COST;
        if (so < INF_COST) {
          // FlowDir order NW N NE W E SW S SE; a diagonal neighbour that is
          // not allowed contributes INF_COST, like the reference's where()
          const float sd = __fmul_rn(so, SQRT2_F);
          const unsigned d = (unsigned)(diag >> (4 * m));
          best = mc;
          best = fminf(best, (d & 1) ? __fadd_rn(uw, sd) : INF_COST);
          best = fminf(best, __fadd_rn(uc, so));
          best = fminf(best, (d & 2) ? __fadd_rn(ue, sd) : INF_COST);
          best = fminf(best, __fadd_rn(mw, so));
          best = fminf(best, __fadd_rn(me, so));
          best = fminf(best, (d & 4) ? __fadd_rn(dw, sd) : INF_COST);
          best = fminf(best, __fadd_rn(dc, so));
          best = fminf(best, (d & 8) ? __fadd_rn(de, sd) : INF_COST);
        }
        changed |= best != mc;
        cur[m] = best;
        b[(lr0 + m + 1) * sw + c + 1] = best;
        uw = mw; uc = mc; ue = me;
        mw = dw; mc = dc; me = de;
      }
      if (top && up != nullptr)
        up[dst * plane + (rows + 1) * sw + c + 1] = cur[0];
      if (bottom && down != nullptr) down[dst * plane + c + 1] = cur[M - 1];
      if (s == BUNDLE - 1) {
        const int any = __syncthreads_or(changed);
        if (t < p) *cluster.map_shared_rank(&bundle_changed[rank], t) = any;
      }
      cluster.sync();
      src = dst;
    }
    int any = 0;
    for (int q = 0; q < p; ++q) any |= bundle_changed[q];
    if (!any) break;
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = r0 + m;
    const size_t i = (size_t)r * w + c;
    const bool seeded = cost[i] != BLOCKED && seed[i] != 0;
    out[i] = seeded ? (seed_cost != nullptr ? seed_cost[i] : 0.0f) : cur[m];
  }
}

template <int M>
cudaError_t launch(const uint8_t* cost, const uint8_t* seed,
                   const float* seed_cost, float* out, int k, int h, int w,
                   int p, int max_iters, cudaStream_t stream) {
  const int rows = h / p;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(k * p));
  cfg.blockDim = dim3((unsigned)((rows / M) * w));
  cfg.dynamicSmemBytes = 2 * (size_t)(rows + 2) * (w + 2) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(
      integrate_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (e == cudaSuccess && p > 8)   // 16 blocks: a non-portable cluster size
    e = cudaFuncSetAttribute(integrate_kernel<M>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, integrate_kernel<M>, cost, seed, seed_cost,
                           out, h, w, p, max_iters);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// Integrate k fields of h x w with clusters of p blocks, each thread
// owning m rows of one column (m in 4, 8, 16); the caller chooses and
// checks the plan (ops/flowfield_cuda.plan). Returns a cudaError_t.
extern "C" int pf_integrate(const uint8_t* cost, const uint8_t* seed,
                            const float* seed_cost, float* out, int k, int h,
                            int w, int p, int m, int max_iters,
                            void* stream) {
  if (k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (m) {
    case 4: return (int)launch<4>(cost, seed, seed_cost, out, k, h, w, p, max_iters, st);
    case 8: return (int)launch<8>(cost, seed, seed_cost, out, k, h, w, p, max_iters, st);
    case 16: return (int)launch<16>(cost, seed, seed_cost, out, k, h, w, p, max_iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
