// K2: batched per-chunk flow-field integration (min-plus relaxation).
//
// Replaces the Pallas kernel `integrate_pallas` / `_integrate_kernel` of
// permafrost_engine_tpu/ops/flowfield_pallas.py; the plain PyTorch version
// it is held against is ops/flowfield.integrate_plain.
//
// What it computes, per 64x64 chunk: Jacobi 8-neighbour min-plus sweeps of
// integ[t] = min(integ[t], integ[n] + step(t, n)) with orthogonal steps
// costing cost[t] and diagonal steps cost[t] * f32(sqrt 2) (allowed only when
// both orthogonal tiles are passable), tiles outside the chunk at INF_COST,
// run in bundles of 8 sweeps until a bundle changes nothing or 4*64 sweeps
// ran; then seeds are re-imposed: out = seed & passable ? seed_cost : integ.
//
// What bounds it on an H100: latency, not bytes. One chunk reads 4 KB of
// costs + 4 KB of seeds (+16 KB of seed costs) and writes 16 KB, but needs up
// to 256 dependent sweeps of 4096 tiles x 8 neighbours; a path request has a
// few to a hundred chunks, far fewer than the 132 SMs can hold.
//
// Design: one 256-thread block per chunk. The field lives in shared memory
// for the whole solve, double-buffered (2 x 16 KB) with a passable mask
// beside it; each thread owns 16 tiles (tile = thread + 256 * j, so a warp
// touches 32 consecutive words) and keeps their step costs, diagonal masks
// and seed values in registers. One __syncthreads() per sweep, and
// __syncthreads_or() on "my tiles changed" once per bundle of 8. Device
// memory is touched once on the way in and once on the way out.
//
// Rounding: the diagonal step is __fmul_rn(cost, sqrt2) and every add is
// __fadd_rn, and the file is built with -fmad=false, so nothing is contracted
// into an FMA: each value rounds exactly where the JAX and PyTorch versions
// round, and the field is bit-equal to them. The sweep schedule, including
// the 256-sweep cap, is the Jacobi one of the reference kernel: a
// Gauss-Seidel or wavefront order would give a different field whenever the
// cap binds on a serpentine chunk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RES = 64;
constexpr int TILES = RES * RES;
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILES / THREADS;   // 16
constexpr int MAX_SWEEPS = 4 * RES;
constexpr int BUNDLE = 8;
constexpr float INF_COST = 3.0e38f;
constexpr float SQRT2_F = 1.41421353816986083984375f;   // f32(sqrt 2)

__global__ void __launch_bounds__(THREADS)
integrate_kernel(const uint8_t* __restrict__ cost,
                 const uint8_t* __restrict__ seed,
                 const float* __restrict__ seed_cost,
                 float* __restrict__ out) {
  __shared__ float field[2][TILES];
  __shared__ uint8_t pass[TILES];

  const size_t base = (size_t)blockIdx.x * TILES;
  const int t = threadIdx.x;

  float step_o[PER_THREAD];
  float step_d[PER_THREAD];
  float seedv[PER_THREAD];
  uint8_t flags[PER_THREAD];   // bit0 passable, bit1 seeded,
                               // bits 4..7 diagonal NW NE SW SE allowed

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = t + j * THREADS;
    pass[i] = cost[base + i] != 255;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = t + j * THREADS;
    const int r = i / RES, c = i % RES;
    const bool p = pass[i];
    const float so = p ? (float)cost[base + i] : INF_COST;
    step_o[j] = so;
    step_d[j] = __fmul_rn(so, SQRT2_F);
    const bool pn = r > 0 && pass[i - RES];
    const bool ps = r < RES - 1 && pass[i + RES];
    const bool pw = c > 0 && pass[i - 1];
    const bool pe = c < RES - 1 && pass[i + 1];
    const bool seeded = p && seed[base + i] != 0;
    const float sv = seed_cost != nullptr ? seed_cost[base + i] : 0.0f;
    seedv[j] = sv;
    flags[j] = (uint8_t)((p ? 1 : 0) | (seeded ? 2 : 0)
                         | ((pn && pw) ? 16 : 0) | ((pn && pe) ? 32 : 0)
                         | ((ps && pw) ? 64 : 0) | ((ps && pe) ? 128 : 0));
    field[0][i] = seeded ? sv : INF_COST;
  }
  __syncthreads();

  int cur = 0;
  for (int sweep = 0; sweep < MAX_SWEEPS; sweep += BUNDLE) {
    float before[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) before[j] = field[cur][t + j * THREADS];

    for (int s = 0; s < BUNDLE; ++s) {
      const float* a = field[cur];
      float* b = field[cur ^ 1];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = t + j * THREADS;
        const int r = i / RES, c = i % RES;
        const uint8_t f = flags[j];
        if (!(f & 1)) {
          b[i] = INF_COST;
          continue;
        }
        const bool hn = r > 0, hs = r < RES - 1, hw = c > 0, he = c < RES - 1;
        const float so = step_o[j], sd = step_d[j];
        float best = a[i];
        // FlowDir order NW N NE W E SW S SE; a diagonal neighbour that is
        // not allowed contributes INF_COST, like the reference's where()
        best = fminf(best, (f & 16) ? __fadd_rn(hn && hw ? a[i - RES - 1] : INF_COST, sd) : INF_COST);
        best = fminf(best, __fadd_rn(hn ? a[i - RES] : INF_COST, so));
        best = fminf(best, (f & 32) ? __fadd_rn(hn && he ? a[i - RES + 1] : INF_COST, sd) : INF_COST);
        best = fminf(best, __fadd_rn(hw ? a[i - 1] : INF_COST, so));
        best = fminf(best, __fadd_rn(he ? a[i + 1] : INF_COST, so));
        best = fminf(best, (f & 64) ? __fadd_rn(hs && hw ? a[i + RES - 1] : INF_COST, sd) : INF_COST);
        best = fminf(best, __fadd_rn(hs ? a[i + RES] : INF_COST, so));
        best = fminf(best, (f & 128) ? __fadd_rn(hs && he ? a[i + RES + 1] : INF_COST, sd) : INF_COST);
        b[i] = best;
      }
      __syncthreads();
      cur ^= 1;
    }

    int changed = 0;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      changed |= field[cur][t + j * THREADS] != before[j];
    if (!__syncthreads_or(changed)) break;
  }

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = t + j * THREADS;
    out[base + i] = (flags[j] & 2) ? seedv[j] : field[cur][i];
  }
}

}  // namespace

extern "C" int pf_integrate(const uint8_t* cost, const uint8_t* seed,
                            const float* seed_cost, float* out, int k,
                            void* stream) {
  if (k <= 0) return 0;
  integrate_kernel<<<k, THREADS, 0, (cudaStream_t)stream>>>(cost, seed,
                                                            seed_cost, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
