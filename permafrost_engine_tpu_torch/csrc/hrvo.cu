// K1: fused nearest-K neighbour selection + HRVO/ClearPath velocity solve.
//
// Replaces the Pallas kernel `hrvo_select_pallas` / `_hrvo_kernel` (with its
// helper `_topk_select`) of permafrost_engine_tpu/ops/crowd_pallas.py; the
// plain PyTorch version it is held against is ops/crowd_cuda.hrvo_select_plain.
//
// What it computes, per entity: the exact K = 32 nearest of its C2 window
// candidates (near to far, first index wins ties), invalid rows sanitized
// onto the entity itself, one HRVO cone per neighbour (tangent-point edges
// and the apex slide in exact mode), a candidate-velocity set (fan: 5 scales,
// 20 rotations, 2 x 16 edge projections = 57; exact adds 256 pairwise edge
// intersections over the nearest 8 cones and 2 x 32 free projections = 377),
// the inside_pcr feasibility of every candidate against every cone, the
// remove-furthest prefix cascade (exact), and the first minimum of
// d_vpref + 1e9 * violations + total_violation, clamped to max speed.
//
// What bounds it on an H100: arithmetic and latency, not bytes. Per entity
// it reads C2 = 144 candidates of 24 B and writes 8 B, but evaluates up to
// 377 x 32 cone tests of ~20 flops each: ~2.4 GFLOP per call at 10k
// entities in exact mode, counted from the shapes.
//
// Design: one warp per entity, since K = 32 is the warp width. Each lane
// keeps <= 16 candidate distances in registers; top-K is 32 rounds of a
// warp arg-min (lowest index wins ties) over them. Lane k then builds cone
// k into shared memory (10 floats per cone, 32 cones per warp), and each
// lane evaluates every 32nd candidate against all 32 cones, keeping the
// inside-cone set as a 32-bit mask. The prefix cascade needs no [C, K]
// cumulative sum: with first_viol[c] = index of the first cone candidate c
// is inside (K if none), the longest prefix with a feasible candidate is
// m_star = max_c first_viol[c] (one warp max), and the prefix violation
// count is popc(mask & low_bits(m_star)) (num_viol when m_star == 0). The
// pick is a warp arg-min over (score, candidate index).
//
// Rounding: built with -fmad=false, so the compiler contracts no a*b+c
// into an FMA. The candidate expressions that XLA contracts when it
// compiles the JAX reference on CPU (rotated fan, edge projections, free
// projections, intersection points) use an explicit __fmaf_rn, as the plain
// version does with its exact f64 emulation; every other expression rounds
// once per operation, in the order the plain version writes it, and
// violations are summed over cones k = 0..31 in order. HRVO near-ties
// therefore resolve as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// f32 constants of the rotated-vdes fan (cos, sin of +-15, 30, 45, 70, 90 deg)
static __constant__ float kCos[10] = {
    0.9659258127212524f, 0.9659258127212524f, 0.8660253882408142f,
    0.8660253882408142f, 0.7071067690849304f, 0.7071067690849304f,
    0.3420201539993286f, 0.3420201539993286f, 6.123234262925839e-17f,
    6.123234262925839e-17f};
static __constant__ float kSin[10] = {
    0.258819043636322f, -0.258819043636322f, 0.5f, -0.5f,
    0.7071067690849304f, -0.7071067690849304f, 0.9396926164627075f,
    -0.9396926164627075f, 1.0f, -1.0f};
static __constant__ float kScale[5] = {1.0f, 0.75f, 0.5f, 0.25f, 0.0f};

namespace {

constexpr int K = 32;                 // MAX_NEIGHBOURS
constexpr int WARPS = 4;              // entities per block
constexpr int MAX_PER_LANE = 16;      // candidates per lane: C2 <= 512
constexpr int KP = 16;                // cones with edge projections
constexpr int KX = 8;                 // cones with pairwise intersections
constexpr float EPS = 1e-6f;
constexpr float BIG = 1e9f;
constexpr float EPS_REF = 1.0f / 1024.0f;

struct Cones {
  float ax[K], az[K];      // apex
  float px[K], pz[K];      // unit direction to the neighbour
  float lx[K], lz[K];      // rot_l (the reference's right edge)
  float rx[K], rz[K];      // rot_r (the reference's left edge)
  float cos_t[K];
  int valid[K];
};

__device__ __forceinline__ void warp_argmin(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

template <bool EXACT>
__device__ __forceinline__ void candidate(int c, const Cones& s, float vpx,
                                          float vpz, float ms, float& cx,
                                          float& cz) {
  if (c < 5) {
    cx = __fmul_rn(vpx, kScale[c]);
    cz = __fmul_rn(vpz, kScale[c]);
  } else if (c < 25) {
    const int a = (c - 5) % 10;
    cx = __fmaf_rn(vpx, kCos[a], -__fmul_rn(vpz, kSin[a]));
    cz = __fmaf_rn(vpx, kSin[a], __fmul_rn(vpz, kCos[a]));
    if (c >= 15) {
      cx = __fmul_rn(cx, 0.5f);
      cz = __fmul_rn(cz, 0.5f);
    }
  } else if (c < 25 + 2 * KP) {
    const bool left = c < 25 + KP;
    const int k = left ? c - 25 : c - 25 - KP;
    const float ex = left ? s.lx[k] : s.rx[k];
    const float ez = left ? s.lz[k] : s.rz[k];
    const float wx = __fsub_rn(vpx, s.ax[k]);
    const float wz = __fsub_rn(vpz, s.az[k]);
    const float d = fmaxf(__fmaf_rn(wz, ez, __fmul_rn(wx, ex)), 0.0f);
    cx = __fmaf_rn(ex, d, s.ax[k]);
    cz = __fmaf_rn(ez, d, s.az[k]);
  } else if (EXACT && c < 25 + 2 * KP + 4 * KX * KX) {
    // pairwise ray intersections, rays i, j over 2*KX edges (rot_l of the
    // nearest KX cones, then their rot_r); pairs with i >= j fall back
    const int idx = c - (25 + 2 * KP);
    const int i = idx / (2 * KX), j = idx % (2 * KX);
    const int ki = i % KX, kj = j % KX;
    const float p1x = s.ax[ki], p1z = s.az[ki];
    const float d1x = i < KX ? s.lx[ki] : s.rx[ki];
    const float d1z = i < KX ? s.lz[ki] : s.rz[ki];
    const float p2x = s.ax[kj], p2z = s.az[kj];
    const float d2x = j < KX ? s.lx[kj] : s.rx[kj];
    const float d2z = j < KX ? s.lz[kj] : s.rz[kj];
    const float det = __fsub_rn(__fmul_rn(d1x, d2z), __fmul_rn(d1z, d2x));
    const float dpx = __fsub_rn(p2x, p1x), dpz = __fsub_rn(p2z, p1z);
    const bool nz = fabsf(det) > EPS;
    const float safe = nz ? det : 1.0f;
    const float t1 = __fdiv_rn(__fsub_rn(__fmul_rn(dpx, d2z), __fmul_rn(dpz, d2x)), safe);
    const float t2 = __fdiv_rn(__fsub_rn(__fmul_rn(dpx, d1z), __fmul_rn(dpz, d1x)), safe);
    const bool ok = nz && t1 >= 0.0f && t2 >= 0.0f && s.valid[ki] && s.valid[kj] && i < j;
    cx = ok ? __fmaf_rn(d1x, t1, p1x) : vpx;
    cz = ok ? __fmaf_rn(d1z, t1, p1z) : vpz;
  } else {
    // free-vector vdes projections on every edge (exact mode)
    const int base = 25 + 2 * KP + 4 * KX * KX;
    const bool left = c < base + K;
    const int k = left ? c - base : c - base - K;
    const float ex = left ? s.lx[k] : s.rx[k];
    const float ez = left ? s.lz[k] : s.rz[k];
    const float w = __fmaf_rn(vpz, ez, __fmul_rn(vpx, ex));
    cx = __fmaf_rn(ex, w, s.ax[k]);
    cz = __fmaf_rn(ez, w, s.az[k]);
  }
  if (!EXACT) {
    const float sp = sqrtf(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cz, cz)));
    const float sc = sp > ms ? __fdiv_rn(ms, fmaxf(sp, EPS)) : 1.0f;
    cx = __fmul_rn(cx, sc);
    cz = __fmul_rn(cz, sc);
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(WARPS * 32)
hrvo_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
            const float* __restrict__ radius, const float* __restrict__ vpref,
            const float* __restrict__ max_speed,
            const float* __restrict__ cand_pos, const float* __restrict__ cand_vel,
            const float* __restrict__ cand_rad,
            const uint8_t* __restrict__ cand_valid,
            const uint8_t* __restrict__ cand_static, float* __restrict__ out,
            int n, int c2) {
  constexpr int NC = EXACT ? 25 + 2 * KP + 4 * KX * KX + 2 * K : 25 + 2 * KP;
  constexpr int NC_PER = (NC + 31) / 32;
  __shared__ Cones cones[WARPS];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * WARPS + w;
  if (e >= n) return;                      // whole warp leaves together
  Cones& s = cones[w];

  const float px = pos[2 * e], pz = pos[2 * e + 1];
  const float vx = vel[2 * e], vz = vel[2 * e + 1];
  const float vpx = vpref[2 * e], vpz = vpref[2 * e + 1];
  const float ms = max_speed[e];
  const float rad = radius[e];
  const size_t cb = (size_t)e * c2;

  // ---- exact nearest K: 32 rounds of a warp arg-min ----------------------
  float d2[MAX_PER_LANE];
#pragma unroll
  for (int m = 0; m < MAX_PER_LANE; ++m) {
    const int c = lane + 32 * m;
    float d = INFINITY;
    if (c < c2 && cand_valid[cb + c]) {
      const float dx = __fsub_rn(cand_pos[2 * (cb + c)], px);
      const float dz = __fsub_rn(cand_pos[2 * (cb + c) + 1], pz);
      d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
    }
    d2[m] = d;
  }
  int my_sel = 0;
  bool my_valid = false;
  for (int kk = 0; kk < K; ++kk) {
    float v = INFINITY;
    int idx = 0x7fffffff;
#pragma unroll
    for (int m = 0; m < MAX_PER_LANE; ++m) {
      const int c = lane + 32 * m;
      if (c < c2 && (d2[m] < v || (d2[m] == v && c < idx))) {
        v = d2[m];
        idx = c;
      }
    }
    warp_argmin(v, idx);
    if (lane == kk) {
      my_sel = idx;
      my_valid = isfinite(v);
    }
    if (idx < c2 && (idx & 31) == lane) {
#pragma unroll
      for (int m = 0; m < MAX_PER_LANE; ++m)
        if (m == (idx >> 5)) d2[m] = INFINITY;
    }
  }

  // ---- lane k builds cone k ------------------------------------------------
  {
    float nx = px, nz = pz, nvx = 0.0f, nvz = 0.0f, nrad = 0.0f;
    bool nstat = false;
    if (my_valid) {
      const size_t ci = cb + my_sel;
      nstat = cand_static[ci] != 0;
      nx = cand_pos[2 * ci];
      nz = cand_pos[2 * ci + 1];
      nvx = nstat ? 0.0f : cand_vel[2 * ci];
      nvz = nstat ? 0.0f : cand_vel[2 * ci + 1];
      nrad = cand_rad[ci];
    }
    const float relx = __fsub_rn(nx, px), relz = __fsub_rn(nz, pz);
    const float dist = sqrtf(__fadd_rn(__fmul_rn(relx, relx), __fmul_rn(relz, relz)));
    const float comb = __fmul_rn(__fadd_rn(rad, nrad), EXACT ? 1.0f : 1.05f);
    const bool colliding = my_valid && dist < comb;
    const float dden = fmaxf(dist, EPS);
    const float phx = __fdiv_rn(relx, dden), phz = __fdiv_rn(relz, dden);
    float sin_t, cos_t;
    if (EXACT) {
      const float hyp = sqrtf(__fadd_rn(__fmul_rn(dist, dist), __fmul_rn(comb, comb)));
      const float hd = fmaxf(hyp, EPS);
      sin_t = __fdiv_rn(comb, hd);
      cos_t = __fdiv_rn(dist, hd);
    } else {
      sin_t = fminf(fmaxf(__fdiv_rn(comb, dden), 0.0f), 1.0f);
      cos_t = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(sin_t, sin_t)), 0.0f));
      if (colliding) cos_t = 0.0f;
    }
    const float rvx = __fdiv_rn(__fadd_rn(vx, nvx), 2.0f);
    const float rvz = __fdiv_rn(__fadd_rn(vz, nvz), 2.0f);
    const float lx = __fsub_rn(__fmul_rn(cos_t, phx), __fmul_rn(sin_t, phz));
    const float lz = __fadd_rn(__fmul_rn(sin_t, phx), __fmul_rn(cos_t, phz));
    const float rx = __fadd_rn(__fmul_rn(cos_t, phx), __fmul_rn(sin_t, phz));
    const float rz = __fadd_rn(__fmul_rn(-sin_t, phx), __fmul_rn(cos_t, phz));
    float ax = nstat ? nvx : rvx, az = nstat ? nvz : rvz;
    if (EXACT && !nstat) {
      const float cx = __fadd_rn(lx, rx), cz = __fadd_rn(lz, rz);
      const float vdet = __fsub_rn(__fmul_rn(cx, vz), __fmul_rn(cz, vx));
      const float nearx = vdet > 0.0f ? rx : lx, nearz = vdet > 0.0f ? rz : lz;
      const float othx = vdet > 0.0f ? lx : rx, othz = vdet > 0.0f ? lz : rz;
      const float denom = __fsub_rn(__fmul_rn(nearx, othz), __fmul_rn(nearz, othx));
      const float dpx = __fsub_rn(nvx, rvx), dpz = __fsub_rn(nvz, rvz);
      const bool nz_d = fabsf(denom) > EPS;
      float t = nz_d ? __fdiv_rn(__fsub_rn(__fmul_rn(dpx, othz), __fmul_rn(dpz, othx)), denom)
                     : 0.0f;
      t = fminf(fmaxf(t, -1e4f), 1e4f);
      if (nz_d && fabsf(vdet) > EPS) {
        ax = __fadd_rn(rvx, __fmul_rn(nearx, t));
        az = __fadd_rn(rvz, __fmul_rn(nearz, t));
      }
    }
    s.ax[lane] = ax;
    s.az[lane] = az;
    s.px[lane] = phx;
    s.pz[lane] = phz;
    s.lx[lane] = lx;
    s.lz[lane] = lz;
    s.rx[lane] = rx;
    s.rz[lane] = rz;
    s.cos_t[lane] = cos_t;
    s.valid[lane] = my_valid;
  }
  __syncwarp();

  // ---- every 32nd candidate against all 32 cones -------------------------
  uint32_t mask[NC_PER];
  float total[NC_PER], dv[NC_PER], cxs[NC_PER], czs[NC_PER];
  int first_max = 0;
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    const int c = lane + 32 * m;
    mask[m] = 0;
    total[m] = 0.0f;
    dv[m] = INFINITY;
    cxs[m] = 0.0f;
    czs[m] = 0.0f;
    if (c >= NC) continue;
    float cx, cz;
    candidate<EXACT>(c, s, vpx, vpz, ms, cx, cz);
    cxs[m] = cx;
    czs[m] = cz;
    const float c2n = __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cz, cz));
    uint32_t bits = 0;
    float tv = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float ax = s.ax[k], az = s.az[k], kx = s.px[k], kz = s.pz[k];
      const float along = __fsub_rn(__fadd_rn(__fmul_rn(cx, kx), __fmul_rn(cz, kz)),
                                    __fadd_rn(__fmul_rn(ax, kx), __fmul_rn(az, kz)));
      const float wl2 = __fadd_rn(
          __fsub_rn(c2n, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(cx, ax), __fmul_rn(cz, az)))),
          __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(az, az)));
      const float wlen = sqrtf(fmaxf(wl2, 0.0f));
      const float ct = s.cos_t[k];
      bool inside;
      if (EXACT) {
        const float lx = s.rx[k], lz = s.rz[k], rx = s.lx[k], rz = s.lz[k];
        const float ldet = __fsub_rn(__fsub_rn(__fmul_rn(cz, lx), __fmul_rn(cx, lz)),
                                     __fsub_rn(__fmul_rn(az, lx), __fmul_rn(ax, lz)));
        const float rdet = __fsub_rn(__fsub_rn(__fmul_rn(cz, rx), __fmul_rn(cx, rz)),
                                     __fsub_rn(__fmul_rn(az, rx), __fmul_rn(ax, rz)));
        const float tol = __fmul_rn(EPS_REF, wlen);
        inside = wlen >= EPS_REF && ldet >= tol && rdet <= -tol;
      } else {
        inside = along > __fadd_rn(__fmul_rn(wlen, ct), EPS);
      }
      inside = inside && s.valid[k];
      if (inside) {
        bits |= 1u << k;
        tv = __fadd_rn(tv, __fsub_rn(along, __fmul_rn(wlen, ct)));
      } else {
        tv = __fadd_rn(tv, 0.0f);
      }
    }
    mask[m] = bits;
    total[m] = tv;
    const float ex = __fsub_rn(cx, vpx), ez = __fsub_rn(cz, vpz);
    dv[m] = sqrtf(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez)));
    const int fv = bits ? __ffs(bits) - 1 : K;
    first_max = max(first_max, fv);
  }

  int m_star = first_max;
  if (EXACT) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_star = max(m_star, __shfl_xor_sync(0xffffffffu, m_star, off));
  }
  const uint32_t prefix = m_star >= 32 ? 0xffffffffu : ((1u << m_star) - 1u);

  float best = INFINITY;
  int best_c = 0x7fffffff;
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    const int c = lane + 32 * m;
    if (c >= NC) continue;
    const int nv = __popc(mask[m]);
    int viol = nv;
    if (EXACT && m_star > 0) viol = __popc(mask[m] & prefix);
    const float score = __fadd_rn(__fadd_rn(dv[m], __fmul_rn(BIG, (float)viol)), total[m]);
    if (score < best) {
      best = score;
      best_c = c;
    }
  }
  warp_argmin(best, best_c);

  // the owner lane of the winning candidate writes it out
  if (best_c < NC && (best_c & 31) == lane) {
    float nx = 0.0f, nz = 0.0f;
#pragma unroll
    for (int m = 0; m < NC_PER; ++m)
      if (m == (best_c >> 5)) {
        nx = cxs[m];
        nz = czs[m];
      }
    if (EXACT) {
      const float sp = sqrtf(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(nz, nz)));
      if (sp > ms) {
        const float f = __fdiv_rn(ms, fmaxf(sp, EPS));
        nx = __fmul_rn(nx, f);
        nz = __fmul_rn(nz, f);
      }
    }
    out[2 * e] = nx;
    out[2 * e + 1] = nz;
  } else if (best_c >= NC && lane == 0) {
    out[2 * e] = 0.0f;       // every score NaN: no pick, like the reference
    out[2 * e + 1] = 0.0f;
  }
}

}  // namespace

extern "C" int pf_hrvo_select(const float* pos, const float* vel,
                              const float* radius, const float* vpref,
                              const float* max_speed, const float* cand_pos,
                              const float* cand_vel, const float* cand_rad,
                              const uint8_t* cand_valid,
                              const uint8_t* cand_static, float* out, int n,
                              int c2, int exact, void* stream) {
  if (n <= 0) return 0;
  if (c2 <= 0 || c2 > 32 * MAX_PER_LANE) return (int)cudaErrorInvalidValue;
  const int blocks = (n + WARPS - 1) / WARPS;
  if (exact)
    hrvo_kernel<true><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        pos, vel, radius, vpref, max_speed, cand_pos, cand_vel, cand_rad,
        cand_valid, cand_static, out, n, c2);
  else
    hrvo_kernel<false><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        pos, vel, radius, vpref, max_speed, cand_pos, cand_vel, cand_rad,
        cand_valid, cand_static, out, n, c2);
  return (int)cudaGetLastError();
}

extern "C" const char* pf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
