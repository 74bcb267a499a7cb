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
// What bounds it on an H100: operations on the FP32 pipe and the issue of
// shared-memory loads, not bytes. Per entity it reads C2 = 144 candidates of
// 22 B and writes 8 B (32.9 MB a call at 10,256 entities, 0.01 ms at
// 3.35 TB/s), but it tests each candidate velocity against each valid cone.
// With the cone-only terms hoisted, a pair needs, in f32 operations that
// fuse nothing (a sqrt counted as one):
//   exact: 10 always (the two wedge determinants, 8, and their signs, 2);
//          16 more where both signs allow the pair inside (along 4, |w|^2 6,
//          its clamp and sqrt 2, the tolerance 1, three tests 3);
//          3 more where it is inside (the violation term and its sum);
//   fan:   5 always (along 4, one test); 11 more where along > EPS (|w|^2 6,
//          clamp and sqrt 2, |w| cos + EPS 2, the test 1); 2 more inside.
// chip_smoke.py counts these (K1_OPS_PER_CONE_TEST) over the pairs of valid
// cones and tested candidates, at the shares its inputs need, from the plain
// version's counts.
//
// Rounding: built with -fmad=false, so the compiler contracts no a*b+c into
// an FMA. The candidate expressions that XLA contracts when it compiles the
// JAX reference on CPU (rotated fan, edge projections, free projections,
// intersection points) use an explicit __fmaf_rn, as the plain version does
// with its exact f64 emulation; every other expression rounds once per
// operation, in the order the plain version writes it, and violations are
// summed over cones k = 0..31 in order. Tensor cores cannot help: a pair's
// products are 2-long dot products that must round as the f32 plain version
// does, and TF32, bf16 or a contracted FMA would change picks. Clamps keep a
// NaN (max.NaN / min.NaN), as torch.clamp and jnp.maximum do.
//
// Design, one warp per entity (K = 32 is the warp width):
// 1. Top-K over the real window width: each lane keeps SLOTS = 5 (C2 <= 160)
//    or 16 (C2 <= 512) distances in registers, the count chosen at launch.
//    Each of the 32 rounds scans them (first index within a lane), then two
//    warp min-reductions give the least distance and the least index holding
//    it; the rounds stop once the window is exhausted.
// 2. Lane k builds cone k and stores it once in shared memory as four 16-byte
//    vectors, with its four cone-only pair terms (L, R, A, Q) rounded exactly
//    as the pair test rounds them; a pair reads a cone with broadcast 128-bit
//    loads and recomputes nothing of it.
// 3. Only distinct candidates are tested. An intersection whose rays do not
//    meet (every pair i >= j, and most pairs i < j) falls back to vpref: it
//    is bit for bit candidate 0 (vpref * 1), so its tests give candidate 0's
//    results, its score ties candidate 0's and candidate 0's lower index
//    wins. Exact mode builds the 241 candidates left once the 136 pairs
//    i >= j are dropped, then packs those that are not copies to the front,
//    in index order, before the cone loop.
// 4. Cone outer, candidate inner: each lane holds its candidates (packed
//    position p = lane + 32 m) in registers with their violation sums and
//    inside masks, and tests all of them against one valid cone before the
//    next (invalid cones are the same for the whole warp and skipped). Each
//    candidate's sum still runs over k in order, and a lane has independent
//    chains. A miss adds nothing: the sum starts at +0 and a round-to-nearest
//    sum is -0 only if both terms are, so adding +0 would change no bit.
// 5. Only what a pair's result needs, where it pays: inside needs ldet >=
//    tol >= 0 and rdet <= -tol <= 0 (exact), or along > |w| cos + EPS >= EPS
//    (fan), so |w|, its sqrt and the violation term can be skipped for a slot
//    of 32 candidates in which no pair passes that sign test (a branch per
//    cone and slot). Fan mode takes the branch (PF_HRVO_SKIP_FAN=1); exact
//    mode computes every pair (PF_HRVO_SKIP_EXACT=0): on the battle window
//    two slots in three have a pair that passes, and the branch cost more
//    than it saved (PERF.md).
// 6. Cascade and pick: first_viol from each mask after the loop, m_star a
//    warp max, the prefix count a popcount; the pick is a warp arg-min over
//    (score, index). The reference takes the first minimum as a one-hot weight
//    over all candidates: a NaN score leaves no minimum (output 0), and a
//    non-finite component of a candidate it does not pick makes that output
//    component NaN. Both are mirrored.
// PF_HRVO_PERSISTENT=1 (built by tools/profile_k1.py only) runs persistent
// warps that stage the next entity's window into shared memory with cp.async
// while the current one is solved.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef PF_HRVO_SKIP_EXACT
#define PF_HRVO_SKIP_EXACT 0
#endif
#ifndef PF_HRVO_SKIP_FAN
#define PF_HRVO_SKIP_FAN 1
#endif
#ifndef PF_HRVO_PERSISTENT
#define PF_HRVO_PERSISTENT 0
#endif

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
constexpr int NARROW = 5;             // slots per lane for C2 <= 160
constexpr int WIDE = 16;              // slots per lane for C2 <= 512
constexpr int KP = 16;                // cones with edge projections
constexpr int KX = 8;                 // cones with pairwise intersections
constexpr float EPS = 1e-6f;
constexpr float BIG = 1e9f;
constexpr float EPS_REF = 1.0f / 1024.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 0x7fffffff;
constexpr unsigned INF_BITS = 0x7f800000u;

// cone k as the pair test reads it: four broadcast 16-byte loads
struct __align__(16) Cone {
  float4 edge;   // rot_r x, z (the reference's left edge); rot_l x, z
  float4 term;   // L = az*rot_r.x - ax*rot_r.z, R = az*rot_l.x - ax*rot_l.z,
                 // A = ax*kx + az*kz, Q = ax*ax + az*az
  float4 axis;   // apex ax, az; unit direction to the neighbour kx, kz
  float4 cosv;   // cos_t (y, z, w unused)
};

// one entity's window of candidates (device memory, or shared when staged)
struct Window {
  const float2* pos;
  const float2* vel;
  const float* rad;
  const uint8_t* valid;
  const uint8_t* stat;
};

__device__ __forceinline__ float max_nan(float x, float lo) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(lo));
  return r;
}

__device__ __forceinline__ float min_nan(float x, float hi) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(hi));
  return r;
}

__device__ __forceinline__ void warp_argmin(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// Candidate c; `copy` is set where it is an intersection that falls back to
// vpref, bit for bit candidate 0's value.
template <bool EXACT>
__device__ __forceinline__ void candidate(int c, const Cone* s, uint32_t vmask,
                                          float vpx, float vpz, float ms,
                                          float& cx, float& cz, bool& copy) {
  copy = false;
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
    const float4 ed = s[k].edge;
    const float ax = s[k].axis.x, az = s[k].axis.y;
    const float ex = left ? ed.z : ed.x;
    const float ez = left ? ed.w : ed.y;
    const float wx = __fsub_rn(vpx, ax);
    const float wz = __fsub_rn(vpz, az);
    const float d = max_nan(__fmaf_rn(wz, ez, __fmul_rn(wx, ex)), 0.0f);
    cx = __fmaf_rn(ex, d, ax);
    cz = __fmaf_rn(ez, d, az);
  } else if (EXACT && c < 25 + 2 * KP + 4 * KX * KX) {
    // pairwise ray intersections, rays i, j over 2*KX edges (rot_l of the
    // nearest KX cones, then their rot_r); pairs with i >= j fall back
    const int idx = c - (25 + 2 * KP);
    const int i = idx / (2 * KX), j = idx % (2 * KX);
    const int ki = i % KX, kj = j % KX;
    const float4 ei = s[ki].edge, ej = s[kj].edge;
    const float p1x = s[ki].axis.x, p1z = s[ki].axis.y;
    const float d1x = i < KX ? ei.z : ei.x;
    const float d1z = i < KX ? ei.w : ei.y;
    const float p2x = s[kj].axis.x, p2z = s[kj].axis.y;
    const float d2x = j < KX ? ej.z : ej.x;
    const float d2z = j < KX ? ej.w : ej.y;
    const float det = __fsub_rn(__fmul_rn(d1x, d2z), __fmul_rn(d1z, d2x));
    const float dpx = __fsub_rn(p2x, p1x), dpz = __fsub_rn(p2z, p1z);
    const bool nz = fabsf(det) > EPS;
    const float safe = nz ? det : 1.0f;
    const float t1 = __fdiv_rn(__fsub_rn(__fmul_rn(dpx, d2z), __fmul_rn(dpz, d2x)), safe);
    const float t2 = __fdiv_rn(__fsub_rn(__fmul_rn(dpx, d1z), __fmul_rn(dpz, d1x)), safe);
    const bool ok = nz && t1 >= 0.0f && t2 >= 0.0f && ((vmask >> ki) & 1u) &&
                    ((vmask >> kj) & 1u) && i < j;
    cx = ok ? __fmaf_rn(d1x, t1, p1x) : vpx;
    cz = ok ? __fmaf_rn(d1z, t1, p1z) : vpz;
    copy = !ok;
  } else {
    // free-vector vdes projections on every edge (exact mode)
    const int base = 25 + 2 * KP + 4 * KX * KX;
    const bool left = c < base + K;
    const int k = left ? c - base : c - base - K;
    const float4 ed = s[k].edge;
    const float ex = left ? ed.z : ed.x;
    const float ez = left ? ed.w : ed.y;
    const float w = __fmaf_rn(vpz, ez, __fmul_rn(vpx, ex));
    cx = __fmaf_rn(ex, w, s[k].axis.x);
    cz = __fmaf_rn(ez, w, s[k].axis.y);
  }
  if (!EXACT) {
    const float sp = sqrtf(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cz, cz)));
    const float sc = sp > ms ? __fdiv_rn(ms, max_nan(sp, EPS)) : 1.0f;
    cx = __fmul_rn(cx, sc);
    cz = __fmul_rn(cz, sc);
  }
}

// Exact mode builds the intersections of rays i < j only: a pair i >= j
// always falls back to vpref. Build position p runs over the 57 fan and edge
// candidates, the 120 pairs i < j (row by row), then the 64 free
// projections, and maps to candidate index c (increasing with p).
constexpr int RAYS = 2 * KX;
constexpr int NFAN = 25 + 2 * KP;
constexpr int NPAIR = RAYS * (RAYS - 1) / 2;

__device__ __forceinline__ int candidate_index(int p) {
  if (p < NFAN) return p;
  if (p < NFAN + NPAIR) {
    // row i of the triangle starts at q = i (2 RAYS - 1 - i) / 2; the root
    // is exact at every row start, so the floor picks the row
    const int q = p - NFAN;
    const float r = sqrtf((float)((2 * RAYS - 1) * (2 * RAYS - 1) - 8 * q));
    const int i = (int)(__fmul_rn(__fsub_rn((float)(2 * RAYS - 1), r), 0.5f));
    const int j = i + 1 + q - i * (2 * RAYS - 1 - i) / 2;
    return NFAN + RAYS * i + j;
  }
  return p + RAYS * RAYS - NPAIR;
}

// Per warp shared memory: the 32 cones, and (exact mode) the tested
// candidates packed to the front.
template <bool EXACT>
struct WarpSmem {
  static constexpr int NPACK = EXACT ? 256 : 1;
  Cone cone[K];
  float2 xz[NPACK];
  int c[NPACK];
};

// The whole solve for entity e by one warp, in its shared memory sm.
template <bool EXACT, int SLOTS>
__device__ __forceinline__ void solve(
    const int lane, const int e, WarpSmem<EXACT>& sm, const Window win,
    const int c2, const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ vpref,
    const float* __restrict__ max_speed, float* __restrict__ out) {
  // positions built: 241 of the 377 candidates (exact), all 57 (fan)
  constexpr int NT = EXACT ? NFAN + NPAIR + 2 * K : NFAN;
  constexpr int NC_PER = (NT + 31) / 32;
  Cone* __restrict__ s = sm.cone;

  const float px = pos[2 * e], pz = pos[2 * e + 1];
  const float vx = vel[2 * e], vz = vel[2 * e + 1];
  const float vpx = vpref[2 * e], vpz = vpref[2 * e + 1];
  const float ms = max_speed[e];
  const float rad = radius[e];

  // ---- 1. exact nearest K: rounds of a lane scan + two warp reductions ----
  float d2[SLOTS];
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const int c = lane + 32 * m;
    float d = INFINITY;
    if (c < c2) {                         // both loads in flight at once
      const bool ok = win.valid[c] != 0;
      const float2 p = win.pos[c];
      const float dx = __fsub_rn(p.x, px), dz = __fsub_rn(p.y, pz);
      if (ok) d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
    }
    d2[m] = d;
  }
  int my_sel = 0;
  bool my_valid = false;
  for (int kk = 0; kk < K; ++kk) {
    float v = INFINITY;
    int idx = NONE;
#pragma unroll
    for (int m = 0; m < SLOTS; ++m)       // c rises with m: first index wins
      if (d2[m] < v) {
        v = d2[m];
        idx = lane + 32 * m;
      }
    // distances are >= +0 (or +inf), so their bits order as their values
    const unsigned vb = __float_as_uint(v);
    const unsigned vmin = __reduce_min_sync(FULL, vb);
    if (vmin == INF_BITS) break;          // window exhausted, the same for all
    const int imin = __reduce_min_sync(FULL, vb == vmin ? idx : NONE);
    if (lane == kk) {
      my_sel = imin;
      my_valid = true;
    }
    if ((imin & 31) == lane) {
#pragma unroll
      for (int m = 0; m < SLOTS; ++m)
        if (m == (imin >> 5)) d2[m] = INFINITY;
    }
  }

  // ---- 2. lane k builds cone k and its hoisted pair terms -----------------
  {
    float nx = px, nz = pz, nvx = 0.0f, nvz = 0.0f, nrad = 0.0f;
    bool nstat = false;
    if (my_valid) {
      nstat = win.stat[my_sel] != 0;
      const float2 np = win.pos[my_sel];
      nx = np.x;
      nz = np.y;
      if (!nstat) {
        const float2 nv = win.vel[my_sel];
        nvx = nv.x;
        nvz = nv.y;
      }
      nrad = win.rad[my_sel];
    }
    const float relx = __fsub_rn(nx, px), relz = __fsub_rn(nz, pz);
    const float dist = sqrtf(__fadd_rn(__fmul_rn(relx, relx), __fmul_rn(relz, relz)));
    const float comb = __fmul_rn(__fadd_rn(rad, nrad), EXACT ? 1.0f : 1.05f);
    const bool colliding = my_valid && dist < comb;
    const float dden = max_nan(dist, EPS);
    const float phx = __fdiv_rn(relx, dden), phz = __fdiv_rn(relz, dden);
    float sin_t, cos_t;
    if (EXACT) {
      const float hyp = sqrtf(__fadd_rn(__fmul_rn(dist, dist), __fmul_rn(comb, comb)));
      const float hd = max_nan(hyp, EPS);
      sin_t = __fdiv_rn(comb, hd);
      cos_t = __fdiv_rn(dist, hd);
    } else {
      sin_t = min_nan(max_nan(__fdiv_rn(comb, dden), 0.0f), 1.0f);
      cos_t = sqrtf(max_nan(__fsub_rn(1.0f, __fmul_rn(sin_t, sin_t)), 0.0f));
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
      t = min_nan(max_nan(t, -1e4f), 1e4f);
      if (nz_d && fabsf(vdet) > EPS) {
        ax = __fadd_rn(rvx, __fmul_rn(nearx, t));
        az = __fadd_rn(rvz, __fmul_rn(nearz, t));
      }
    }
    Cone& q = s[lane];
    q.edge = make_float4(rx, rz, lx, lz);
    q.term = make_float4(__fsub_rn(__fmul_rn(az, rx), __fmul_rn(ax, rz)),
                         __fsub_rn(__fmul_rn(az, lx), __fmul_rn(ax, lz)),
                         __fadd_rn(__fmul_rn(ax, phx), __fmul_rn(az, phz)),
                         __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(az, az)));
    q.axis = make_float4(ax, az, phx, phz);
    q.cosv = make_float4(cos_t, 0.0f, 0.0f, 0.0f);
  }
  const uint32_t vmask = __ballot_sync(FULL, my_valid);
  __syncwarp();

  // ---- 3-5. the distinct candidates against every valid cone, cone outer --
  float cxs[NC_PER], czs[NC_PER], c2n[NC_PER], tv[NC_PER];
  uint32_t bits[NC_PER];
  int cid[NC_PER];                         // candidate index, NONE if not tested
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    const int p = lane + 32 * m;
    float cx = NAN, cz = NAN;              // not tested: no test passes
    cid[m] = NONE;
    if (p < NT) {
      const int c = EXACT ? candidate_index(p) : p;
      bool copy;
      candidate<EXACT>(c, s, vmask, vpx, vpz, ms, cx, cz, copy);
      if (copy) {
        cx = cz = NAN;
      } else {
        cid[m] = c;
      }
    }
    cxs[m] = cx;
    czs[m] = cz;
  }
  int nt = NT;                             // candidates to test, the same for all
  if (EXACT) {
    // pack the candidates that are not copies to the front, in index order
    // (c still rises with m in every lane), so the cone loop runs over as
    // few slots as there are candidates
    nt = 0;
#pragma unroll
    for (int m = 0; m < NC_PER; ++m) {
      const bool keep = cid[m] != NONE;
      const uint32_t bal = __ballot_sync(FULL, keep);
      if (keep) {
        const int at = nt + __popc(bal & ((1u << lane) - 1u));
        sm.xz[at] = make_float2(cxs[m], czs[m]);
        sm.c[at] = cid[m];
      }
      nt += __popc(bal);
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < NC_PER; ++m) {
      const int p = lane + 32 * m;
      const float2 v = p < nt ? sm.xz[p] : make_float2(NAN, NAN);
      cxs[m] = v.x;
      czs[m] = v.y;
      cid[m] = p < nt ? sm.c[p] : NONE;
    }
  }
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    c2n[m] = __fadd_rn(__fmul_rn(cxs[m], cxs[m]), __fmul_rn(czs[m], czs[m]));
    tv[m] = 0.0f;
    bits[m] = 0;
  }
  for (uint32_t rest = vmask; rest != 0; rest &= rest - 1) {
    const int k = __ffs(rest) - 1;         // valid cones, k ascending
    const float4 ed = s[k].edge, tm = s[k].term, xs = s[k].axis;
    const float ct = s[k].cosv.x;
#pragma unroll
    for (int m = 0; m < NC_PER; ++m) {
      if (32 * m >= nt) break;             // the same for the whole warp
      const float cx = cxs[m], cz = czs[m];
      if (EXACT) {
        const float ldet = __fsub_rn(__fsub_rn(__fmul_rn(cz, ed.x), __fmul_rn(cx, ed.y)), tm.x);
        const float rdet = __fsub_rn(__fsub_rn(__fmul_rn(cz, ed.z), __fmul_rn(cx, ed.w)), tm.y);
        if (!PF_HRVO_SKIP_EXACT || (ldet >= 0.0f && rdet <= 0.0f)) {
          const float along = __fsub_rn(
              __fadd_rn(__fmul_rn(cx, xs.z), __fmul_rn(cz, xs.w)), tm.z);
          const float wl2 = __fadd_rn(
              __fsub_rn(c2n[m], __fmul_rn(2.0f, __fadd_rn(__fmul_rn(cx, xs.x),
                                                         __fmul_rn(cz, xs.y)))),
              tm.w);
          const float wlen = sqrtf(max_nan(wl2, 0.0f));
          const float tol = __fmul_rn(EPS_REF, wlen);
          if (wlen >= EPS_REF && ldet >= tol && rdet <= -tol) {
            bits[m] |= 1u << k;
            tv[m] = __fadd_rn(tv[m], __fsub_rn(along, __fmul_rn(wlen, ct)));
          }
        }
      } else {
        const float along = __fsub_rn(
            __fadd_rn(__fmul_rn(cx, xs.z), __fmul_rn(cz, xs.w)), tm.z);
        if (!PF_HRVO_SKIP_FAN || along > EPS) {
          const float wl2 = __fadd_rn(
              __fsub_rn(c2n[m], __fmul_rn(2.0f, __fadd_rn(__fmul_rn(cx, xs.x),
                                                         __fmul_rn(cz, xs.y)))),
              tm.w);
          const float wct = __fmul_rn(sqrtf(max_nan(wl2, 0.0f)), ct);
          if (along > __fadd_rn(wct, EPS)) {
            bits[m] |= 1u << k;
            tv[m] = __fadd_rn(tv[m], __fsub_rn(along, wct));
          }
        }
      }
    }
  }

  // ---- 5. cascade and pick -------------------------------------------------
  int first_max = 0;
#pragma unroll
  for (int m = 0; m < NC_PER; ++m)
    if (cid[m] != NONE)
      first_max = max(first_max, bits[m] ? __ffs(bits[m]) - 1 : K);
  const int m_star = EXACT ? __reduce_max_sync(FULL, first_max) : 0;
  const uint32_t prefix = m_star >= 32 ? FULL : ((1u << m_star) - 1u);

  float best = INFINITY;
  int best_c = NONE;
  bool nan_score = false;
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    const int c = cid[m];                  // rises with m; slot 0 always tested
    if (c == NONE) continue;
    const float ex = __fsub_rn(cxs[m], vpx), ez = __fsub_rn(czs[m], vpz);
    const float dv = sqrtf(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ez, ez)));
    const int viol = __popc(EXACT && m_star > 0 ? bits[m] & prefix : bits[m]);
    const float score = __fadd_rn(__fadd_rn(dv, __fmul_rn(BIG, (float)viol)), tv[m]);
    nan_score |= isnan(score);
    if (m == 0 || score < best) {          // an all-inf row still picks its first
      best = score;
      best_c = c;
    }
  }
  warp_argmin(best, best_c);
  const bool pick = !__any_sync(FULL, nan_score);
  const int chosen = pick ? best_c : NONE;
  // exact mode always has fallbacks (copies of vpref, never picked)
  bool bad_x = EXACT && !isfinite(vpx), bad_z = EXACT && !isfinite(vpz);
  bool mine = false;
  float nx = 0.0f, nz = 0.0f;
#pragma unroll
  for (int m = 0; m < NC_PER; ++m) {
    if (cid[m] == NONE) continue;
    if (cid[m] == chosen) {
      mine = true;
      nx = cxs[m];
      nz = czs[m];
    } else {
      bad_x |= !isfinite(cxs[m]);
      bad_z |= !isfinite(czs[m]);
    }
  }
  bad_x = __any_sync(FULL, bad_x);
  bad_z = __any_sync(FULL, bad_z);

  // the owner lane of the pick (lane 0 when there is none) writes it out
  if (pick ? mine : lane == 0) {
    if (bad_x) nx = NAN;
    if (bad_z) nz = NAN;
    if (EXACT) {
      const float sp = sqrtf(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(nz, nz)));
      if (sp > ms) {
        const float f = __fdiv_rn(ms, max_nan(sp, EPS));
        nx = __fmul_rn(nx, f);
        nz = __fmul_rn(nz, f);
      }
    }
    out[2 * e] = nx;
    out[2 * e + 1] = nz;
  }
}

#define PF_HRVO_PARAMS                                                        \
  const float *__restrict__ pos, const float *__restrict__ vel,               \
      const float *__restrict__ radius, const float *__restrict__ vpref,      \
      const float *__restrict__ max_speed, const float *__restrict__ cand_pos, \
      const float *__restrict__ cand_vel, const float *__restrict__ cand_rad,  \
      const uint8_t *__restrict__ cand_valid,                                  \
      const uint8_t *__restrict__ cand_static, float *__restrict__ out, int n, \
      int c2
#define PF_HRVO_ARGS                                                          \
  pos, vel, radius, vpref, max_speed, cand_pos, cand_vel, cand_rad,           \
      cand_valid, cand_static, out, n, c2

template <bool EXACT, int SLOTS>
__global__ void __launch_bounds__(WARPS * 32) hrvo_kernel(PF_HRVO_PARAMS) {
  __shared__ WarpSmem<EXACT> smem[WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * WARPS + w;
  if (e >= n) return;                      // whole warp leaves together
  const size_t cb = (size_t)e * c2;
  const Window win{reinterpret_cast<const float2*>(cand_pos) + cb,
                   reinterpret_cast<const float2*>(cand_vel) + cb,
                   cand_rad + cb, cand_valid + cb, cand_static + cb};
  solve<EXACT, SLOTS>(lane, e, smem[w], win, c2, pos, vel, radius, vpref,
                      max_speed, out);
}

#if PF_HRVO_PERSISTENT
constexpr int STAGED_C2 = 32 * NARROW;    // widths the staged variant takes

struct __align__(16) Staged {
  float2 pos[STAGED_C2];
  float2 vel[STAGED_C2];
  float rad[STAGED_C2];
  uint8_t valid[STAGED_C2];
  uint8_t stat[STAGED_C2];
};

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes,
                                       int lane) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = 16 * lane; i < bytes; i += 16 * 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d + i), "l"(static_cast<const char*>(src) + i));
}

// entity e's window into dst, as one cp.async group per lane (c2 % 16 == 0
// keeps every row 16-byte aligned)
__device__ __forceinline__ void stage(Staged* dst, const float* cand_pos,
                                      const float* cand_vel,
                                      const float* cand_rad,
                                      const uint8_t* cand_valid,
                                      const uint8_t* cand_static, int e,
                                      int c2, int lane) {
  const size_t cb = (size_t)e * c2;
  copy16(dst->pos, cand_pos + 2 * cb, 8 * c2, lane);
  copy16(dst->vel, cand_vel + 2 * cb, 8 * c2, lane);
  copy16(dst->rad, cand_rad + cb, 4 * c2, lane);
  copy16(dst->valid, cand_valid + cb, c2, lane);
  copy16(dst->stat, cand_static + cb, c2, lane);
}

template <bool EXACT>
__global__ void __launch_bounds__(WARPS * 32) hrvo_persistent(PF_HRVO_PARAMS) {
  __shared__ WarpSmem<EXACT> smem[WARPS];
  __shared__ Staged buf[WARPS][2];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int stride = gridDim.x * WARPS;
  int e = blockIdx.x * WARPS + w;
  if (e < n)
    stage(&buf[w][0], cand_pos, cand_vel, cand_rad, cand_valid, cand_static,
          e, c2, lane);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int b = 0; e < n; e += stride, b ^= 1) {
    if (e + stride < n)
      stage(&buf[w][b ^ 1], cand_pos, cand_vel, cand_rad, cand_valid,
            cand_static, e + stride, c2, lane);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const Staged& st = buf[w][b];
    const Window win{st.pos, st.vel, st.rad, st.valid, st.stat};
    solve<EXACT, NARROW>(lane, e, smem[w], win, c2, pos, vel, radius,
                         vpref, max_speed, out);
    __syncwarp();                          // buffer b is free to refill
  }
}

template <bool EXACT>
cudaError_t launch_persistent(PF_HRVO_PARAMS, cudaStream_t stream) {
  if (c2 > STAGED_C2 || c2 % 16 != 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hrvo_persistent<EXACT>,
                                                WARPS * 32, 0);
  const int need = (n + WARPS - 1) / WARPS;
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  hrvo_persistent<EXACT><<<blocks, WARPS * 32, 0, stream>>>(PF_HRVO_ARGS);
  return cudaGetLastError();
}
#endif

template <bool EXACT, int SLOTS>
cudaError_t launch(PF_HRVO_PARAMS, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  hrvo_kernel<EXACT, SLOTS><<<blocks, WARPS * 32, 0, stream>>>(PF_HRVO_ARGS);
  return cudaGetLastError();
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
  if (c2 <= 0 || c2 > 32 * WIDE) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#if PF_HRVO_PERSISTENT
  return (int)(exact ? launch_persistent<true>(PF_HRVO_ARGS, st)
                     : launch_persistent<false>(PF_HRVO_ARGS, st));
#else
  const bool narrow = c2 <= 32 * NARROW;
  if (exact)
    return (int)(narrow ? launch<true, NARROW>(PF_HRVO_ARGS, st)
                        : launch<true, WIDE>(PF_HRVO_ARGS, st));
  return (int)(narrow ? launch<false, NARROW>(PF_HRVO_ARGS, st)
                      : launch<false, WIDE>(PF_HRVO_ARGS, st));
#endif
}

extern "C" int pf_hrvo_blocks_per_sm(int exact, int c2) {
  int per_sm = 0;
#if PF_HRVO_PERSISTENT
  (void)c2;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, exact ? hrvo_persistent<true> : hrvo_persistent<false>,
      WARPS * 32, 0);
#else
  const bool narrow = c2 <= 32 * NARROW;
  const void* fn = exact ? (narrow ? (const void*)hrvo_kernel<true, NARROW>
                                   : (const void*)hrvo_kernel<true, WIDE>)
                         : (narrow ? (const void*)hrvo_kernel<false, NARROW>
                                   : (const void*)hrvo_kernel<false, WIDE>);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, WARPS * 32, 0);
#endif
  return per_sm;
}

extern "C" const char* pf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
