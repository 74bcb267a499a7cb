"""Kernel K1: fused nearest-K selection + HRVO velocity solve on the card.

Counterpart of ``permafrost_engine_tpu/ops/crowd_pallas.py``
(``hrvo_select_pallas``, kernel ``_hrvo_kernel``, helper ``_topk_select``).
The kernel is ``csrc/hrvo.cu``; ``hrvo_select_plain`` below is its plain
PyTorch version, written expression for expression in the kernel's order.
``hrvo_select`` is the movement substep's only HRVO entry: CPU tensors take
the plain version, CUDA tensors launch the kernel, anything else raises.

Candidate sets follow the Pallas kernel (not ``ops/clearpath.py``): fan
mode 57 candidates, exact mode 377 (the 16 x 16 intersection square with
the lower triangle falling back to vpref), scored
``d_vpref + 1e9 * violations + total_violation`` with ``total_violation``
summed over all K cones, including those the cascade dropped (the known
fault the JAX code carries, kept for parity).

Rounding: XLA on CPU contracts multiply-adds into FMAs, so the JAX
reference builds its candidates with single-rounding FMAs. The kernel
(``__fmaf_rn``) and the plain version (``ops/rounding.fma``) contract exactly
the same candidate expressions (the rotated fan, the edge projections, the free
projections and the intersection points) and nothing else, which makes
more than half of the picks bit-equal to both JAX paths on the CPU test
scenes; every other expression rounds once per operation in both.

Non-finite values follow the Pallas kernel's one-hot pick: a NaN score
leaves no minimum, and a non-finite component of a candidate that is not
picked makes that output component NaN (a NaN preferred velocity gives a
NaN velocity, not zero); clamps keep a NaN, as ``jnp.maximum`` does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from permafrost_engine_tpu_torch.core.config import MAX_NEIGHBOURS
from permafrost_engine_tpu_torch.ops import cuda_build
from permafrost_engine_tpu_torch.ops.rounding import fma

_EPS = 1e-6
_BIG = 1e9
_EPS_REF = 1.0 / 1024
_SCALES = (1.0, 0.75, 0.5, 0.25, 0.0)
_ANGLES_DEG = (15.0, -15.0, 30.0, -30.0, 45.0, -45.0, 70.0, -70.0,
               90.0, -90.0)
KP = 16   # cones with clamped edge projections
KX = 8    # cones with pairwise edge intersections
MAX_CANDIDATES = 512   # window width the kernel holds in registers

# launches of the CUDA kernel (not of the plain version)
launches = 0

_bound = None


def _f32(vals, dev):
    return torch.tensor(vals, dtype=torch.float32, device=dev)


def hrvo_select_plain(pos, vel, radius, vpref, max_speed, cand_pos, cand_vel,
                      cand_rad, cand_valid, cand_static, *, exact=False,
                      stats=None):
    """Plain PyTorch K1: f32[N, 2] new per-tick velocities (callers apply
    their own active mask). Shapes: pos/vel/vpref [N,2], radius/max_speed
    [N], cand_pos/cand_vel [N,C2,2], cand_rad [N,C2], cand_valid and
    cand_static bool[N,C2].

    ``stats`` (a dict, optional) receives the counts the kernel's cost
    follows, over the candidates it tests (all but the intersections that
    fall back to vpref, copies of candidate 0): ``pairs`` (candidate, valid
    cone), ``passed`` (pairs whose sign test leaves them possibly inside, so
    the test needs |w| and its sqrt), ``inside``; ``slots``, the kernel's
    warp-wide sign tests (a slot of 32 packed candidates against a valid
    cone), and ``slots_passed``, those in which some pair passed, so the
    warp runs the rest of the test."""
    n, c2 = cand_valid.shape
    dev = pos.device
    k = MAX_NEIGHBOURS
    px, pz = pos[:, 0:1], pos[:, 1:2]
    vx, vz = vel[:, 0:1], vel[:, 1:2]
    vpx, vpz = vpref[:, 0:1], vpref[:, 1:2]
    ms = max_speed[:, None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)

    # ---- exact nearest K, near -> far, first index on ties ---------------
    # (a stable sort orders exactly as K rounds of first-minimum extraction)
    dx = cand_pos[..., 0] - px
    dz = cand_pos[..., 1] - pz
    d2 = torch.where(cand_valid, dx * dx + dz * dz, inf)
    sd, order = torch.sort(d2, dim=1, stable=True)
    kk = min(k, c2)
    sd, order = sd[:, :kk], order[:, :kk]
    if kk < k:
        sd = torch.cat([sd, inf.expand(n, k - kk)], dim=1)
        order = torch.cat([order, order.new_zeros(n, k - kk)], dim=1)
    nvalid = torch.isfinite(sd)
    npos = torch.take_along_dim(cand_pos, order[..., None], dim=1)
    nvel = torch.take_along_dim(cand_vel, order[..., None], dim=1)
    nrad = torch.take_along_dim(cand_rad, order, dim=1)
    nstat = torch.take_along_dim(cand_static, order, dim=1) & nvalid
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # sanitize invalid rows onto the entity itself (sentinel payloads
    # would overflow the exact-mode cone math into NaN)
    nx = torch.where(nvalid, npos[..., 0], px)
    nz = torch.where(nvalid, npos[..., 1], pz)
    nvx = torch.where(nvalid & ~nstat, nvel[..., 0], zero)
    nvz = torch.where(nvalid & ~nstat, nvel[..., 1], zero)
    nrad = torch.where(nvalid, nrad, zero)

    # ---- HRVO cones [N, K] ---------------------------------------------------
    relx, relz = nx - px, nz - pz
    dist = torch.sqrt(relx * relx + relz * relz)
    comb = (radius[:, None] + nrad) * (1.0 if exact else _f32(1.05, dev))
    colliding = nvalid & (dist < comb)
    dden = torch.clamp(dist, min=_EPS)
    phx, phz = relx / dden, relz / dden
    if exact:
        hd = torch.clamp(torch.sqrt(dist * dist + comb * comb), min=_EPS)
        sin_t, cos_t = comb / hd, dist / hd
    else:
        sin_t = torch.clamp(comb / dden, 0.0, 1.0)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
        cos_t = torch.where(colliding, zero, cos_t)
    rvx, rvz = (vx + nvx) / 2.0, (vz + nvz) / 2.0
    lx = cos_t * phx - sin_t * phz
    lz = sin_t * phx + cos_t * phz
    rx = cos_t * phx + sin_t * phz
    rz = (-sin_t) * phx + cos_t * phz
    ax = torch.where(nstat, nvx, rvx)
    az = torch.where(nstat, nvz, rvz)
    if exact:
        cx_, cz_ = lx + rx, lz + rz
        vdet = cx_ * vz - cz_ * vx
        pos_side = vdet > 0.0
        nearx, nearz = torch.where(pos_side, rx, lx), torch.where(pos_side, rz, lz)
        othx, othz = torch.where(pos_side, lx, rx), torch.where(pos_side, lz, rz)
        denom = nearx * othz - nearz * othx
        nz_d = denom.abs() > _EPS
        t = torch.where(nz_d, ((nvx - rvx) * othz - (nvz - rvz) * othx)
                        / torch.where(nz_d, denom, 1.0), zero)
        t = torch.clamp(t, -1e4, 1e4)
        slide = nz_d & (vdet.abs() > _EPS) & ~nstat
        ax = torch.where(slide, rvx + nearx * t, ax)
        az = torch.where(slide, rvz + nearz * t, az)

    # ---- candidates [N, C] -----------------------------------------------------
    scales = _f32(_SCALES, dev)
    ca = _f32([math.cos(math.radians(d)) for d in _ANGLES_DEG], dev)
    sa = _f32([math.sin(math.radians(d)) for d in _ANGLES_DEG], dev)
    rotx = fma(vpx, ca, -(vpz * sa))
    rotz = fma(vpx, sa, vpz * ca)

    def proj(ex, ez):
        ex, ez, pax, paz = ex[:, :KP], ez[:, :KP], ax[:, :KP], az[:, :KP]
        d = torch.clamp(fma(vpz - paz, ez, (vpx - pax) * ex), min=0.0)
        return fma(ex, d, pax), fma(ez, d, paz)

    plx, plz = proj(lx, lz)
    prx, prz = proj(rx, rz)
    xs = [vpx * scales, rotx, rotx * 0.5, plx, prx]
    zs = [vpz * scales, rotz, rotz * 0.5, plz, prz]
    if exact:
        rax = torch.cat([ax[:, :KX], ax[:, :KX]], 1)
        raz = torch.cat([az[:, :KX], az[:, :KX]], 1)
        rdx = torch.cat([lx[:, :KX], rx[:, :KX]], 1)
        rdz = torch.cat([lz[:, :KX], rz[:, :KX]], 1)
        rv = torch.cat([nvalid[:, :KX], nvalid[:, :KX]], 1)
        p1x, p1z, d1x, d1z = (a[:, :, None] for a in (rax, raz, rdx, rdz))
        p2x, p2z, d2x, d2z = (a[:, None, :] for a in (rax, raz, rdx, rdz))
        det = d1x * d2z - d1z * d2x
        dpx, dpz = p2x - p1x, p2z - p1z
        nzd = det.abs() > _EPS
        safe = torch.where(nzd, det, 1.0)
        t1 = (dpx * d2z - dpz * d2x) / safe
        t2 = (dpx * d1z - dpz * d1x) / safe
        r2 = 2 * KX
        upper = torch.triu(torch.ones(r2, r2, dtype=torch.bool, device=dev), 1)
        ok = (nzd & (t1 >= 0.0) & (t2 >= 0.0) & rv[:, :, None]
              & rv[:, None, :] & upper)
        xs.append(torch.where(ok, fma(d1x, t1, p1x), vpx[:, :, None]
                              ).reshape(n, -1))
        tested = torch.cat([ok.new_ones(n, 25 + 2 * KP), ok.reshape(n, -1),
                            ok.new_ones(n, 2 * k)], 1)
        zs.append(torch.where(ok, fma(d1z, t1, p1z), vpz[:, :, None]
                              ).reshape(n, -1))
        wl = fma(vpz, lz, vpx * lx)
        wr = fma(vpz, rz, vpx * rx)
        xs += [fma(lx, wl, ax), fma(rx, wr, ax)]
        zs += [fma(lz, wl, az), fma(rz, wr, az)]
    cx = torch.cat(xs, 1)
    cz = torch.cat(zs, 1)
    if not exact:
        sp = torch.sqrt(cx * cx + cz * cz)
        sc = torch.where(sp > ms, ms / torch.clamp(sp, min=_EPS), 1.0)
        cx, cz = cx * sc, cz * sc

    # ---- feasibility of every candidate against cones 0..K-1, in order -----
    c2n = cx * cx + cz * cz
    total = torch.zeros_like(cx)
    count = torch.zeros(cx.shape, dtype=torch.int32, device=dev)
    first = torch.full(cx.shape, k, dtype=torch.int32, device=dev)
    inside_k = []
    if stats is not None:
        # the kernel tests the candidates that are not copies of vpref,
        # packed in index order into slots of 32
        if not exact:
            tested = torch.ones_like(cx, dtype=torch.bool)
        slot = (torch.cumsum(tested, 1) - 1).clamp(min=0) // 32
        passed = slots_passed = 0
    for j in range(k):
        axk, azk = ax[:, j:j + 1], az[:, j:j + 1]
        kx, kz = phx[:, j:j + 1], phz[:, j:j + 1]
        ct = cos_t[:, j:j + 1]
        along = (cx * kx + cz * kz) - (axk * kx + azk * kz)
        wl2 = (c2n - 2.0 * (cx * axk + cz * azk)) + (axk * axk + azk * azk)
        wlen = torch.sqrt(torch.clamp(wl2, min=0.0))
        if exact:
            llx, llz = rx[:, j:j + 1], rz[:, j:j + 1]
            rrx, rrz = lx[:, j:j + 1], lz[:, j:j + 1]
            ldet = (cz * llx - cx * llz) - (azk * llx - axk * llz)
            rdet = (cz * rrx - cx * rrz) - (azk * rrx - axk * rrz)
            tol = _EPS_REF * wlen
            inside = (wlen >= _EPS_REF) & (ldet >= tol) & (rdet <= -tol)
        else:
            inside = along > wlen * ct + _EPS
        if stats is not None:
            sign_ok = ((ldet >= 0.0) & (rdet <= 0.0)) if exact else along > _EPS
            pj = sign_ok & nvalid[:, j:j + 1] & tested
            passed += int(pj.sum())
            hit = torch.zeros(n, (cx.shape[1] + 31) // 32, dtype=torch.int32,
                              device=dev).scatter_add_(1, slot, pj.to(torch.int32))
            slots_passed += int((hit > 0).sum())
        inside = inside & nvalid[:, j:j + 1]
        total = total + torch.where(inside, along - wlen * ct, zero)
        count += inside.to(torch.int32)
        if exact:
            first = torch.where((first == k) & inside, j, first)
            inside_k.append(inside)
    if stats is not None:
        stats.update(
            pairs=int((tested.sum(1) * nvalid.sum(1)).sum()), passed=passed,
            inside=int((count * tested).sum()),
            slots=int(((tested.sum(1) + 31) // 32 * nvalid.sum(1)).sum()),
            slots_passed=slots_passed)
    ex, ez = cx - vpx, cz - vpz
    dv = torch.sqrt(ex * ex + ez * ez)
    if exact:
        # remove-furthest cascade in closed form: the longest near->far cone
        # prefix that admits a feasible candidate has length max_c first[c]
        m_star = first.max(dim=1, keepdim=True).values
        viol = torch.zeros_like(count)
        for j in range(k):
            viol += (inside_k[j] & (j < m_star)).to(torch.int32)
        viol = torch.where(m_star > 0, viol, count)
    else:
        viol = count
    score = (dv + _BIG * viol.to(torch.float32)) + total

    # ---- first minimum, then clamp (exact) ---------------------------------
    smin = score.min(dim=1, keepdim=True).values
    eq = score == smin
    idx = eq.to(torch.int32).argmax(dim=1, keepdim=True)
    has = eq.any(dim=1, keepdim=True)
    nvx_ = torch.where(has, torch.take_along_dim(cx, idx, 1), zero)
    nvz_ = torch.where(has, torch.take_along_dim(cz, idx, 1), zero)
    # the reference sums the one-hot pick times every candidate, so a
    # non-finite component of a candidate it does not pick makes that
    # component of the sum NaN (a NaN score anywhere already left no pick)
    other = ~(has & (torch.arange(cx.shape[1], device=dev) == idx))
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    nvx_ = torch.where((other & ~torch.isfinite(cx)).any(1, keepdim=True), nan, nvx_)
    nvz_ = torch.where((other & ~torch.isfinite(cz)).any(1, keepdim=True), nan, nvz_)
    if exact:
        sp = torch.sqrt(nvx_ * nvx_ + nvz_ * nvz_)
        f = ms / torch.clamp(sp, min=_EPS)
        over = sp > ms
        nvx_ = torch.where(over, nvx_ * f, nvx_)
        nvz_ = torch.where(over, nvz_ * f, nvz_)
    return torch.cat([nvx_, nvz_], dim=1)


def _lib():
    global _bound
    if _bound is None:
        lib = cuda_build.load("hrvo")
        lib.pf_hrvo_select.restype = ctypes.c_int
        lib.pf_hrvo_select.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _bound = lib
    return _bound


def hrvo_select(pos, vel, radius, vpref, max_speed, cand_pos, cand_vel,
                cand_rad, cand_valid, cand_static, *, exact=False):
    """K1 entry: plain version for CPU tensors, the kernel for CUDA ones."""
    if pos.device.type == "cpu":
        return hrvo_select_plain(pos, vel, radius, vpref, max_speed, cand_pos,
                                 cand_vel, cand_rad, cand_valid, cand_static,
                                 exact=exact)
    if pos.device.type != "cuda":
        raise RuntimeError(f"hrvo_select: no kernel for device {pos.device}")
    return hrvo_select_cuda(pos, vel, radius, vpref, max_speed, cand_pos,
                            cand_vel, cand_rad, cand_valid, cand_static,
                            exact=exact)


def hrvo_select_cuda(pos, vel, radius, vpref, max_speed, cand_pos, cand_vel,
                     cand_rad, cand_valid, cand_static, *, exact=False):
    """Launch K1 on CUDA tensors (checks device, dtype, shape, layout)."""
    global launches
    n, c2 = cand_valid.shape
    if not 1 <= c2 <= MAX_CANDIDATES:
        raise ValueError(f"hrvo_select: window width {c2} outside "
                         f"1..{MAX_CANDIDATES}")
    spec = [(pos, torch.float32, (n, 2)), (vel, torch.float32, (n, 2)),
            (radius, torch.float32, (n,)), (vpref, torch.float32, (n, 2)),
            (max_speed, torch.float32, (n,)),
            (cand_pos, torch.float32, (n, c2, 2)),
            (cand_vel, torch.float32, (n, c2, 2)),
            (cand_rad, torch.float32, (n, c2)),
            (cand_valid, torch.bool, (n, c2)),
            (cand_static, torch.bool, (n, c2))]
    dev = pos.device
    for t, dtype, shape in spec:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"hrvo_select: expected {dtype}{list(shape)}, "
                             f"got {t.dtype}{list(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("hrvo_select: inputs must be contiguous on one "
                             "CUDA device")
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pf_hrvo_select(
            *(t.data_ptr() for t, _, _ in spec), out.data_ptr(), n, c2,
            int(bool(exact)), stream)
    cuda_build.check(lib, code, "hrvo kernel")
    launches += 1
    return out
