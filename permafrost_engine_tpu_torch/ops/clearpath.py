"""ClearPath / HRVO collision avoidance as a dense candidate-velocity solve.

Port of ``permafrost_engine_tpu/ops/clearpath.py`` (ref:
src/game/clearpath.c:130-388, G_ClearPath_NewVelocity clearpath.c:694):
per entity, one HRVO cone per neighbour, a candidate-velocity set, the
feasibility of every candidate against every cone, and the feasible
candidate nearest the preferred velocity, as [N, candidates, cones] tensor
ops. Fan mode (``exact=False``) and the reference-exact mode (the default,
``cfg.clearpath_exact``) are both ported.

Parity-only module: the engine never selects it. It is the JAX package's
XLA-path solver (241 exact-mode candidates from the upper-triangle pair
list), kept to hold the port against ``clearpath.new_velocities``. The
movement substep always goes through kernel K1 (``ops/crowd_cuda.py``,
377 exact-mode candidates), the counterpart of the Pallas kernel; do not
wire this solver in beside it.
The known fault is kept: exact mode adds ``total_viol`` over all K cones,
including those the remove-furthest cascade dropped (clearpath.py:305).
"""

from __future__ import annotations

import torch

_EPS = 1e-6
_BIG = 1e9


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def new_velocities(pos, vel, radius, vpref, max_speed_tick, neigh_idx,
                   neigh_valid, neigh_static, active, neigh_pos=None,
                   neigh_vel=None, neigh_rad=None, exact: bool = False):
    """Feasible velocity nearest vpref per entity; inactive entities get
    vpref. Shapes as in the JAX function: [N,2] / [N] per entity, [N,K]
    (and [N,K,2]) per neighbour."""
    n, k = neigh_idx.shape
    dev = pos.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    ni = torch.clamp(neigh_idx, 0, n - 1).long()
    npos = pos[ni] if neigh_pos is None else neigh_pos
    nvel = vel[ni] if neigh_vel is None else neigh_vel
    nvel = torch.where(neigh_static[..., None], zero, nvel)
    nrad = radius[ni] if neigh_rad is None else neigh_rad
    npos = torch.where(neigh_valid[..., None], npos, pos[:, None, :])
    nvel = torch.where(neigh_valid[..., None], nvel, zero)
    nrad = torch.where(neigh_valid, nrad, zero)

    rel = npos - pos[:, None, :]
    dist = _norm(rel)
    comb_r = (radius[:, None] + nrad) * (1.0 if exact else torch.tensor(
        1.05, dtype=f32, device=dev))
    colliding = neigh_valid & (dist < comb_r)
    p_hat = rel / torch.clamp(dist, min=_EPS)[..., None]
    if exact:
        hyp = torch.sqrt(dist * dist + comb_r * comb_r)
        sin_t = comb_r / torch.clamp(hyp, min=_EPS)
        cos_t = dist / torch.clamp(hyp, min=_EPS)
    else:
        sin_t = torch.clamp(comb_r / torch.clamp(dist, min=_EPS), 0.0, 1.0)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
        cos_t = torch.where(colliding, zero, cos_t)
        sin_t = torch.where(colliding, 1.0, sin_t)

    rvo_apex = (vel[:, None, :] + nvel) / 2.0
    vo_apex = nvel
    apex = torch.where(neigh_static[..., None], vo_apex, rvo_apex)
    phx, phz = p_hat[..., 0], p_hat[..., 1]
    rot_l = torch.stack([cos_t * phx - sin_t * phz,
                         sin_t * phx + cos_t * phz], dim=-1)
    rot_r = torch.stack([cos_t * phx + sin_t * phz,
                         (-sin_t) * phx + cos_t * phz], dim=-1)

    if exact:
        center = rot_l + rot_r
        vdet = center[..., 0] * vel[:, None, 1] - center[..., 1] * vel[:, None, 0]
        side = (vdet > 0)[..., None]
        near = torch.where(side, rot_r, rot_l)
        other = torch.where(side, rot_l, rot_r)
        denom = near[..., 0] * other[..., 1] - near[..., 1] * other[..., 0]
        dp = vo_apex - rvo_apex
        nz = denom.abs() > _EPS
        t = torch.where(nz, (dp[..., 0] * other[..., 1] - dp[..., 1] * other[..., 0])
                        / torch.where(nz, denom, 1.0), zero)
        t = torch.clamp(t, -1e4, 1e4)
        hrvo_apex = rvo_apex + near * t[..., None]
        slide_ok = nz & (vdet.abs() > _EPS)
        apex = torch.where(neigh_static[..., None], vo_apex,
                           torch.where(slide_ok[..., None], hrvo_apex, rvo_apex))

    # ---- candidate set (clearpath.c:321-367) -------------------------------
    kp = min(16, k)
    w = vpref[:, None, :] - apex[:, :kp]

    def proj(rot):
        d = torch.clamp(w[..., 0] * rot[:, :kp, 0] + w[..., 1] * rot[:, :kp, 1],
                        min=0.0)
        return apex[:, :kp] + rot[:, :kp] * d[..., None]

    proj_l, proj_r = proj(rot_l), proj(rot_r)
    scales = torch.tensor([1.0, 0.75, 0.5, 0.25, 0.0], dtype=f32, device=dev)
    base = vpref[:, None, :] * scales[None, :, None]
    angs = [15.0, -15.0, 30.0, -30.0, 45.0, -45.0, 70.0, -70.0, 90.0, -90.0]
    rad = torch.deg2rad(torch.tensor(angs, dtype=f32, device=dev))
    ca, sa = torch.cos(rad), torch.sin(rad)
    vx, vz = vpref[:, 0:1], vpref[:, 1:2]
    rot = torch.stack([vx * ca - vz * sa, vx * sa + vz * ca], dim=-1)
    rot = torch.cat([rot, rot * 0.5], dim=1)
    cand = torch.cat([base, rot, proj_l, proj_r], dim=1)

    if exact:
        kx = min(8, k)
        ra = torch.cat([apex[:, :kx], apex[:, :kx]], dim=1)
        rd = torch.cat([rot_l[:, :kx], rot_r[:, :kx]], dim=1)
        rv = torch.cat([neigh_valid[:, :kx]] * 2, dim=1)
        iu, ju = torch.triu_indices(2 * kx, 2 * kx, offset=1, device=dev)
        p1, d1, p2, d2 = ra[:, iu], rd[:, iu], ra[:, ju], rd[:, ju]
        det = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
        dp2 = p2 - p1
        nzd = det.abs() > _EPS
        safe = torch.where(nzd, det, 1.0)
        t1 = (dp2[..., 0] * d2[..., 1] - dp2[..., 1] * d2[..., 0]) / safe
        t2 = (dp2[..., 0] * d1[..., 1] - dp2[..., 1] * d1[..., 0]) / safe
        xpt = p1 + d1 * t1[..., None]
        ok = nzd & (t1 >= 0.0) & (t2 >= 0.0) & rv[:, iu] & rv[:, ju]
        xcand = torch.where(ok[..., None], xpt, vpref[:, None, :])
        wl = (vpref[:, None, :] * rot_l).sum(-1, keepdim=True)
        wr = (vpref[:, None, :] * rot_r).sum(-1, keepdim=True)
        cand = torch.cat([cand, xcand, apex + rot_l * wl, apex + rot_r * wr],
                         dim=1)
    else:
        cspeed = _norm(cand)
        cscale = torch.where(cspeed > max_speed_tick[:, None],
                             max_speed_tick[:, None]
                             / torch.clamp(cspeed, min=_EPS), 1.0)
        cand = cand * cscale[..., None]

    # ---- feasibility ------------------------------------------------------------
    cx, cz = cand[..., 0], cand[..., 1]
    ax, az = apex[..., 0], apex[..., 1]
    d_vpref = _norm(cand - vpref[:, None, :])
    if exact:                                   # [N, K, C] layout
        along = (phx[:, :, None] * cx[:, None, :] + phz[:, :, None] * cz[:, None, :]
                 - (ax * phx + az * phz)[:, :, None])
        wlen2 = ((cx * cx + cz * cz)[:, None, :]
                 - 2.0 * (ax[:, :, None] * cx[:, None, :]
                          + az[:, :, None] * cz[:, None, :])
                 + (ax * ax + az * az)[:, :, None])
        wlen = torch.sqrt(torch.clamp(wlen2, min=0.0))
        lx, lz = rot_r[..., 0], rot_r[..., 1]
        rx, rz = rot_l[..., 0], rot_l[..., 1]
        ldet = (lx[:, :, None] * cz[:, None, :] - lz[:, :, None] * cx[:, None, :]
                - (az * lx - ax * lz)[:, :, None])
        rdet = (rx[:, :, None] * cz[:, None, :] - rz[:, :, None] * cx[:, None, :]
                - (az * rx - ax * rz)[:, :, None])
        eps_ref = 1.0 / 1024
        tol = eps_ref * wlen
        inside = ((wlen >= eps_ref) & (ldet >= tol) & (rdet <= -tol)
                  & neigh_valid[:, :, None])
        violation = torch.where(inside, along - wlen * cos_t[:, :, None], zero)
        num_viol = inside.sum(1)
        total_viol = violation.sum(1)
        # remove-furthest cascade over distance ranks (clearpath.c:372-390)
        dsort = torch.where(neigh_valid, dist, float("inf"))
        kio = torch.arange(k, device=dev)
        lower = (dsort[:, :, None] > dsort[:, None, :]) | (
            (dsort[:, :, None] == dsort[:, None, :])
            & (kio[:, None] > kio[None, :])[None])
        rank = lower.sum(2)
        pref = rank[:, :, None] <= kio[None, None, :]           # [N,K,J]
        cum = torch.einsum("nkc,nkj->njc", inside.to(f32), pref.to(f32))
        any_m = (cum < 0.5).any(2)
        m_star = torch.cumprod(any_m.to(torch.int32), dim=1).sum(1)
        mi = torch.clamp(m_star - 1, min=0)
        viol_star = torch.take_along_dim(
            cum, mi[:, None, None].expand(n, 1, cum.shape[2]), dim=1)[:, 0]
        viol_star = torch.where((m_star > 0)[:, None], viol_star,
                                num_viol.to(f32))
        score = d_vpref + _BIG * viol_star + total_viol
    else:                                       # [N, C, K] layout
        along = (cx[:, :, None] * phx[:, None, :] + cz[:, :, None] * phz[:, None, :]
                 - (ax * phx + az * phz)[:, None, :])
        wlen2 = ((cx * cx + cz * cz)[:, :, None]
                 - 2.0 * (cx[:, :, None] * ax[:, None, :]
                          + cz[:, :, None] * az[:, None, :])
                 + (ax * ax + az * az)[:, None, :])
        wlen = torch.sqrt(torch.clamp(wlen2, min=0.0))
        inside = ((along > wlen * cos_t[:, None, :] + _EPS)
                  & neigh_valid[:, None, :])
        violation = torch.where(inside, along - wlen * cos_t[:, None, :], zero)
        num_viol = inside.sum(-1)
        total_viol = violation.sum(-1)
        score = d_vpref + _BIG * num_viol.to(f32) + total_viol
    best = torch.argmin(score, dim=1)
    newv = torch.take_along_dim(cand, best[:, None, None], dim=1)[:, 0, :]
    if exact:
        speed = _norm(newv)[:, None]
        newv = torch.where(speed > max_speed_tick[:, None],
                           newv * (max_speed_tick[:, None]
                                   / torch.clamp(speed, min=_EPS)), newv)
    return torch.where(active[..., None], newv, vpref)
