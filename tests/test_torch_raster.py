"""PyTorch port vs the JAX package: the rasterizer (``render/raster.py``).

The same seeded numpy inputs go through the JAX functions and the port's
(on the CPU). Tolerances, with the worst case measured when they were set:

* ``project`` and ``clip_near``: within 1e-5 relative plus 1e-5 absolute
  (``REL``); measured 3.2e-6 relative on pixel x (1.1e-4 relative, 2.3e-5
  absolute, near x = 0), 2.4e-7 relative on y, z and 1/w, and 1.5e-5
  absolute on the clipped vertices (2.4e-6 on their attributes). Validity
  is equal except on slivers at the 1e-6 area cut, which cover no pixel.
* ``raster_gbuffer`` on ``tests/test_raster.py``'s brute-force oracle
  scene: triangle ids equal on every pixel (and equal to the oracle's), z
  within 1e-5 (3.6e-7 measured, barycentrics 3.1e-7).
* a seeded 2,000-triangle soup that overflows the per-tile K cap and
  takes the big-triangle path: ids equal on at least 99.9% of pixels
  (100% measured), z within 1e-5 where the ids agree (5.4e-7 measured).
* ``shade_gbuffer`` on one G-buffer fed to both, with textures, a shadow
  map and fog: within 1e-4 (2.4e-7 measured).
* ties: more visible instances than ``maxi`` (``scene.assemble_instances``
  ranks a 0/1 vector) and more big triangles than ``kbig`` in one depth
  bucket: the port takes JAX's set in JAX's order (equal ids; the
  instances' vertices equal, their attributes within 6e-8).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from permafrost_engine_tpu.render import raster as jr
from permafrost_engine_tpu.render import scene as jscene
from permafrost_engine_tpu.render.camera import Camera
from permafrost_engine_tpu_torch.render import raster as tr
from permafrost_engine_tpu_torch.render import scene as tscene

from test_raster import _oracle

REL = 1e-5
Z_ATOL = 1e-5
SHADE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vp(cam):
    return (cam.proj_matrix() @ cam.view_matrix()).astype(np.float32)


def _soup(n, seed, lo=(0, -5, 0), hi=(256, 20, 256), size=12.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(lo, hi, (n, 1, 3))
    return (c + rng.uniform(-size, size, (n, 3, 3))).astype(np.float32)


CAMS = [Camera(pos=np.array([128.0, 60.0, 300.0]), pitch=-35.0, yaw=90.0,
               aspect=1.0),
        # low camera inside the soup: many triangles cross the near plane
        Camera(pos=np.array([128.0, 4.0, 128.0]), pitch=-10.0, yaw=60.0,
               aspect=1.0)]


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_project_and_clip_near_match_jax(cam):
    vp = _vp(CAMS[cam])
    verts = _soup(600, seed=cam)
    attrs = np.random.default_rng(7).normal(size=(600, 3, 5)).astype(
        np.float32)
    jv, ja, jok = jr.clip_near(jnp.asarray(verts), jnp.asarray(attrs),
                               jnp.asarray(vp))
    tv, ta, tok = tr.clip_near(_t(verts), _t(attrs), _t(vp))
    assert (_np(tok) == np.asarray(jok)).all()
    if cam == 1:     # the low camera splits some triangles in two
        assert 0 < int(np.asarray(jok[600:]).sum())
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=REL, atol=1e-5)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=REL, atol=1e-5)
    want = jr.project(jv, jnp.asarray(vp), 128, 128)
    got = tr.project(tv, _t(vp), 128, 128)
    # slivers (a clip's near-duplicate vertices) sit at the 1e-6 area cut,
    # where one rounding decides; they cover no pixel centre
    area = np.abs(np.asarray(jr._edge(want[0][:, 0], want[0][:, 1],
                                      want[0][:, 2])))
    solid = area > 1e-3
    assert (np.asarray(want[3]) == _np(got[3]))[solid].all()
    ok = np.asarray(want[3]) & solid
    assert ok.sum() > 50
    assert (np.asarray(want[4]) == _np(got[4]))[ok].all()
    for i in range(3):
        np.testing.assert_allclose(_np(got[i])[ok], np.asarray(want[i])[ok],
                                   rtol=REL, atol=1e-5)


def _oracle_scene():
    """tests/test_raster.py's brute-force oracle scene."""
    rng = np.random.default_rng(0)
    t_n = 200
    xy = rng.uniform(-10, 74, (t_n, 3, 2)).astype(np.float32)
    z = rng.uniform(-0.9, 0.9, (t_n, 3)).astype(np.float32)
    valid = rng.random(t_n) < 0.9
    xy[:5] = rng.uniform(-20, 90, (5, 3, 2))      # oversized -> brute path
    area = np.asarray(jr._edge(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
                               jnp.asarray(xy[:, 2])))
    flip = area < 0
    xy[flip] = xy[flip][:, ::-1]
    z[flip] = z[flip][:, ::-1]
    valid &= np.abs(area) > 1e-6
    return xy, z, valid


def test_raster_gbuffer_matches_oracle_and_jax():
    xy, z, valid = _oracle_scene()
    h = w = 64
    tz, tt, tb = tr.raster_gbuffer(_t(xy), _t(z), _t(valid), h=h, w=w)
    jz, jt, jb = jr.raster_gbuffer(jnp.asarray(xy), jnp.asarray(z),
                                   jnp.asarray(valid), h=h, w=w)
    ozbuf, otri = _oracle(xy, z, valid, h, w)
    assert (_np(tt) == np.asarray(jt)).all()
    assert (_np(tt) == otri).all()
    fin = np.isfinite(ozbuf)
    assert (np.isfinite(_np(tz)) == fin).all()
    np.testing.assert_allclose(_np(tz)[fin], np.asarray(jz)[fin], atol=Z_ATOL)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), atol=Z_ATOL)


def _screen_soup(n, seed, h, w, frac_big=0.05, clustered=True):
    """Screen-space triangles, winding-normalized like `project`'s output;
    a dense cluster overflows the per-tile K cap."""
    rng = np.random.default_rng(seed)
    if clustered:
        c = rng.normal([w / 2, h / 2], [w / 8, h / 8], (n, 1, 2))
    else:
        c = rng.uniform([0, 0], [w, h], (n, 1, 2))
    xy = (c + rng.uniform(-9, 9, (n, 3, 2))).astype(np.float32)
    nb = int(n * frac_big)
    xy[:nb] = rng.uniform(-20, max(h, w) + 20, (nb, 3, 2))
    z = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    a = np.asarray(jr._edge(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
                            jnp.asarray(xy[:, 2])))
    flip = a < 0
    xy[flip] = xy[flip][:, ::-1]
    z[flip] = z[flip][:, ::-1]
    valid = np.abs(a) > 1e-6
    return xy, z, valid


def test_raster_gbuffer_overflow_and_big_path():
    h, w = 96, 128
    xy, z, valid = _screen_soup(2000, seed=3, h=h, w=w)
    jz, jt, _ = jr.raster_gbuffer(jnp.asarray(xy), jnp.asarray(z),
                                  jnp.asarray(valid), h=h, w=w)
    tz, tt, _ = tr.raster_gbuffer(_t(xy), _t(z), _t(valid), h=h, w=w)
    jt, tt = np.asarray(jt), _np(tt)
    # the scene does what it is for: the K cap binds and the big path runs
    tiles_hit = np.zeros((h // 16) * (w // 16), int)
    xs, ys = xy[..., 0], xy[..., 1]
    span_x = np.floor(xs.max(1) / 16) - np.floor(xs.min(1) / 16)
    span_y = np.floor(ys.max(1) / 16) - np.floor(ys.min(1) / 16)
    assert ((span_x >= 4) | (span_y >= 4))[valid].sum() > 64
    small = valid & (span_x < 4) & (span_y < 4)
    for t in np.nonzero(small)[0]:
        tx = np.clip(np.floor(xs[t].mean() / 16), 0, w // 16 - 1)
        ty = np.clip(np.floor(ys[t].mean() / 16), 0, h // 16 - 1)
        tiles_hit[int(ty * (w // 16) + tx)] += 1
    assert tiles_hit.max() > 96
    same = tt == jt
    assert same.mean() >= 0.999, same.mean()
    both = same & np.isfinite(np.asarray(jz))
    np.testing.assert_allclose(_np(tz)[both], np.asarray(jz)[both],
                               atol=Z_ATOL)


def test_big_triangle_ties_take_jax_set_and_order():
    """More big triangles than kbig, all in one depth bucket: the big path
    keeps the first kbig by index (XLA's top_k order on ties)."""
    h = w = 128
    n = 200
    rng = np.random.default_rng(5)
    # every triangle spans the frame: the big path takes all of them
    xy = np.stack([rng.uniform(-40, 0, (n, 2)),
                   np.stack([rng.uniform(128, 168, n),
                             rng.uniform(-40, 168, n)], 1),
                   np.stack([rng.uniform(-40, 168, n),
                             rng.uniform(128, 168, n)], 1)], 1
                  ).astype(np.float32)
    a = np.asarray(jr._edge(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
                            jnp.asarray(xy[:, 2])))
    xy[a < 0] = xy[a < 0][:, ::-1]
    # one near-depth bucket for all (ZQ bucket 562); flat triangles, later
    # ids nearer, so a different kept set would show in the ids
    z = np.repeat((0.1006 - 3e-6 * np.arange(n, dtype=np.float32))[:, None],
                  3, 1).astype(np.float32)
    valid = np.abs(a) > 1e-6
    jz, jt, _ = jr.raster_gbuffer(jnp.asarray(xy), jnp.asarray(z),
                                  jnp.asarray(valid), h=h, w=w, kbig=16)
    tz, tt, _ = tr.raster_gbuffer(_t(xy), _t(z), _t(valid), h=h, w=w, kbig=16)
    assert (_np(tt) == np.asarray(jt)).all()
    # the kept set is the lowest 16 valid ids, in JAX as in the port
    assert set(np.unique(_np(tt))) - {-1} <= set(np.nonzero(valid)[0][:16])
    score = np.where(valid, 7, 0).astype(np.int32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(score), 16)
    got_v, got_i = tr.stable_top(_t(score), 16)
    assert (_np(got_i) == np.asarray(want_i)).all()
    assert (_np(got_v) == np.asarray(want_v)).all()


def test_assemble_instances_ties_take_jax_set_and_order():
    """More visible instances than maxi: a 0/1 score ties everywhere."""
    n, maxi = 48, 16
    rng = np.random.default_rng(9)
    mats = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    mats[:, :3, 3] = rng.uniform(0, 100, (n, 3))
    visible = rng.random(n) < 0.7
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mesh_id = rng.integers(0, 3, n).astype(np.int32)
    color = rng.random((n, 3)).astype(np.float32)
    bank = jscene._mesh_bank()
    jv, ja = jscene.assemble_instances(
        jnp.asarray(mats), jnp.asarray(visible), jnp.asarray(scale),
        jnp.asarray(mesh_id), jnp.asarray(color), jnp.asarray(bank),
        maxi=maxi)
    tv, ta = tscene.assemble_instances(
        _t(mats), _t(visible), _t(scale), _t(mesh_id), _t(color), _t(bank),
        maxi=maxi)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=REL, atol=1e-4)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=REL, atol=1e-4)


def _gbuffer_inputs(seed=0, h=48, w=64, t_n=40, c_n=14):
    rng = np.random.default_rng(seed)
    tri = rng.integers(-1, t_n, (h, w)).astype(np.int32)
    bary = rng.dirichlet([1, 1, 1], (h, w)).astype(np.float32)
    inv_w = rng.uniform(0.01, 1.0, (t_n, 3)).astype(np.float32)
    attrs = np.zeros((t_n, 3, c_n), np.float32)
    attrs[..., 0:3] = rng.uniform(0, 256, (t_n, 3, 3))
    attrs[..., 3:6] = rng.normal(size=(t_n, 3, 3))
    attrs[..., 6:9] = rng.random((t_n, 3, 3))
    attrs[..., 9:11] = rng.uniform(-3, 3, (t_n, 3, 2))
    tex = rng.integers(-1, 3, (t_n, 2)).astype(np.float32)
    attrs[..., 11:13] = tex[:, None, :]
    attrs[..., 13] = rng.random((t_n, 3))
    light = np.array([-0.45, -0.8, -0.35], np.float32)
    light /= np.linalg.norm(light)
    shadow_z = rng.uniform(-1, 1, (32, 32)).astype(np.float32)
    light_vp = jscene._ortho_vp(np.array([0.0, -2.0, 0.0]),
                                np.array([256.0, 20.0, 256.0]), light)
    fog = rng.integers(0, 3, (16, 16)).astype(np.uint8)
    fog_scale = np.array([16 / 256, 16 / 256], np.float32)
    cam = Camera(pos=np.array([128.0, 60.0, 300.0]), pitch=-35.0, yaw=90.0,
                 aspect=w / h)
    rays = jr.camera_rays(cam, w, h)
    atlas = rng.uniform(0, 2, (128, 128, 3)).astype(np.float32)
    table = np.array([[0, 0], [0, 64], [64, 0]], np.int32)
    return (tri, bary, inv_w, attrs, light, shadow_z, light_vp, fog,
            fog_scale, jscene.SKY, rays, atlas, table)


@pytest.mark.parametrize("textured", [True, False], ids=["atlas", "plain"])
def test_shade_gbuffer_matches_jax(textured):
    args = list(_gbuffer_inputs())
    if not textured:
        args[3] = args[3][..., :9]
    *base, atlas, table = args
    want = jr.shade_gbuffer(*[jnp.asarray(a) for a in base],
                            atlas=jnp.asarray(atlas),
                            tex_table=jnp.asarray(table), tex_size=64)
    got = tr.shade_gbuffer(*[_t(a) for a in base], atlas=_t(atlas),
                           tex_table=_t(table), tex_size=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=SHADE_ATOL)


def test_camera_rays_equal():
    from permafrost_engine_tpu_torch.render.camera import Camera as TCam
    kw = dict(pos=np.array([1.0, 50.0, 2.0]), pitch=-33.0, yaw=71.0,
              aspect=1.5)
    assert (tr.camera_rays(TCam(**kw), 48, 32)
            == jr.camera_rays(Camera(**kw), 48, 32)).all()


def test_near_plane_clip_recovers_ground_under_low_camera():
    """tests/test_raster.py's low-camera case on the port: the clipped
    floor fills the bottom of the frame, and the perspective-correct world
    position at sampled pixels is the ray-plane hit."""
    cam = Camera(pos=np.array([0.0, 8.0, 0.0]), pitch=-25.0, yaw=90.0,
                 aspect=1.0)
    vp = _t(_vp(cam))
    w = h = 64
    s = 500.0
    quad = np.array([[[-s, 0, -s], [s, 0, -s], [s, 0, s]],
                     [[-s, 0, -s], [s, 0, s], [-s, 0, s]]], np.float32)
    attrs = np.zeros((2, 3, 9), np.float32)
    attrs[..., 0:3] = quad
    assert int(tr.project(_t(quad), vp, w, h)[3].sum()) == 0
    verts2, attrs2, ok2 = tr.clip_near(_t(quad), _t(attrs), vp)
    xy, z, inv_w, valid, flip = tr.project(verts2, vp, w, h)
    valid = valid & ok2
    attrs2 = torch.where(flip[:, None, None], attrs2.flip(1), attrs2)
    _zb, tri, bary = tr.raster_gbuffer(xy, z, valid, h=h, w=w, k=16, kbig=8)
    tri, bary = tri.numpy(), bary.numpy()
    assert (tri[-h // 3:, :] >= 0).all()
    rays = tr.camera_rays(cam, w, h)
    for (r, c) in [(60, 10), (50, 32), (44, 60), (63, 31)]:
        t = tri[r, c]
        pw = bary[r, c] * inv_w.numpy()[t]
        pw = pw / pw.sum()
        wp = (pw[:, None] * attrs2.numpy()[t, :, 0:3]).sum(0)
        hit = np.array([0.0, 8.0, 0.0]) + rays[r, c] * (-8.0 / rays[r, c][1])
        assert np.allclose(wp, hit, atol=0.5), (wp, hit)
