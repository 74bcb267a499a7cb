"""PFOBJ model format: parser producing device-ready animation data.

Implements the ASCII model format from the reference's spec
(ref: docs/pfobj.txt v1.0): header, vertices (pos/uv/normal/weights/
material), materials, optional joints, animation sets, and per-frame
bounding boxes. Joint keyframes are converted to the arrays the pose
kernels consume (ops/pose.py): parents i32[J], bind TRS, and per-clip
[F, J] translation/rotation/scale arrays (quaternions from the spec's
XYZ-order Euler angles).

The port's own copy of ``permafrost_engine_tpu/assets/pfobj.py``, verbatim
but for the package name (numpy only).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Material:
    name: str
    ambient: float
    diffuse: tuple
    specular: tuple
    texture: str


@dataclasses.dataclass
class AnimClip:
    name: str
    frames: int
    trans: np.ndarray    # f32[F, J, 3]
    rots: np.ndarray     # f32[F, J, 4] quaternion (x, y, z, w)
    scales: np.ndarray   # f32[F, J, 3]
    bboxes: np.ndarray | None = None   # f32[F, 2, 3] (min, max) per frame


@dataclasses.dataclass
class PFObj:
    verts: np.ndarray        # f32[V, 3]
    uvs: np.ndarray          # f32[V, 2]
    normals: np.ndarray      # f32[V, 3]
    weight_joints: np.ndarray  # i32[V, 4] (-1 = unused)
    weight_vals: np.ndarray    # f32[V, 4]
    vert_mat: np.ndarray       # i32[V]
    materials: list[Material]
    joint_parents: np.ndarray  # i32[J] (-1 = root)
    joint_names: list[str]
    bind_trans: np.ndarray     # f32[J, 3]
    bind_rots: np.ndarray      # f32[J, 4]
    bind_scales: np.ndarray    # f32[J, 3]
    clips: dict[str, AnimClip]
    bbox: np.ndarray | None    # f32[2, 3] static (min, max)

    @property
    def num_joints(self) -> int:
        return len(self.joint_parents)


class PFObjError(ValueError):
    pass


def euler_xyz_to_quat(rx: float, ry: float, rz: float) -> np.ndarray:
    """XYZ-order Euler degrees -> quaternion (x, y, z, w)."""
    hx, hy, hz = (math.radians(a) / 2 for a in (rx, ry, rz))
    cx, sx = math.cos(hx), math.sin(hx)
    cy, sy = math.cos(hy), math.sin(hy)
    cz, sz = math.cos(hz), math.sin(hz)
    # q = qz * qy * qx (applying x first)
    qx = np.array([sx, 0, 0, cx])
    qy = np.array([0, sy, 0, cy])
    qz = np.array([0, 0, sz, cz])

    def mul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array([
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ])

    return mul(mul(qz, qy), qx)


def _parse_slashed(tok: str, n: int = 3) -> list[float]:
    parts = tok.split("/")
    if len(parts) != n:
        raise PFObjError(f"expected {n} slash-delimited floats: {tok!r}")
    return [float(p) for p in parts]


def quat_to_euler_xyz(q: np.ndarray) -> tuple[float, float, float]:
    """Quaternion (x, y, z, w) -> XYZ-order Euler degrees (the writer's
    inverse of euler_xyz_to_quat)."""
    x, y, z, w = (float(v) for v in q)
    sinr = 2 * (w * x + y * z)
    cosr = 1 - 2 * (x * x + y * y)
    rx = math.atan2(sinr, cosr)
    sinp = max(-1.0, min(1.0, 2 * (w * y - z * x)))
    ry = math.asin(sinp)
    siny = 2 * (w * z + x * y)
    cosy = 1 - 2 * (y * y + z * z)
    rz = math.atan2(siny, cosy)
    return math.degrees(rx), math.degrees(ry), math.degrees(rz)


def write_pfobj(m: PFObj) -> str:
    """Serialize a PFObj back to the ASCII format (ref: docs/pfobj.txt;
    the Blender addon's export path, tools/blender_addon).
    parse_pfobj(write_pfobj(m)) round-trips."""
    def f3(v, n=3):
        return "/".join(f"{float(x):.6f}" for x in v[:n])

    clips = list(m.clips.values())
    has_bb = bool(clips) and clips[0].bboxes is not None
    out = [
        "version 1.0",
        f"num_verts {len(m.verts)}",
        f"num_joints {m.num_joints}",
        f"num_material {len(m.materials)}",
        f"num_as {len(clips)}",
        "frame_counts " + " ".join(str(c.frames) for c in clips),
        f"has_collision {int(has_bb)}",
    ]
    for i in range(len(m.verts)):
        out.append("v " + " ".join(f"{x:.6f}" for x in m.verts[i]))
        out.append("vt " + " ".join(f"{x:.6f}" for x in m.uvs[i]))
        out.append("vn " + " ".join(f"{x:.6f}" for x in m.normals[i]))
        out.append("vw " + " ".join(
            f"{int(m.weight_joints[i, k])}/{float(m.weight_vals[i, k]):.6f}"
            for k in range(4)))
        out.append(f"vm {int(m.vert_mat[i])}")
    for mat in m.materials:
        out += [f"material {mat.name}",
                f"\tambient {mat.ambient:.6f}",
                "\tdiffuse " + " ".join(f"{x:.6f}" for x in mat.diffuse),
                "\tspecular " + " ".join(f"{x:.6f}" for x in mat.specular),
                f"\ttexture {mat.texture or '__none__'}"]
    for j in range(m.num_joints):
        rx, ry, rz = quat_to_euler_xyz(m.bind_rots[j])
        out.append(
            f"j {int(m.joint_parents[j]) + 1} {m.joint_names[j]} "
            f"{f3(m.bind_scales[j])} {rx:.6f}/{ry:.6f}/{rz:.6f} "
            f"{f3(m.bind_trans[j])}")
    for c in clips:
        out.append(f"as {c.name} {c.frames}")
        for f in range(c.frames):
            for j in range(m.num_joints):
                rx, ry, rz = quat_to_euler_xyz(c.rots[f, j])
                out.append(f"\t{j + 1} {f3(c.scales[f, j])} "
                           f"{rx:.6f}/{ry:.6f}/{rz:.6f} {f3(c.trans[f, j])}")
        if has_bb:
            for f in range(c.frames):
                bb = c.bboxes[f]
                out.append(f"\tx_bounds {bb[0][0]:.6f} {bb[1][0]:.6f}")
                out.append(f"\ty_bounds {bb[0][1]:.6f} {bb[1][1]:.6f}")
                out.append(f"\tz_bounds {bb[0][2]:.6f} {bb[1][2]:.6f}")
    return "\n".join(out) + "\n"


def parse_pfobj(text: str) -> PFObj:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    it = iter(lines)

    def nx() -> str:
        try:
            return next(it)
        except StopIteration:
            raise PFObjError("unexpected end of file") from None

    def header(key) -> list[str]:
        parts = nx().split()
        if parts[0] != key:
            raise PFObjError(f"expected {key!r}, got {parts[0]!r}")
        return parts[1:]

    float(header("version")[0])
    num_verts = int(header("num_verts")[0])
    num_joints = int(header("num_joints")[0])
    num_materials = int(header("num_material")[0])
    num_as = int(header("num_as")[0])
    frame_counts = [int(x) for x in header("frame_counts")]
    has_collision = bool(int(header("has_collision")[0]))
    if len(frame_counts) != num_as:
        raise PFObjError("frame_counts length != num_as")

    verts = np.zeros((num_verts, 3), np.float32)
    uvs = np.zeros((num_verts, 2), np.float32)
    normals = np.zeros((num_verts, 3), np.float32)
    wj = np.full((num_verts, 4), -1, np.int32)
    wv = np.zeros((num_verts, 4), np.float32)
    vmat = np.zeros(num_verts, np.int32)

    for i in range(num_verts):
        v = nx().split()
        assert v[0] == "v"
        verts[i] = [float(x) for x in v[1:4]]
        vt = nx().split()
        assert vt[0] == "vt"
        uvs[i] = [float(x) for x in vt[1:3]]
        vn = nx().split()
        assert vn[0] == "vn"
        normals[i] = [float(x) for x in vn[1:4]]
        vw = nx().split()
        assert vw[0] == "vw"
        for k, pair in enumerate(vw[1:5]):
            j, w = pair.split("/")
            wj[i, k] = int(j)
            wv[i, k] = float(w)
        vm = nx().split()
        assert vm[0] == "vm"
        vmat[i] = int(vm[1])

    materials = []
    for _ in range(num_materials):
        name = nx().split()[1]
        ambient = float(nx().split()[1])
        diffuse = tuple(float(x) for x in nx().split()[1:4])
        specular = tuple(float(x) for x in nx().split()[1:4])
        texture = nx().split()[1]
        materials.append(Material(name, ambient, diffuse, specular, texture))

    parents = np.full(num_joints, -1, np.int32)
    names = []
    b_t = np.zeros((num_joints, 3), np.float32)
    b_r = np.zeros((num_joints, 4), np.float32)
    b_s = np.ones((num_joints, 3), np.float32)
    for j in range(num_joints):
        parts = nx().split()
        assert parts[0] == "j"
        parents[j] = int(parts[1]) - 1           # spec: 1-based, 0 = root
        names.append(parts[2])
        b_s[j] = _parse_slashed(parts[3])
        b_r[j] = euler_xyz_to_quat(*_parse_slashed(parts[4]))
        b_t[j] = _parse_slashed(parts[5])

    clips: dict[str, AnimClip] = {}
    for a in range(num_as):
        head = nx().split()
        assert head[0] == "as"
        name, frames = head[1], int(head[2])
        tr = np.zeros((frames, num_joints, 3), np.float32)
        rt = np.zeros((frames, num_joints, 4), np.float32)
        sc = np.ones((frames, num_joints, 3), np.float32)
        for f in range(frames):
            for _ in range(num_joints):
                parts = nx().split()
                j = int(parts[0]) - 1
                sc[f, j] = _parse_slashed(parts[1])
                rt[f, j] = euler_xyz_to_quat(*_parse_slashed(parts[2]))
                tr[f, j] = _parse_slashed(parts[3])
        bboxes = None
        if has_collision:
            bboxes = np.zeros((frames, 2, 3), np.float32)
            for f in range(frames):
                rec = {}
                for _ in range(3):
                    parts = nx().split()
                    rec[parts[0]] = [float(x) for x in parts[1:]]
                # x/y/z extents as min/max pairs
                mins = [rec["x_bounds"][0], rec["y_bounds"][0], rec["z_bounds"][0]]
                maxs = [rec["x_bounds"][1], rec["y_bounds"][1], rec["z_bounds"][1]]
                bboxes[f] = [mins, maxs]
        clips[name] = AnimClip(name, frames, tr, rt, sc, bboxes)

    bbox = None
    if clips:
        first = next(iter(clips.values()))
        if first.bboxes is not None:
            bbox = first.bboxes[0]

    return PFObj(
        verts=verts, uvs=uvs, normals=normals, weight_joints=wj,
        weight_vals=wv, vert_mat=vmat, materials=materials,
        joint_parents=parents, joint_names=names, bind_trans=b_t,
        bind_rots=b_r, bind_scales=b_s, clips=clips, bbox=bbox)
