"""Animation system: host clip registry + device pose batching.

Port of ``permafrost_engine_tpu/render/anim_system.py``: the clip
bookkeeping is the same host code; ``pose_palettes`` runs on the port's
``ops/pose.py`` and ``torch.linalg.inv``, on the engine's device.

Mirrors src/anim/anim.c: per-entity clip playback (idle/active clip,
LOOP/ONCE modes, finish events) with per-tick pose computation — here the
clip bookkeeping is host code (frame counters only) and the pose palettes
for ALL animated entities of a model are produced by one batched device
computation per clip (ops/pose.py), the equivalent of the shared anim
texture (ref: src/anim/anim_texture.c:93-145).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.events import EventType


class AnimMode:
    LOOP = 0
    ONCE = 1


ANIM_FPS = 24.0  # reference clip playback rate


@dataclasses.dataclass
class AnimState:
    model: str = ""              # pfobj path / model key
    clip: str = "idle"
    idle_clip: str = "idle"
    mode: int = AnimMode.LOOP
    t: float = 0.0               # seconds into the clip


class AnimSystem:
    def __init__(self, engine):
        self.engine = engine
        self.states: dict[int, AnimState] = {}
        self.models: dict[str, object] = {}   # model key -> PFObj

    # -- registration ------------------------------------------------------------

    def load_model(self, key: str, pfobj) -> None:
        self.models[key] = pfobj

    def register(self, uid: int, model: str = "", idle_clip: str = "idle") -> None:
        self.states[uid] = AnimState(model=model, clip=idle_clip,
                                     idle_clip=idle_clip)

    def unregister(self, uid: int) -> None:
        self.states.pop(uid, None)

    # -- playback (ref: anim.h:52-83) -----------------------------------------------

    def play(self, uid: int, clip: str, mode: int = AnimMode.LOOP) -> None:
        st = self.states[uid]
        st.clip = clip
        st.mode = mode
        st.t = 0.0

    def set_idle(self, uid: int, clip: str) -> None:
        self.states[uid].idle_clip = clip

    def current(self, uid: int) -> str:
        return self.states[uid].clip

    def tick(self, dt: float) -> None:
        """Advance clip clocks; ONCE clips fire a finish event and return
        to idle (ref: EVENT_ANIM_FINISHED)."""
        for uid, st in self.states.items():
            st.t += dt
            model = self.models.get(st.model)
            if model is None or st.clip not in getattr(model, "clips", {}):
                continue
            clip = model.clips[st.clip]
            dur = clip.frames / ANIM_FPS
            if st.t >= dur:
                if st.mode == AnimMode.ONCE:
                    self.engine.bus.notify(
                        EventType.ANIM_FINISHED,
                        {"uid": uid, "clip": st.clip}, uid=uid)
                    self.engine.bus.notify(
                        EventType.ANIM_FINISHED,
                        {"uid": uid, "clip": st.clip})
                    st.clip = st.idle_clip
                    st.mode = AnimMode.LOOP
                st.t = st.t % max(dur, 1e-6)

    # -- pose batching (device) -------------------------------------------------------

    def pose_palettes(self, model_key: str) -> np.ndarray | None:
        """Skinning palettes [N_instances, J, 4, 4] for every registered
        entity of a model — one batched device computation per clip (the
        anim texture contents), returned as a host array."""
        from permafrost_engine_tpu_torch.ops import pose as pose_ops

        model = self.models.get(model_key)
        if model is None or model.num_joints == 0:
            return None
        uids = [u for u, st in self.states.items() if st.model == model_key]
        if not uids:
            return None
        dev = self.engine.device

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        # batch sample_clip per CLIP, not per entity: instances of a model
        # share a handful of clips (the reference's anim texture likewise
        # fills all instances of a clip in one pass, anim_texture.c:93-145)
        groups: dict[str, list[int]] = {}
        for row, u in enumerate(uids):
            st = self.states[u]
            cname = st.clip if st.clip in model.clips else next(
                iter(model.clips))
            groups.setdefault(cname, []).append(row)
        local_rows = [None] * len(uids)
        for cname, rows in groups.items():
            clip = model.clips[cname]
            dur = clip.frames / ANIM_FPS
            times = f32([self.states[uids[r]].t % dur for r in rows])
            key_t = f32(np.arange(clip.frames) / ANIM_FPS)
            local = pose_ops.sample_clip(
                key_t, f32(clip.trans), f32(clip.rots), f32(clip.scales),
                times)                                 # [len(rows), J, ...]
            for i, r in enumerate(rows):
                local_rows[r] = local[i]
        local_mats = torch.stack(local_rows)

        bind = pose_ops.trs_to_mat(f32(model.bind_trans), f32(model.bind_rots),
                                   f32(model.bind_scales))
        # inverse bind: accumulate bind globals then invert
        parents = np.asarray(model.joint_parents)
        levels = tuple(tuple(lvl.tolist())
                       for lvl in pose_ops.hierarchy_levels(parents))
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        bind_glob = pose_ops.pose_palette(
            bind[None], eye.expand(bind[None].shape), parents, levels)[0]
        inv_bind = torch.linalg.inv(bind_glob)

        return pose_ops.pose_palette(local_mats, inv_bind, parents,
                                     levels).cpu().numpy()
