"""Whole-arena device skinning: per-frame pose palettes for every entity.

The benchmark's frozen copy of ``permafrost_engine_tpu_torch/ops/skin.py``,
taken when the benchmark was defined and kept as it was: part of the plain
reference that ``benchmark/check.py`` holds the program against. It imports
nothing of the program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/skin.py``. The reference advances each
animated entity's clip clock on the main thread and bakes the visible
entities' joint palettes into one shared GL texture each rendered frame
(ref: src/anim/anim.c A_Update, src/anim/anim_texture.c:93-145). Here it is
one batched stage of the tick:

  * clip selection follows the simulation FSMs (corpse -> die, attacking ->
    attack, moving -> run, else idle);
  * clip clocks live in the state (``state.anim``: clip id and start
    frame), so clip restarts on FSM transitions are exact;
  * keyframe interpolation, the hierarchy products and the inverse-bind
    multiply run for every slot as batched [N, J, 4, 4] math
    (``ops/pose.py``), producing ``state.anim.palettes``.

The stage reads the frame from ``state.anim.tick``, a device counter the
tick advances with the host ``GameState.tick``, so a CUDA graph replay of
the stage sees the frame it runs at, not the frame it was captured at.

A bank comes from ``make_bank``, ``bank_from_pfobj`` (a loaded PFObj's
clips, ``assets/pfobj.py``), ``make_procedural_bank`` or
``state.convert.bank_from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.config import (
    CombatState,
    FRAME_HZ,
    MoveState,
)
from benchmark.reference import pose as pose_ops

ANIM_FPS = 24.0  # reference clip playback rate

# canonical clip slots (bank rows); games may register more
CLIP_IDLE, CLIP_RUN, CLIP_ATTACK, CLIP_DIE = 0, 1, 2, 3


@dataclasses.dataclass(eq=False)
class SkinBank:
    """Stacked clip keyframes for one rig, on one device.

    `pack` holds every clip's keyframes as [C * F, J, 10] rows of
    (trans[3] | quat[4] | scale[3]); clips shorter than F pad with their
    last keyframe (never sampled: `frames` bounds the phase). `max_frames`,
    `levels` (joint ids by hierarchy depth) and `parents` are host values."""

    pack: torch.Tensor       # f32[C*F, J, 10]
    frames: torch.Tensor     # i32[C] real keyframe count per clip
    loop: torch.Tensor       # bool[C] LOOP (wrap) vs ONCE (hold last frame)
    inv_bind: torch.Tensor   # f32[J, 4, 4]
    max_frames: int
    levels: tuple
    parents: tuple = ()


def make_bank(clips: list[tuple[np.ndarray, np.ndarray, np.ndarray, bool]],
              parents: np.ndarray, bind_trans: np.ndarray,
              bind_rots: np.ndarray, bind_scales: np.ndarray, *,
              device="cuda") -> SkinBank:
    """A SkinBank on `device` from per-clip (trans [F,J,3], rots [F,J,4],
    scales [F,J,3], loop) keyframe stacks and the bind pose. The inverse
    bind is computed on the host in f32 (``torch.linalg.inv``)."""
    j = parents.shape[0]
    f_max = max(int(c[0].shape[0]) for c in clips)
    packs, frames, loops = [], [], []
    for trans, rots, scales, loop in clips:
        f = trans.shape[0]
        p = np.concatenate([trans, rots, scales], axis=-1)  # [F, J, 10]
        if f < f_max:
            p = np.concatenate(
                [p, np.repeat(p[-1:], f_max - f, axis=0)], axis=0)
        packs.append(p)
        frames.append(f)
        loops.append(loop)
    pack = np.concatenate(packs, axis=0).astype(np.float32)  # [C*F, J, 10]

    levels = tuple(tuple(lvl.tolist())
                   for lvl in pose_ops.hierarchy_levels(parents))
    bind = pose_ops.trs_to_mat(
        torch.from_numpy(np.asarray(bind_trans, np.float32)),
        torch.from_numpy(np.asarray(bind_rots, np.float32)),
        torch.from_numpy(np.asarray(bind_scales, np.float32)))
    bind_glob = pose_ops.pose_palette(
        bind[None], torch.eye(4).expand(1, j, 4, 4), parents, levels)[0]
    inv_bind = torch.linalg.inv(bind_glob)

    return SkinBank(
        pack=torch.from_numpy(pack).to(device),
        frames=torch.tensor(frames, dtype=torch.int32, device=device),
        loop=torch.tensor(loops, dtype=torch.bool, device=device),
        inv_bind=inv_bind.to(device),
        max_frames=f_max,
        levels=levels,
        parents=tuple(int(p) for p in np.asarray(parents)),
    )


def make_procedural_bank(num_joints: int = 32, *, device="cuda") -> SkinBank:
    """Deterministic humanoid-scale test rig: a torso chain with four
    3-joint limb chains and filler joints, and 4 clips (idle/run/attack/
    die) of sinusoid joint swings: the default bank when no model is
    loaded, with a real rig's shapes and hierarchy depth."""
    j = num_joints
    parents = np.zeros(j, np.int32)
    parents[0] = -1
    # torso chain 0-5, then limbs hang off joints 2 (arms) and 0 (legs)
    for i in range(1, 6):
        parents[i] = i - 1
    anchors = [2, 2, 0, 0]
    idx = 6
    for limb in range(4):
        prev = anchors[limb]
        for seg in range(3):
            if idx >= j:
                break
            parents[idx] = prev
            prev = idx
            idx += 1
    while idx < j:                       # filler: ribbon off the torso
        parents[idx] = (idx - 1) if (idx % 4) else 3
        idx += 1

    bind_trans = np.zeros((j, 3), np.float32)
    bind_trans[:, 1] = 0.3               # stacked 0.3u bone offsets
    bind_rots = np.zeros((j, 4), np.float32)
    bind_rots[:, 3] = 1.0
    bind_scales = np.ones((j, 3), np.float32)

    def clip(f, amp, freq, loop):
        t = np.arange(f, dtype=np.float32)[:, None]     # [F, 1]
        ph = np.arange(j, dtype=np.float32)[None, :]    # [1, J]
        ang = amp * np.sin(2 * np.pi * freq * t / f + ph)  # [F, J]
        half = ang * 0.5
        rots = np.stack([np.sin(half), np.zeros_like(half),
                         np.zeros_like(half), np.cos(half)], -1)
        trans = np.repeat(bind_trans[None], f, 0)
        scales = np.ones((f, j, 3), np.float32)
        return trans.astype(np.float32), rots.astype(np.float32), \
            scales.astype(np.float32), loop

    clips = [clip(16, 0.10, 1.0, True),   # idle: slow sway
             clip(12, 0.45, 2.0, True),   # run: fast swing
             clip(10, 0.60, 1.0, False),  # attack: one swing
             clip(14, 0.80, 0.5, False)]  # die: one fall
    return make_bank(clips, parents, bind_trans, bind_rots, bind_scales,
                     device=device)


def select_clips(ents) -> torch.Tensor:
    """Per-entity clip id i32[N] from the simulation FSMs (the reference's
    script-driven pf.play_anim calls for combat/movement transitions)."""
    ms, cs = ents.movestate, ents.combatstate
    moving = ((ms == MoveState.MOVING) | (ms == MoveState.TURNING)
              | (ms == MoveState.SEEK_ENEMIES)
              | (ms == MoveState.ARRIVING_TO_CELL)
              | (ms == MoveState.SURROUND_ENTITY))
    dead = (cs == CombatState.DEATH_ANIM) | (cs == CombatState.CORPSE)
    attacking = cs == CombatState.ATTACK_ANIM
    return torch.where(
        dead, CLIP_DIE,
        torch.where(attacking, CLIP_ATTACK,
                    torch.where(moving, CLIP_RUN, CLIP_IDLE))).to(torch.int32)


def skin_palettes(bank: SkinBank, clip: torch.Tensor,
                  tsec: torch.Tensor) -> torch.Tensor:
    """Palettes f32[N, J, 4, 4] for N entities playing `clip` (i32[N]) at
    clip-local times `tsec` (f32[N], seconds): keyframe lerp/slerp,
    hierarchy products and the inverse bind, all batched."""
    ci = clip.long()
    nf = bank.frames[ci]                                     # [N] i32
    nff = nf.to(torch.float32)
    loop = bank.loop[ci]
    ph = tsec * ANIM_FPS
    # LOOP wraps over [0, nf) (the nf-1 -> 0 segment blends back to the
    # first keyframe); ONCE clamps to the last keyframe and holds.
    # torch.remainder is floored, as jnp.mod
    looped = torch.remainder(ph, torch.clamp(nff, min=1.0))
    once = torch.minimum(ph, nff - 1.0)
    phase = torch.where(loop, looped, once)
    i0 = torch.minimum(torch.floor(phase).to(torch.int32), nf - 1)
    w = (phase - i0.to(torch.float32))[:, None, None]        # [N,1,1]
    i1 = torch.where(loop, torch.remainder(i0 + 1, torch.clamp(nf, min=1)),
                     torch.minimum(i0 + 1, nf - 1))
    base = ci * bank.max_frames
    r0 = bank.pack[base + i0]                                # [N, J, 10]
    r1 = bank.pack[base + i1]
    tr = r0[..., 0:3] * (1 - w) + r1[..., 0:3] * w
    q = pose_ops.quat_slerp(r0[..., 3:7], r1[..., 3:7], w)
    sc = r0[..., 7:10] * (1 - w) + r1[..., 7:10] * w
    local = pose_ops.trs_to_mat(tr, q, sc)                   # [N, J, 4, 4]
    return pose_ops.pose_palette(local, bank.inv_bind, bank.parents,
                                 bank.levels)


def skin_substep(cfg, bank: SkinBank, state):
    """The tick's skinning stage: advance the clip FSM clocks and rebuild
    every palette (``state.anim``), at the frame ``state.anim.tick``."""
    anim = state.anim
    now = anim.tick
    new_clip = select_clips(state.ents)
    start = torch.where(new_clip != anim.clip, now, anim.start)
    tsec = (now - start).to(torch.float32) / float(FRAME_HZ)
    # deterministic desync: golden-ratio per-slot phase offset so idle
    # units don't breathe in lockstep; added to ONCE clips too, as the
    # JAX stage does (skin.py:239)
    slots = torch.arange(cfg.max_ents, dtype=torch.float32,
                         device=tsec.device)
    tsec = tsec + torch.remainder(slots * 0.61803398875, 1.0)
    anim.palettes = skin_palettes(bank, new_clip, tsec)
    anim.clip, anim.start = new_clip, start
    return state
