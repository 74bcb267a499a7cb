"""How ``correct`` is decided: the program's own frames after the window,
held against the plain reference (``benchmark/reference``) run from the
same states.

The reference can only follow the program step by step: a battle at
contact depends on every earlier frame, and the order path's planning
(portals, A*) and the formation auction live on the host. So once the
window has closed, ``Recorder`` keeps every state the timed path's own
entry (``Engine.step_scan``'s segments or ``Engine.step``'s frames) is
handed and hands back, and every kernel K2 launch and flow-direction
quantization the nav service makes, while the cell's traffic goes on
(orders, waves, the nav cadence). The reference then runs each recorded
segment from its recorded start, in its own tick with its own fog
heights and skin rig worked out from the map and the configuration, and
integrates each recorded K2 batch itself. Separately, ``check_start``
holds what the program derived from the benchmark's inputs (the nav
costs of the map) against the reference's own, and ``judge_formations``
the formation layouts the standing orders made in set-up
(``FormationRecorder``), each recomputed from its recorded inputs.

The numbers compared (``compare_frames``, ``judge``), each the worst
over every recorded frame, or their sum for counts:

- ``pos_gap``: the largest gap of an entity's position (world units);
- ``hp_gap``: the largest gap of an entity's hit points;
- ``rows_differ``: entity and projectile rows that differ in any column,
  compared exactly;
- ``fog_differ``: fog-of-war tiles that differ;
- ``palette_gap``: the largest gap of a skinning palette entry (cells
  with skinning);
- ``field_gap``: the largest gap of a K2 integration value, infinite if
  the reachable tiles differ;
- ``dirs_differ``: flow-direction tiles that differ;
- ``map_differ``: nav-cost tiles that differ from the reference's
  compilation of the map;
- ``formation_cells_differ`` (cells with formations): formation cells
  that differ from the reference's layout of the same inputs.

Not compared, and printed on the ``check:`` line: ``formation_swap_gain``,
how far the units' assignment to those cells is from the least total
squared distance (``reference/formation.swap_gain``). The program's
auction stops at its round cap on these battles and leaves units to a
greedy fill, so it reads far above an auction's bound (``PERF.md``, open
questions).

These are the numbers every cell shares (``NUMBERS``). A generator adds
its own: ``Cell.recorders()`` gives context managers that ``verify``
enters beside the ``Recorder`` while the traffic is recorded (they only
copy, and take their patches off on exit), and ``Cell.judge_extra``
computes the generator's numbers from what they copied, with reference
code of its own under ``benchmark/reference/``, once the program's state
is freed. The entity columns the host rewrote during a recorded call
(``Cell.host_columns``, the fourth field of a segment) are left out of
that call's tick comparison; a generator whose host systems rewrite
columns names them there and compares them in ``judge_extra``.

Each configuration's limits are in ``benchmark/limits/<config>.json``:
every number a run of its cells must report, shared or a generator's,
with its limit, set from the readings ``PERF.md`` gives. A configuration
is added with a limits file of its own, and a generator's number is named
there and nowhere else.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

# the numbers every cell shares; a generator's own may not take these names
NUMBERS = ("pos_gap", "hp_gap", "rows_differ", "fog_differ", "palette_gap",
           "field_gap", "dirs_differ", "map_differ", "formation_cells_differ")


def clone_tree(obj):
    """A detached copy of a state or accumulator (dataclasses or
    namespaces of tensors and host values) as namespaces."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if obj is None or isinstance(obj, (int, float, bool, str)):
        return obj
    if dataclasses.is_dataclass(obj) or isinstance(obj, SimpleNamespace):
        return SimpleNamespace(**{k: clone_tree(v)
                                  for k, v in vars(obj).items()})
    raise TypeError(f"cannot copy a {type(obj).__name__} of the state")


class _Patches:
    """Wrappers set on the program's functions while entered, and taken
    off again on exit."""

    def __init__(self):
        self._undo: list = []

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        setattr(owner, name, wrap(orig))
        self._undo.append((owner, name, orig))

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()
        return False


class Recorder(_Patches):
    """While entered, records every K2 launch (inputs and output) and
    every flow-direction quantization (inputs and output) of the nav
    service. The wrappers only copy: each call goes to the program's own
    function with the arguments it was given. ``segments`` collects what
    ``Cell.record`` copies around the timed path's calls: (state before,
    frames, state after, the entity columns the host rewrote during the
    call)."""

    def __init__(self):
        super().__init__()
        self.segments: list = []
        self.k2: list = []
        self.dirs: list = []

    def __enter__(self):
        from permafrost_engine_tpu_torch.ops import flowfield, flowfield_cuda

        def k2(orig):
            def run(cost, seed_mask, seed_cost=None, *rest, **kw):
                out = orig(cost, seed_mask, seed_cost, *rest, **kw)
                max_iters = rest[0] if rest else kw["max_iters"]
                self.k2.append((cost.clone(), seed_mask.clone(),
                                None if seed_cost is None
                                else seed_cost.clone(), max_iters,
                                out.clone()))
                return out
            return run

        def dirs(orig):
            def run(integ, cost):
                out = orig(integ, cost)
                self.dirs.append((integ.clone(), cost.clone(), out.clone()))
                return out
            return run

        # the kernel's launcher, and the plain version the wrapper runs
        # instead on CPU tensors
        self._patch(flowfield_cuda, "integrate_cuda", k2)
        self._patch(flowfield_cuda, "integrate_plain", k2)
        self._patch(flowfield, "flow_dirs", dirs)
        return self


class FormationRecorder(_Patches):
    """While entered, records every formation layout (``layout_cells``'
    inputs and the cells it returns) and every assignment (the units'
    positions, the cells, and the cell index given each unit) that
    ``Engine.move_in_formation`` makes. The wrappers only copy."""

    def __init__(self):
        super().__init__()
        self.layouts: list = []
        self.assigns: list = []

    def __enter__(self):
        from permafrost_engine_tpu_torch.game import engine

        def layout(orig):
            def run(n, goal, direction, ftype, **kw):
                out = orig(n, goal, direction, ftype, **kw)
                self.layouts.append((
                    int(n), np.array(goal), np.array(direction), int(ftype),
                    {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                     for k, v in kw.items()}, np.array(out)))
                return out
            return run

        def assign(orig):
            def run(units_pos, cells, **kw):
                out = orig(units_pos, cells, **kw)
                self.assigns.append((np.array(units_pos), np.array(cells),
                                     np.array(out)))
                return out
            return run

        self._patch(engine, "layout_cells", layout)
        self._patch(engine, "assign_cells", assign)
        return self


def _bf16(x):
    """A float or array rounded to bfloat16 and back."""
    t = torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    out = t.to(torch.float32).numpy()
    return float(out) if np.ndim(x) == 0 else out


def judge_formations(rec: FormationRecorder, device,
                     lowp: bool = False) -> tuple[dict, float | None]:
    """``formation_cells_differ`` of the recorded layouts (none where
    nothing was recorded), and the largest ``formation_swap_gain`` of the
    recorded assignments (None without one), which is not compared. With
    `lowp` the control: the layouts from goals, directions and spacings
    held in bfloat16, in the program's place."""
    from benchmark.reference import formation as ref

    gain = None
    for units_pos, cells, got in rec.assigns:
        g = ref.swap_gain(ref.sq_dist(units_pos, cells, device), got)
        gain = g if gain is None else max(gain, g)
    if not rec.layouts:
        return {}, gain
    differ = 0
    for n, goal, direction, ftype, kw, got in rec.layouts:
        want = ref.layout_cells(n, goal, direction, ftype, **kw)
        if lowp:
            kw = dict(kw, spacing=_bf16(kw["spacing"]))
            got = ref.layout_cells(n, _bf16(goal), _bf16(direction), ftype,
                                   **kw)
        if got.shape != want.shape:
            differ += max(len(got), len(want))
        else:
            differ += int((got != want).any(1).sum())
    return {"formation_cells_differ": differ}, gain


class Reference:
    """The plain reference tick of a configuration on `device`: its own
    ``EngineConfig``, fog heights (from its own compilation of the map)
    and skin rig (``make_procedural_bank``). ``lowp`` holds every float
    column of the state in bfloat16 between frames: the control."""

    def __init__(self, conf: dict, map_data, device):
        from benchmark.reference.config import EngineConfig
        from benchmark.reference.skin import make_procedural_bank
        from benchmark.reference.tick import make_tick

        self.device = torch.device(device)
        self.cfg = EngineConfig(**conf["engine"])
        self.tile_height = None
        if map_data is not None:
            from benchmark.reference.pfmap import compile_nav_costs

            _, heights = compile_nav_costs(map_data)
            if np.ptp(heights) > 0.5:
                self.tile_height = torch.from_numpy(np.ascontiguousarray(
                    heights[::2, ::2], np.float32)).to(self.device)
        bank = (make_procedural_bank(self.cfg.skin_joints, device=self.device)
                if self.cfg.skin_joints > 0 else None)
        self.tick = make_tick(self.cfg, self.tile_height, skin_bank=bank)

    def run(self, state, n: int, lowp: bool = False):
        """n reference frames from a copy of `state`, with the events'
        accumulator empty (the engine drains it at the end of every call
        of the timed path)."""
        s, a = clone_tree(state), empty_deltas(self.cfg, self.device)
        for _ in range(n):
            s, a = self.tick(s, a)
            if lowp:
                _round_bf16(s)
        return s

    def integrate(self, cost, seed_mask, seed_cost, max_iters,
                  lowp: bool = False):
        from benchmark.reference.flowfield import integrate_plain

        out = integrate_plain(cost, seed_mask, seed_cost, max_iters=max_iters)
        if lowp:
            out = out.to(torch.bfloat16).to(torch.float32)
        return out

    def flow_dirs(self, integ, cost):
        from benchmark.reference.flowfield import flow_dirs

        return flow_dirs(integ, cost)


def empty_deltas(cfg, device) -> SimpleNamespace:
    """An empty events accumulator of the tick."""
    n, p = cfg.max_ents, cfg.max_projectiles
    b = torch.bool
    return SimpleNamespace(
        arrived=torch.zeros(n, dtype=b, device=device),
        motion_start=torch.zeros(n, dtype=b, device=device),
        died=torch.zeros(n, dtype=b, device=device),
        attack_started=torch.zeros(n, dtype=b, device=device),
        proj_hit=torch.full((p,), -1, dtype=torch.int32, device=device),
        proj_hit_shooter=torch.full((p,), -1, dtype=torch.int32,
                                    device=device),
        proj_hit_cookie=torch.zeros(p, dtype=torch.float32, device=device),
        corpse_expired=torch.zeros(n, dtype=b, device=device),
    )


def _round_bf16(tree) -> None:
    """Round every f32 tensor of a namespace tree to bfloat16, in place."""
    for k, v in vars(tree).items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.float32:
                v.copy_(v.to(torch.bfloat16))
        elif isinstance(v, SimpleNamespace):
            _round_bf16(v)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference; infinite where one side is NaN and
    the other is not."""
    if a.numel() == 0:
        return 0.0
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if bool((nan_a != nan_b).any()):
        return math.inf
    d = torch.where(nan_a, 0.0, (a - b).abs())
    return float(d.max())


def _rows_differ(a: SimpleNamespace, b: SimpleNamespace) -> int:
    """Rows (first dimension) of a table that differ in any column,
    comparing exactly (NaN equal to NaN)."""
    bad = None
    for k, va in vars(a).items():
        vb = getattr(b, k)
        if not isinstance(va, torch.Tensor) or va.dim() == 0:
            continue
        eq = (va == vb)
        if va.is_floating_point():
            eq = eq | (torch.isnan(va) & torch.isnan(vb))
        row = ~eq.reshape(eq.shape[0], -1).all(1)
        bad = row if bad is None else bad | row
    return 0 if bad is None else int(bad.sum())


def compare_frames(prog, ref, host_columns=()) -> dict:
    """The tick's numbers for one recorded call (see the module
    docstring). The entity columns `host_columns`, which the host rewrote
    during the call after the tick, are left out: of ``rows_differ``, and
    of ``pos_gap`` and ``hp_gap`` where they name ``pos`` or ``hp``."""
    ents_p = SimpleNamespace(**{k: v for k, v in vars(prog.ents).items()
                                if k not in host_columns})
    out = {
        "pos_gap": (0.0 if "pos" in host_columns
                    else _gap(prog.ents.pos, ref.ents.pos)),
        "hp_gap": (0.0 if "hp" in host_columns
                   else _gap(prog.ents.hp, ref.ents.hp)),
        "rows_differ": (_rows_differ(ents_p, ref.ents)
                        + _rows_differ(prog.projectiles, ref.projectiles)),
        "fog_differ": int((prog.fog.state != ref.fog.state).sum()),
    }
    if getattr(prog, "anim", None) is not None:
        out["palette_gap"] = _gap(prog.anim.palettes, ref.anim.palettes)
    return out


def _worse(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, 0), b.get(k, 0)) if k.endswith("_gap")
            else a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def judge(rec: Recorder, ref: Reference, lowp: bool = False) -> dict:
    """Every number of the recorded frames and fields. With `lowp` the
    control: the reference in bfloat16 stands where the program's output
    was, and is held against the reference in float32."""
    out: dict = {}
    for before, n, after, host_columns in rec.segments:
        want = ref.run(before, n)
        if lowp:
            after = ref.run(before, n, lowp=True)
        out = _worse(out, compare_frames(after, want, host_columns))
        del want
    field_gap, dirs_differ = 0.0, 0
    for cost, seeds, seed_cost, max_iters, got in rec.k2:
        want = ref.integrate(cost, seeds, seed_cost, max_iters)
        if lowp:
            got = ref.integrate(cost, seeds, seed_cost, max_iters, lowp=True)
        reach_w, reach_g = want < 1e30, got < 1e30
        if not torch.equal(reach_w, reach_g):
            field_gap = math.inf
        elif bool(reach_w.any()):
            field_gap = max(field_gap, float((got - want)[reach_w].abs().max()))
    for integ, cost, got in rec.dirs:
        want = ref.flow_dirs(integ, cost)
        if lowp:
            got = ref.flow_dirs(integ.to(torch.bfloat16).to(torch.float32),
                                cost)
        dirs_differ += int((got != want).sum())
    out["field_gap"] = field_gap
    out["dirs_differ"] = dirs_differ
    return out


def check_start(eng, conf: dict, map_data) -> dict:
    """What the program derived from the map against the reference's own
    compilation: nav-cost tiles that differ (``map_differ``)."""
    if map_data is None:
        want = np.ones(tuple(eng.state.nav.cost_base.shape), np.uint8)
    else:
        from benchmark.reference.pfmap import compile_nav_costs

        cost, _ = compile_nav_costs(map_data)
        want = cost[:eng.state.nav.cost_base.shape[0]]
    got = eng.state.nav.cost_base.cpu().numpy()
    return {"map_differ": int((got != want).sum())}


def verify(cell, frames: int, control: bool = False, log=None):
    """Record `frames` more frames of `cell`'s traffic, with the
    generator's own recorders (``cell.recorders()``) entered beside the
    ``Recorder``, free the program's state and judge them, with the
    formations its set-up recorded (``cell.formations``) and the
    generator's own numbers (``cell.judge_extra``): (the program's numbers,
    the control's numbers or None). The control reads the shared numbers
    only."""
    import time

    t0 = time.perf_counter()
    rec = Recorder()
    with contextlib.ExitStack() as stack:
        stack.enter_context(rec)
        for extra in cell.recorders():
            stack.enter_context(extra)
        cell.record(frames, rec)
    sound = check_start(cell.eng, cell.conf, cell.map_data)
    cell.eng = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = Reference(cell.conf, cell.map_data, cell.device)
    sound.update(judge(rec, ref))
    forms = cell.formations
    numbers, gain = judge_formations(forms, cell.device)
    sound.update(numbers)
    own = cell.judge_extra(cell.device)
    clash = sorted(set(own) & set(NUMBERS))
    if clash:
        raise ValueError(f"the generator's own numbers {clash} take the "
                         "names of shared ones")
    sound.update(own)
    if log:
        log(f"check: {len(rec.segments)} calls "
            f"({sum(s[1] for s in rec.segments)} frames), {len(rec.k2)} K2 "
            f"launches and {len(rec.dirs)} flow-direction calls recorded in "
            f"{t1 - t0:.2f} s, {len(forms.layouts)} formation layouts and "
            f"{len(forms.assigns)} assignments in set-up, "
            f"{len(own)} numbers of the generator's own; the reference "
            f"took {time.perf_counter() - t1:.2f} s; formation_swap_gain "
            f"{gain} (in 2 eps; not compared)")
    if not control:
        return sound, None
    return sound, {**judge(rec, ref, lowp=True),
                   **judge_formations(forms, cell.device, lowp=True)[0]}
