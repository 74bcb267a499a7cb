"""The rank mesh: process group, device, transport, exchange helpers, plan.

Counterpart of ``permafrost_engine_tpu/parallel/mesh.py``. JAX drives many
chips from one controller over global-view arrays that GSPMD partitions;
here every rank is a process running the same engine program (SPMD), holds
the whole ``GameState`` on its own device, and divides the per-entity work
of the tick by rows (``parallel/step.py``). ``state_shardings`` gives the
same per-leaf plan as JAX's sharding rules: ``"ents"`` for the entity
arena, ``"rows"`` for the map grids when the map is row-sharded,
``"repl"`` for the rest. The plan says which rank computes which rows; the
storage stays whole on every rank.

Transport, chosen once by ``spawn`` from the device count and printed:

* ``nccl``: one card per rank (``cuda:<rank>``), collectives on the cards;
* ``gloo-host``: fewer cards than ranks, so every rank computes on
  ``cuda:0`` and each message is staged through host memory explicitly;
* ``gloo``: CPU tensors (the tests).

A failing collective raises; nothing switches transport.

``spawn(fn, world, *args)`` starts `world` rank processes on a ``file://``
store, runs ``fn(*args)`` in each inside an initialised process group and
returns the results in rank order: the counterpart of JAX's single
controller. A rank that fails or outlives the timeout fails the call, and
every rank is stopped.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from permafrost_engine_tpu_torch.core.config import EngineConfig
from permafrost_engine_tpu_torch.state.schema import GameState

ENT_AXIS = "ents"

_KINDS = ("all_gather", "halo", "all_reduce")


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D mesh over the ``ents`` axis: the process
    group, this rank, the world size, the rank's compute device and the
    transport (see the module docstring); its one axis is ``ENT_AXIS``.
    ``state_plan`` is the plan of the state ``shard_state`` placed last;
    ``counters`` holds, per kind of collective (``all_gather``, ``halo``,
    ``all_reduce``), the calls this rank issued and the bytes it sent."""

    group: object
    rank: int
    world: int
    device: torch.device
    transport: str
    state_plan: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=lambda: {
        k: {"calls": 0, "bytes": 0} for k in _KINDS})

    def reset_counters(self) -> None:
        for c in self.counters.values():
            c["calls"] = c["bytes"] = 0

    def _count(self, kind: str, nbytes: int) -> None:
        self.counters[kind]["calls"] += 1
        self.counters[kind]["bytes"] += int(nbytes)

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's band [lo, hi) of `n` rows (`n` divides the world)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the transport's collectives take it."""
        return t.cpu() if self.transport == "gloo-host" else t

    def all_gather_rows(self, bands: list, dim: int = 0) -> list:
        """Every rank's band of each tensor, concatenated along `dim` in
        rank order: the whole tensors. All bands go in ONE collective as
        packed bytes; every rank's bands have the same shapes."""
        if self.world == 1:
            return list(bands)
        moved = [b.movedim(dim, 0).contiguous() for b in bands]
        raw = [m.reshape(-1).view(torch.uint8) for m in moved]
        sizes = [r.numel() for r in raw]
        # each segment padded to 8 bytes, so every piece views aligned
        raw = [torch.cat([r, r.new_zeros(-r.numel() % 8)]) for r in raw]
        buf = self._wire(torch.cat(raw))
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf, group=self.group)
        self._count("all_gather", buf.numel())
        whole = torch.cat(out).to(self.device)
        per = buf.numel()
        res = []
        off = 0
        for m, size in zip(moved, sizes):
            parts = [whole[r * per + off:r * per + off + size]
                     .view(m.dtype).reshape(m.shape)
                     for r in range(self.world)]
            res.append(torch.cat(parts).movedim(0, dim))
            off += size + (-size % 8)
        return res

    def halo_exchange(self, top: torch.Tensor, bottom: torch.Tensor):
        """One ring step of the band halo: send this rank's `top` row to
        the rank above and its `bottom` row to the rank below. Returns
        (the row above this band, the row below it): the bottom row of
        rank - 1 and the top row of rank + 1, None beyond the map edge
        (the ring's wrap-around messages are not sent, since the edges take
        a fill value, as the JAX version's masks do)."""
        r, n = self.rank, self.world
        from_above = from_below = None
        ops = []
        if r > 0:
            from_above = self._wire(torch.empty_like(bottom))
            ops += [dist.P2POp(dist.isend, self._wire(top), r - 1, self.group),
                    dist.P2POp(dist.irecv, from_above, r - 1, self.group)]
        if r < n - 1:
            from_below = self._wire(torch.empty_like(top))
            ops += [dist.P2POp(dist.isend, self._wire(bottom), r + 1,
                               self.group),
                    dist.P2POp(dist.irecv, from_below, r + 1, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self._count("halo", (len(ops) // 2) * top.numel()
                        * top.element_size())
        if from_above is not None:
            from_above = from_above.to(self.device)
        if from_below is not None:
            from_below = from_below.to(self.device)
        return from_above, from_below

    def all_reduce(self, t: torch.Tensor, op: str = "min") -> torch.Tensor:
        """The MIN or MAX of `t` over the ranks, on this rank's device."""
        red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
        buf = self._wire(t.clone())
        dist.all_reduce(buf, op=red, group=self.group)
        self._count("all_reduce", buf.numel() * buf.element_size())
        return buf.to(self.device)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This rank's mesh; call it inside an initialised process group (as
    ``spawn`` runs a rank). `n_devices`, when given, must be the world
    size. With the NCCL backend rank r computes on ``cuda:r``; with gloo on
    `device`, by default ``cuda:0`` when there is a card (messages staged
    through the host) and the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (run under spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices, world is {world}")
    if dist.get_backend() == "nccl":
        dev, transport = torch.device("cuda", rank), "nccl"
    else:
        if device is None:
            device = "cuda:0" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        transport = "gloo-host" if dev.type == "cuda" else "gloo"
    return Mesh(dist.group.WORLD, rank, world, dev, transport)


def _leaf_paths(obj, prefix=""):
    """(dotted name, tensor) of every tensor leaf of a state dataclass."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _leaf_paths(v, prefix + f.name + ".")


def state_shardings(cfg: EngineConfig, mesh: Mesh, state: GameState,
                    map_sharded: bool = False) -> dict[str, str]:
    """The plan: a tag per tensor leaf (dotted name -> ``"ents"``,
    ``"rows"`` or ``"repl"``), by the JAX rules: arena and anim leaves of
    ``max_ents`` rows are ``"ents"``; with `map_sharded` (and the field
    and fog heights dividing the world) the nav grids [C, H, W] whose H is
    ``field_h`` or ``tiles_h``, ``fog.state`` and ``fields.global_flow``
    are ``"rows"``; everything else is ``"repl"``."""
    n = mesh.world
    rows_ok = cfg.field_h % n == 0 and cfg.tiles_h % n == 0
    plan = {}
    for name, t in _leaf_paths(state):
        tag = "repl"
        top = name.split(".")[0]
        if (top in ("ents", "anim") and t.dim() >= 1
                and t.shape[0] == cfg.max_ents):
            tag = "ents"
        elif map_sharded and rows_ok:
            if top == "nav" and (t.dim() == 3 and t.shape[1] % n == 0
                                 and t.shape[1] in (cfg.field_h, cfg.tiles_h)):
                tag = "rows"
            elif name in ("fog.state", "fields.global_flow"):
                tag = "rows"
        plan[name] = tag
    return plan


def shard_state(cfg: EngineConfig, mesh: Mesh, state: GameState,
                map_sharded: bool = False) -> GameState:
    """Put `state` on the rank's device (every leaf, whole), check that the
    arena and, with `map_sharded`, the field and fog heights divide over
    the ranks, and attach the plan as ``state_plan`` on the mesh."""
    if cfg.max_ents % mesh.world:
        raise ValueError(f"max_ents {cfg.max_ents} does not divide over "
                         f"{mesh.world} ranks")
    if map_sharded and (cfg.field_h % mesh.world or cfg.tiles_h % mesh.world):
        raise ValueError(f"field_h {cfg.field_h} and tiles_h {cfg.tiles_h} "
                         f"must divide over {mesh.world} ranks")

    def move(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                setattr(obj, f.name, v.to(mesh.device))
            elif dataclasses.is_dataclass(v):
                move(v)

    move(state)
    mesh.state_plan = state_shardings(cfg, mesh, state, map_sharded)
    return state


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def choose_transport(world: int, device: str = "cuda") -> str:
    """``nccl`` when there is a card per rank, ``gloo-host`` when ranks
    share fewer cards, ``gloo`` for CPU ranks."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("spawn: no CUDA device for cuda ranks")
    return "nccl" if torch.cuda.device_count() >= world else "gloo-host"


def _rank_main(fn, rank, world, store, transport, threads, timeout_s, args,
               results):
    """A rank process: join the group, run fn(*args), report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if transport == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if transport == "nccl" else "gloo",
            init_method=f"file://{store}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, device: str = "cuda",
          timeout_s: float = 600.0, threads: int | None = None,
          store_dir: str | None = None, log=print) -> list:
    """Run ``fn(*args)`` on `world` rank processes (the spawn start method;
    `fn` must be importable by name) and return their results in rank
    order. The ranks meet on a fresh ``file://`` store under `store_dir`
    (the system's temporary directory by default); `threads` sets each rank's
    torch threads. Raises if a rank raises or the ranks do not all finish
    within `timeout_s`; every rank is stopped before this returns."""
    transport = choose_transport(world, device)
    log(f"parallel: {world} ranks, transport {transport}")
    with tempfile.TemporaryDirectory(prefix="pf_store_",
                                     dir=store_dir) as tmp:
        return _run_ranks(fn, world, args, os.path.join(tmp, "store"),
                          transport, threads, timeout_s)


def _run_ranks(fn, world, args, store, transport, threads, timeout_s):
    """``spawn``'s body: start, collect, stop."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, transport, threads,
                               timeout_s, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"ranks {sorted(set(range(world)) - set(got))} "
                           f"did not finish within {timeout_s:.0f} s")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    failure = (f"ranks {dead} exited with "
                               f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    if failure is not None:
        raise RuntimeError(f"spawn: {failure}")
    return [got[r] for r in range(world)]
