"""permafrost_engine_tpu_torch — the PyTorch/CUDA port of permafrost_engine_tpu.

The same engine, module for module (``state/ ops/ nav/ game/`` mirror the
JAX package's layout and names), written as plain PyTorch over tensors on
an explicit device. The two Pallas kernels of the JAX package are
hand-written CUDA C++ kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound with ctypes; on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.

The port imports neither ``jax`` nor anything of the JAX package. The
JAX-free modules it needs are its own copies, under the same names:
``core/config.py``, ``core/events.py``, ``core/sched.py``,
``core/settings.py``, ``core/audio.py``, ``game/arrival.py``,
``game/region.py``, ``game/selection.py``, ``assets/pfmap.py`` (with the
PFMAP parser and writer, and ``assets/mapgen.py``, the battle map),
``assets/pfobj.py``, ``assets/cache.py``, ``render/camera.py``,
``script/constants.py``, ``script/ui.py``, ``script/ui_style.py``,
``script/task.py``, ``render/textures.py``, ``render/hud.py``,
``render/ui_compose.py``, ``render/debug_overlays.py``, ``utils/noise.py``,
``utils/image.py`` and ``utils/native.py``, which builds the repository's
``native/pf_native.cpp`` into the port's ``_build/``.

Ported so far: the move-order -> flow-field -> movement-substep path, the
war path and the combined-arms orders (``game/engine.Engine``:
``spawn_batch``, ``move``, ``move_in_formation``, ``seek_enemies``,
``surround``, ``set_structure_blocking``, ``set_diplomacy``, ``step``):
combat, projectiles, corpses, fog of war (with the height-aware
shadowcaster), per-(faction, layer) chase fields, RANK/COLUMN formations
(``game/formation.py`` with the auction of ``ops/assignment.py``),
structures with incremental portal-graph updates, and the 60-frame nav
cadence; skinning (``ops/pose.py``, ``ops/skin.py``), micro-batched
stepping and ``step_scan`` as CUDA graphs (``game/graphs.py``); the host
layer (the scheduler, pause, the economy, regions, selection, audio, the
animation system), profiling and sessions (``core/perf.py``,
``core/pickling.py``, ``core/session.py``); and the ``pf`` script surface
(``script/pf.py``: ``from permafrost_engine_tpu_torch.script import pf``,
with ``script/entity.py``'s entity classes, ``pf.Task``, the UI and the
constants) with ``ops/collision.py``; and rendering (``render/raster.py``,
``render/scene.py``'s ``SceneRenderer`` on the engine's device, the HUD, UI
and debug overlays, ``pf.dump_framebuffer``). Not yet: ``parallel/``.

The shared names a caller of the port needs are re-exported here, so a
driver script imports only this package.
"""

__version__ = "0.1.0"

from permafrost_engine_tpu_torch.assets.pfmap import compile_nav_costs  # noqa: F401
from permafrost_engine_tpu_torch.core.config import (  # noqa: F401
    COST_IMPASSABLE, FIELD_RES, FRAME_HZ, MAX_NEIGHBOURS, DiplomacyState,
    EngineConfig, FogState)
