"""permafrost_engine_tpu_torch — the PyTorch/CUDA port of permafrost_engine_tpu.

The same engine, module for module (``state/ ops/ nav/ game/`` mirror the
JAX package's layout and names), written as plain PyTorch over tensors on
an explicit device. The two Pallas kernels of the JAX package are
hand-written CUDA C++ kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound with ctypes; on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.

The port imports neither ``jax`` nor anything of the JAX package. The
JAX-free modules it needs are its own copies, under the same names:
``core/config.py``, ``core/events.py``, ``game/arrival.py``,
``assets/pfmap.py`` (with ``assets/mapgen.py``, the battle map) and
``utils/native.py``, which builds the repository's ``native/pf_native.cpp``
into the port's ``_build/``.

Ported so far: the move-order -> flow-field -> movement-substep path and
the war path (``game/engine.Engine``: ``spawn_batch``, ``move``,
``set_diplomacy``, ``step``): combat, projectiles, corpses, fog of war
(with the height-aware shadowcaster), per-(faction, layer) chase fields
and the 60-frame nav cadence.

The shared names a caller of the port needs are re-exported here, so a
driver script imports only this package.
"""

__version__ = "0.1.0"

from permafrost_engine_tpu_torch.assets.pfmap import compile_nav_costs  # noqa: F401
from permafrost_engine_tpu_torch.core.config import (  # noqa: F401
    COST_IMPASSABLE, FIELD_RES, FRAME_HZ, MAX_NEIGHBOURS, DiplomacyState,
    EngineConfig, FogState)
