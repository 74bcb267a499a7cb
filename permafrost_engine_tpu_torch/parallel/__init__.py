"""Multi-rank driving mode: the port's counterpart of
``permafrost_engine_tpu/parallel/`` on ``torch.distributed``.

``mesh.py``: the rank mesh, the per-leaf plan, the exchange helpers and
the launcher; ``step.py``: the sharded tick and ``sharded_engine``;
``fields.py``: the row-banded halo-exchange field integrator."""

from permafrost_engine_tpu_torch.parallel.fields import (  # noqa: F401
    AXIS,
    make_sharded_integrate,
)
from permafrost_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    ENT_AXIS,
    Mesh,
    make_mesh,
    shard_state,
    spawn,
    state_shardings,
)
from permafrost_engine_tpu_torch.parallel.step import (  # noqa: F401
    deltas_shardings,
    make_sharded_tick,
    sharded_engine,
)
