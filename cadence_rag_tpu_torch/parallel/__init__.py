"""Multi-device scaling (counterpart of ``cadence_rag_tpu.parallel``):
device meshes, the row-sharded index's lanes and their candidate merge,
the op-log that keeps a multi-process gang in lockstep, and the ``model``
axis's tensor-parallel weights and collectives (``tensor.py``)."""

from .mesh import make_mesh, parse_mesh_shape  # noqa: F401
from .sharded import sharded_dense_topk, sharded_multi_lane  # noqa: F401
