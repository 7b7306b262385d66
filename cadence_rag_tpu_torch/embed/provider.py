"""The embedding result record.

Counterpart of the ``EmbeddingResult`` of ``cadence_rag_tpu/embed/
provider.py``. The JAX package's provider registry (HTTP, neural, Qwen3)
and its cache are not ported: the port has no such providers yet, only the
deterministic stub (``embed/stub.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class EmbeddingResult:
    # (N, dim) float32 rows
    vectors: Union[np.ndarray, List[List[float]]]
    model: str
