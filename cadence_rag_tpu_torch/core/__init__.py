"""Device-resident index state (counterpart of ``cadence_rag_tpu.core``)."""

from .index import (  # noqa: F401
    CorpusIndex,
    DeviceIndexManager,
    DocRow,
    get_index,
    reset_index,
)
