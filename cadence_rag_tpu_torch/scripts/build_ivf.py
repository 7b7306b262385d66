"""Build (or rebuild) the IVF dense index over the live corpus.

Usage: python -m cadence_rag_tpu_torch.scripts.build_ivf [--corpus chunks]
       [--clusters N] [--nprobe N] [--device cuda|cpu]

Counterpart of ``cadence_rag_tpu/scripts/build_ivf.py``, the operator's
analogue of pgvector's ``CREATE INDEX ... USING hnsw`` build step: spherical
k-means on the device (``ops/ivf.py``) over the index this process holds,
rebuilt from the store when it is empty (row-sharded when ``MESH_SHAPE`` is
set: the k-means reads every shard). Afterwards, queries whose candidate
count passes IVF_MIN_ROWS use the probed-cluster scan when
DENSE_IVF_ENABLED is on; rows ingested after the build stay in the
exact-scanned overflow tail until the next run. ``--device`` defaults to
``cuda`` and raises without a card. Prints the build's summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from ..config import settings
from ..core.index import get_index
from ..logging_utils import configure_logging

logger = logging.getLogger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="build IVF dense index")
    parser.add_argument("--corpus", choices=["chunks", "artifact_chunks"],
                        default="chunks")
    parser.add_argument("--clusters", type=int, default=None)
    parser.add_argument("--nprobe", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args()
    configure_logging(settings.log_level)

    index = get_index(args.device)
    corpus = index.corpus(args.corpus)
    if corpus.count == 0:
        from ..core.vocab import activate_from_store
        from ..ingest.ingest import rebuild_index_from_store
        from ..store.db import get_store

        activate_from_store(get_store())
        rebuild_index_from_store()
    t0 = time.perf_counter()
    state = corpus.build_ivf(n_clusters=args.clusters, nprobe=args.nprobe)
    summary = {
        "corpus": args.corpus, "rows": state.built_count,
        "clusters": state.n_clusters, "nprobe": state.nprobe,
        "bucket_cap": int(state.buckets.shape[1]),
        "overflow": state.overflow_count, "shards": corpus.n_shards,
        "device": str(corpus.device), "s": time.perf_counter() - t0,
    }
    logger.info("build_ivf.done %s", summary)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
