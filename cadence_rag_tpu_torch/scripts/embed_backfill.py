"""Embedding backfill CLI.

Usage: python -m cadence_rag_tpu_torch.scripts.embed_backfill [--batch-size N]
       [--call-id UUID]

(reference: app/scripts/embed_backfill.py:8-23). Counterpart of
``cadence_rag_tpu/scripts/embed_backfill.py``; store-only by default,
``--device-index`` scatters into an index in this process on ``--device``.
"""

from __future__ import annotations

import argparse

from ..config import settings
from ..embed.pipeline import run_embedding_backfill
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="embedding backfill")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--call-id", type=str, default=None)
    parser.add_argument(
        "--device-index", action="store_true",
        help="also scatter vectors into a process-local device index "
        "(default: store-only — a serving process syncs via the "
        "mutation log, and a standalone process's device state is "
        "discarded at exit anyway)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the --device-index index: cuda (default; raises "
        "without a card) or cpu",
    )
    args = parser.parse_args()
    configure_logging(settings.log_level)
    if args.device_index:
        from ..core.index import get_index

        get_index(args.device)
    else:
        from ..ingest.ingest import set_store_only

        set_store_only(True)
    summary = run_embedding_backfill(
        batch_size=args.batch_size or int(settings.embeddings_batch_size),
        call_id=args.call_id,
    )
    logger.info(
        "backfill.done rows=%s calls=%s model=%s per_table=%s",
        summary.rows_updated, summary.calls_touched,
        summary.model_used, summary.per_table,
    )


if __name__ == "__main__":
    main()
