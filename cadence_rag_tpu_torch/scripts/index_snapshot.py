"""Index checkpoint CLI.

Usage:
  python -m cadence_rag_tpu_torch.scripts.index_snapshot save <dir> [--device cuda|cpu]
  python -m cadence_rag_tpu_torch.scripts.index_snapshot restore <dir> [--device cuda|cpu]

Counterpart of ``cadence_rag_tpu/scripts/index_snapshot.py``; the directory
is in that package's checkpoint format, so either package restores what the
other saved. ``save`` snapshots the live device index (rebuilding it from
the store first if empty); ``restore`` loads a snapshot without touching the
store. The index lives on ``--device`` (the card unless the caller asks for
the CPU).
"""

from __future__ import annotations

import argparse

from ..config import settings
from ..core.checkpoint import restore_index, save_index
from ..core.index import get_index
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="device index snapshots")
    parser.add_argument("action", choices=["save", "restore"])
    parser.add_argument("path")
    parser.add_argument(
        "--device", default="cuda",
        help="device of the index: cuda (default; raises without a card) "
             "or cpu",
    )
    args = parser.parse_args()
    configure_logging(settings.log_level)
    if args.action == "save":
        # activate the store's lexical vocab BEFORE any rebuild/save: the
        # stored lex_sig blobs carry its layout, and save_index records
        # the active vocab in checkpoint meta (a save without it would
        # stamp lex_vocab_version=0 over head-layout rows)
        from ..core.vocab import activate_from_store
        from ..store.db import get_store

        activate_from_store(get_store())
        index = get_index(args.device)
        if index.chunks.count == 0 and index.artifacts.count == 0:
            from ..ingest.ingest import rebuild_index_from_store

            counts = rebuild_index_from_store()
            logger.info("snapshot.rebuilt chunks=%s artifacts=%s", *counts)
        meta = save_index(args.path)
    else:
        meta = restore_index(args.path, get_index(args.device))
    logger.info("snapshot.%s path=%s counts=%s", args.action, args.path,
                meta["counts"])


if __name__ == "__main__":
    main()
