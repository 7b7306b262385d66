"""Learn + apply the lexical vocab head for this store's corpus.

Usage: python -m cadence_rag_tpu_torch.scripts.build_lex_vocab
       [--head N] [--limit-docs N] [--dry-run] [--device cuda|cpu]

Counterpart of ``cadence_rag_tpu/scripts/build_lex_vocab.py``. The index the
re-featurized rows are scattered into lives on ``--device`` (the card unless
the caller asks for the CPU; ``--dry-run`` needs no index).

Operator analogue of rebuilding pg_search's BM25 index after a tokenizer
change (reference: alembic/versions/0005:17-37 rebuilds the index with
ngram(3,3)): scans stored texts for the top-``head`` document-frequent
feature hashes, persists them as a new ``lex_vocab`` version, and
re-featurizes every stored document (store blobs + live device rows + df
tables) under the new layout — see core/vocab.py for why.

MUST run offline: a serving process started before the rebuild would
score new-layout signatures with old-layout query vectors. Serving
processes activate the store's vocab at startup; checkpoints record the
vocab version and startup refuses a snapshot/store divergence.
"""

from __future__ import annotations

import argparse
import json

from ..config import settings
from ..core import vocab as vocab_mod
from ..core.index import get_index
from ..logging_utils import configure_logging, get_logger
from ..store.db import get_store

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="learn + apply the lexical vocab head"
    )
    parser.add_argument(
        "--head", type=int, default=None,
        help=f"head size (default LEX_VOCAB_HEAD={settings.lex_vocab_head})",
    )
    parser.add_argument(
        "--limit-docs", type=int, default=0,
        help="cap scanned docs per corpus (0 = all; df ranking of frequent "
             "features is robust under prefix sampling)",
    )
    parser.add_argument(
        "--dry-run", action="store_true",
        help="learn + report the vocab without persisting or re-featurizing",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the index: cuda (default; raises without a card) "
             "or cpu",
    )
    args = parser.parse_args()
    configure_logging(settings.log_level)

    store = get_store()
    if args.dry_run:
        head = int(args.head or settings.lex_vocab_head)
        hashes = vocab_mod.build_vocab_from_store(
            store, head, limit_docs=args.limit_docs
        )
        print(json.dumps({
            "dry_run": True, "head": int(hashes.size),
            "dim": int(settings.lexical_dim),
        }))
        return

    index = get_index(args.device)
    if index.chunks.count == 0 and index.artifacts.count == 0:
        from ..ingest.ingest import rebuild_index_from_store

        # adopt the store's current layout before rehydrating, so the
        # version-provenance check (rehydrate_doc_rows) sees a coherent
        # process rather than a layout lag
        vocab_mod.activate_from_store(store)
        rebuild_index_from_store()
    summary = vocab_mod.build_and_apply(
        store, index, head=args.head, limit_docs=args.limit_docs
    )
    logger.info("build_lex_vocab.done %s", summary)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
