"""Tech-token backfill: recompute tokens after extraction-rule changes.

Usage: python -m cadence_rag_tpu_torch.scripts.tech_tokens_backfill [--dry-run]
       [--batch-size N] [--table chunks|artifact_chunks|analysis_artifacts]

Keyset-batched over each table (resumable by construction; reference:
app/scripts/tech_tokens_backfill.py:36-218), updating both the store rows
and the device index tech slots. Counterpart of
``cadence_rag_tpu/scripts/tech_tokens_backfill.py``; store-only by default,
``--device-index`` updates an index in this process on ``--device``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import settings
from ..core.index import get_index
from ..ingest import featurize
from ..ingest.chunking import extract_tech_tokens
from ..logging_utils import configure_logging, get_logger
from ..store.db import from_json, get_store

logger = get_logger(__name__)

TABLES = {
    "chunks": ("chunk_id", "text", "chunks"),
    "artifact_chunks": ("artifact_chunk_id", "content", "artifact_chunks"),
    "analysis_artifacts": ("artifact_id", "content", None),  # no device corpus
}


def backfill_table(
    table: str, batch_size: int = 500, dry_run: bool = False
) -> int:
    id_col, text_col, corpus_name = TABLES[table]
    store = get_store()
    from ..ingest.ingest import store_only

    # standalone runs write the store only — the UPDATE triggers log the
    # mutations and a serving process's syncer re-scatters the slots
    index = None if store_only() else get_index()
    changed = 0
    after_id = 0
    while True:
        with store.read() as conn:
            rows = conn.execute(
                f"SELECT {id_col} AS row_id, {text_col} AS content, tech_tokens "
                f"FROM {table} WHERE {id_col} > ? ORDER BY {id_col} ASC LIMIT ?",
                (after_id, batch_size),
            ).fetchall()
        if not rows:
            break
        updates = []
        device_ids = []
        device_tech = []
        for row in rows:
            fresh = extract_tech_tokens(row["content"])
            if fresh != (from_json(row["tech_tokens"]) or []):
                updates.append((json.dumps(fresh), row["row_id"]))
                device_ids.append(row["row_id"])
                device_tech.append(featurize.tech_slots(fresh))
        if updates and not dry_run:
            with store.tx() as conn:
                conn.executemany(
                    f"UPDATE {table} SET tech_tokens = ? WHERE {id_col} = ?",
                    updates,
                )
            if index is not None and corpus_name is not None and device_ids:
                index.corpus(corpus_name).set_tech(
                    device_ids, np.stack(device_tech)
                )
        changed += len(updates)
        after_id = rows[-1]["row_id"]
    return changed


def main() -> None:
    parser = argparse.ArgumentParser(description="tech tokens backfill")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--batch-size", type=int, default=500)
    parser.add_argument("--table", choices=sorted(TABLES), default=None)
    parser.add_argument(
        "--device-index", action="store_true",
        help="also update a process-local device index (default: "
        "store-only; a serving process syncs via the mutation log)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the --device-index index: cuda (default; raises "
        "without a card) or cpu",
    )
    args = parser.parse_args()
    configure_logging(settings.log_level)
    if args.device_index:
        get_index(args.device)
    else:
        from ..ingest.ingest import set_store_only

        set_store_only(True)
    tables = [args.table] if args.table else list(TABLES)
    total = 0
    for table in tables:
        changed = backfill_table(table, args.batch_size, args.dry_run)
        logger.info(
            "tech_backfill.table table=%s changed=%s dry_run=%s",
            table, changed, args.dry_run,
        )
        total += changed
    logger.info("tech_backfill.done total_changed=%s", total)


if __name__ == "__main__":
    main()
