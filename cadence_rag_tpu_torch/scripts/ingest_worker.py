"""Queue worker daemon.

Usage: python -m cadence_rag_tpu_torch.scripts.ingest_worker [--once]

Claims jobs from the SQLite queue and processes them (reference:
app/scripts/ingest_worker.py runs an RQ worker; our queue is in-store).
Counterpart of ``cadence_rag_tpu/scripts/ingest_worker.py``. Store-only by
default: the serving process's syncer (ingest/sync.py) brings the rows onto
its device. ``--device-index`` builds an index in this process on
``--device`` (cuda unless the caller asks for cpu; no card, no index: it
raises).
"""

from __future__ import annotations

import argparse
import time
import uuid

from ..config import settings
from ..ingest.fs_queue import work_once
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="ingest queue worker")
    parser.add_argument("--once", action="store_true", help="drain one job")
    parser.add_argument("--idle-sleep", type=float, default=1.0)
    parser.add_argument(
        "--device-index", action="store_true",
        help="also build a process-local device index (single-process "
        "setups only; by default the worker writes the store and a "
        "serving process syncs the device index via the mutation log)",
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
        # A standalone worker's device index dies with the process and a
        # serving API never sees it (the round-2 coherence gap): write
        # the store + mutation log only; the server's StoreSyncer
        # (ingest/sync.py) applies the device work.
        from ..ingest.ingest import set_store_only

        set_store_only(True)
    worker_id = f"worker-{uuid.uuid4().hex[:8]}"
    # featurize new documents under the store's active lexical vocab (the
    # serving process and stored lex_sig blobs already follow it)
    from ..core.vocab import activate_from_store, refresh_if_changed
    from ..store.db import get_store

    activate_from_store(get_store())

    if args.once:
        status = work_once(worker_id)
        logger.info("worker.once status=%s", status)
        return
    logger.info("worker.start id=%s", worker_id)
    while True:
        try:
            # a long-lived worker must track offline build_lex_vocab runs:
            # new docs featurized under a stale head layout would never be
            # re-featurized (the apply pass has already moved past them)
            switched = refresh_if_changed(get_store())
            if switched is not None:
                logger.info("worker.lex_vocab_switched version=%s", switched)
            status = work_once(worker_id)
        except Exception:
            logger.exception("worker.job_failed")
            status = "error"
        if status is None:
            time.sleep(args.idle_sleep)


if __name__ == "__main__":
    main()
