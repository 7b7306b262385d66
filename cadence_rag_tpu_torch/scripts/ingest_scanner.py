"""Drop-folder scanner daemon.

Usage: python -m cadence_rag_tpu_torch.scripts.ingest_scanner [--once]

Polls INGEST_ROOT_DIR/inbox every INGEST_POLL_SECONDS, enqueueing valid
bundles (reference: app/scripts/ingest_scanner.py:11-49). The loop survives
exceptions. Counterpart of ``cadence_rag_tpu/scripts/ingest_scanner.py``;
host code only, it touches no device.
"""

from __future__ import annotations

import argparse
import time

from ..config import settings
from ..ingest.fs_queue import scan_inbox_once
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="ingest drop-folder scanner")
    parser.add_argument("--once", action="store_true", help="single pass")
    parser.add_argument("--poll-seconds", type=int, default=None)
    args = parser.parse_args()
    configure_logging(settings.log_level)
    poll = args.poll_seconds or int(settings.ingest_poll_seconds)

    if args.once:
        stats = scan_inbox_once()
        logger.info("scanner.once %s", stats)
        return
    logger.info("scanner.start root=%s poll=%ss", settings.ingest_root_dir, poll)
    while True:
        try:
            scan_inbox_once()
        except Exception:
            logger.exception("scanner.pass_failed")
        time.sleep(poll)


if __name__ == "__main__":
    main()
