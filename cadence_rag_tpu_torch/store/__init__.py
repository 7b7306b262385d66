"""Host-side durable state.

Postgres's roles in the reference split in two here (SURVEY.md §7): the
TPU-resident index arrays carry all search state, and this package carries
the durable metadata — calls, utterances, chunks, artifacts, ingest jobs,
ingestion runs — on SQLite (WAL), plus an in-process durable job queue that
replaces Redis/RQ.
"""

from .db import Store, get_store, reset_store  # noqa: F401
