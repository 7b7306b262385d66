"""Small locking primitives.

RWLock: many concurrent readers, one exclusive writer, writer-preferring
(a waiting writer blocks NEW readers so a steady reader stream cannot
starve it). Used as the vocab-layout gate (ingest/featurize.vocab_gate):
ingest paths hold the read side across featurize -> store write -> device
insert so an online vocab rebuild (core/vocab.build_and_apply, write
side) can never interleave with a half-landed document — the interleaving
would strand an old-layout signature on device after the re-featurize
pass already scanned that row.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
