"""The deployment's identifiers: the exact tokens its tech lane matches.

Tickets (``OPS-1234``), versions (``v3.12.5``) and errno-style codes
(``ECONNLAG17``), ``config["tech_identifiers"]`` of them, the same for every
seed. Rows of the corpus hold some of them in their tech slots; queries
carry some of them, so the tech lane finds rows.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import numpy as np

from ..reference.features import tech_hash

_TICKETS = ("OPS", "INC", "SRE", "NET", "DBA")
_CODES = ("CONNRESET", "TIMEDOUT", "HOSTDOWN", "NOSPC", "PIPE", "CONNLAG")


@functools.lru_cache(maxsize=8)
def _identifiers(n: int) -> tuple:
    out = []
    for i in range(n):
        form = i % 3
        if form == 0:
            out.append(f"{_TICKETS[i % 5]}-{1000 + i // 3}")
        elif form == 1:
            out.append(f"v{1 + i % 9}.{(i // 9) % 64}.{i // 576}")
        else:
            out.append(f"E{_CODES[i % 6]}{i // 3}")
    return tuple(out)


def identifiers(config: Dict[str, Any]) -> List[str]:
    return list(_identifiers(int(config["tech_identifiers"])))


@functools.lru_cache(maxsize=8)
def _hashes(n: int) -> np.ndarray:
    return np.array([tech_hash(t) for t in _identifiers(n)], dtype=np.int64)


def hashes(config: Dict[str, Any]) -> np.ndarray:
    """Each identifier's tech hash (int64), in ``identifiers`` order."""
    return _hashes(int(config["tech_identifiers"]))
