"""Request-scoped logging.

Parity with the reference's request-ID contextvar pattern
(reference: app/logging_utils.py:13-50): every log line carries the current
``X-Request-ID`` injected by a logging filter; the HTTP layer sets/resets it
per request. Policy carried over: never log transcript/artifact text.
"""

from __future__ import annotations

import logging
from contextvars import ContextVar, Token

_request_id_var: ContextVar[str] = ContextVar("request_id", default="-")


class RequestIdFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = _request_id_var.get()
        return True


def configure_logging(level: str = "INFO") -> None:
    root = logging.getLogger()
    root.setLevel(level.upper())
    if any(isinstance(h, logging.StreamHandler) and getattr(h, "_cadence", False)
           for h in root.handlers):
        return
    handler = logging.StreamHandler()
    handler._cadence = True  # type: ignore[attr-defined]
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s [req=%(request_id)s] %(message)s"
        )
    )
    handler.addFilter(RequestIdFilter())
    root.addHandler(handler)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def set_request_id(request_id: str) -> Token:
    return _request_id_var.set(request_id)


def reset_request_id(token: Token) -> None:
    _request_id_var.reset(token)


def get_request_id() -> str:
    return _request_id_var.get()
