"""Class-scoped logging mixin (port of ``znicz_tpu/core/logger.py``).

Per-class loggers under a colored stderr formatter, with the JAX package's
record format (``%(asctime)s %(levelname).1s %(name)s: %(message)s``) and
its idempotent ``setup_logging``.
"""

from __future__ import annotations

import logging
import sys
from typing import Any

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"
_configured = False


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def setup_logging(level: int = logging.INFO, *, force: bool = False) -> None:
    """Install the colored stderr handler on the root logger.

    Idempotent: when logging is already configured — by a prior call OR
    by any other library/test harness that attached root handlers —
    the existing handlers are left untouched (clobbering them silently
    un-configures everyone else).  The requested LEVEL is still
    applied (a multihost worker asking for INFO must not lose its logs
    to a default-WARNING root someone else left behind).  ``force=True``
    is the explicit escape hatch that replaces the handlers too.
    """
    global _configured
    root = logging.getLogger()
    if not force and (_configured or root.handlers):
        _configured = True  # someone configured logging; respect it
        if level < root.getEffectiveLevel():
            # only ever RAISE verbosity: a default-WARNING root must not
            # eat INFO logs, but a deliberately-DEBUG root (pytest
            # --log-cli-level, basicConfig) must not be quieted either
            root.setLevel(level)
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _ColorFormatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
    )
    root.handlers[:] = [handler]
    root.setLevel(level)
    _configured = True


class Logger:
    """Mixin giving every unit/workflow a class-scoped logger."""

    @property
    def logger(self) -> logging.Logger:
        if not _configured:
            setup_logging()
        return logging.getLogger(type(self).__name__)

    def debug(self, msg: str, *args: Any) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self.logger.error(msg, *args)
