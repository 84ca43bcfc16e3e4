"""Typed serving errors — the submit-side half of the failure taxonomy (port
of ``znicz_tpu/services/errors.py``, stdlib only, the same names).

Submit-time failures are EXCEPTIONS (the request never entered the
system); failures after acceptance are typed COMPLETIONS
(``Completion.finish_reason`` — see docs/SERVING.md "Failure
taxonomy").  A caller therefore handles exactly two shapes: an
exception at the door, or a completion with a reason.

:class:`RequestTooLargeError` subclasses ``ValueError`` so existing
callers that caught the engine's old bare ``ValueError`` keep working;
the message content (which names the backend's actual capacity) is
unchanged.
"""

from __future__ import annotations

import math
from typing import Optional


class RequestTooLargeError(ValueError):
    """The request can never fit this backend's KV capacity — no
    amount of queueing or retrying will help; shrink it or route it to
    a bigger pool."""


class SpeculationUnsupportedError(ValueError):
    """Speculative decoding was configured on a backend that cannot
    roll rejected tokens back — a CONFIG error, raised at engine
    construction, never per request.  Subclasses ``ValueError`` (the
    same contract as :class:`RequestTooLargeError`): callers that
    validate engine config with a bare ``except ValueError`` keep
    working, typed callers can route it specifically."""


class EngineClosedError(RuntimeError):
    """Submitted to a closed (or closing) front door / engine — the
    graceful-shutdown path; retry against a live replica."""


class RejectedError(RuntimeError):
    """Load shed at admission: the pending queue or the KV pool crossed
    its watermark.  TRANSIENT — retry after ``retry_after_s``; the HTTP
    surface maps this to ``503`` + ``Retry-After``."""

    def __init__(
        self,
        message: str,
        *,
        reason: str = "queue_full",
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def retryable(exc: BaseException) -> Optional[float]:
    """Seconds to wait before retrying ``exc``, or None when the error
    is permanent (too large, malformed)."""
    if isinstance(exc, RejectedError):
        return exc.retry_after_s
    if isinstance(exc, EngineClosedError):
        return 1.0
    return None


def retry_after_header(exc: BaseException) -> str:
    """``Retry-After`` header value for a retryable error: whole
    seconds, rounded up, floored at 1.  ONE owner of the clamping
    rule, shared by the replica HTTP surface and the cluster router's
    — the two must never advertise different backoff for the same
    rejection."""
    return str(max(int(math.ceil(retryable(exc) or 1.0)), 1))
