"""Serving (port of ``znicz_tpu/services``): the continuous-batching decode
engines over dense and paged KV (:mod:`engine`), the typed serving errors
(:mod:`errors`), the front door around an engine (:mod:`frontdoor`:
streaming handles, deadlines, cancellation, load shedding, the watchdog
restart, graceful shutdown) and the HTTP server (:mod:`serve`:
``POST /generate``, ``/healthz``, ``/metrics``, ``/slo``, ``/debug/*``,
``/prefix_probe``).

Not ported yet: the plotting, image saver, publishing and web status
services (``StatusWriter``, ``ImageSaver``, ``MarkdownReporter``, the
plotters: ROADMAP.md A11).
"""

from znicz_tpu_torch.services.engine import (  # noqa: F401
    Completion,
    DecodeEngine,
    PagedDecodeEngine,
)
from znicz_tpu_torch.services.errors import (  # noqa: F401
    EngineClosedError,
    RejectedError,
    RequestTooLargeError,
    SpeculationUnsupportedError,
    retryable,
)
from znicz_tpu_torch.services.frontdoor import (  # noqa: F401
    RequestHandle,
    ServingFrontDoor,
)
