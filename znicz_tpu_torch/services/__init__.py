"""Serving (port of ``znicz_tpu/services``): the continuous-batching decode
engines over dense and paged KV (:mod:`engine`) and the typed serving
errors (:mod:`errors`).

Not ported yet: the front door, the HTTP server and the fleet telemetry
around the engine (``frontdoor.py``, ``serve.py``: ROADMAP.md A9), and the
plotting, image saver, publishing and web status services (ROADMAP.md
A11).
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
