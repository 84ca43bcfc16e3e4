"""Services (port of ``znicz_tpu/services``): the per-epoch services
(plotters and the metrics CSV, the status page, the image saver, the run
report), the continuous-batching decode engines over dense and paged KV
(:mod:`engine`), the typed serving errors (:mod:`errors`), the front door
around an engine (:mod:`frontdoor`: streaming handles, deadlines,
cancellation, load shedding, the watchdog restart, graceful shutdown) and
the HTTP server (:mod:`serve`: ``POST /generate``, ``/healthz``,
``/metrics``, ``/slo``, ``/debug/*``, ``/prefix_probe``).
"""

from znicz_tpu_torch.services.plotting import (  # noqa: F401
    AccumulatingPlotter,
    MetricsCSVWriter,
    Weights2D,
)
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
from znicz_tpu_torch.services.image_saver import ImageSaver  # noqa: F401
from znicz_tpu_torch.services.publishing import MarkdownReporter  # noqa: F401
from znicz_tpu_torch.services.web_status import StatusWriter  # noqa: F401
