"""Multi-replica serving control plane (port of ``znicz_tpu/cluster``: the
same names, policies, HTTP contract, metric families and fault points;
docs/SERVING.md "The router").

The scale-out rung above the single-replica front door: a serving
router fronting N :class:`~znicz_tpu_torch.services.frontdoor
.ServingFrontDoor` replicas — the paper's master–slave coordinator
lineage (SURVEY §3.4 ``apply_data_from_slave``) revived as a serving
concern, with SGLang-style cache-aware placement over the paged
engine's prefix-cache chained block keys:

* :mod:`registry` — replica roster with heartbeat liveness
  (``/healthz``-probed: healthy / degraded / dead, ejection after
  consecutive failures, re-admission on the first answered probe).
* :mod:`affinity` — the router-side prefix-affinity index: learned
  from routed requests, TTL/LRU-decayed in sync with replica caches
  (tracks, never trusts).
* :mod:`router` — placement (longest-cached-prefix first, load
  tiebreak, least-loaded fallback) + the retrying proxy stream
  (bounded failover with the delivered prefix skipped on resume).
* :mod:`proxy` — the HTTP face: the single-replica ``POST /generate``
  contract, unchanged, over the whole fleet.
"""

from znicz_tpu_torch.cluster.affinity import PrefixAffinityIndex  # noqa: F401
from znicz_tpu_torch.cluster.proxy import (  # noqa: F401
    RouterRequestHandler,
    build_router_server,
    run_router_server,
)
from znicz_tpu_torch.cluster.registry import (  # noqa: F401
    STATE_DEAD,
    STATE_DEGRADED,
    STATE_HEALTHY,
    Replica,
    ReplicaRegistry,
)
from znicz_tpu_torch.cluster.router import (  # noqa: F401
    POLICY_LEAST_LOADED,
    POLICY_PREFIX_AFFINITY,
    POLICY_ROUND_ROBIN,
    RoutedStream,
    ServingRouter,
)
