"""The JAX package's ``ServingRouter`` fronting two port replicas, on the CPU.

Each replica is the port's front door over the port's paged engine behind
the port's HTTP server (``services/serve.py``), in this process; the router,
its registry and the fleet aggregator are the JAX package's
(``znicz_tpu/cluster/``, ``observability/aggregate.py``).  This pins the
HTTP contract that a router relies on (``POST /generate``'s NDJSON and done
record, ``X-Znicz-Trace-Id``, ``/healthz`` with its load body, the pushed
``znicz_serve_frontdoor_*`` series): the goldens through the router equal
the port's ``generate``; a replica's engine crash mid-stream (the port's
``engine.decode_step`` fault point) is re-routed with the delivered prefix
skipped and a golden stream; a refused connection fails over.  The port's
modules import no jax; only this test holds both.
"""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from znicz_tpu.cluster import ServingRouter, build_router_server
from znicz_tpu.core import prng as jprng
from znicz_tpu.observability.aggregate import (
    MetricsAggregator,
    build_aggregator_server,
    series_value,
)
from znicz_tpu.services.engine import prefix_block_keys as jax_block_keys
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch.services import PagedDecodeEngine, ServingFrontDoor
from znicz_tpu_torch.services import serve as tserve
from znicz_tpu_torch.services.engine import prefix_block_keys
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 14
HEADS = 4
BS = 8
KW = dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=64, admit_every=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def params():
    jprng.seed_all(27)
    return model_lib.params_from_jax(jax.device_get(jinit(17, 32, 2, HEADS, max_seq=64)), "cpu")


def _reference(params, prompt, budget):
    out = G.generate(params, torch.as_tensor(prompt)[None], n_heads=HEADS,
                     max_new_tokens=budget, eos_id=EOS)[0].tolist()
    new = out[len(prompt):]
    return new[: new.index(EOS) + 1] if EOS in new else new


class _Fleet:
    """Two port replicas (front door + HTTP server), pushing to a JAX
    aggregator, behind one JAX router server."""

    def __init__(self, params):
        self.agg = MetricsAggregator()
        self.agg_srv = build_aggregator_server(self.agg, port=0)
        threading.Thread(target=self.agg_srv.serve_forever, daemon=True).start()
        agg_url = f"http://127.0.0.1:{self.agg_srv.server_address[1]}"
        self.doors, self.srvs = [], []
        for i in range(2):
            door = ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW), max_pending=8,
                                    aggregator_url=agg_url, instance=f"rep-{i}",
                                    push_interval_s=60.0)
            srv = tserve.build_server(directory=".", port=0, frontdoor=door)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.doors.append(door)
            self.srvs.append(srv)
        self.router = ServingRouter(block_size=BS, heartbeat_interval_s=60.0,
                                    aggregator=self.agg)
        for i, srv in enumerate(self.srvs):
            self.router.register(f"rep-{i}", f"http://127.0.0.1:{srv.server_address[1]}")
        self.rsrv = build_router_server(self.router, port=0)
        threading.Thread(target=self.rsrv.serve_forever, daemon=True).start()
        self.port = self.rsrv.server_address[1]

    def post(self, prompt, max_new=12):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request("POST", "/generate", body=json.dumps(
                {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new}))
            resp = conn.getresponse()
            if resp.status != 200:
                return {"status": resp.status, "body": json.loads(resp.read() or b"{}")}
            out = {"status": 200, "tokens": [], "done": None,
                   "replica": resp.getheader("X-Znicz-Replica"),
                   "trace": resp.getheader("X-Znicz-Trace-Id")}
            for line in resp.read().decode().splitlines():
                rec = json.loads(line)
                if "token" in rec:
                    out["tokens"].append(rec["token"])
                elif rec.get("done"):
                    out["done"] = rec
            return out
        finally:
            conn.close()

    def swept(self):
        # a door whose watchdog is still rebuilding its engine has none yet
        return all(d.engine is not None
                   and d.engine.stats()["pool_blocks_free"] == d.engine.stats()["pool_blocks"]
                   for d in self.doors)

    def close(self):
        for srv in self.srvs + [self.rsrv, self.agg_srv]:
            srv.shutdown()
            srv.server_close()
        for door in self.doors:
            door.close(grace_s=10.0)
        self.router.close()


@pytest.fixture
def fleet(params):
    f = _Fleet(params)
    yield f
    f.close()


def _wait_until(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def test_router_block_keys_are_the_port_engines():
    gen = np.random.default_rng(5)
    for n in (3, 8, 21, 40):
        p = gen.integers(0, 17, (n,)).astype(np.int32)
        assert prefix_block_keys(p, BS) == jax_block_keys(p, BS)


def test_goldens_through_the_router(fleet, params):
    gen = np.random.default_rng(11)
    shared = gen.integers(0, 17, (2 * BS,)).astype(np.int32)
    prompts = [gen.integers(0, 17, (k,)).astype(np.int32) for k in (5, 9, 13)]
    prompts += [np.concatenate([shared, gen.integers(0, 17, (3,)).astype(np.int32)])
                for _ in range(2)]
    seen = []
    for p in prompts:
        r = fleet.post(p)
        assert r["status"] == 200
        assert r["tokens"] == _reference(params, p, 12)
        assert r["done"]["finish_reason"] in ("eos", "budget")
        assert r["done"]["router"]["retries"] == 0
        assert r["trace"] == r["done"]["trace_id"]
        seen.append(r["replica"])
    assert set(seen) <= {"rep-0", "rep-1"}
    # the shared-prefix pair co-located on one replica (learned router-side)
    assert seen[-1] == seen[-2]
    _wait_until(fleet.swept, what="pools swept")


def test_midstream_crash_is_rerouted_golden(fleet, params):
    gen = np.random.default_rng(37)
    prompt = gen.integers(0, 17, (2 * BS + 3,)).astype(np.int32)
    ref = _reference(params, prompt, 12)
    assert len(ref) > 5, "need a stream long enough to crash inside"
    # the first decode chunk streams, the second crashes its replica's
    # engine: a typed error done record, which the router re-routes
    faults.inject("engine.decode_step", exc=RuntimeError("replica engine died"), after=1,
                  times=1)
    r = fleet.post(prompt)
    assert r["status"] == 200
    assert r["tokens"] == ref
    assert r["done"]["finish_reason"] in ("eos", "budget")
    assert r["done"]["router"]["retries"] == 1
    restarts = [d.stats()["watchdog_restarts"] for d in fleet.doors]
    assert sorted(restarts) == [0, 1]
    _wait_until(lambda: not any(d.has_work() for d in fleet.doors), what="fleet idle")
    _wait_until(fleet.swept, what="pools swept")


def test_connect_refused_fails_over(fleet, params):
    prompt = np.random.default_rng(31).integers(0, 17, (9,)).astype(np.int32)
    jfaults.inject("router.connect", times=1)
    r = fleet.post(prompt)
    assert r["status"] == 200
    assert r["tokens"] == _reference(params, prompt, 12)
    assert r["done"]["router"]["retries"] == 1


def test_a_dead_replica_fails_over_for_real(fleet, params):
    dead = fleet.srvs[0]
    dead.shutdown()
    dead.server_close()
    prompt = np.random.default_rng(41).integers(0, 17, (7,)).astype(np.int32)
    for _ in range(3):
        r = fleet.post(prompt)
        assert r["status"] == 200 and r["replica"] == "rep-1"
        assert r["tokens"] == _reference(params, prompt, 12)


def test_healthz_load_body_and_pushed_series_feed_the_router(fleet):
    fleet.router.registry.probe_all()
    for i in range(2):
        rep = fleet.router.registry.get(f"rep-{i}")
        assert rep.health["state"] == "running"
        assert rep.health["pool_free_frac"] == 1.0
    for door in fleet.doors:
        assert door._pusher.push_now() is True
    for i in range(2):
        fams = fleet.agg.instance_families(f"rep-{i}")
        for name in ("znicz_serve_frontdoor_pending", "znicz_serve_frontdoor_inflight",
                     "znicz_serve_slo_burn_rate"):
            assert series_value(fams, name) == 0.0
    assert {rep.instance for rep, _ in fleet.router.rank([])} == {"rep-0", "rep-1"}
