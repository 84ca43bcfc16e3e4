"""The port's serving cluster (``znicz_tpu_torch/cluster/``) against the JAX
package's, on the CPU.

Both routers front the same port replicas: the port's front door over the
port's paged engine behind the port's HTTP server, in this process, at the
JAX cluster tests' size (vocab 17, d_model 32, 2 layers, 4 heads, max_seq
64, block 8, 2 slots, EOS 14, ``prng.seed_all(27)``; the JAX LM's params
carried across with ``params_from_jax``).  Held equal, exactly: the
affinity index under one learn/prune/drop sequence on an injected clock;
the registry's states under the same probe outcomes (``router.heartbeat``
armed in both packages, a real replica server that dies and comes back);
``rank`` under each policy over one roster, load bodies, aggregator gauges
and burn rates; the replica each request of an interleaved family stream
lands on, its token records and its done record (trace ids and timings
aside); and how each failover scenario of ``tests/test_cluster.py`` ends
(status, tokens, the done record's router view, the router's metric
deltas).  The port's router over the port's replicas gives the tokens of
the port's ``generate`` and of JAX's.  Every wait has its own timeout.
"""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import cluster as jcluster
from znicz_tpu import observability as jobs
from znicz_tpu.cluster import router as jrouter
from znicz_tpu.core import prng as jprng
from znicz_tpu.observability.aggregate import MetricsAggregator as JAggregator
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow import generate as JG
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch import cluster as tcluster
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.cluster import router as trouter
from znicz_tpu_torch.observability.aggregate import MetricsAggregator as TAggregator
from znicz_tpu_torch.observability.aggregate import build_aggregator_server
from znicz_tpu_torch.observability.collector import build_collector_server
from znicz_tpu_torch.services import PagedDecodeEngine, RejectedError, ServingFrontDoor
from znicz_tpu_torch.services import serve as tserve
from znicz_tpu_torch.services.engine import prefix_block_keys
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 14
HEADS = 4
T_MAX = 64
BS = 8
KW = dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=T_MAX, admit_every=4)
JAX = types.SimpleNamespace(name="jax", cluster=jcluster, router=jrouter, faults=jfaults,
                            obs=jobs, Aggregator=JAggregator)
PORT = types.SimpleNamespace(name="port", cluster=tcluster, router=trouter, faults=faults,
                             obs=tobs, Aggregator=TAggregator)
BOTH = (JAX, PORT)
# done-record fields that differ from run to run: the router's trace id
# carries a random suffix; latencies and the lifecycle timings are clocks
VOLATILE = ("trace_id", "latency_ms", "ttft_ms", "timings")
TRACE_ID = re.compile(r"^znicz-router-[0-9a-f]{6}-\d{6}$")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def jparams():
    jprng.seed_all(27)
    return jax.device_get(jinit(17, 32, 2, HEADS, max_seq=T_MAX))


@pytest.fixture(scope="module")
def params(jparams):
    return model_lib.params_from_jax(jparams, "cpu")


@pytest.fixture(scope="module")
def warm(params):
    """Every program the scenarios run, made once (a long request walks the
    window ladder, a short one admits at the first rung)."""
    eng = PagedDecodeEngine(params, **KW)
    gen = np.random.default_rng(3)
    eng.submit(gen.integers(0, 17, (21,)).astype(np.int32), 30)
    eng.submit(gen.integers(0, 17, (5,)).astype(np.int32), 8)
    eng.run()
    return set(eng.compile_stats()["programs"])


_GOLDEN = {}


@pytest.fixture(scope="module")
def golden(params, jparams):
    """``golden(prompt, budget)``: the port's ``generate`` tokens up to EOS,
    held equal to JAX's ``generate`` on the same weights."""

    def ref(prompt, budget=12):
        key = (tuple(int(t) for t in prompt), budget)
        if key not in _GOLDEN:
            ours = G.generate(params, torch.as_tensor(np.asarray(prompt))[None], n_heads=HEADS,
                              max_new_tokens=budget, eos_id=EOS)[0].tolist()[len(prompt):]
            theirs = np.asarray(JG.generate(jparams, jnp.asarray(prompt)[None], n_heads=HEADS,
                                            max_new_tokens=budget, eos_id=EOS))[0]
            theirs = [int(t) for t in theirs[len(prompt):]]
            assert ours == theirs
            _GOLDEN[key] = ours[: ours.index(EOS) + 1] if EOS in ours else ours
        return _GOLDEN[key]

    return ref


def _wait_until(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _post(port, prompt, max_new=12, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new}))
        resp = conn.getresponse()
        if resp.status != 200:
            return {"status": resp.status, "body": json.loads(resp.read() or b"{}"),
                    "retry_after": resp.getheader("Retry-After")}
        out = {"status": 200, "tokens": [], "records": [], "done": None,
               "replica_header": resp.getheader("X-Znicz-Replica"),
               "trace_header": resp.getheader("X-Znicz-Trace-Id")}
        while True:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            out["records"].append(rec)
            if "token" in rec:
                out["tokens"].append(rec["token"])
            elif rec.get("done"):
                out["done"] = rec
        return out
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class _Replicas:
    """N port replicas (front door + HTTP server) in this process."""

    def __init__(self, params, n=2):
        self.doors, self.srvs = [], []
        for _ in range(n):
            door = ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW), max_pending=8)
            self.doors.append(door)
            self.srvs.append(self._serve(door))

    @staticmethod
    def _serve(door, port=0):
        srv = tserve.build_server(directory=".", port=port, frontdoor=door)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    def url(self, i):
        return f"http://127.0.0.1:{self.srvs[i].server_address[1]}"

    def kill(self, i):
        self.srvs[i].shutdown()
        self.srvs[i].server_close()

    def revive(self, i):
        """A new server for replica ``i``'s door on the same port."""
        self.srvs[i] = self._serve(self.doors[i], self.srvs[i].server_address[1])

    def idle(self):
        """No door has work, and none is between a crashed engine and its
        rebuilt one."""
        return all(d.engine is not None and not d.has_work() for d in self.doors)

    def swept(self):
        engines = [d.engine for d in self.doors]
        return all(e is not None and e.stats()["pool_blocks_free"] == e.stats()["pool_blocks"]
                   for e in engines)

    def close(self):
        for srv in self.srvs:
            srv.shutdown()
            srv.server_close()
        for door in self.doors:
            door.close(grace_s=10.0)


class _Front:
    """One package's router, registered over ``replicas``, behind its own
    router server."""

    def __init__(self, ns, replicas, **router_kw):
        kw = {"block_size": BS, "heartbeat_interval_s": 60.0}
        kw.update(router_kw)
        self.ns = ns
        self.router = ns.cluster.ServingRouter(**kw)
        for i in range(len(replicas.srvs)):
            self.router.register(f"rep-{i}", replicas.url(i))
        self.rsrv = ns.cluster.build_router_server(self.router, port=0)
        threading.Thread(target=self.rsrv.serve_forever, daemon=True).start()
        self.port = self.rsrv.server_address[1]

    def post(self, prompt, max_new=12):
        return _post(self.port, prompt, max_new)

    def close(self):
        self.rsrv.shutdown()
        self.rsrv.server_close()
        self.router.close()


def _stable(snapshot):
    """A registry roster without its clocks (probe age, tick ages)."""
    return [{**{k: v for k, v in r.items() if k != "last_probe_age_s"},
             "health": {k: v for k, v in r["health"].items()
                        if k not in ("last_tick_age_s", "tick_in_flight_s")}}
            for r in snapshot]


def _counter(ns, name, **labels):
    metric = ns.obs.counter(name, "", tuple(labels))
    return (metric.labels(**labels) if labels else metric).value


def _latency_count(ns):
    snap = ns.obs.get_registry().snapshot().get("znicz_router_request_seconds")
    return sum(s["count"] for s in snap["series"]) if snap else 0


def _view(r):
    """What a client and the router's ledger see of one request."""
    if r["status"] != 200:
        return {"status": r["status"], "reason": r["body"].get("reason"),
                "error": r["body"].get("error"), "retry_after": r["retry_after"]}
    done = r["done"]
    return {"status": 200, "tokens": r["tokens"], "replica_header": r["replica_header"],
            "done_keys": sorted(done), "trace_is_router_minted": (
                r["trace_header"] == done["trace_id"]
                and bool(TRACE_ID.match(done["trace_id"]))),
            "done": {k: v for k, v in done.items() if k not in VOLATILE and k != "error"},
            "error_prefix": (done.get("error") or "")[:30]}


# -- the affinity index --------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _affinity_run(ns, ttl_s, cap):
    clock = _Clock()
    idx = ns.cluster.PrefixAffinityIndex(ttl_s=ttl_s, max_keys_per_replica=cap)
    idx._now = clock
    gauge = ns.obs.gauge("znicz_router_affinity_keys", "")
    keys = [f"k{i}" for i in range(8)]
    out = []

    def look(tag):
        out.append((tag, [idx.overlap(i, keys) for i in ("a", "b", "c")],
                    idx.overlap("a", ["k0", "kX", "k2"]), idx.rank(keys[:5], ["c", "a", "b"]),
                    idx.rank(["k1"], ["a"]), idx.stats(), gauge.value))

    idx.learn("a", keys[:3])
    look("learn a")
    clock.t += 2.0
    idx.learn("b", keys[:5])
    idx.learn("a", [])
    look("learn b")
    clock.t += 2.0
    idx.learn("a", keys[:2] + ["x1", "x2", "x3"])
    look("re-touch a")
    clock.t += 3.5
    look("a's first keys past a ttl of 5")
    out.append(("prune", idx.prune()))
    look("pruned")
    clock.t += 1.0
    idx.learn("c", keys)
    look("learn c")
    out.append(("drop b", idx.drop("b"), idx.drop("b"), idx.drop("nobody")))
    look("dropped")
    clock.t += 100.0
    out.append(("prune all", idx.prune()))
    look("all expired")
    return out


@pytest.mark.parametrize("ttl_s,cap", [(5.0, 4096), (5.0, 4), (600.0, 3), (600.0, 1)])
def test_affinity_index_equals_jax_on_an_injected_clock(ttl_s, cap):
    assert _affinity_run(PORT, ttl_s, cap) == _affinity_run(JAX, ttl_s, cap)


@pytest.mark.parametrize("kw", [{"ttl_s": 0}, {"ttl_s": -1.0}, {"max_keys_per_replica": 0}])
def test_affinity_index_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as port_err:
        PORT.cluster.PrefixAffinityIndex(**kw)
    with pytest.raises(ValueError) as jax_err:
        JAX.cluster.PrefixAffinityIndex(**kw)
    assert str(port_err.value) == str(jax_err.value)


# -- the registry ------------------------------------------------------------


def _rep_view(rep):
    return (rep.state, rep.failures, rep.traffic_failures, rep.degraded_by_transport, rep.probes,
            rep.ejections, rep.readmissions, rep.health.get("state"),
            rep.health.get("pool_free_frac"))


def test_registry_states_equal_jax_under_the_same_probes(params):
    reps = _Replicas(params, n=1)
    regs, hooks, seqs = {}, {}, {}
    for ns in BOTH:
        hooks[ns.name] = []
        regs[ns.name] = ns.cluster.ReplicaRegistry(
            start=False, dead_after=3,
            on_eject=lambda r, k=ns.name: hooks[k].append(("eject", r.instance)),
            on_readmit=lambda r, k=ns.name: hooks[k].append(("readmit", r.instance, r.state)))
        seqs[ns.name] = []

    def step(tag, fn):
        for ns in BOTH:
            reg = regs[ns.name]
            got = fn(ns, reg)
            seqs[ns.name].append((tag, got, _rep_view(reg.get("rep-0")), list(hooks[ns.name])))

    def heartbeat_fault(n):
        def fn(ns, reg):
            ns.faults.inject("router.heartbeat", times=n)
            return [reg.probe("rep-0") for _ in range(n)]
        return fn

    try:
        step("register", lambda ns, reg: reg.register("rep-0", reps.url(0)).state)
        step("heartbeat timeouts x2", heartbeat_fault(2))
        step("answered", lambda ns, reg: reg.probe("rep-0"))
        step("note_failure", lambda ns, reg: reg.note_failure("rep-0"))
        step("note_success", lambda ns, reg: reg.note_success("rep-0"))
        step("self-reported stall", lambda ns, reg: reg._apply(
            reg.get("rep-0"), "degraded", {"state": "stalled"}))
        step("a blip on top", lambda ns, reg: reg.note_failure("rep-0"))
        step("note_success keeps it degraded", lambda ns, reg: reg.note_success("rep-0"))
        step("replica truth", lambda ns, reg: reg.probe("rep-0"))
        step("heartbeat timeouts x3: ejected", heartbeat_fault(3))
        step("readmitted", lambda ns, reg: reg.probe_all())
        step("traffic failures x3", lambda ns, reg: [reg.note_failure("rep-0") for _ in range(3)])
        step("quarantined though it answers", lambda ns, reg: reg.probe("rep-0"))
        step("served traffic lifts it", lambda ns, reg: (reg.note_success("rep-0"),
                                                         reg.probe("rep-0")))
        reps.kill(0)
        step("server gone", lambda ns, reg: [reg.probe("rep-0") for _ in range(3)])
        step("unknown replica", lambda ns, reg: (reg.probe("nobody"), reg.note_failure("nobody"),
                                                 reg.note_success("nobody"), reg.get("nobody")))
        reps.revive(0)
        step("reborn on the same port", lambda ns, reg: reg.probe("rep-0"))
        step("snapshot", lambda ns, reg: _stable(reg.snapshot()))
        step("routable", lambda ns, reg: [r.instance for r in reg.routable()])
        step("deregister", lambda ns, reg: (reg.deregister("rep-0"), reg.deregister("rep-0"),
                                            reg.register("rep-0", reps.url(0)).state))
    finally:
        for reg in regs.values():
            reg.close()
        reps.close()
    assert seqs["port"] == seqs["jax"]
    states = [s[2][0] for s in seqs["port"]]
    assert {"healthy", "degraded", "dead"} <= set(states)
    assert hooks["port"].count(("eject", "rep-0")) == 3


@pytest.mark.parametrize("url", ["ftp://127.0.0.1:1", "http://", "127.0.0.1:80"])
def test_registry_refuses_what_jax_refuses(url):
    msgs = []
    for ns in BOTH:
        reg = ns.cluster.ReplicaRegistry(start=False)
        with pytest.raises(ValueError) as err:
            reg.register("x", url)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    for ns in BOTH:
        for kw in ({"probe_interval_s": 0}, {"dead_after": 0}):
            with pytest.raises(ValueError):
                ns.cluster.ReplicaRegistry(start=False, **kw)


def test_a_garbage_http_replica_counts_as_a_heartbeat_failure():
    """A port taken by a non-HTTP process (BadStatusLine) counts toward
    ejection and does not abort the sweep, in both registries."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    port = sock.getsockname()[1]
    stop = threading.Event()

    def garbage_server():
        sock.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            conn.sendall(b"not http at all\r\n")
            conn.close()

    t = threading.Thread(target=garbage_server, daemon=True)
    t.start()
    try:
        got = {}
        for ns in BOTH:
            reg = ns.cluster.ReplicaRegistry(start=False, dead_after=2)
            rep = reg.register("junk", f"http://127.0.0.1:{port}")
            got[ns.name] = (rep.failures, reg.probe("junk"), reg.get("junk").ejections)
        assert got["port"] == got["jax"] == (1, "dead", 1)
    finally:
        stop.set()
        t.join(timeout=5.0)
        sock.close()
    assert not t.is_alive()


def test_the_heartbeat_thread_sweeps_prunes_and_stops(params):
    reps = _Replicas(params, n=1)
    sweeps = []
    try:
        with PORT.cluster.ReplicaRegistry(probe_interval_s=0.05,
                                          on_sweep=lambda: sweeps.append(1)) as reg:
            reg.register("rep-0", reps.url(0))
            _wait_until(lambda: len(sweeps) >= 3, timeout=10.0, what="three sweeps")
            thread = reg._thread
            assert reg.get("rep-0").probes >= 3 and reg.get("rep-0").state == "healthy"
            assert reg.start() is reg and reg._thread is thread  # idempotent
        assert not thread.is_alive()
        reg.close()  # idempotent
    finally:
        reps.close()
    # a router that owns its registry hangs the affinity prune on the sweep
    router = PORT.cluster.ServingRouter(heartbeat_interval_s=60.0)
    try:
        assert router.registry.on_sweep == router.affinity.prune
        assert router.registry.on_eject == router._on_eject
    finally:
        router.close()
    assert not router.registry._thread.is_alive()


# -- placement -----------------------------------------------------------------

ROSTER = (  # instance, state, /healthz load body
    ("c", "healthy", {"state": "running", "pending": 1, "inflight": 0, "pool_free_frac": 0.5}),
    ("a", "healthy", {"state": "running", "pending": 0, "inflight": 0, "pool_free_frac": 0.9}),
    ("e", "healthy", {"state": "running", "pending": 0, "inflight": 0, "pool_free_frac": 0.9}),
    ("b", "degraded", {"state": "stalled", "pending": 0, "inflight": 2}),
    ("f", "healthy", {}),
    ("d", "dead", {"state": "running"}),
)
# instance -> (pending, inflight, burn rate, kv blocks free, cached, used)
PUSHED = {"c": (0.0, 0.0, 0.2, 30.0, 2.0, 0.0), "a": (3.0, 1.0, 0.1, 10.0, 0.0, 22.0),
          "e": (0.0, 0.0, 2.5, 32.0, 0.0, 0.0), "b": (0.0, 0.0, None, 5.0, 5.0, 22.0)}


def _families(pending, inflight, burn, free, cached, used):
    def gauge(series):
        return {"type": "gauge", "help": "", "series": series}

    fams = {"znicz_serve_frontdoor_pending": gauge([{"labels": {}, "value": pending}]),
            "znicz_serve_frontdoor_inflight": gauge([{"labels": {}, "value": inflight}]),
            "znicz_serve_kv_pool_blocks": gauge(
                [{"labels": {"state": s}, "value": v}
                 for s, v in (("free", free), ("cached", cached), ("used", used))])}
    if burn is not None:
        fams["znicz_serve_slo_burn_rate"] = gauge([{"labels": {}, "value": burn}])
    return fams


def _ranks(ns, policy, aggregated, burn_threshold):
    agg = None
    if aggregated:
        agg = ns.Aggregator()
        for inst, vals in PUSHED.items():
            agg.push(inst, _families(*vals))
    reg = ns.cluster.ReplicaRegistry(start=False)
    router = ns.cluster.ServingRouter(reg, block_size=BS, policy=policy, aggregator=agg,
                                      slo_burn_threshold=burn_threshold)
    try:
        for i, (inst, state, health) in enumerate(ROSTER):
            rep = router.register(inst, f"http://127.0.0.1:{i + 1}", probe=False)
            rep.state, rep.health = state, dict(health)
        keys = prefix_block_keys(np.arange(1, 6 * BS + 1), BS)
        router.affinity.learn("c", keys[:3])
        router.affinity.learn("a", keys[:1])
        router.affinity.learn("b", keys[:6])
        router.affinity.learn("e", keys[:5])
        out = [{r.instance: router._load(r) for r in reg.replicas()}]
        for _ in range(4):
            for k, exclude in ((keys, None), (keys, {"c"}), (keys[1:], None), ([], None),
                               (keys[:2], {"a", "e", "f"})):
                out.append([(r.instance, ov) for r, ov in router.rank(k, exclude=exclude)])
        return out
    finally:
        router.close()


@pytest.mark.parametrize("burn_threshold", [1.0, 5.0])
@pytest.mark.parametrize("aggregated", [False, True], ids=["heartbeat", "aggregator"])
@pytest.mark.parametrize("policy", ["prefix_affinity", "round_robin", "least_loaded"])
def test_rank_equals_jax(policy, aggregated, burn_threshold):
    port = _ranks(PORT, policy, aggregated, burn_threshold)
    assert port == _ranks(JAX, policy, aggregated, burn_threshold)
    assert all("d" not in [i for i, _ in order] for order in port[1:])


def test_router_refuses_what_jax_refuses():
    for kw in ({"policy": "random"}, {"block_size": 0}):
        msgs = []
        for ns in BOTH:
            reg = ns.cluster.ReplicaRegistry(start=False)
            with pytest.raises(ValueError) as err:
                ns.cluster.ServingRouter(reg, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# -- both routers over the same replicas ---------------------------------------


def _family_stream(seed=5, families=2, per_family=3, tail=5):
    gen = np.random.default_rng(seed)
    shared = [gen.integers(0, 17, (2 * BS,)).astype(np.int32) for _ in range(families)]
    stream = []
    for i in range(per_family):
        for f in range(families):
            stream.append((f, np.concatenate([shared[f],
                                              gen.integers(0, 17, (tail,)).astype(np.int32)])))
    stream += [(None, gen.integers(0, 17, (n,)).astype(np.int32)) for n in (5, 3, 9)]
    return stream


def test_both_routers_place_and_stream_alike_over_the_same_replicas(params, golden):
    reps = _Replicas(params)
    fronts = {ns.name: _Front(ns, reps) for ns in BOTH}
    placed = {}
    hits0 = {ns.name: _counter(ns, "znicz_router_affinity_total", signal="hit") for ns in BOTH}
    try:
        for f, prompt in _family_stream():
            got = {}
            for ns in BOTH:
                r = fronts[ns.name].post(prompt)
                assert r["status"] == 200
                assert r["records"][-1] is r["done"]
                got[ns.name] = _view(r)
            assert got["port"] == got["jax"]
            assert got["port"]["tokens"] == golden(prompt)
            assert got["port"]["trace_is_router_minted"]
            assert got["port"]["done"]["router"]["retries"] == 0
            placed.setdefault(f, set()).add(got["port"]["done"]["router"]["replica"])
        _wait_until(reps.idle, what="fleet idle")
        _wait_until(reps.swept, what="pools swept")
        stats = {ns.name: fronts[ns.name].router.stats() for ns in BOTH}
        for st in stats.values():
            st["replicas"] = _stable(st["replicas"])
    finally:
        for front in fronts.values():
            front.close()
        reps.close()
    # each family on one replica, both families spread, learned router-side
    assert len(placed[0]) == len(placed[1]) == 1 and placed[0] != placed[1]
    hits = {ns.name: _counter(ns, "znicz_router_affinity_total", signal="hit") - hits0[ns.name]
            for ns in BOTH}
    assert hits["port"] == hits["jax"] >= 4
    assert stats["port"] == stats["jax"]


def test_least_loaded_spreads_distinct_prompts_like_jax(params, golden):
    reps = _Replicas(params)
    fronts = {ns.name: _Front(ns, reps, policy="least_loaded") for ns in BOTH}
    gen = np.random.default_rng(23)
    used = set()
    try:
        for _ in range(6):
            prompt = gen.integers(0, 17, (5,)).astype(np.int32)
            got = {ns.name: _view(fronts[ns.name].post(prompt, max_new=4)) for ns in BOTH}
            assert got["port"] == got["jax"]
            assert got["port"]["done"]["router"]["affinity_blocks"] == 0
            assert got["port"]["tokens"] == golden(prompt, 4)
            used.add(got["port"]["done"]["router"]["replica"])
    finally:
        for front in fronts.values():
            front.close()
        reps.close()
    assert used == {"rep-0", "rep-1"}


def test_round_robin_alternates_like_jax(params):
    reps = _Replicas(params)
    fronts = {ns.name: _Front(ns, reps, policy="round_robin") for ns in BOTH}
    shared = np.random.default_rng(43).integers(0, 17, (BS,)).astype(np.int32)
    seen = {ns.name: [] for ns in BOTH}
    try:
        for _ in range(4):
            for ns in BOTH:
                r = fronts[ns.name].post(shared, max_new=4)
                assert r["status"] == 200
                seen[ns.name].append(r["done"]["router"]["replica"])
    finally:
        for front in fronts.values():
            front.close()
        reps.close()
    assert seen["port"] == seen["jax"] == ["rep-0", "rep-1", "rep-0", "rep-1"]


# -- failover: each scenario of tests/test_cluster.py's TestFailover, run
# through each package's router over port replicas; the outcomes must match


def _scenario_connect_refused(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        prompt = np.random.default_rng(31).integers(0, 17, (9,)).astype(np.int32)
        c0 = _counter(ns, "znicz_router_retries_total", reason="connect")
        ns.faults.inject("router.connect", times=1)
        r = front.post(prompt)
        assert r["status"] == 200 and r["tokens"] == golden(prompt)
        assert r["done"]["router"]["retries"] == 1
        states = [rep.state for rep in front.router.registry.replicas()]
        return {"view": _view(r), "states": states,
                "connect_retries": _counter(ns, "znicz_router_retries_total",
                                            reason="connect") - c0}
    finally:
        front.close()
        reps.close()


def _scenario_midstream_death(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        prompt = np.random.default_rng(37).integers(0, 17, (2 * BS + 3,)).astype(np.int32)
        ref = golden(prompt)
        assert len(ref) >= 4, "need a stream long enough to die inside"
        m0 = _counter(ns, "znicz_router_retries_total", reason="mid_stream")
        ns.faults.inject("router.stream", after=2, times=1)  # 2 records pass, then it dies
        r = front.post(prompt)
        assert r["status"] == 200 and r["tokens"] == ref
        assert r["done"]["finish_reason"] in ("eos", "budget")
        # the abandoned replica's request was cancelled by the dropped
        # connection: both pools sweep back to fully free
        _wait_until(reps.idle, what="abandoned request reclaimed")
        _wait_until(reps.swept, what="pools swept")
        return {"view": _view(r), "failures": sorted(
            (rep.instance, rep.failures, rep.traffic_failures)
            for rep in front.router.registry.replicas()),
            "mid_stream_retries": _counter(ns, "znicz_router_retries_total",
                                           reason="mid_stream") - m0}
    finally:
        front.close()
        reps.close()


def _scenario_engine_crash_midstream(ns, params, golden):
    """A replica's own engine dies after its first decode chunk streamed:
    its typed ``error`` done record is re-routed, the delivered prefix
    skipped, and the client's stream is the golden one."""
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        prompt = np.random.default_rng(37).integers(0, 17, (2 * BS + 3,)).astype(np.int32)
        ref = golden(prompt)
        assert len(ref) > 5, "need a stream long enough to crash inside"
        e0 = _counter(ns, "znicz_router_retries_total", reason="upstream_error")
        faults.inject("engine.decode_step", exc=RuntimeError("replica engine died"), after=1,
                      times=1)
        r = front.post(prompt)
        assert r["status"] == 200 and r["tokens"] == ref
        _wait_until(reps.idle, what="fleet idle")
        _wait_until(reps.swept, what="pools swept")
        return {"view": _view(r),
                "restarts": sorted(d.stats()["watchdog_restarts"] for d in reps.doors),
                "upstream_error_retries": _counter(ns, "znicz_router_retries_total",
                                                   reason="upstream_error") - e0}
    finally:
        front.close()
        reps.close()


def _scenario_all_replicas_crash(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        f0 = _counter(ns, "znicz_router_requests_total", outcome="failed")
        n0 = _latency_count(ns)
        prompt = np.random.default_rng(41).integers(0, 17, (9,)).astype(np.int32)
        ns.faults.inject("router.stream")  # every upstream read dies, on both replicas
        r = front.post(prompt)
        ns.faults.clear("router.stream")
        assert r["status"] == 200  # headers were committed before the fault
        assert r["done"]["finish_reason"] == "error" and "router" in r["done"]
        failed = _counter(ns, "znicz_router_requests_total", outcome="failed") - f0
        n1 = _latency_count(ns)
        # a fast terminal error is no latency measurement; a served one is
        ok = front.post(np.arange(1, 8, dtype=np.int32), max_new=4)
        assert ok["status"] == 200
        _wait_until(reps.idle, what="fleet idle")
        return {"view": _view(r), "failed": failed, "latency_counted": (n1 - n0,
                                                                        _latency_count(ns) - n0)}
    finally:
        front.close()
        reps.close()


def _scenario_replica_4xx(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        c0 = _counter(ns, "znicz_router_retries_total", reason="connect")
        r = front.post(np.arange(1, 10, dtype=np.int32), max_new=10_000)
        assert r["status"] == 400 and "rejected the request" in r["body"]["detail"]
        return {"view": _view(r), "states": [(rep.state, rep.failures)
                                             for rep in front.router.registry.replicas()],
                "connect_retries": _counter(ns, "znicz_router_retries_total",
                                            reason="connect") - c0}
    finally:
        front.close()
        reps.close()


def _park(door, n=3):
    """Fill ``door``'s pending queue to its limit while its engine thread
    sleeps in an injected slow tick."""
    handles = []
    for _ in range(n):
        try:
            handles.append(door.submit(np.arange(1, 6, dtype=np.int32), 4))
        except RejectedError:
            break
        if len(door._pending) >= door.max_pending:
            break
    assert len(door._pending) >= door.max_pending
    return handles


def _scenario_fleet_saturated(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        for door in reps.doors:
            door.max_pending = 1
        faults.inject("frontdoor.slow_tick", delay=0.5)
        time.sleep(0.1)  # both engine threads now inside a sleeping tick
        handles = [h for door in reps.doors for h in _park(door)]
        s0 = _counter(ns, "znicz_router_requests_total", outcome="shed")
        r = front.post(np.arange(1, 8, dtype=np.int32), max_new=4)
        faults.clear("frontdoor.slow_tick")
        assert r["status"] == 503 and r["body"]["reason"] == "fleet_saturated"
        assert int(r["retry_after"]) >= 1
        reasons = [h.result(timeout=30.0).finish_reason for h in handles]
        assert all(x in ("eos", "budget") for x in reasons)
        return {"view": _view(r), "shed": _counter(ns, "znicz_router_requests_total",
                                                   outcome="shed") - s0}
    finally:
        faults.clear("frontdoor.slow_tick")
        front.close()
        reps.close()


def _scenario_transport_walk_bounded(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps, max_retries=0)
    try:
        c0 = _counter(ns, "znicz_router_retries_total", reason="connect")
        ns.faults.inject("router.connect")  # every connect refused
        r = front.post(np.arange(1, 8, dtype=np.int32), max_new=4)
        ns.faults.clear("router.connect")
        assert r["status"] == 503 and r["body"]["reason"] == "no_upstream"
        return {"view": _view(r), "connect_retries": _counter(
            ns, "znicz_router_retries_total", reason="connect") - c0}
    finally:
        front.close()
        reps.close()


def _scenario_no_live_replicas(ns, params, golden):
    reg = ns.cluster.ReplicaRegistry(start=False)
    router = ns.cluster.ServingRouter(reg, block_size=BS)
    rsrv = ns.cluster.build_router_server(router, port=0)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    try:
        r = _post(rsrv.server_address[1], [1, 2, 3], max_new=4)
        status, body = _get(rsrv.server_address[1], "/healthz")
        assert r["status"] == 503 and r["body"]["reason"] == "no_replicas"
        assert r["retry_after"] is not None and status == 503
        return {"view": _view(r), "healthz": (status, json.loads(body))}
    finally:
        rsrv.shutdown()
        rsrv.server_close()
        router.close()


def _scenario_misconfigured_instance(ns, params, golden):
    """A registered URL that answers HTTP but is no replica (a metrics
    aggregator: /healthz 200, /generate 404) fails over, is noted, and is
    quarantined once its traffic failures reach ``dead_after``."""
    reps = _Replicas(params)
    front = _Front(ns, reps)
    asrv = build_aggregator_server(port=0)
    threading.Thread(target=asrv.serve_forever, daemon=True).start()
    try:
        reg = front.router.registry
        front.router.register("bogus", f"http://127.0.0.1:{asrv.server_address[1]}")
        out = {"registered": reg.get("bogus").state}
        prompt = np.arange(1, 2 * BS + 1, dtype=np.int32)
        front.router.affinity.learn("bogus", prefix_block_keys(prompt, BS))
        r = front.post(prompt, max_new=4)
        assert r["status"] == 200 and r["done"]["router"]["replica"] != "bogus"
        out["view"] = _view(r)
        out["failures"] = reg.get("bogus").failures
        washes = []
        for i in range(reg.dead_after - 1):
            washes.append(reg.probe("bogus"))
            p2 = np.arange(3 + i, 3 + i + 2 * BS, dtype=np.int32)
            front.router.affinity.learn("bogus", prefix_block_keys(p2, BS))
            washes.append(_view(front.post(p2, max_new=4)))
        out["washes"] = washes
        out["quarantined"] = (reg.get("bogus").traffic_failures, reg.probe("bogus"))
        out["lifted"] = (reg.note_success("bogus"), reg.get("bogus").traffic_failures,
                         reg.probe("bogus"))
        assert out["quarantined"][1] == "degraded" and out["lifted"][2] == "healthy"
        return out
    finally:
        asrv.shutdown()
        asrv.server_close()
        front.close()
        reps.close()


def _scenario_sheds_spare_the_budget(ns, params, golden):
    reps = _Replicas(params)
    front = _Front(ns, reps)
    try:
        rs = ns.router.RoutedStream(front.router, {"prompt": [1], "max_new_tokens": 4}, [])
        rs.retries = 5  # five sheds reported...
        unit = [rs._budget_used, rs._can_retry()]  # ...and the crash budget untouched
        rs._budget_used = front.router.max_retries
        unit.append(rs._can_retry())
        # end to end: a persistently shedding replica ranked first is
        # walked through (reported), the healthy one serves
        reps.doors[0].max_pending = 1
        faults.inject("frontdoor.slow_tick", delay=0.5)
        time.sleep(0.1)
        parked = _park(reps.doors[0])
        prompt = np.arange(2, 2 * BS + 2, dtype=np.int32)
        front.router.affinity.learn("rep-0", prefix_block_keys(prompt, BS))
        r = front.post(prompt, max_new=4)
        faults.clear("frontdoor.slow_tick")
        assert r["status"] == 200 and r["done"]["router"]["replica"] == "rep-1"
        for h in parked:
            h.result(timeout=30.0)
        return {"unit": unit, "view": _view(r)}
    finally:
        faults.clear("frontdoor.slow_tick")
        front.close()
        reps.close()


def _scenario_done_record_reconciles(ns, params, golden):
    reg = ns.cluster.ReplicaRegistry(start=False)
    router = ns.cluster.ServingRouter(reg, block_size=BS)
    try:
        out = []
        for sent, rec in ((3, {"done": True, "finish_reason": "deadline_exceeded", "n_new": 0}),
                          (3, {"done": True, "finish_reason": "budget", "n_new": 3})):
            rs = ns.router.RoutedStream(router, {"prompt": [1], "max_new_tokens": 8}, [])
            rs._sent = sent
            out.append(rs._finish(rec))
        assert [r["n_new"] for r in out] == [3, 3]
        return out
    finally:
        router.close()


def _scenario_remaining_deadline(ns, params, golden):
    reg = ns.cluster.ReplicaRegistry(start=False)
    router = ns.cluster.ServingRouter(reg, block_size=BS)
    try:
        rs = ns.router.RoutedStream(
            router, {"prompt": [1, 2, 3], "max_new_tokens": 4, "deadline_s": 5.0}, [])
        rs._t0 = time.monotonic() - 3.0  # 3 s already burned
        d = rs.payload_now()["deadline_s"]
        assert 1.8 <= d <= 2.1, d
        rs._t0 = time.monotonic() - 60.0  # the budget exhausted
        spent = rs.payload_now()["deadline_s"]
        rs2 = ns.router.RoutedStream(router, {"prompt": [1], "max_new_tokens": 4}, [])
        return {"remaining": round(d, 1), "spent": spent, "none": rs2.payload_now()}
    finally:
        router.close()


FAILOVER = {
    "connect_refused": _scenario_connect_refused,
    "midstream_death": _scenario_midstream_death,
    "engine_crash_midstream": _scenario_engine_crash_midstream,
    "all_replicas_crash": _scenario_all_replicas_crash,
    "replica_4xx": _scenario_replica_4xx,
    "fleet_saturated": _scenario_fleet_saturated,
    "transport_walk_bounded": _scenario_transport_walk_bounded,
    "no_live_replicas": _scenario_no_live_replicas,
    "misconfigured_instance": _scenario_misconfigured_instance,
    "sheds_spare_the_budget": _scenario_sheds_spare_the_budget,
    "done_record_reconciles": _scenario_done_record_reconciles,
    "remaining_deadline": _scenario_remaining_deadline,
}


@pytest.mark.parametrize("scenario", sorted(FAILOVER))
def test_failover_ends_as_in_jax(scenario, params, golden):
    jax_out = FAILOVER[scenario](JAX, params, golden)
    faults.clear()
    jfaults.clear()
    assert FAILOVER[scenario](PORT, params, golden) == jax_out


def _splice(ns):
    """One stream whose first upstream delivers two tokens and dies, and
    whose second recomputes another prefix before a third token."""
    reg = ns.cluster.ReplicaRegistry(start=False)
    router = ns.cluster.ServingRouter(reg, block_size=BS)
    try:
        rs = ns.router.RoutedStream(router, {"prompt": [1, 2], "max_new_tokens": 6}, [])
        rs.trace_id = "t"
        upstreams = iter([[{"token": 1}, {"token": 2}],
                          [{"token": 9}, {"token": 8}, {"token": 3},
                           {"done": True, "finish_reason": "budget", "n_new": 3}]])
        rs._read_upstream = lambda: iter(next(upstreams))

        def reroute(exc):  # what _connect(rs, skip=rs._sent) leaves behind
            rs._to_skip = rs._sent
            return True

        rs._reroute = reroute
        return list(rs.records())
    finally:
        router.close()


def test_failover_splice_trusts_greedy_recompute():
    """Like JAX's, the router skips a resumed stream's first ``sent`` tokens
    unread: it never checks them against what it already delivered, so a
    replica that recomputes another prefix is spliced all the same."""
    got = _splice(PORT)
    assert got == _splice(JAX)
    # 1, 2 from the first replica; 9, 8 skipped unread; 3 from the second
    assert [r["token"] for r in got if "token" in r] == [1, 2, 3]
    assert got[-1]["done"] and got[-1]["n_new"] == 3


# -- the HTTP surface ------------------------------------------------------------


def test_router_http_surface_equals_jax(params):
    reps = _Replicas(params)
    fronts = {ns.name: _Front(ns, reps) for ns in BOTH}
    out = {}
    try:
        for ns in BOTH:
            port = fronts[ns.name].port
            codes = []
            for body in (b"not json", json.dumps({"max_new_tokens": 4}).encode(),
                         json.dumps({"prompt": "nope", "max_new_tokens": 4}).encode(),
                         json.dumps({"prompt": "123", "max_new_tokens": 4}).encode(),
                         json.dumps({"prompt": [], "max_new_tokens": 4}).encode(),
                         json.dumps({"prompt": [1, "x"], "max_new_tokens": 4}).encode(),
                         json.dumps({"prompt": [1, 2], "max_new_tokens": 0}).encode(),
                         json.dumps({"prompt": [1, 2], "deadline_s": "soon"}).encode()):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                try:
                    conn.request("POST", "/generate", body=body)
                    resp = conn.getresponse()
                    codes.append((resp.status, json.loads(resp.read())["error"]))
                finally:
                    conn.close()
            status, body = _get(port, "/replicas")
            roster = json.loads(body)
            roster["replicas"] = _stable(roster["replicas"])
            healthz = _get(port, "/healthz")
            metrics = _get(port, "/metrics")
            snap = json.loads(_get(port, "/metrics.json")[1])
            missing = (_get(port, "/nothing")[0],)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            try:
                conn.request("POST", "/other", body=b"{}")
                resp = conn.getresponse()
                resp.read()
                missing += (resp.status,)
            finally:
                conn.close()
            families = sorted(k for k in snap if k.startswith("znicz_router_"))
            out[ns.name] = {"bad_requests": codes, "replicas": (status, roster),
                            "healthz": (healthz[0], json.loads(healthz[1])),
                            "metrics": (metrics[0], [f for f in families
                                                     if f"# TYPE {f} " in metrics[1].decode()]),
                            "families": {f: (snap[f]["type"], snap[f]["help"]) for f in families},
                            "missing": missing}
    finally:
        for front in fronts.values():
            front.close()
        reps.close()
    assert out["port"] == out["jax"]
    assert all(code == (400, "bad_request") for code in out["port"]["bad_requests"])
    assert out["port"]["healthz"] == (200, {"state": "routing",
                                            "replicas": {"rep-0": "healthy", "rep-1": "healthy"}})
    assert out["port"]["replicas"][1]["policy"] == "prefix_affinity"
    assert {"znicz_router_requests_total", "znicz_router_replicas",
            "znicz_router_heartbeats_total"} <= set(out["port"]["families"])
    assert out["port"]["missing"] == (404, 404)


def test_the_proxy_cli_fronts_replicas_and_stops_on_sigterm(params, golden):
    reps = _Replicas(params, n=1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["PYTHONUNBUFFERED"] = "1"  # the bound address is read off stdout
    usage = subprocess.run([sys.executable, "-m", "znicz_tpu_torch.cluster.proxy"], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and "usage: python -m znicz_tpu_torch.cluster.proxy" in (
        usage.stderr)
    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch.cluster.proxy", reps.url(0), "--port", "0",
         "--block-size", str(BS), "--policy", "least_loaded"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = []
        reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert line and "znicz serving router on http://127.0.0.1:" in line[0], line
        port = int(line[0].split("http://127.0.0.1:")[1].split()[0])
        prompt = np.arange(2, 9, dtype=np.int32)
        r = _post(port, prompt, max_new=6)
        assert r["status"] == 200 and r["tokens"] == golden(prompt, 6)
        assert r["done"]["router"]["replica"] == "replica-0"
        roster = json.loads(_get(port, "/replicas")[1])
        assert roster["policy"] == "least_loaded" and roster["block_size"] == BS
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        reps.close()


def test_the_router_pushes_its_hop_to_a_collector(params):
    """``collector_url``: the router's route/retry/done instants and both
    replicas' spans share the router-minted trace id in the merged view."""
    csrv = build_collector_server(port=0)
    threading.Thread(target=csrv.serve_forever, daemon=True).start()
    tracer = tobs.get_tracer()
    if tracer.recording:
        tracer.stop()
    reps = _Replicas(params)
    front = _Front(PORT, reps, collector_url=f"http://127.0.0.1:{csrv.server_address[1]}",
                   name="znicz-router")
    try:
        prompt = np.random.default_rng(37).integers(0, 17, (2 * BS + 3,)).astype(np.int32)
        faults.inject("router.stream", after=2, times=1)
        r = front.post(prompt)
        assert r["status"] == 200 and r["done"]["router"]["retries"] == 1
        tid = r["trace_header"]
        pusher = front.router._trace_pusher

        def events():
            pusher.push_now()
            return [e for e in csrv.collector.merged_trace(tid)["traceEvents"] if e["ph"] != "M"]

        _wait_until(lambda: "router/done" in [e["name"] for e in events()], what="the router hop")
        names = [e["name"] for e in events()]
        assert names.count("router/route") == 2 and names.count("router/retry") == 1
        _wait_until(reps.idle, what="fleet idle")
    finally:
        front.close()
        reps.close()
        csrv.shutdown()
        csrv.server_close()
        if tracer.recording:
            tracer.stop()
    assert front.router._trace_pusher is None


# -- programs ------------------------------------------------------------------


def test_router_and_replicas_add_zero_programs(params, warm):
    """Two replicas and the router serve a mixed affinity stream and make
    nothing beyond the warm single-engine ladder: each engine's programs and
    the process-wide ``znicz_serve_compiles_total``."""
    reps = _Replicas(params)
    front = _Front(PORT, reps)
    compiles = tobs.counter("znicz_serve_compiles_total", "", ("kind", "bucket"))
    try:
        total0 = sum(child.value for child in compiles.children().values())
        gen = np.random.default_rng(47)
        shared = gen.integers(0, 17, (2 * BS,)).astype(np.int32)
        for i in range(4):
            tail = gen.integers(0, 17, (3 + i,)).astype(np.int32)
            assert front.post(np.concatenate([shared, tail]), max_new=8)["status"] == 200
        total1 = sum(child.value for child in compiles.children().values())
        extra = [set(d.engine.compile_stats()["programs"]) - warm for d in reps.doors]
    finally:
        front.close()
        reps.close()
    assert total1 - total0 == 0, "routing across replicas compiled new programs"
    assert extra == [set(), set()]
