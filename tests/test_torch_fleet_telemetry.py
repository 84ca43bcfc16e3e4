"""The port's fleet telemetry against the JAX package's, on the CPU.

``observability/aggregate.py``, ``collector.py`` and ``slo.py`` of both
packages take the same registry snapshots, Prometheus text and span events
(built alike on each side) and must give the same merged fleet ``/metrics``
(text and JSON), ``series_value``, ``/instances``, ``evaluate_exposition``,
``lifetime_snapshot``, rolling :class:`SLOMonitor` windows and merged
``/trace`` timeline.  The wire format is shared both ways: a JAX
``MetricsPusher`` / ``TracePusher`` feeds the port's aggregator /
collector over HTTP and a port pusher feeds JAX's, which the JAX router's
load tiebreak relies on.  Every wait carries its own timeout.
"""

import http.client
import json
import threading

import pytest

from znicz_tpu.observability import aggregate as jagg
from znicz_tpu.observability import collector as jcol
from znicz_tpu.observability import slo as jslo
from znicz_tpu.observability.registry import MetricsRegistry as JRegistry
from znicz_tpu.observability.tracing import Tracer as JTracer
from znicz_tpu.utils import faults as jfaults
from znicz_tpu_torch.observability import aggregate as tagg
from znicz_tpu_torch.observability import collector as tcol
from znicz_tpu_torch.observability import slo as tslo
from znicz_tpu_torch.observability.registry import MetricsRegistry as TRegistry
from znicz_tpu_torch.observability.tracing import Tracer as TTracer
from znicz_tpu_torch.utils import faults as tfaults

SIDES = (
    (JRegistry, jagg, jcol, jslo, JTracer),
    (TRegistry, tagg, tcol, tslo, TTracer),
)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _fill(reg_cls, submitted, ttfts, lat, pending, reasons):
    """A serving replica's registry: the front door's and engine's series
    that the aggregator merges and the SLO monitor judges."""
    r = reg_cls()
    r.counter("znicz_serve_requests_submitted_total", "req").inc(submitted)
    h = r.histogram("znicz_serve_frontdoor_ttft_seconds", "ttft")
    for t in ttfts:
        h.observe(t)
    h = r.histogram("znicz_serve_frontdoor_latency_seconds", "lat")
    for t in lat:
        h.observe(t)
    h = r.histogram("znicz_serve_ttft_seconds", "engine ttft")
    for t in ttfts:
        h.observe(t / 2)
    r.gauge("znicz_serve_frontdoor_pending", "pend").set(pending)
    r.gauge("znicz_serve_pool_free_frac", "free", ("instance_kind",)).labels(
        instance_kind="paged").set(0.25 * pending)
    ret = r.counter("znicz_serve_requests_retired_total", "ret", ("reason",))
    for reason in reasons:
        ret.labels(reason=reason).inc()
    r.counter("znicz_serve_rejected_total", "shed", ("reason",)).labels(
        reason="queue_full").inc(len(reasons) // 2)
    return r


REPLICAS = {
    "rep-a": (3, [0.01, 0.2, 0.7], [0.3, 0.9, 2.5], 2, ("eos", "budget", "eos")),
    "rep-b": (5, [0.05, 1.5, 0.02, 0.3], [0.4, 6.0, 0.2, 1.1], 7,
              ("eos", "error", "cancelled", "budget")),
}


def _registries(side):
    return {name: _fill(SIDES[side][0], *spec) for name, spec in REPLICAS.items()}


def _aggregators(form):
    """Both sides' aggregators fed the same pushes (``form``: the registry
    snapshot or its Prometheus text)."""
    out = []
    for side in (0, 1):
        agg = SIDES[side][1].MetricsAggregator(default_ttl_s=30.0)
        for i, (name, reg) in enumerate(_registries(side).items()):
            if form == "snapshot":
                agg.push(name, reg.snapshot(), now=float(i))
            else:
                agg.push(name, text=reg.prometheus_text(), ttl_s=5.0, now=float(i))
        out.append(agg)
    return out


@pytest.mark.parametrize("form", ["snapshot", "text"])
def test_merged_fleet_view_equals_jax(form):
    jag, tag = _aggregators(form)
    assert tag.prometheus_text(now=2.0) == jag.prometheus_text(now=2.0)
    assert tag.merged_snapshot(now=2.0) == jag.merged_snapshot(now=2.0)
    assert tag.instances(now=2.0) == jag.instances(now=2.0)
    # past the text pushes' TTL, rep-a ages out on both sides alike
    assert tag.prometheus_text(now=5.5) == jag.prometheus_text(now=5.5)


@pytest.mark.parametrize("name,labels", [
    ("znicz_serve_requests_submitted_total", None),
    ("znicz_serve_frontdoor_pending", None),
    ("znicz_serve_pool_free_frac", {"instance_kind": "paged"}),
    ("znicz_serve_requests_retired_total", {"reason": "eos"}),
    ("znicz_serve_requests_retired_total", {"reason": "absent"}),
    ("znicz_serve_frontdoor_ttft_seconds", None),  # a histogram: None
    ("znicz_no_such_family", None),
])
def test_series_value_equals_jax(name, labels):
    jag, tag = _aggregators("snapshot")
    for inst in REPLICAS:
        jv = jagg.series_value(jag.instance_families(inst, now=2.0), name, labels)
        tv = tagg.series_value(tag.instance_families(inst, now=2.0), name, labels)
        assert tv == jv
        assert tag.instance_value(inst, name, labels, now=2.0) == jag.instance_value(
            inst, name, labels, now=2.0)
    assert tagg.series_value(None, name, labels) is None


def test_malformed_pushes_raise_alike():
    for bad in ({"x": 1}, {"znicz_a": {"type": "counter"}}, "notadict"):
        errs = []
        for side in (0, 1):
            with pytest.raises(ValueError) as exc:
                SIDES[side][1].MetricsAggregator().push("i", bad)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("frontdoor", [False, True])
def test_evaluate_exposition_equals_jax(frontdoor):
    snaps = []
    for side in (0, 1):
        slo = SIDES[side][3]
        targets = slo.FRONTDOOR_TARGETS if frontdoor else slo.DEFAULT_TARGETS
        text = _registries(side)["rep-b"].prometheus_text()
        snaps.append(slo.evaluate_exposition(text, targets))
    assert _timeless(snaps[1]) == _timeless(snaps[0])
    assert tslo._render_table(snaps[1]) == jslo._render_table(snaps[0])


def test_evaluate_exposition_of_the_merged_fleet_equals_jax():
    jag, tag = _aggregators("snapshot")
    j = jslo.evaluate_exposition(jag.prometheus_text(now=2.0), jslo.FRONTDOOR_TARGETS)
    t = tslo.evaluate_exposition(tag.prometheus_text(now=2.0), tslo.FRONTDOOR_TARGETS)
    assert _timeless(t) == _timeless(j)


def test_lifetime_snapshot_equals_jax():
    j = jslo.lifetime_snapshot(_registries(0)["rep-b"], jslo.FRONTDOOR_TARGETS)
    t = tslo.lifetime_snapshot(_registries(1)["rep-b"], tslo.FRONTDOOR_TARGETS)
    assert _timeless(t) == _timeless(j)


def test_slo_monitor_windows_equal_jax():
    """Rolling windows over the same registry history: a sample, more
    traffic, a sample, judged at fixed clocks."""
    snaps = []
    for side in (0, 1):
        reg_cls, _, _, slo, _ = SIDES[side]
        reg = _fill(reg_cls, *REPLICAS["rep-a"])
        targets = (slo.SLOTarget("ttft", "znicz_serve_frontdoor_ttft_seconds", 0.15, 0.9),
                   slo.SLOTarget("latency", "znicz_serve_frontdoor_latency_seconds", 1.0))
        mon = slo.SLOMonitor(registry=reg, targets=targets, windows_s=(10.0, 100.0),
                             min_sample_gap_s=0.0)
        mon.sample(now=0.0)
        h = reg.histogram("znicz_serve_frontdoor_ttft_seconds", "ttft")
        for t in (0.4, 0.6, 0.01):
            h.observe(t)
        reg.counter("znicz_serve_requests_retired_total", "ret", ("reason",)).labels(
            reason="error").inc()
        mon.sample(now=50.0)
        reg.histogram("znicz_serve_frontdoor_ttft_seconds", "ttft").observe(3.0)
        mon.sample(now=95.0)
        snaps.append((_timeless(mon.snapshot(now=100.0)), mon.latest_burn()))
    assert snaps[1] == snaps[0]


def test_slo_main_exit_codes_equal_jax(tmp_path, capsys):
    prom = tmp_path / "metrics.prom"
    prom.write_text(_registries(1)["rep-b"].prometheus_text())
    for argv in ([str(prom), "--frontdoor", "--json"], [str(prom), "--ttft", "5", "--latency",
                 "9"], [str(prom), "--objective", "x"], []):
        codes, outs = [], []
        for mod in (jslo, tslo):
            codes.append(mod.main(list(argv)))
            outs.append(capsys.readouterr())
        assert codes[1] == codes[0]
        if "--json" in argv:
            assert _timeless(json.loads(outs[1].out)) == _timeless(json.loads(outs[0].out))
        else:
            assert outs[1].out == outs[0].out


def _timeless(snap):
    """An SLO snapshot without its wall-clock stamp."""
    return {k: v for k, v in snap.items() if k != "generated_unix"}


def _events():
    """Chrome trace events as two replicas' tracers emit them."""
    return {
        "rep-a": [
            {"name": "serve/admit", "ph": "X", "ts": 10.0, "dur": 5.0, "pid": 1, "tid": 2,
             "args": {"trace": "t-1", "instance": "rep-a"}},
            {"name": "serve/queued", "ph": "i", "s": "t", "ts": 3.0, "pid": 1, "tid": 2,
             "args": {"trace": "t-1"}},
            {"name": "frontdoor/done", "ph": "i", "s": "t", "ts": 40.0, "pid": 1, "tid": 3,
             "args": {"id": "t-2", "instance": "rep-b"}},
        ],
        "rep-b": [
            {"name": "serve/decode", "ph": "X", "ts": 1.0, "dur": 9.0, "pid": 7, "tid": 1,
             "args": {"residents": 2}},
            {"name": "serve/retired", "ph": "i", "s": "t", "ts": 12.0, "pid": 7, "tid": 1,
             "args": {"trace": "t-2", "reason": "eos"}},
        ],
    }


@pytest.mark.parametrize("trace_id", [None, "t-1", "t-2"])
def test_merged_trace_equals_jax(trace_id):
    merged = []
    for side in (0, 1):
        col = SIDES[side][2].TraceCollector(default_ttl_s=30.0, max_events_per_instance=4)
        for i, (inst, evs) in enumerate(_events().items()):
            col.push(inst, [dict(e) for e in evs], epoch_us=1e6 + 250.0 * i, now=float(i))
        col.push("rep-a", [dict(_events()["rep-b"][0])], epoch_us=1e6, now=1.5)
        merged.append((col.merged_trace(trace_id=trace_id, now=2.0), col.instances(now=2.0)))
    assert merged[1] == merged[0]


def _server(build, obj):
    srv = build(obj, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url, path):
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("pusher_side,agg_side", [(0, 1), (1, 0)])
def test_metrics_pusher_feeds_the_other_aggregator(pusher_side, agg_side):
    """The shared wire: one side's pusher into the other side's aggregator
    over HTTP gives the merged view the aggregator's own side gives for
    the same registry."""
    agg_mod = SIDES[agg_side][1]
    agg = agg_mod.MetricsAggregator()
    srv, url = _server(agg_mod.build_aggregator_server, agg)
    try:
        reg = _fill(SIDES[pusher_side][0], *REPLICAS["rep-b"])
        pusher = SIDES[pusher_side][1].MetricsPusher(url, instance="rep-b", registry=reg,
                                                     timeout_s=10.0)
        assert pusher.push_now() is True
        local = agg_mod.MetricsAggregator()
        local.push("rep-b", _fill(SIDES[agg_side][0], *REPLICAS["rep-b"]).snapshot())
        for name in ("znicz_serve_requests_submitted_total", "znicz_serve_frontdoor_pending",
                     "znicz_serve_requests_retired_total"):
            for labels in (None, {"reason": "eos"}, {"reason": "error"}):
                assert agg.instance_value("rep-b", name, labels) == local.instance_value(
                    "rep-b", name, labels)
        status, body = _get(url, "/metrics")
        assert status == 200
        text = body.decode()
        assert 'znicz_serve_requests_submitted_total 5' in text
        assert 'znicz_serve_frontdoor_ttft_seconds_count 4' in text
        status, body = _get(url, "/instances")
        assert [i["instance"] for i in json.loads(body)["instances"]] == ["rep-b"]
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("side", [0, 1])
def test_pusher_failure_point_is_counted_not_raised(side):
    reg_cls, agg_mod, _, _, _ = SIDES[side]
    faults = (jfaults, tfaults)[side]
    agg = agg_mod.MetricsAggregator()
    srv, url = _server(agg_mod.build_aggregator_server, agg)
    try:
        pusher = agg_mod.MetricsPusher(url, instance="x", registry=reg_cls(), timeout_s=10.0)
        faults.inject("pusher.push", times=1)
        assert pusher.push_now() is False
        assert pusher.pushes_failed == 1
        assert pusher.push_now() is True
        assert agg.instances()[0]["instance"] == "x"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("pusher_side,col_side", [(0, 1), (1, 0), (1, 1)])
def test_trace_pusher_feeds_the_other_collector(pusher_side, col_side):
    col_mod = SIDES[col_side][2]
    col = col_mod.TraceCollector()
    srv, url = _server(col_mod.build_collector_server, col)
    tracer = SIDES[pusher_side][4]()
    faults = (jfaults, tfaults)[pusher_side]
    try:
        pusher = SIDES[pusher_side][2].TracePusher(url, instance="rep-a", tracer=tracer,
                                                   timeout_s=10.0)
        tracer.start()
        tracer.instant("frontdoor/submit", id="t-9", instance="rep-a")
        with tracer.span("serve/admit", trace="t-9"):
            pass
        faults.inject("trace_pusher.push", times=1)
        assert pusher.push_now() is False  # the batch is dropped, counted
        tracer.instant("frontdoor/done", id="t-9", reason="eos", instance="rep-a")
        assert pusher.push_now() is True
        tracer.stop()
        pusher.stop(timeout=10.0)
        status, body = _get(url, "/trace")
        assert status == 200
        events = [e for e in json.loads(body)["traceEvents"] if e.get("ph") != "M"]
        assert [e["name"] for e in events] == ["frontdoor/done"]
        assert events[0]["args"] == {"id": "t-9", "reason": "eos", "instance": "rep-a"}
        status, body = _get(url, "/trace?trace_id=t-9")
        assert [e["name"] for e in json.loads(body)["traceEvents"] if e.get("ph") != "M"] == [
            "frontdoor/done"]
    finally:
        if tracer.recording:
            tracer.stop()
        srv.shutdown()
        srv.server_close()


def test_attach_pusher_shares_one_pusher_per_tracer():
    col = tcol.TraceCollector()
    srv, url = _server(tcol.build_collector_server, col)
    tracer = TTracer()
    try:
        a = tcol.attach_pusher(url, instance="a", tracer=tracer, interval_s=30.0)
        b = tcol.attach_pusher(url, instance="b", tracer=tracer, interval_s=10.0)
        assert a is b and a.interval_s == 10.0 and a.instance == "a"
        tcol.detach_pusher(b)
        assert a._thread is not None and a._thread.is_alive()
        tcol.detach_pusher(a)
        assert not a._thread.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()


def test_public_names_equal_jax():
    for jm, tm in ((jagg, tagg), (jcol, tcol), (jslo, tslo)):
        jnames = {n for n in dir(jm) if not n.startswith("_")} - {"annotations"}
        tnames = {n for n in dir(tm) if not n.startswith("_")} - {"annotations"}
        assert tnames == jnames
    assert [t for t in tslo.FRONTDOOR_TARGETS] != []
    assert [(t.name, t.metric, t.threshold_s, t.objective) for t in tslo.FRONTDOOR_TARGETS] == [
        (t.name, t.metric, t.threshold_s, t.objective) for t in jslo.FRONTDOOR_TARGETS]
    assert [(t.name, t.metric, t.threshold_s, t.objective) for t in tslo.DEFAULT_TARGETS] == [
        (t.name, t.metric, t.threshold_s, t.objective) for t in jslo.DEFAULT_TARGETS]
