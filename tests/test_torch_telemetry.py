"""The port's telemetry substrate against the JAX package's, on the CPU.

The metric and stage names are the JAX package's constants; the same
observations give byte-identical Prometheus text and equal snapshots from
both registries; ``PipelineAttribution`` gives the same record as JAX's on
the same stage samples, fed through a fake clock (no wall time); JAX's
``znicz-doctor`` reads a port run's ``metrics.prom``; a tracer window of a
port epoch is valid Chrome-trace JSON with the ``train/dispatch/*`` and
``loader/fetch`` spans.
"""

import json

import numpy as np
import pytest

from znicz_tpu.observability import (
    anomaly as j_anomaly,
    doctor as j_doctor,
    phases as j_phases,
    pipeline as j_pipeline,
    registry as j_registry,
    tracing as j_tracing,
)
from znicz_tpu_torch import observability as t_obs
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.observability import (
    anomaly as t_anomaly,
    phases as t_phases,
    pipeline as t_pipeline,
    registry as t_registry,
    tracing as t_tracing,
)
from znicz_tpu_torch.utils import faults as t_faults
from znicz_tpu_torch.workflow.standard import StandardWorkflow

PAIRS = [(j_pipeline, t_pipeline), (j_anomaly, t_anomaly), (j_registry, t_registry)]


def _constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (str, tuple, int, float))}


@pytest.mark.parametrize("jmod,tmod", PAIRS, ids=["pipeline", "anomaly", "registry"])
def test_names_are_the_jax_constants(jmod, tmod):
    assert _constants(tmod) == _constants(jmod)


def test_verdicts_and_suggestions_are_the_jax_package_s():
    assert t_pipeline._VERDICTS == j_pipeline._VERDICTS
    assert t_pipeline._SUGGESTIONS == j_pipeline._SUGGESTIONS


def _observe_all(reg):
    """One fixed sequence of observations through a registry's public API."""
    c = reg.counter("znicz_test_requests_total", "requests", ("route", "code"))
    c.labels(route="/gen", code="200").inc()
    c.labels(route="/gen", code="200").inc(2.5)
    c.labels(route='we"ird\\path\n', code="500").inc()
    g = reg.gauge("znicz_test_depth", "queue depth")
    g.set(7)
    g.inc(0.25)
    g.dec(3)
    h = reg.histogram("znicz_test_seconds", "latency", ("stage",))
    for i, v in enumerate([0.00005, 0.0003, 0.004, 0.004, 0.2, 3.0, 99.0, 1e-9]):
        h.labels(stage="ab"[i % 2]).observe(v)
    f = reg.histogram("znicz_test_fraction", "occupancy",
                      buckets=t_registry.DEFAULT_FRACTION_BUCKETS)
    for v in (0.0, 0.33, 0.99, 1.0):
        f.observe(v)
    reg.counter("znicz_test_unused_total", "never incremented")


def test_same_observations_give_byte_identical_prometheus_text():
    jreg, treg = j_registry.MetricsRegistry(), t_registry.MetricsRegistry()
    _observe_all(jreg)
    _observe_all(treg)
    text = treg.prometheus_text()
    assert text == jreg.prometheus_text()
    assert 'route="we\\"ird\\\\path\\n"' in text
    assert json.dumps(treg.snapshot(), sort_keys=True) == json.dumps(jreg.snapshot(),
                                                                    sort_keys=True)
    assert t_registry.parse_prometheus_text(text) == j_registry.parse_prometheus_text(text)


class _Clock:
    """A fake ``time`` module: ``perf_counter`` moves only when advanced."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def advance(self, s):
        self.t += s


# (name, prefetching, per-step ms: fetch, wait, h2d, compute, other, verdict)
SCENARIOS = [
    ("input", True, dict(fetch=8.0, wait=8.5, h2d=0.5, compute=1.0, other=0.1), "input-bound"),
    ("h2d", True, dict(fetch=1.0, wait=8.0, h2d=7.0, compute=1.0, other=0.1), "h2d-bound"),
    ("compute", True, dict(fetch=1.0, wait=0.1, h2d=0.5, compute=9.0, other=0.2),
     "compute-bound"),
    ("serial_h2d", False, dict(fetch=1.0, wait=0.0, h2d=6.0, compute=2.0, other=0.1),
     "h2d-bound"),
    ("serial_fill", False, dict(fetch=8.0, wait=0.0, h2d=0.5, compute=1.0, other=0.1),
     "unattributed"),
]


def _drive(obs_pkg, phases_mod, pipeline_mod, tracing_mod, clock, monkeypatch, prefetching,
           ms, steps=24):
    """Feed one package's instrumentation the scenario's stage samples,
    through its PhaseTimer and H2DProbe, on the fake clock."""
    for mod in (phases_mod, pipeline_mod):
        monkeypatch.setattr(mod, "time", clock)
    reg = obs_pkg.MetricsRegistry()
    timer = phases_mod.PhaseTimer("znicz_train_phase_seconds", span_prefix="train/",
                                  registry=reg, tracer=tracing_mod.Tracer())
    probe = pipeline_mod.H2DProbe(reg)
    stages = pipeline_mod.stage_seconds(reg)
    wall = pipeline_mod.step_wall_seconds(reg)
    wait = reg.histogram(pipeline_mod.WAIT_METRIC, "consumer wait")
    s = {k: v / 1e3 for k, v in ms.items()}
    for _ in range(steps):
        t0 = clock.t
        stages.labels(stage=pipeline_mod.STAGE_FETCH).observe(s["fetch"])
        if prefetching:  # the producer's stages ran beside the consumer's wait
            stages.labels(stage=pipeline_mod.STAGE_ENQUEUE).observe(0.0001)
            probe.observe(19_800_000, s["h2d"])
            wait.observe(s["wait"])
            clock.advance(s["wait"])
        else:  # fill and copy inline, on the consumer
            clock.advance(s["fetch"])
            with probe.measure(19_800_000):
                clock.advance(s["h2d"])
        with timer.phase("dispatch/train"):
            clock.advance(s["compute"])
        clock.advance(s["other"])
        wall.observe(clock.t - t0)
    return obs_pkg.PipelineAttribution.from_registry(reg).attribution()


@pytest.mark.parametrize("name,prefetching,ms,verdict", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_attribution_equals_jax_on_fake_clock_samples(monkeypatch, name, prefetching, ms,
                                                      verdict):
    from znicz_tpu import observability as j_obs

    jatt = _drive(j_obs, j_phases, j_pipeline, j_tracing, _Clock(), monkeypatch, prefetching, ms)
    tatt = _drive(t_obs, t_phases, t_pipeline, t_tracing, _Clock(), monkeypatch, prefetching, ms)
    assert tatt == jatt
    assert tatt["verdict"] == verdict, tatt
    assert tatt["steps"] == 24
    assert abs(tatt["fractions_sum"] - 1.0) < 1e-3


LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 3, "kx": 3, "ky": 3}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 6}},
    {"type": "softmax", "->": {"output_sample_shape": 3}},
]


def _workflow(prefetch_batches=2):
    prng.reset()
    prng.seed_all(5)
    rng = np.random.default_rng(0)
    loader = FullBatchLoader(
        {"train": rng.random((40, 6, 6, 1), np.float32), "valid": rng.random((10, 6, 6, 1),
                                                                             np.float32)},
        {"train": rng.integers(0, 3, 40), "valid": rng.integers(0, 3, 10)},
        minibatch_size=8,
    )
    wf = StandardWorkflow(loader, LAYERS, device="cpu", prefetch_batches=prefetch_batches,
                          decision_config={"max_epochs": 50})
    wf.initialize()
    return wf


def test_jax_doctor_reads_a_port_run_metrics_prom(tmp_path, capsys):
    t_registry.get_registry().reset()
    wf = _workflow()
    wf.run_epoch()
    t_pipeline.reset_window()
    wf.run_epoch()
    path = tmp_path / "metrics.prom"
    path.write_text(t_obs.prometheus_text())
    assert j_doctor.main([str(path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # 5 train + 2 valid steps an epoch, each a consumer step-wall sample
    assert report["steps"] == 7
    assert report["type"] == "pipeline" and report["verdict"] != "no-data"
    assert abs(report["fractions_sum"] - 1.0) < 0.05
    assert report["stages"]["fetch"] > 0 and report["stages"]["h2d"] > 0
    assert report["anomalies"]["active"] is False
    ours = t_pipeline.PipelineAttribution.from_prometheus(path.read_text()).attribution()
    assert {k: v for k, v in report.items() if k in ours} == ours


def test_tracer_window_writes_chrome_trace_with_the_loop_spans(tmp_path):
    wf = _workflow()
    tracer = t_obs.get_tracer()
    path = tmp_path / "run.trace.jsonl"
    tracer.start(path=str(path))
    try:
        wf.run_epoch()
    finally:
        tracer.stop()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert events and all(e["ph"] in ("X", "i") for e in events)
    for e in events:
        assert {"name", "ts", "pid", "tid"} <= set(e)
        assert e["ph"] != "X" or e["dur"] >= 0
    names = {e["name"] for e in events}
    assert {"train/dispatch/train", "train/dispatch/valid", "train/metrics_sync",
            "loader/fetch"} <= names
    fetch_tids = {e["tid"] for e in events if e["name"] == "loader/fetch"}
    dispatch_tids = {e["tid"] for e in events if e["name"] == "train/dispatch/train"}
    assert fetch_tids.isdisjoint(dispatch_tids)  # the producer's own thread track
    assert sum(e["name"] == "train/dispatch/train" for e in events) == 5


def test_fault_points_keep_the_jax_api():
    from znicz_tpu.utils import faults as j_faults

    assert t_faults.__all__ == j_faults.__all__
    with t_faults.injected("snapshot.write", times=1):
        assert t_faults.armed("snapshot.write")
        with pytest.raises(t_faults.FaultInjected):
            t_faults.fire("snapshot.write")
        assert not t_faults.armed("snapshot.write")  # times=1 spent
    t_faults.inject("train.crash", flag=True, after=1)
    try:
        assert t_faults.fire("train.crash") is False  # the first fire passes
        assert t_faults.fire("train.crash") is True
    finally:
        t_faults.clear()
    assert not t_faults.armed("train.crash")
    t_faults._parse_env("loader.fetch:times=2:delay=0,loader.h2d:flag")
    try:
        assert t_faults.armed("loader.fetch") and t_faults.armed("loader.h2d")
    finally:
        t_faults.clear()
    with pytest.raises(ValueError, match="unknown field"):
        t_faults._parse_env("loader.fetch:often=1")


def test_step_timer_stopwatch_and_latency_stats_match_jax():
    from znicz_tpu.utils import profiling as j_prof
    from znicz_tpu_torch.utils import profiling as t_prof

    vals = [0.003, 0.001, 0.5, 0.02, 0.0007] * 3
    summaries = []
    for mod in (j_prof, t_prof):
        stats = mod.LatencyStats(max_samples=8)
        for v in vals:
            stats.record(v)
        summaries.append(stats.summary())
    assert summaries[0] == summaries[1] and summaries[1]["count"] == len(vals)
    timer = t_prof.StepTimer()
    with timer.phase("a"):
        pass
    assert timer.summary()["a"]["count"] == 1
    assert t_prof.Stopwatch().elapsed() >= 0.0


def test_phase_timer_summary_is_a_window_of_the_registry():
    reg = t_registry.MetricsRegistry()
    a = t_phases.PhaseTimer("znicz_x_seconds", registry=reg, tracer=t_tracing.Tracer())
    with a.phase("p"):
        pass
    b = t_phases.PhaseTimer("znicz_x_seconds", registry=reg, tracer=t_tracing.Tracer())
    with b.phase("p"):
        pass
    assert a.summary()["p"]["count"] == 2 and b.summary()["p"]["count"] == 1
    b.reset()
    assert b.summary() == {}


def test_anomaly_detector_gives_the_jax_verdicts():
    from znicz_tpu.observability.anomaly import StepAnomalyDetector as J

    losses = [1.0 - 0.01 * i for i in range(30)] + [50.0, float("nan"), 0.7]
    out = []
    for cls, reg in ((J, j_registry.MetricsRegistry()),
                     (t_obs.StepAnomalyDetector, t_registry.MetricsRegistry())):
        det = cls(registry=reg)
        verdicts = []
        for i, loss in enumerate(losses):
            verdicts += [(v["type"], v["step"]) for v in
                         det.observe_step(i, loss=loss, grad_norm=1.0, step_seconds=0.01)]
        out.append((verdicts, reg.prometheus_text()))
    assert out[0] == out[1]
    assert ("loss_spike", 30) in out[1][0] and ("non_finite_loss", 31) in out[1][0]
