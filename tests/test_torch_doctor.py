"""The port's fleet triage CLI (``znicz_tpu_torch/observability/doctor.py``)
against the JAX package's, on the CPU.

Both doctors read the same exposition: a file written here (input-, h2d-
and compute-bound step walls, an active anomaly, past anomalies only, a
restart loop, a rollback that gave up, counters under budget, no training
data, a malformed capture, a fleet exposition scoped by ``--instance``), a
port training run's ``metrics.prom``, and a live ``/metrics`` URL.  Held
equal, exactly: the exit code, the text report, the ``--json`` object and
what is written to stderr.
"""

import contextlib
import io
import json
import threading

import numpy as np
import pytest

from znicz_tpu.observability import doctor as jdoctor
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.observability import doctor as tdoctor
from znicz_tpu_torch.observability import pipeline as P
from znicz_tpu_torch.observability.registry import MetricsRegistry
from znicz_tpu_torch.services import serve as tserve
from znicz_tpu_torch.workflow.standard import StandardWorkflow


def _run(doctor, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = doctor.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    """Each doctor's (exit code, stdout, stderr) on ``argv``; equal."""
    port, jax_ = _run(tdoctor, argv), _run(jdoctor, argv)
    assert port == jax_
    return port


def _steps(reg, n=64, wall=0.1, wait=0.0, compute=0.0, stages=None, instance=None):
    labels = {"instance": instance} if instance else {}
    names = tuple(labels)
    step = reg.histogram(P.STEP_WALL_METRIC, "", names)
    waits = reg.histogram(P.WAIT_METRIC, "", names)
    phase = reg.histogram(P.PHASE_METRIC, "", names + ("phase",))
    stage = reg.histogram(P.STAGE_METRIC, "", names + ("stage",))
    for _ in range(n):
        (step.labels(**labels) if labels else step).observe(wall)
        if wait:
            (waits.labels(**labels) if labels else waits).observe(wait)
        phase.labels(**labels, phase="dispatch/train").observe(compute)
        for s, v in (stages or {}).items():
            stage.labels(**labels, stage=s).observe(v)


def _prom(kind):
    reg = MetricsRegistry()
    if kind == "input_bound":
        _steps(reg, wait=0.083, compute=0.012,
               stages={"fetch": 0.07, "transform": 0.001, "h2d": 0.003, "enqueue": 0.0005})
        reg.counter(P.H2D_BYTES_METRIC, "").inc(64 * 3.5e6)
        reg.counter(P.QUEUE_FULL_METRIC, "").inc(2)
    elif kind == "h2d_bound":
        _steps(reg, wait=0.07, compute=0.02, stages={"fetch": 0.005, "h2d": 0.06})
        reg.gauge(P.H2D_BPS_METRIC, "").set(1.2e7)
    elif kind == "compute_bound":
        _steps(reg, n=12, compute=0.09, stages={"fetch": 0.001, "h2d": 0.001})
    elif kind == "serial_loop":
        _steps(reg, n=6, compute=0.03, stages={"h2d": 0.05})
    elif kind == "anomaly_active":
        _steps(reg, compute=0.09)
        reg.gauge(P.ANOMALY_ACTIVE_METRIC, "").set(1)
        c = reg.counter(P.ANOMALY_TOTAL_METRIC, "", ("type",))
        c.labels(type="non_finite_loss").inc(2)
        c.labels(type="loss_spike").inc(1)
        reg.gauge(P.LAST_LOSS_METRIC, "").set(float("nan"))
        reg.gauge(P.LAST_GRAD_METRIC, "").set(3.5)
    elif kind == "past_anomalies":
        _steps(reg, compute=0.05)
        reg.gauge(P.ANOMALY_ACTIVE_METRIC, "").set(0)
        reg.counter(P.ANOMALY_TOTAL_METRIC, "", ("type",)).labels(type="grad_spike").inc(3)
    elif kind == "restart_loop":
        reg.counter(P.RESTARTS_METRIC, "").inc(3)
        reg.gauge(P.RESTART_BUDGET_METRIC, "").set(3)
    elif kind == "rollback_give_up":
        reg.counter(P.ROLLBACKS_METRIC, "", ("reason",)).labels(reason="non_finite_loss").inc(2)
        reg.gauge(P.ROLLBACK_GIVE_UP_METRIC, "").set(1)
    elif kind == "under_budget":
        _steps(reg, compute=0.05, wait=0.01, stages={"fetch": 0.01})
        reg.counter(P.ROLLBACKS_METRIC, "", ("reason",)).labels(reason="loss_spike").inc(1)
        reg.counter(P.RESTARTS_METRIC, "").inc(1)
        reg.gauge(P.RESTART_BUDGET_METRIC, "").set(3)
        reg.counter(P.LOADER_RETRIES_METRIC, "").inc(2)
        reg.counter(P.LOADER_SKIPPED_METRIC, "").inc(1)
        reg.counter(P.SNAPSHOT_FAILURES_METRIC, "").inc(1)
    elif kind == "no_data":
        reg.counter("some_counter_total", "x").inc()
    elif kind == "fleet":
        _steps(reg, n=10, wall=0.1, compute=0.09, instance="a")
        _steps(reg, n=10, wall=0.9, wait=0.8, compute=0.05, stages={"fetch": 0.7}, instance="b")
    return reg.prometheus_text()


CASES = {  # kind -> the exit code JAX's doctor gives
    "input_bound": 0, "h2d_bound": 0, "compute_bound": 0, "serial_loop": 0,
    "anomaly_active": 1, "past_anomalies": 0, "restart_loop": 1, "rollback_give_up": 1,
    "under_budget": 0, "no_data": 0, "fleet": 0,
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_doctor_equals_jax_on_an_exposition(kind, tmp_path):
    path = tmp_path / "metrics.prom"
    path.write_text(_prom(kind))
    rc, text, err = _both([str(path)])
    assert rc == CASES[kind] and err == ""
    rc_json, out, err = _both([str(path), "--json"])
    report = json.loads(out)
    assert rc_json == rc and report["source"] == str(path) and report["instance"] is None
    if kind == "no_data":
        assert report["verdict"] == "no-data" and "no-data" in text
    if kind == "anomaly_active":
        assert report["anomalies"]["active"] and "ACTIVE" in text
    if kind in ("restart_loop", "rollback_give_up"):
        assert report["recovery"]["looping"] and "LOOPING" in text
    if kind == "input_bound":
        assert report["verdict"] == "input-bound" and report["queue_full_stalls"] == 2


@pytest.mark.parametrize("instance", ["a", "b", "nobody"])
def test_doctor_equals_jax_scoped_to_one_instance_of_a_fleet(instance, tmp_path):
    path = tmp_path / "fleet.prom"
    path.write_text(_prom("fleet"))
    rc, text, _ = _both([str(path), "--instance", instance])
    _, out, _ = _both(["--json", str(path), "--instance", instance])
    report = json.loads(out)
    assert rc == 0 and report["instance"] == instance
    assert report["steps"] == (0 if instance == "nobody" else 10)


@pytest.mark.parametrize("argv", [[], ["a", "b"], ["--instance"], ["--json"], ["--oops"],
                                  ["{dir}/missing.prom"], ["{dir}/bad.prom"],
                                  ["{dir}/bad.prom", "--json"]])
def test_doctor_usage_and_unreadable_sources_exit_2_as_jax(argv, tmp_path):
    (tmp_path / "bad.prom").write_text("this is { not an exposition !!!\n")
    rc, out, err = _both([a.format(dir=tmp_path) for a in argv])
    assert rc == 2 and out == "" and err


def test_doctor_equals_jax_on_a_port_run(tmp_path):
    """A port training run's exposition: 5 train and 2 valid steps an epoch
    through the prefetch thread, the window reset after a first epoch."""
    tobs.get_registry().reset()
    prng.reset()
    prng.seed_all(5)
    rng = np.random.default_rng(0)
    loader = FullBatchLoader(
        {"train": rng.random((40, 6, 6, 1), np.float32),
         "valid": rng.random((10, 6, 6, 1), np.float32)},
        {"train": rng.integers(0, 3, 40), "valid": rng.integers(0, 3, 10)}, minibatch_size=8)
    wf = StandardWorkflow(loader, [
        {"type": "conv_relu", "->": {"n_kernels": 3, "kx": 3, "ky": 3}},
        {"type": "softmax", "->": {"output_sample_shape": 3}},
    ], device="cpu", prefetch_batches=2, decision_config={"max_epochs": 50})
    wf.initialize()
    wf.run_epoch()
    P.reset_window()
    wf.run_epoch()
    path = tmp_path / "metrics.prom"
    path.write_text(tobs.get_registry().prometheus_text())
    rc, text, _ = _both([str(path)])
    _, out, _ = _both([str(path), "--json"])
    report = json.loads(out)
    assert rc == 0 and report["steps"] == 7 and report["verdict"] != "no-data"


def test_doctor_equals_jax_on_a_live_metrics_url(tmp_path, monkeypatch):
    """A bare ``http://host:port`` gets ``/metrics`` appended: the port's
    HTTP server's live registry (its request log, which stamps the second,
    silenced)."""
    monkeypatch.setattr(tserve.StatusRequestHandler, "log_message", lambda *args: None)
    tobs.get_registry().reset()
    reg = tobs.get_registry()
    reg.counter(P.RESTARTS_METRIC, "").inc(2)
    reg.gauge(P.RESTART_BUDGET_METRIC, "").set(2)
    srv = tserve.build_server(directory=str(tmp_path), port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        rc, text, _ = _both([url])
        _, out, _ = _both([url + "/metrics", "--json"])
        unreachable = _both(["http://127.0.0.1:9/metrics"])
    finally:
        srv.shutdown()
        srv.server_close()
        tobs.get_registry().reset()
    assert rc == 1 and "LOOPING" in text
    assert json.loads(out)["recovery"]["restarts"] == 2
    assert unreachable[0] == 2
