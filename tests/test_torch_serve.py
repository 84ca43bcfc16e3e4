"""The port's HTTP server against the JAX package's, on the CPU.

``services/serve.py`` of both packages, each in front of its own front door
over the same tiny LM (vocab 17, d_model 32, 2 layers, 4 heads, max_seq 64,
block 8, EOS 14, ``prng.seed_all(27)``, the JAX params carried across with
``params_from_jax``), answer the same requests alike: ``POST /generate``'s
NDJSON token lines and its done record (JAX's keys), the
``X-Znicz-Trace-Id`` header and an inbound id adopted, 503 with
``Retry-After`` on a shed or a closed door, 400 on bad and oversized
requests, ``/healthz`` with and without a door, ``/slo`` and its fallback,
``/debug/requests``, ``/debug/programs`` (the port's device ledger),
``/debug/profile`` (the port's ``torch.profiler`` capture: the clamp, 400
on bad seconds, 409 when busy, the keep-alive body drain),
``/prefix_probe``, ``/metrics`` and ``/metrics.json`` file-first, 404s; a
client that disconnects mid-stream cancels its request (blocks reclaimed);
the graceful shutdown drains, then stops the listener.  Every wait has its
own timeout.
"""

import http.client
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.services import engine as JE
from znicz_tpu.services import frontdoor as JF
from znicz_tpu.services import serve as jserve
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch.observability import device as tdevice
from znicz_tpu_torch.services import engine as TE
from znicz_tpu_torch.services import frontdoor as TF
from znicz_tpu_torch.services import serve as tserve
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 14
HEADS = 4
KW = dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=8, max_seq=64, admit_every=4)
DONE_KEYS = {"done", "trace_id", "finish_reason", "n_new", "latency_ms", "ttft_ms", "timings"}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def both_params():
    jprng.seed_all(27)
    jp = jinit(17, 32, 2, HEADS, max_seq=64)
    return jp, model_lib.params_from_jax(jax.device_get(jp), "cpu")


class _Served:
    """A front door (or none) behind a ready server on an ephemeral port."""

    def __init__(self, serve_mod, door=None, directory="."):
        self.door = door
        self.srv = serve_mod.build_server(directory=directory, port=0, frontdoor=door)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        if self.door is not None:
            self.door.close(grace_s=10.0)


def _doors(both_params, **door_kw):
    jp, tp = both_params
    return (JF.ServingFrontDoor(lambda: JE.PagedDecodeEngine(jp, **KW), **door_kw),
            TF.ServingFrontDoor(lambda: TE.PagedDecodeEngine(tp, **KW), **door_kw))


@pytest.fixture
def pair(both_params):
    jd, td = _doors(both_params)
    served = (_Served(jserve, jd), _Served(tserve, td))
    yield served
    for s in served:
        s.close()


def request(port, method, path, body=None, headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, dict(resp.getheaders()), raw
    finally:
        conn.close()


def generate(port, prompt, max_new=8, headers=None, **extra):
    status, hdrs, raw = request(port, "POST", "/generate",
                                {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new,
                                 **extra}, headers)
    if status != 200:
        return status, hdrs, json.loads(raw), None
    lines = [json.loads(line) for line in raw.decode().splitlines() if line]
    return status, hdrs, lines[:-1], lines[-1]


def _prompts():
    gen = np.random.default_rng(7)
    return [gen.integers(0, 17, (k,)).astype(np.int32) for k in (5, 12, 3, 9)]


def _reference(params, prompt, budget):
    out = G.generate(params, torch.as_tensor(prompt)[None], n_heads=HEADS,
                     max_new_tokens=budget, eos_id=EOS)[0].tolist()
    new = out[len(prompt):]
    return new[: new.index(EOS) + 1] if EOS in new else new


def test_generate_ndjson_equals_jax(pair, both_params):
    (js, ts), tp = pair, both_params[1]
    for p in _prompts():
        out = [generate(s.port, p, 8) for s in (js, ts)]
        (jst, jh, jtoks, jdone), (tst, th, ttoks, tdone) = out
        assert jst == tst == 200
        assert ttoks == jtoks == [{"token": t} for t in _reference(tp, p, 8)]
        assert set(tdone) == set(jdone) == DONE_KEYS
        for k in ("done", "finish_reason", "n_new"):
            assert tdone[k] == jdone[k]
        assert set(tdone["timings"]) == set(jdone["timings"])
        assert th["X-Znicz-Trace-Id"] == tdone["trace_id"]
        assert th["Content-Type"] == jh["Content-Type"] == "application/x-ndjson"
        assert th["Transfer-Encoding"] == jh["Transfer-Encoding"] == "chunked"
    # an inbound trace id is adopted verbatim
    for s in (js, ts):
        _, hdrs, _, done = generate(s.port, _prompts()[0], 3,
                                    headers={"X-Znicz-Trace-Id": "router-42"})
        assert hdrs["X-Znicz-Trace-Id"] == done["trace_id"] == "router-42"
    assert ts.door.engine.stats()["pool_blocks_free"] == ts.door.engine.stats()["pool_blocks"]


@pytest.mark.parametrize("body", [
    b"not json", {"max_new_tokens": 4}, {"prompt": None}, {"prompt": [[1, 2], [3]]},
    {"prompt": [1, 2], "max_new_tokens": "many"}, {"prompt": [1, 2], "deadline_s": "soon"},
    {"prompt": [1, 2, 3], "max_new_tokens": 10_000}, {"prompt": []},
])
def test_bad_requests_answer_400_as_jax(pair, body):
    out = []
    for s in pair:
        status, hdrs, raw = request(s.port, "POST", "/generate", body)
        out.append((status, json.loads(raw)["error"], hdrs["Content-Type"]))
    assert out[1] == out[0]
    assert out[1][0] == 400


def test_shed_and_closed_answer_503_with_retry_after(both_params):
    served = [_Served(m, d) for m, d in zip(
        (jserve, tserve), _doors(both_params, max_pending=1, engine_queue_limit=0))]
    try:
        out = []
        for s in served:
            s.door.submit(_prompts()[0], 4)  # parked: the queue is full
            status, hdrs, raw = request(s.port, "POST", "/generate",
                                        {"prompt": [1, 2], "max_new_tokens": 4})
            body = json.loads(raw)
            s.door.close(grace_s=0.1)
            st2, hdrs2, raw2 = request(s.port, "POST", "/generate",
                                       {"prompt": [1, 2], "max_new_tokens": 4})
            out.append((status, body["error"], body["reason"], hdrs["Retry-After"], st2,
                        json.loads(raw2)["error"], hdrs2["Retry-After"]))
        assert out[1] == out[0]
        assert out[1][:4] == (503, "rejected", "queue_full", "1")
        assert out[1][4:6] == (503, "engine_closed")
    finally:
        for s in served:
            s.close()


def test_no_door_answers_as_jax(tmp_path):
    served = [_Served(m, directory=str(tmp_path)) for m in (jserve, tserve)]
    try:
        out = []
        for s in served:
            row = []
            for method, path, body in (("GET", "/healthz", None),
                                       ("POST", "/generate", {"prompt": [1]}),
                                       ("POST", "/prefix_probe", {"prompt": [1]}),
                                       ("GET", "/debug/requests", None),
                                       ("POST", "/nowhere", {}),
                                       ("GET", "/missing.html", None)):
                status, hdrs, raw = request(s.port, method, path, body)
                row.append((status, raw if path == "/healthz" else
                            json.loads(raw).get("error") if status in (503, 404) and
                            raw.startswith(b"{") else None))
            out.append(row)
        assert out[1] == out[0]
        assert out[1][0] == (200, b"ok\n")
    finally:
        for s in served:
            s.close()


def test_healthz_with_a_door_carries_the_load_body(pair):
    bodies = []
    for s in pair:
        status, hdrs, raw = request(s.port, "GET", "/healthz")
        assert status == 200 and hdrs["Content-Type"] == "application/json"
        bodies.append(json.loads(raw))
    assert set(bodies[1]) == set(bodies[0])
    assert bodies[1]["state"] == "running" and bodies[1]["pool_free_frac"] == 1.0


def test_slo_and_its_fallback_answer_as_jax(pair, tmp_path):
    for s in pair:
        generate(s.port, _prompts()[0], 3)
    snaps = [json.loads(request(s.port, "GET", "/slo")[2]) for s in pair]
    assert set(snaps[1]) == set(snaps[0])
    assert set(snaps[1]["targets"]) == set(snaps[0]["targets"])
    assert snaps[1]["targets"]["ttft"]["metric"] == "znicz_serve_frontdoor_ttft_seconds"
    served = [_Served(m, directory=str(tmp_path)) for m in (jserve, tserve)]
    try:
        fallback = [json.loads(request(s.port, "GET", "/slo")[2]) for s in served]
        assert set(fallback[1]) == set(fallback[0])
        assert fallback[1]["targets"]["ttft"]["metric"] == "znicz_serve_ttft_seconds"
    finally:
        for s in served:
            s.close()


def test_debug_requests_ring(pair):
    rings = []
    for s in pair:
        _, _, _, done = generate(s.port, _prompts()[1], 5)
        status, _, raw = request(s.port, "GET", "/debug/requests")
        assert status == 200
        ring = json.loads(raw)["requests"]
        assert ring[0]["trace_id"] == done["trace_id"]
        rings.append(ring[0])
    assert set(rings[1]) == set(rings[0])
    assert rings[1]["finish_reason"] == rings[0]["finish_reason"]


def test_debug_programs_is_the_port_ledger(pair):
    js, ts = pair
    generate(ts.port, _prompts()[2], 4)
    status, _, raw = request(ts.port, "GET", "/debug/programs")
    assert status == 200
    body = json.loads(raw)
    snap = tdevice.ledger_snapshot()
    assert body["count"] == snap["count"] and body["by_kind"] == snap["by_kind"]
    assert [p["key"] for p in body["programs"]] == [p["key"] for p in snap["programs"]]
    assert body["device_memory"] == [{"device": "cpu:0", "stats": None}]
    jbody = json.loads(request(js.port, "GET", "/debug/programs")[2])
    assert set(body) == set(jbody)


def test_debug_profile_captures_clamps_and_refuses(pair, monkeypatch):
    js, ts = pair
    monkeypatch.setattr(tdevice, "PROFILE_MAX_SECONDS", 0.05)
    status, _, raw = request(ts.port, "POST", "/debug/profile?seconds=5", timeout=60)
    body = json.loads(raw)
    assert status == 200 and body["ok"] is True and body["seconds"] == 0.05
    trace = os.path.join(body["log_dir"], tdevice.PROFILE_TRACE)
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    status, _, raw = request(ts.port, "POST", "/debug/profile?seconds=0", timeout=60)
    assert status == 200 and json.loads(raw)["seconds"] == 0.01
    for bad in ("abc", "nan", "inf"):
        out = [request(s.port, "POST", f"/debug/profile?seconds={bad}") for s in pair]
        assert out[1][0] == out[0][0] == 400
        assert json.loads(out[1][2])["error"] == json.loads(out[0][2])["error"] == "bad_request"
    # busy: another capture holds the profiler
    from znicz_tpu.observability import device as jdevice
    for lock in (jdevice._PROFILE_LOCK, tdevice._PROFILE_LOCK):
        assert lock.acquire(timeout=10)
    try:
        out = [request(s.port, "POST", "/debug/profile?seconds=1") for s in pair]
    finally:
        jdevice._PROFILE_LOCK.release()
        tdevice._PROFILE_LOCK.release()
    assert out[1][0] == out[0][0] == 409
    assert json.loads(out[1][2])["error"] == json.loads(out[0][2])["error"] == "profile_busy"


def test_profile_request_body_is_drained_for_keep_alive(pair):
    """A body on /debug/profile must not be parsed as the next request of a
    kept-alive connection."""
    js, ts = pair
    lock = tdevice._PROFILE_LOCK
    assert lock.acquire(timeout=10)  # answered 409 at once
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ts.port, timeout=30)
        conn.request("POST", "/debug/profile?seconds=1", body=b'{"junk": "x" }')
        resp = conn.getresponse()
        assert resp.status == 409
        resp.read()
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["state"] == "running"
        conn.close()
    finally:
        lock.release()


def test_prefix_probe_equals_jax(pair):
    prompt = [int(t) for t in np.arange(20) % 16 + 1]
    out = []
    for s in pair:
        generate(s.port, prompt, 3)
        status, _, raw = request(s.port, "POST", "/prefix_probe", {"prompt": prompt})
        assert status == 200
        out.append(json.loads(raw))
        assert request(s.port, "POST", "/prefix_probe", {"nope": 1})[0] == 400
    assert out[1] == out[0]
    assert out[1] == pair[1].door.prefix_probe(prompt)


def test_metrics_are_file_first_then_the_registry(both_params, tmp_path):
    served = [_Served(m, directory=str(tmp_path)) for m in (jserve, tserve)]
    try:
        for s in served:
            status, hdrs, raw = request(s.port, "GET", "/metrics")
            assert status == 200 and hdrs["Content-Type"].startswith("text/plain; version=0.0.4")
            assert b"# TYPE" in raw
        prom = ("# HELP znicz_x_total x\n# TYPE znicz_x_total counter\n"
                "znicz_x_total 3\n")
        (tmp_path / "metrics.prom").write_text(prom)
        texts = [request(s.port, "GET", "/metrics")[2] for s in served]
        assert texts[1] == texts[0] == prom.encode()
        snaps = [json.loads(request(s.port, "GET", "/metrics.json")[2]) for s in served]
        assert snaps[1] == snaps[0]
        assert snaps[1]["znicz_x_total"]["series"][0]["value"] == 3.0
    finally:
        for s in served:
            s.close()


def test_client_disconnect_cancels_and_reclaims(both_params):
    tp = both_params[1]
    door = TF.ServingFrontDoor(lambda: TE.PagedDecodeEngine(tp, **KW))
    s = _Served(tserve, door)
    # slow ticks: the 50-token stream takes >= 13 ticks x 0.2 s, so the
    # client is gone long before it could finish, however busy the host
    faults.inject("frontdoor.slow_tick", delay=0.2)
    try:
        sock = socket.create_connection(("127.0.0.1", s.port), timeout=30)
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_new_tokens": 50}).encode()
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while b'{"token"' not in got:
            chunk = sock.recv(4096)
            assert chunk, "server closed before the first token"
            got += chunk
        sock.close()
        deadline = time.monotonic() + 30
        while door.stats()["cancelled"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert door.stats()["cancelled"] == 1
        faults.clear()
        deadline = time.monotonic() + 30
        while door.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        st = door.engine.stats()
        assert st["pool_blocks_free"] == st["pool_blocks"]
    finally:
        faults.clear()
        s.close()


def test_graceful_shutdown_drains_then_stops(both_params):
    tp = both_params[1]
    door = TF.ServingFrontDoor(lambda: TE.PagedDecodeEngine(tp, **KW))
    s = _Served(tserve, door)
    out = {}
    p = _prompts()[1]
    faults.inject("frontdoor.slow_tick", delay=0.02)
    t = threading.Thread(target=lambda: out.update(r=generate(s.port, p, 8)))
    t.start()
    deadline = time.monotonic() + 30
    while door.stats()["submitted"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    tserve.shutdown_gracefully(s.srv, door, grace_s=30.0)
    t.join(timeout=30)
    s.srv.server_close()
    status, _, toks, done = out["r"]
    assert status == 200 and done["finish_reason"] in ("eos", "budget")
    assert [r["token"] for r in toks] == _reference(tp, p, 8)
    assert door.watchdog_state()["state"] == "closed"
    s.thread.join(timeout=10)
    assert not s.thread.is_alive()
    with pytest.raises(OSError):
        request(s.port, "GET", "/healthz", timeout=2)


def test_public_surface_equals_jax():
    for name in ("StatusRequestHandler", "HttpJsonMixin", "build_server", "shutdown_gracefully",
                 "run_server", "main", "PROM_CONTENT_TYPE", "NDJSON_CONTENT_TYPE"):
        assert hasattr(tserve, name)
    assert tserve.PROM_CONTENT_TYPE == jserve.PROM_CONTENT_TYPE
    assert tserve.NDJSON_CONTENT_TYPE == jserve.NDJSON_CONTENT_TYPE
