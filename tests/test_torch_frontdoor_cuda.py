"""The port's front door and HTTP server on their own terms; on the card.
This file imports no jax, so it runs on the card with ``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_frontdoor_cuda.py -q``.

On the CPU: a door stream equals the engine alone on the same stream, and
``/debug/programs`` and ``/debug/profile`` answer while the door serves.
On the card (``cuda``-marked, skipped without one), at 2 layers: a door
stream (its programs captured into CUDA graphs on the door's engine
thread, one graph a key) gives the tokens of the same engine run eagerly
(``cuda_graphs=False``); an engine crash mid-stream fails the slot-resident
request with a typed error, the door drops the dead engine before the
factory runs, the rebuilt engine captures its own graphs and serves the
re-admitted requests' goldens, and no program is ledgered anew;
``/debug/programs`` carries ``cuda:0``'s memory and ``/debug/profile``'s
trace holds the engine's CUDA kernels.
"""

import http.client
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from znicz_tpu_torch import observability as obs
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.observability import device as device_telemetry
from znicz_tpu_torch.services import PagedDecodeEngine, ServingFrontDoor
from znicz_tpu_torch.services import serve
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G
from znicz_tpu_torch.workflow.transformer import init_lm_params

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

HEADS = 4
EOS = 14
KW = dict(n_heads=HEADS, eos_id=EOS, batch_size=3, block_size=8, max_seq=64, admit_every=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _params(device, seed=27, d_model=32):
    prng.reset()
    prng.seed_all(seed)
    params = init_lm_params(17, d_model, 2, HEADS, 64, device=device)
    prng.reset()
    return params


def _stream(seed=7, lengths=(5, 12, 3, 20, 9, 30, 6), budgets=(6, 9, 12, 7, 8, 4, 10)):
    gen = np.random.default_rng(seed)
    return [(gen.integers(0, 17, (n,)).astype(np.int32), b) for n, b in zip(lengths, budgets)]


def _alone(params, reqs, **kw):
    eng = PagedDecodeEngine(params, **{**KW, **kw})
    ids = [eng.submit(p, b) for p, b in reqs]
    eng.run()
    return [eng.completions[i].tokens.tolist() for i in ids], eng


def _long_prompt(params, budget=30, seed=21):
    """A prompt whose greedy generation does not hit EOS within ``budget``."""
    gen = np.random.default_rng(seed)
    for _ in range(200):
        p = gen.integers(0, 17, (6,)).astype(np.int32)
        out = G.generate(params, p[None], n_heads=HEADS, max_new_tokens=budget,
                         eos_id=EOS).cpu().numpy()[0]
        if EOS not in out[len(p):]:
            return p
    raise AssertionError("no EOS-free prompt found in 200 draws")


def _through_door(door, reqs):
    handles = [door.submit(p, b) for p, b in reqs]
    streams = [list(h.tokens(timeout=120.0)) for h in handles]
    comps = [h.result(timeout=120.0) for h in handles]
    for (p, _), s, c in zip(reqs, streams, comps):
        assert s == c.tokens[len(p):].tolist()
        assert c.finish_reason in ("eos", "budget")
    return [c.tokens.tolist() for c in comps]


def _swept(door):
    st = door.engine.stats()
    return st["pool_blocks_free"] == st["pool_blocks"]


def _get(port, method, path, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_door_stream_equals_the_engine_alone_on_the_cpu():
    params = _params("cpu")
    reqs = _stream()
    want, _ = _alone(params, reqs)
    with ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW)) as door:
        assert _through_door(door, reqs) == want
        assert _swept(door)


def test_debug_endpoints_answer_while_the_door_serves_on_the_cpu():
    params = _params("cpu")
    with ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW)) as door:
        srv = serve.build_server(port=0, frontdoor=door)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        try:
            handles = [door.submit(p, b) for p, b in _stream()]
            status, body = _get(port, "POST", "/debug/profile?seconds=0.05")
            assert status == 200
            assert os.path.exists(os.path.join(body["log_dir"], device_telemetry.PROFILE_TRACE))
            status, body = _get(port, "GET", "/debug/programs")
            want = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                    if torch.cuda.is_available() else ["cpu:0"])
            assert status == 200 and [d["device"] for d in body["device_memory"]] == want
            for h in handles:
                assert h.result(timeout=60.0).finish_reason in ("eos", "budget")
        finally:
            srv.shutdown()
            srv.server_close()


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _graphs(eng):
    st = eng.compile_stats()
    return sum(v for k, v in st.items() if k.endswith("_graph_entries")), len(st["programs"])


@pytest.mark.cuda
def test_door_stream_on_the_card_equals_the_eager_engine(card):
    params = _params(card)
    reqs = _stream()
    want, _ = _alone(params, reqs, cuda_graphs=False)
    with ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW)) as door:
        assert _through_door(door, reqs) == want
        graphs, programs = _graphs(door.engine)
        assert graphs == programs >= 2
        assert all(p.graph is not None for p in door.engine._progs.values())
        # a second pass replays: no new capture, the same tokens
        captured = dict(door.engine.capture_s)
        assert _through_door(door, reqs) == want
        assert door.engine.capture_s == captured
        assert _swept(door)


@pytest.mark.cuda
def test_watchdog_restart_recaptures_and_serves_the_goldens(card):
    params = _params(card)
    victim = _long_prompt(params)
    gen = np.random.default_rng(22)
    queued = [(gen.integers(0, 17, (n,)).astype(np.int32), 6) for n in (5, 11)]
    one = dict(batch_size=1, admit_every=2)
    want, _ = _alone(params, queued, cuda_graphs=False, **one)
    # every program key the scenario can reach, ledgered before it starts
    _alone(params, [(victim, 30)] + queued, **one)
    held = []
    door = dead = None

    def factory():
        if door is not None:
            held.append((door._engine is not None, dead() is not None))
        return PagedDecodeEngine(params, **{**KW, **one})

    compiles = obs.get_registry().metrics()["znicz_serve_compiles_total"]
    faults.inject("frontdoor.slow_tick", delay=0.05)
    door = ServingFrontDoor(factory, engine_queue_limit=1)
    try:
        dead = weakref.ref(door.engine)
        hv = door.submit(victim, 30)
        next(hv.tokens(timeout=120.0))
        handles = [door.submit(p, b) for p, b in queued]
        before = {k: c.value for k, c in compiles.children().items()}
        faults.inject("engine.decode_step", exc=RuntimeError("card fell over"), times=1)
        comp = hv.result(timeout=120.0)
        faults.clear("frontdoor.slow_tick")
        assert comp.finish_reason == "error" and "card fell over" in comp.error
        got = [h.result(timeout=120.0).tokens.tolist() for h in handles]
        assert got == want
        assert door.stats()["watchdog_restarts"] == 1
        assert held == [(False, False)]  # the dead engine was dropped and freed first
        assert door.engine is not None and dead() is None
        graphs, programs = _graphs(door.engine)
        assert graphs == programs >= 2  # the rebuilt engine captured its own
        assert {k: c.value for k, c in compiles.children().items()} == before
        assert _swept(door)
    finally:
        door.close(grace_s=10.0)


@pytest.mark.cuda
def test_debug_endpoints_read_the_card(card):
    params = _params(card)
    with ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW)) as door:
        srv = serve.build_server(port=0, frontdoor=door)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        try:
            _through_door(door, _stream())  # every program captured
            # traffic until the capture answers: a process's first capture
            # starts CUPTI for seconds before its window opens
            answered = threading.Event()

            def traffic():
                while not answered.is_set():
                    _through_door(door, _stream(seed=9))

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            try:
                status, body = _get(port, "POST", "/debug/profile?seconds=0.5", timeout=300)
            finally:
                answered.set()
                t.join(timeout=300)
            assert status == 200
            with open(os.path.join(body["log_dir"], device_telemetry.PROFILE_TRACE)) as f:
                events = json.load(f)["traceEvents"]
            assert any(e.get("cat") == "kernel" for e in events)
            status, body = _get(port, "GET", "/debug/programs")
            assert status == 200
            mem = {d["device"]: d["stats"] for d in body["device_memory"]}
            assert set(mem) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}
            assert all(mem["cuda:0"][k] > 0 for k in (
                "bytes_in_use", "peak_bytes_in_use", "bytes_limit"))
        finally:
            srv.shutdown()
            srv.server_close()
