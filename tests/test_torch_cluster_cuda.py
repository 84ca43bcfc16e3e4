"""The port's router in front of two port replicas, on its own terms; on the
card.  This file imports no jax, so it runs on the card with ``python3 -m
pytest --noconftest -p no:cacheprovider tests/test_torch_cluster_cuda.py -q``.

Two replicas (the port's front door over the port's paged engine behind
the port's HTTP server) and the port's router, in this process, at 2
layers.  On the CPU and on the card (``cuda``-marked, skipped without one):
an interleaved family stream through the router gives the engine alone's
tokens, each family on one replica; a replica's engine crashing
mid-stream is re-routed with the delivered prefix skipped and the client's
stream is the uninterrupted golden; a stream read dying mid-stream is the
same; the pools sweep back to free and no program is made beyond the
engine alone's.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from znicz_tpu_torch.cluster import ServingRouter, build_router_server
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.services import PagedDecodeEngine, ServingFrontDoor
from znicz_tpu_torch.services import serve
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G
from znicz_tpu_torch.workflow.transformer import init_lm_params

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

HEADS = 4
EOS = 14
BS = 8
KW = dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=64, admit_every=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _params(device, seed=27):
    prng.reset()
    prng.seed_all(seed)
    params = init_lm_params(17, 32, 2, HEADS, 64, device=device)
    prng.reset()
    return params


def _alone(params, reqs):
    """The engine alone on every request at once: tokens and programs."""
    eng = PagedDecodeEngine(params, **KW)
    ids = [eng.submit(p, b) for p, b in reqs]
    eng.run()
    return [eng.completions[i].tokens.tolist() for i in ids], set(eng.compile_stats()["programs"])


def _families(seed=5):
    gen = np.random.default_rng(seed)
    shared = [gen.integers(0, 17, (2 * BS,)).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([shared[f], gen.integers(0, 17, (5,)).astype(np.int32)]), 12)
            for _ in range(3) for f in range(2)]


def _long_prompt(params, budget=12, seed=37):
    """A prompt of three blocks whose greedy stream does not end early."""
    gen = np.random.default_rng(seed)
    for _ in range(200):
        p = gen.integers(0, 17, (2 * BS + 3,)).astype(np.int32)
        out = G.generate(params, p[None], n_heads=HEADS, max_new_tokens=budget,
                         eos_id=EOS).cpu().numpy()[0]
        if EOS not in out[len(p):]:
            return p
    raise AssertionError("no EOS-free prompt found in 200 draws")


class _Fleet:
    def __init__(self, params):
        self.doors, self.srvs = [], []
        for _ in range(2):
            door = ServingFrontDoor(lambda: PagedDecodeEngine(params, **KW), max_pending=8)
            srv = serve.build_server(port=0, frontdoor=door)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.doors.append(door)
            self.srvs.append(srv)
        self.router = ServingRouter(block_size=BS, heartbeat_interval_s=60.0)
        for i, srv in enumerate(self.srvs):
            self.router.register(f"rep-{i}", f"http://127.0.0.1:{srv.server_address[1]}")
        self.rsrv = build_router_server(self.router, port=0)
        threading.Thread(target=self.rsrv.serve_forever, daemon=True).start()

    def post(self, prompt, budget):
        conn = http.client.HTTPConnection("127.0.0.1", self.rsrv.server_address[1], timeout=120)
        try:
            conn.request("POST", "/generate", body=json.dumps(
                {"prompt": [int(t) for t in prompt], "max_new_tokens": budget}))
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            recs = [json.loads(line) for line in resp.read().decode().splitlines()]
        finally:
            conn.close()
        assert recs[-1]["done"] and recs[-1]["finish_reason"] in ("eos", "budget")
        return [int(p) for p in prompt] + [r["token"] for r in recs if "token" in r], recs[-1]

    def settled(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # a door between a crashed engine and its rebuilt one has none
            engines = [d.engine for d in self.doors]
            if all(e is not None for e in engines) and not any(
                    d.has_work() for d in self.doors) and all(
                    e.stats()["pool_blocks_free"] == e.stats()["pool_blocks"] for e in engines):
                return True
            time.sleep(0.01)
        return False

    def programs(self):
        return [set(d.engine.compile_stats()["programs"]) for d in self.doors]

    def close(self):
        for srv in self.srvs + [self.rsrv]:
            srv.shutdown()
            srv.server_close()
        for door in self.doors:
            door.close(grace_s=10.0)
        self.router.close()


def _families_golden(device):
    params = _params(device)
    reqs = _families()
    want, programs = _alone(params, reqs)
    fleet = _Fleet(params)
    try:
        placed = {}
        for j, (p, b) in enumerate(reqs):
            tokens, done = fleet.post(p, b)
            assert tokens == want[j], f"request {j}"
            assert done["router"]["retries"] == 0
            placed.setdefault(j % 2, set()).add(done["router"]["replica"])
        assert fleet.settled()
        assert all(progs <= programs for progs in fleet.programs())
    finally:
        fleet.close()
    assert len(placed[0]) == len(placed[1]) == 1 and placed[0] != placed[1]


def _crash_golden(device, point, **arm):
    params = _params(device)
    prompt = _long_prompt(params)
    (want,), _ = _alone(params, [(prompt, 12)])
    fleet = _Fleet(params)
    try:
        fleet.post(np.arange(1, 6, dtype=np.int32), 4)  # each program made before the crash
        fleet.post(np.arange(2, 7, dtype=np.int32), 4)
        faults.inject(point, **arm)
        tokens, done = fleet.post(prompt, 12)
        assert tokens == want
        assert done["router"]["retries"] == 1
        assert fleet.settled()
        return [d.stats()["watchdog_restarts"] for d in fleet.doors]
    finally:
        fleet.close()


def test_families_through_the_router_equal_the_engine_alone_on_the_cpu():
    _families_golden("cpu")


def test_an_engine_crash_mid_stream_is_rerouted_golden_on_the_cpu():
    restarts = _crash_golden("cpu", "engine.decode_step", exc=RuntimeError("replica died"),
                             after=1, times=1)
    assert sorted(restarts) == [0, 1]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_families_through_the_router_equal_the_engine_alone_on_the_card(card):
    _families_golden(card)


@pytest.mark.cuda
def test_an_engine_crash_mid_stream_is_rerouted_golden_on_the_card(card):
    restarts = _crash_golden(card, "engine.decode_step", exc=RuntimeError("replica died"),
                             after=1, times=1)
    assert sorted(restarts) == [0, 1]


@pytest.mark.cuda
def test_a_stream_read_dying_mid_stream_is_rerouted_golden_on_the_card(card):
    assert _crash_golden(card, "router.stream", after=3, times=1) == [0, 0]
