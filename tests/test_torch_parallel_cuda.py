"""Data parallelism of the port on the card, at a small size.  This file
imports no jax, so it runs on the card with ``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py -q``;
every test is ``cuda``-marked and skips without a card.

- One NCCL rank (``multihost.initialize`` at a free localhost port, the
  group destroyed after the module): the MNIST MLP with the policy equals
  the run without it bitwise, in the step dispatch and in the graph
  dispatch, whose captured step holds the NCCL all-reduces; the Kohonen
  and RBM kernels' psum rules over the one-rank mesh give the step
  without a mesh bitwise.
- Two ranks on the one card over gloo (two processes, each wait with its
  own timeout): the MNIST MLP's losses within rtol 1e-4 of one process on
  the card, the SOM's weights within 1e-5 of max |w|, and
  ``epoch_dispatch="scan"`` refused (a gloo collective on the card cannot
  be captured).
- Two ranks on the one card over gloo as a ``(data=1, model=2)`` mesh:
  Megatron's four operators on the card's tensors give the unsharded
  function's outputs and gradients; a small LM with ``tensor_parallel``
  through the flash kernels (each rank over its 2 local heads) and a conv
  net under ``cnn_tp_rules`` give one process's losses on the card within
  rtol 1e-4.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 300

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def nccl():
    """A one-rank NCCL group for the module's tests (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from znicz_tpu_torch.parallel import DataParallel, make_mesh, multihost

    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        yield DataParallel(make_mesh())
    finally:
        dist.destroy_process_group()


def _mnist(dispatch, parallel=None, resident=True):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import FullBatchLoader
    from znicz_tpu_torch.workflow import StandardWorkflow

    gen = np.random.default_rng(0)
    imgs = gen.integers(0, 256, (500, 64), dtype=np.uint8)  # a padded last batch
    labels = gen.integers(0, 10, 500).astype(np.int32)
    prng.reset()
    prng.seed_all(5)
    loader = FullBatchLoader({"train": imgs[:400], "test": imgs[400:]},
                             {"train": labels[:400], "test": labels[400:]}, minibatch_size=64,
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=resident)
    wf = StandardWorkflow(loader, [{"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
                                   {"type": "softmax", "->": {"output_sample_shape": 10}}],
                          decision_config={"max_epochs": 3},
                          default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
                          epoch_dispatch=dispatch, parallel=parallel, device="cuda")
    wf.initialize(seed=5)
    return wf


def _same(a, b):
    assert a.decision.history == b.decision.history
    for la, lb in zip(a.state.params, b.state.params):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["step", "scan"])
def test_one_nccl_rank_is_the_run_without_the_policy(nccl, dispatch):
    plain = _mnist(dispatch)
    plain.run()
    dp = _mnist(dispatch, nccl)
    assert dp._use_epoch_scan() == (dispatch == "scan")
    dp.run()
    torch.cuda.synchronize()
    _same(plain, dp)
    if dispatch == "scan":
        assert any(r.graph is not None for r in dp._splits.values())


@pytest.mark.cuda
def test_psum_rules_over_one_nccl_rank_are_the_plain_steps(nccl):
    from znicz_tpu_torch.ops import kohonen as kh, rbm as rbm_op
    from znicz_tpu_torch.ops.kernels import kohonen as khk, rbm as rbk

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((100, 784), generator=gen, device="cuda")
    mask = (torch.arange(100, device="cuda") < 90).float()
    coords = kh.grid_coords(8, 8, device="cuda")
    w = {"weights": torch.rand((64, 784), generator=gen, device="cuda")}
    kw = dict(learning_rate=0.1, tss=khk.sigma_tensor(2.0, "cuda"), mask=mask)
    assert torch.equal(khk.train_step(w, x, coords, mesh=nccl.mesh, **kw)["weights"],
                       khk.train_step(w, x, coords, **kw)["weights"])
    params = rbm_op.init_params(784, 128, device="cuda")
    v0 = (x > 0.5).float()
    a = rbk.cd_step(params, v0, rbk.seed_tensor(4, "cuda"), learning_rate=0.1, mask=mask,
                    mesh=nccl.mesh)
    b = rbk.cd_step(params, v0, rbk.seed_tensor(4, "cuda"), learning_rate=0.1, mask=mask)
    assert torch.equal(a[1], b[1])
    for k in params:
        assert torch.equal(a[0][k], b[0][k])


GLOO_WORKER = r'''
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="tcp://" + sys.argv[2], world_size=2,
                        rank=int(sys.argv[3]), timeout=datetime.timedelta(seconds=120))
sys.path.insert(0, sys.argv[1] + "/tests")
from test_torch_parallel_cuda import _mnist, _som
from znicz_tpu_torch.parallel import DataParallel, make_mesh
dp = DataParallel(make_mesh())
out = {"host_collectives": dp.host_collectives}
try:
    _mnist("scan", dp).run_epoch()
    out["scan"] = None
except ValueError as exc:
    out["scan"] = str(exc)
wf = _mnist("auto", dp)
out["auto_scan"] = wf._use_epoch_scan()
out["hist"] = [e["train"]["loss"] for e in wf.run().history]
out["som"] = _som(dp).tolist()
dist.destroy_process_group()
print("OUT=" + json.dumps(out))
'''


def _som(parallel=None):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.workflow import KohonenWorkflow

    prng.reset()
    prng.seed_all(31)
    loader = datasets.mnist(n_train=300, n_test=0, minibatch_size=64, normalization="mean_disp")
    wf = KohonenWorkflow(loader, sx=4, sy=4, total_epochs=2, device="cuda", parallel=parallel)
    wf.initialize(seed=31)
    wf.run()
    return wf.state.params["weights"].cpu().numpy()


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_WORKER, REPO, addr, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        reports.append(json.loads([ln for ln in out.splitlines() if ln.startswith("OUT=")][-1][4:]))
    assert reports[0] == reports[1]
    got = reports[0]
    assert got["host_collectives"] and not got["auto_scan"]
    assert got["scan"] and "gloo" in got["scan"]
    one = _mnist("step")
    np.testing.assert_allclose(got["hist"], [e["train"]["loss"] for e in one.run().history],
                               rtol=1e-4)
    ref = _som()
    assert np.abs(np.asarray(got["som"]) - ref).max() <= 1e-5 * np.abs(ref).max()


TP_WORKER = r'''
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="tcp://" + sys.argv[2], world_size=2,
                        rank=int(sys.argv[3]), timeout=datetime.timedelta(seconds=120))
sys.path.insert(0, sys.argv[1] + "/tests")
from test_torch_parallel_cuda import _tp_conv, _tp_lm, _tp_operators
from znicz_tpu_torch.parallel import DataParallel, make_mesh
from znicz_tpu_torch.ops.kernels import attention as fa
dp = DataParallel(make_mesh(1, 2))
out = {"ops": _tp_operators(dp)}
fa.flash_fwd.launches = 0
out["lm"] = _tp_lm(dp)
out["flash"] = [fa.flash_fwd.launches, list(fa.flash_fwd.last_shape)]
out["conv"] = _tp_conv(dp)
dist.destroy_process_group()
print("OUT=" + json.dumps(out))
'''


def _tp_operators(dp):
    """Each conjugate operator's forward and its input's gradient, on this
    rank's block where the operator shards, against the unsharded function
    on the card: the largest absolute differences."""
    from znicz_tpu_torch.parallel import tensor_parallel as tp_ops

    g, m = dp.model_group, dp.model_index
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(4, 6, device="cuda", generator=gen)
    w = torch.randn(6, 8, device="cuda", generator=gen)
    errs = {}
    # column then row: copy, local product, reduce; against x @ w @ w.T
    xa = x.clone().requires_grad_(True)
    wl = w[:, 4 * m:4 * m + 4]
    y = tp_ops.reduce_from_model(tp_ops.copy_to_model(xa, g) @ wl @ wl.t(), g)
    y.sum().backward()
    xb = x.clone().requires_grad_(True)
    (xb @ w @ w.t()).sum().backward()
    errs["copy_reduce"] = [float((y - xb @ w @ w.t()).abs().max()),
                           float((xa.grad - xb.grad).abs().max())]
    xa = x.clone().requires_grad_(True)
    z = tp_ops.gather_from_model(tp_ops.scatter_to_model(xa, -1, g) * (m + 1.0), -1, g)
    (z * z).sum().backward()
    scale = torch.tensor([1.0] * 3 + [2.0] * 3, device="cuda")
    xb = x.clone().requires_grad_(True)
    ((xb * scale) ** 2).sum().backward()
    errs["scatter_gather"] = [float((z - x * scale).abs().max()),
                              float((xa.grad - xb.grad).abs().max())]
    return errs


def _tp_lm(parallel=None):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import FullBatchLoader
    from znicz_tpu_torch.workflow import TransformerLMWorkflow

    tokens = np.random.default_rng(7).integers(0, 64, (16, 128)).astype(np.int32)
    prng.reset()
    prng.seed_all(12)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=8), vocab=64,
                               d_model=128, n_layers=2, n_heads=4, max_epochs=2,
                               attention="flash", device="cuda", parallel=parallel,
                               tensor_parallel=parallel is not None)
    wf.initialize(seed=12)
    return [e["train"]["loss"] for e in wf.run().history]


def _tp_conv(parallel=None):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.parallel import DataParallel
    from znicz_tpu_torch.workflow import StandardWorkflow

    prng.reset()
    prng.seed_all(77)
    wf = StandardWorkflow(
        datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
        [{"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
         {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
         {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
         {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
         {"type": "softmax", "->": {"output_sample_shape": 10}}],
        decision_config={"max_epochs": 2},
        default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9}, device="cuda",
        parallel=None if parallel is None else DataParallel(parallel.mesh, tp=True))
    wf.initialize(seed=77)
    return [e["train"]["loss"] for e in wf.run().history]


@pytest.mark.cuda
def test_two_gloo_tensor_parallel_ranks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", TP_WORKER, REPO, addr, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        reports.append(json.loads([ln for ln in out.splitlines() if ln.startswith("OUT=")][-1][4:]))
    for r in reports:
        for name, (fwd, grad) in r["ops"].items():
            assert fwd <= 1e-5 and grad <= 1e-5, (name, fwd, grad)
        assert r["flash"][0] == 2 * 2 * 2 and r["flash"][1][2] == 2  # 2 local heads
    assert reports[0]["lm"] == reports[1]["lm"] and reports[0]["conv"] == reports[1]["conv"]
    np.testing.assert_allclose(reports[0]["lm"], _tp_lm(), rtol=1e-4)
    np.testing.assert_allclose(reports[0]["conv"], _tp_conv(), rtol=1e-4)
