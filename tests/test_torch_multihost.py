"""Two-process data parallelism of the port on the CPU, against the JAX
package's single-process runs and the port's own.

Each test starts two port processes (``python -c``, importing no jax) that
meet through ``multihost.initialize`` at a localhost TCP port taken from a
bound socket and train over a gloo group, one rank a process; every wait
has its own timeout and the processes are killed in ``finally``.  As in
``tests/test_multihost.py``: the rendezvous and the one-coordinator
contract; the MNIST MLP (a padded last batch in both splits: 250 train and
70 test rows at batch 64, so one rank holds only padding of the last test
batch) against the port's one-process run and the JAX package's: per-epoch
loss and final weights within rtol 1e-4 (atol 1e-5 on the weights), n_err
equal, both ranks' histories equal, and only the coordinator wrote
snapshots, and ``evaluate``'s confusion summed over the ranks equals the
one-process run's exactly; a NaN read on every rank at one step, under
sync and deferred epoch sync: both ranks roll back once together and end
as the one-process run with the same fault; a kill of one rank and the
resume of both from the coordinator's snapshot, continuing as the
uninterrupted run; the resident pool's scan dispatch; ``python -m
znicz_tpu_torch --mesh`` over two ranks at ``--device cpu`` (the JAX
package's ``test_cli_mesh_flag_builds_tp_dataparallel``), against JAX's
launcher on the same command line.  The models' runs (the pool-sharded pool, the SOM,
the RBM's psum rule, the small LM) are in
``tests/test_torch_multihost_models.py``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 240  # each worker's wait; there is no pytest-timeout here
RTOL = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5

# every worker: argv = [repo, address, world, rank, *args]; the body ends
# by calling report(...), printed as one JSON line tagged with the rank
WORKER_HEAD = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from znicz_tpu_torch.parallel import DataParallel, make_mesh, multihost
INFO = multihost.initialize(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
RANK = int(sys.argv[4])
ARGS = sys.argv[5:]
torch.set_float32_matmul_precision("highest")

def report(**kw):
    print("OUT=" + json.dumps(kw), flush=True)

def history(dec, *splits):
    return [{f"{s}_{k}": e[s][k] for s in splits for k in ("loss", "n_err")}
            for e in dec.history]
'''

# every worker's last lines: its process group torn down before the
# interpreter exits (what held the group dropped first), since a group
# still alive while the interpreter clears its modules can abort the rank
# at exit ("terminate called without an active exception")
WORKER_TAIL = r'''
import gc
for _name in [n for n, v in globals().items()
              if not n.startswith("__") and not isinstance(v, type(gc))]:
    del globals()[_name]
gc.collect()
if dist.is_initialized():
    dist.destroy_process_group()
'''

MLP = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]
MNIST = dict(n_train=250, n_test=70, minibatch_size=64)
HYPER = {"learning_rate": 0.1, "gradient_moment": 0.9}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(body, *args, world=2):
    addr = f"127.0.0.1:{free_port()}"
    return [
        subprocess.Popen(
            [sys.executable, "-c", WORKER_HEAD + body + WORKER_TAIL, REPO, addr,
             str(world), str(r), *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]


def run_ranks(body, *args, world=2, timeout=WAIT_S):
    """Run ``body`` on ``world`` ranks; returns each rank's report."""
    procs = start_ranks(body, *args, world=world)
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("OUT=")]
        assert lines, out
        reports.append(json.loads(lines[-1][4:]))
    return reports


def jax_mnist(max_epochs):
    from znicz_tpu.core import prng
    from znicz_tpu.loader import datasets
    from znicz_tpu.workflow import StandardWorkflow

    prng.reset()
    prng.seed_all(99)
    wf = StandardWorkflow(datasets.mnist(**MNIST), MLP, decision_config={"max_epochs": max_epochs},
                          default_hyper=HYPER, prefetch_batches=0)
    wf.initialize(seed=99)
    dec = wf.run()
    import jax

    weights = [np.asarray(layer[k]) for layer in jax.device_get(wf.state.params)
               for k in sorted(layer)]
    return dec.history, weights


def port_mnist(max_epochs, evaluate=False):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.workflow import StandardWorkflow

    prng.reset()
    prng.seed_all(99)
    wf = StandardWorkflow(datasets.mnist(**MNIST), MLP, decision_config={"max_epochs": max_epochs},
                          default_hyper=HYPER, device="cpu")
    wf.initialize(seed=99)
    dec = wf.run()
    weights = [layer[k].detach().numpy().copy() for layer in wf.state.params
               for k in sorted(layer)]
    if evaluate:
        return dec.history, weights, wf.evaluate("test", confusion=True)
    return dec.history, weights


def same_history(hist, ref, splits=("train", "test")):
    assert len(hist) == len(ref)
    for got, want in zip(hist, ref):
        for s in splits:
            assert got[f"{s}_n_err"] == want[s]["n_err"], (s, got, want[s])
            np.testing.assert_allclose(got[f"{s}_loss"], want[s]["loss"], rtol=RTOL)


RENDEZVOUS = r'''
flags = torch.tensor([1.0 if multihost.is_coordinator() else 0.0])
dist.all_reduce(flags)
local = torch.ones(4) * (RANK + 1)
dist.all_reduce(local)
mesh = make_mesh()
dp = DataParallel(mesh)
errors = []
try:
    make_mesh(3)
except (ValueError, NotImplementedError) as exc:
    errors.append(str(exc))
tp = DataParallel(make_mesh(1, 2), tp=True)
from znicz_tpu_torch.loader import FullBatchLoader
from znicz_tpu_torch.workflow import TransformerLMWorkflow
lm = TransformerLMWorkflow(FullBatchLoader({"train": np.zeros((8, 6), np.int32)}, minibatch_size=4),
                           vocab=8, d_model=8, n_layers=1, n_heads=2, moe_experts=2,
                           moe_dispatch="capacity", parallel=dp, device="cpu")
lm.initialize(seed=1)
lm_loss = lm.run_epoch()["summary"]["train"]["loss"]
(summed,) = dp.all_reduce([torch.arange(3.0) * (RANK + 1)])
(peak,) = dp.all_reduce([torch.arange(3.0) * (RANK + 1)], "max")
report(info=INFO, flags=float(flags[0]), total=float(local.sum()), shape=list(mesh.mesh.shape),
       n_data=dp.n_data, index=dp.index, coordinate=list(mesh.get_coordinate()),
       summed=summed.tolist(), peak=peak.tolist(), errors=errors,
       shard=list(dp.shard_batch(np.zeros((3, 2))).shape),
       tp=[list(tp.mesh.mesh.shape), tp.n_data, tp.n_model, tp.tp, tp.index, tp.model_index,
           tp.group is None], lm_loss=lm_loss)
'''


def test_two_process_rendezvous_and_one_coordinator():
    reports = run_ranks(RENDEZVOUS)
    for rank, r in enumerate(reports):
        assert r["info"] == {"process_index": rank, "process_count": 2, "local_devices": 1,
                             "global_devices": 2}
        assert r["flags"] == 1.0  # exactly one coordinator
        assert r["total"] == 12.0  # 4*1 + 4*2
        assert r["shape"] == [2, 1] and r["n_data"] == 2
        assert r["index"] == rank and r["coordinate"] == [rank, 0]
        assert r["summed"] == [0.0, 3.0, 6.0] and r["peak"] == [0.0, 2.0, 4.0]
        assert r["shard"] == [3, 2]
        assert r["errors"] == ["mesh 3x1x1 needs 3 devices, have 2"]
        # a model axis of 2 (ROADMAP.md A6 is done): both ranks on data row
        # 0, model positions 0 and 1, no data group to reduce over
        assert r["tp"] == [[1, 2], 1, 2, True, 0, rank, True]
        # capacity dispatch over two data ranks: slots from the global batch
        assert np.isfinite(r["lm_loss"])
    assert reports[0]["lm_loss"] == reports[1]["lm_loss"]


MNIST_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.workflow import StandardWorkflow
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
prng.seed_all(99)
wf = StandardWorkflow(
    datasets.mnist(n_train=250, n_test=70, minibatch_size=64),
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 3},
    default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9}, device="cpu")
wf.parallel = DataParallel(make_mesh())
# a directory a rank: only the coordinator's may hold files
wf.snapshotter = Snapshotter(os.path.join(ARGS[0], f"proc{RANK}"), interval=1)
wf.initialize(seed=99)
assert wf.loader.process_count == 2 and wf.loader.process_index == RANK
dec = wf.run()
np.savez(os.path.join(ARGS[0], f"w{RANK}.npz"),
         *[layer[k].detach().numpy() for layer in wf.state.params for k in sorted(layer)])
ev = wf.evaluate("test", confusion=True)
report(hist=history(dec, "train", "test"), batch=wf.loader.max_minibatch_size,
       evaluate={k: (v.tolist() if k == "confusion" else v) for k, v in ev.items()})
'''


def test_two_process_mnist_matches_one_process_and_jax(tmp_path):
    reports = run_ranks(MNIST_WORKER, tmp_path)
    assert reports[0]["hist"] == reports[1]["hist"]  # one global history
    port_hist, port_w, port_eval = port_mnist(3, evaluate=True)
    # evaluate: the ranks' metrics and confusion summed over the data axis
    assert reports[0]["evaluate"] == reports[1]["evaluate"]
    got = reports[0]["evaluate"]
    np.testing.assert_array_equal(np.asarray(got["confusion"]), port_eval["confusion"])
    assert got["n_samples"] == port_eval["n_samples"] == 70.0
    assert got["n_err"] == port_eval["n_err"]
    np.testing.assert_allclose(got["loss"], port_eval["loss"], rtol=RTOL)
    jax_hist, jax_w = jax_mnist(3)
    same_history(reports[0]["hist"], port_hist)
    same_history(reports[0]["hist"], jax_hist)
    for rank in (0, 1):
        got = np.load(tmp_path / f"w{rank}.npz")
        for i, (pw, jw) in enumerate(zip(port_w, jax_w)):
            np.testing.assert_allclose(got[f"arr_{i}"], pw, rtol=RTOL_W, atol=ATOL_W)
            np.testing.assert_allclose(got[f"arr_{i}"], jw, rtol=RTOL_W, atol=ATOL_W)
    wrote0 = os.listdir(tmp_path / "proc0")
    wrote1 = os.listdir(tmp_path / "proc1")
    assert any(f.startswith("workflow_epoch") for f in wrote0), wrote0
    assert wrote1 == [], wrote1


KILL_WORKER = r'''
import signal
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.workflow import StandardWorkflow
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
phase, snap_dir = ARGS
prng.seed_all(99)
wf = StandardWorkflow(
    datasets.mnist(n_train=250, n_test=70, minibatch_size=64),
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 5},
    default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9}, device="cpu",
    parallel=DataParallel(make_mesh()))
# ONE shared directory: only the coordinator's writer flag is set
wf.snapshotter = Snapshotter(snap_dir, interval=1)
if phase == "kill":
    wf.initialize(seed=99)
    for done in range(1, 6):
        v = wf.run_epoch()
        if RANK == 1 and done == 3:
            # epoch 2's snapshot is durable, epoch 3 is in flight on the peer
            os.kill(os.getpid(), signal.SIGKILL)
        if v["stop"]:
            break
    report(done=True)
else:
    wf.initialize(snapshot=os.path.join(snap_dir, "workflow_epoch2.pickle.gz"))
    assert wf.decision.epoch == 3, wf.decision.epoch
    report(hist=history(wf.run(), "train"))
'''


def test_kill_and_resume_from_the_coordinators_snapshot(tmp_path):
    snap_dir = str(tmp_path / "snaps")
    procs = start_ranks(KILL_WORKER, "kill", snap_dir)
    try:
        deadline = time.time() + WAIT_S
        while procs[1].poll() is None and time.time() < deadline:
            time.sleep(0.2)
        assert procs[1].returncode == -signal.SIGKILL, procs[1].communicate(timeout=10)
        time.sleep(2.0)  # the coordinator's in-flight snapshot write, if any
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
    assert "workflow_epoch2.pickle.gz" in os.listdir(snap_dir)
    reports = run_ranks(KILL_WORKER, "resume", snap_dir)
    assert reports[0]["hist"] == reports[1]["hist"]
    assert len(reports[0]["hist"]) == 5  # restored epochs 0-2, resumed 3-4
    same_history(reports[0]["hist"], port_mnist(5)[0], ("train",))
    same_history(reports[0]["hist"], jax_mnist(5)[0], ("train",))


ROLLBACK_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import StandardWorkflow
from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
sync, snap_dir = ARGS[0], ARGS[1] if len(ARGS) > 1 else None
prng.seed_all(99)
policy = RecoveryPolicy(max_rollbacks=2, lr_backoff=1.0, perturb=False)
wf = StandardWorkflow(
    datasets.mnist(n_train=250, n_test=70, minibatch_size=64),
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 3},
    default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9}, device="cpu",
    epoch_sync=sync, recovery=policy, parallel=DataParallel(make_mesh()))
if snap_dir:
    wf.snapshotter = Snapshotter(snap_dir, interval=1)
wf.initialize(seed=99)
# every rank reads a NaN loss at the same step: all roll back together
faults.inject("train.step_nan", flag=True, times=1, after=5)
dec = wf.run()
report(hist=history(dec, "train"), rollbacks=policy.rollbacks_used)
'''


@pytest.mark.parametrize("sync", ["sync", "deferred"])
def test_two_process_rollback_matches_one_process(tmp_path, sync):
    """A NaN watch reading at step 5 on every rank: the reduced loss and
    norms make every rank's detector decide alike, so both ranks roll back
    once (sync: the epoch-start buffer; deferred: the coordinator's newest
    snapshot, read by both) and replay, ending as the one-process run
    with the same fault."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.utils import faults
    from znicz_tpu_torch.workflow import StandardWorkflow
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
    from znicz_tpu_torch.workflow.snapshotter import Snapshotter

    args = (sync,) if sync == "sync" else (sync, tmp_path / "ranks")
    reports = run_ranks(ROLLBACK_WORKER, *args)
    assert reports[0] == reports[1] and reports[0]["rollbacks"] == 1
    prng.reset()
    prng.seed_all(99)
    policy = RecoveryPolicy(max_rollbacks=2, lr_backoff=1.0, perturb=False)
    wf = StandardWorkflow(datasets.mnist(**MNIST), MLP, decision_config={"max_epochs": 3},
                          default_hyper=HYPER, device="cpu", epoch_sync=sync, recovery=policy)
    if sync == "deferred":
        wf.snapshotter = Snapshotter(str(tmp_path / "one"), interval=1)
    wf.initialize(seed=99)
    faults.inject("train.step_nan", flag=True, times=1, after=5)
    try:
        dec = wf.run()
    finally:
        faults.clear()
    assert policy.rollbacks_used == 1
    same_history(reports[0]["hist"], dec.history, ("train",))


SCAN_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import FullBatchLoader
from znicz_tpu_torch.workflow import StandardWorkflow
gen = np.random.default_rng(0)
imgs = gen.integers(0, 256, (250, 64), dtype=np.uint8)
labels = gen.integers(0, 10, 250).astype(np.int32)
prng.seed_all(77)
loader = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=64,
                         normalization="range",
                         normalization_kwargs={"scale": 255.0, "shift": -0.5},
                         device_resident=True)
wf = StandardWorkflow(loader,
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 3},
    default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9}, device="cpu",
    parallel=DataParallel(make_mesh()))
wf.initialize(seed=77)
assert wf._use_epoch_scan(), "a device-resident loader takes the scan dispatch"
report(hist=history(wf.run(), "train"))
'''


def _scan_reference(framework):
    gen = np.random.default_rng(0)
    imgs = gen.integers(0, 256, (250, 64), dtype=np.uint8)
    labels = gen.integers(0, 10, 250).astype(np.int32)
    kw = dict(minibatch_size=64, normalization="range",
              normalization_kwargs={"scale": 255.0, "shift": -0.5}, device_resident=True)
    if framework == "jax":
        from znicz_tpu.core import prng
        from znicz_tpu.loader import FullBatchLoader
        from znicz_tpu.workflow import StandardWorkflow

        extra = {"prefetch_batches": 0}
    else:
        from znicz_tpu_torch.core import prng
        from znicz_tpu_torch.loader import FullBatchLoader
        from znicz_tpu_torch.workflow import StandardWorkflow

        extra = {"device": "cpu"}
    prng.reset()
    prng.seed_all(77)
    wf = StandardWorkflow(FullBatchLoader({"train": imgs}, {"train": labels}, **kw), MLP,
                          decision_config={"max_epochs": 3}, default_hyper=HYPER, **extra)
    wf.initialize(seed=77)
    assert wf._use_epoch_scan()
    return wf.run().history


def test_two_process_resident_scan_matches_one_process_and_jax():
    reports = run_ranks(SCAN_WORKER)
    assert reports[0]["hist"] == reports[1]["hist"]
    for framework in ("port", "jax"):
        same_history(reports[0]["hist"], _scan_reference(framework), ("train",))


@pytest.mark.parametrize("body,match", [
    ("from znicz_tpu_torch.loader import datasets\n"
     "from znicz_tpu_torch.workflow import StandardWorkflow\n"
     "wf = StandardWorkflow(datasets.mnist(n_train=64, n_test=0, minibatch_size=32),\n"
     "    [{'type': 'softmax', '->': {'output_sample_shape': 10}}], device='cpu')\n",
     "multi-host training needs a DataParallel"),
    ("from znicz_tpu_torch.loader import datasets\n"
     "from znicz_tpu_torch.workflow import StandardWorkflow\n"
     "wf = StandardWorkflow(datasets.mnist(n_train=64, n_test=0, minibatch_size=33),\n"
     "    [{'type': 'softmax', '->': {'output_sample_shape': 10}}], device='cpu',\n"
     "    parallel=DataParallel(make_mesh()))\n",
     "minibatch_size 33 not divisible by process_count 2"),
], ids=["no_policy", "indivisible_batch"])
def test_two_process_configuration_errors(body, match):
    reports = run_ranks(body + (
        "try:\n    wf.initialize(seed=1)\n    report(error=None)\n"
        "except ValueError as exc:\n    report(error=str(exc))\n"))
    for r in reports:
        assert r["error"] is not None and match in r["error"], r


CLI_MODULE = r"""
import json

import numpy as np

from znicz_tpu_torch.models.wine import build_workflow
from znicz_tpu_torch.parallel import multihost


def run(load, main):
    wf = load(build_workflow)
    main()
    dp = wf.parallel
    params = wf.snapshot_state()[0]
    print("OUT=" + json.dumps({
        "rank": multihost.process_index(), "backend": __import__("torch").distributed.get_backend(),
        "mesh": [dp.n_data, dp.n_model], "tp": dp.tp, "device": str(dp.device),
        "history": [{s: [float(e[s]["n_err"]), float(e[s]["loss"])] for s in e
                     if isinstance(e[s], dict) and "loss" in e[s]} for e in wf.decision.history],
        "params": [{k: v.detach().numpy().tolist() for k, v in layer.items()} for layer in params],
    }), flush=True)
"""
CLI_CONFIG = ("root.wine.decision.update({'max_epochs': 1})\n"
              # 178 samples at batch 10 do not split over two data ranks
              "root.wine.loader.update({'minibatch_size': 16})\n")


@pytest.mark.parametrize("spec", ["data=1,model=2", "data=2"])
def test_cli_mesh_flag_over_two_ranks_matches_jax(spec, tmp_path):
    """Two ``python -m znicz_tpu_torch ... --mesh SPEC --device cpu
    --coordinator ...`` processes build a gloo job and a CPU mesh of that
    shape (``tp`` on with a model axis) and train Wine as JAX's launcher
    does on the same flags in this process: n_err equal, losses rtol 1e-4,
    the gathered params rtol 1e-4 (atol 1e-5), both ranks alike."""
    from znicz_tpu import launcher as jlauncher
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot

    wf, cfg = tmp_path / "wf.py", tmp_path / "cfg.py"
    wf.write_text(CLI_MODULE)
    cfg.write_text("from znicz_tpu_torch.core.config import root\n" + CLI_CONFIG)
    addr = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", str(wf), str(cfg), "--mesh", spec,
         "--device", "cpu", "--random-seed", "3", "--coordinator", addr,
         "--num-processes", "2", "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err[-4000:]}"
            outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith("OUT=")][-1][4:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    jwf, jcfg = tmp_path / "jwf.py", tmp_path / "jcfg.py"
    jwf.write_text("from znicz_tpu.models.wine import run  # noqa: F401\n")
    jcfg.write_text("from znicz_tpu.core.config import root\n" + CLI_CONFIG)
    saved = jroot.to_dict()
    jprng.reset()  # the ranks' registries are a fresh process's
    try:
        want = jlauncher.run_args([str(jwf), str(jcfg), "--mesh", spec, "--random-seed", "3"])
    finally:
        for name in ("__znicz_workflow__", "__znicz_config__"):
            sys.modules.pop(name, None)
        jroot.clear()
        jroot.update(saved)
    jdp = want.workflow.parallel
    n_data, n_model = (int(dict(s.split("=") for s in spec.split(",")).get(a, 1))
                       for a in ("data", "model"))
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["backend"] == "gloo" and o["device"] == "cpu"
        assert o["mesh"] == [n_data, n_model] and o["tp"] == (n_model > 1) == jdp.tp
        assert o["history"] == outs[0]["history"] and o["params"] == outs[0]["params"]
    import jax

    jhist = want.workflow.decision.history
    assert len(outs[0]["history"]) == len(jhist)
    for got, ref in zip(outs[0]["history"], jhist):
        assert sorted(got) == sorted(s for s in ref if isinstance(ref[s], dict) and "loss" in ref[s])
        for s, (n_err, loss) in got.items():
            assert n_err == ref[s]["n_err"], (s, got, ref[s])
            np.testing.assert_allclose(loss, ref[s]["loss"], rtol=RTOL)
    jparams = jax.device_get(want.workflow.state.params)
    for g, w in zip(outs[0]["params"], jparams):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=RTOL_W,
                                       atol=ATOL_W, err_msg=k)
