"""The port's launcher (``python -m znicz_tpu_torch``) against the JAX
package's, on the CPU.

The CLI tests of ``tests/test_models_cli.py`` run here at ``--device cpu``
on the Wine model, each training run beside JAX's launcher on the same
command line from the same registry state: a config override,
``--stop-after``, ``--epoch-sync deferred`` with interval snapshots (the
same snapshot files), a snapshot resume continued on both sides from one
JAX snapshot; each pair's decision histories (n_err exactly, losses rtol
1e-4) and final params (rtol 1e-4, atol 1e-6) agree.  Also ``--dry-run``,
``--evaluate`` (its JSON JAX's within rtol 1e-4), a missing split,
``--export``, a module without ``run``, and ``--device cpu
--data-parallel`` where a card is visible.  The parser takes exactly JAX's
option strings with its defaults; ``--device tpu`` means the card; without
a card and without ``--device`` the run raises; ``--optimize`` refuses
naming ROADMAP.md A11; every model module builds under ``--dry-run
--device cpu`` (AlexNet at full width on a cut loader).  As
``tests/test_self_healing.py`` does for the JAX package, a crash under
``--supervise`` resumes to the uninterrupted run's history and params, and
a SIGTERM mid-epoch exits 75 with an emergency snapshot from which
``--resume auto`` finishes the same run (four subprocesses); that
uninterrupted run equals JAX's launcher on the same module in the process.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from znicz_tpu import launcher as jlauncher
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.workflow.snapshotter import find_latest_valid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
RTOL, ATOL = 1e-4, 1e-6
MODELS = ("alexnet", "cifar", "kanji", "kohonen", "mnist", "mnist_ae", "mnist_rbm",
          "transformer_lm", "video_ae", "wine", "yale_faces")


@pytest.fixture(autouse=True)
def _isolate():
    """Each CLI run loads modules under fixed names, may edit ``root`` and
    replaces the root logger's handlers: put all three back."""
    saved = (jroot.to_dict(), troot.to_dict())
    log = logging.getLogger()
    handlers, level = list(log.handlers), log.level
    yield
    for name in ("__znicz_workflow__", "__znicz_config__"):
        sys.modules.pop(name, None)
    for r, tree in zip((jroot, troot), saved):
        r.clear()
        r.update(tree)
    log.handlers[:] = handlers
    log.setLevel(level)


def _wine(tmp_path, pkg="znicz_tpu_torch"):
    wf_py = tmp_path / f"wf_{pkg}.py"
    wf_py.write_text(f"from {pkg}.models.wine import run  # noqa: F401\n")
    return str(wf_py)


def _config(tmp_path, body):
    """The config module ``body`` (over ``root``) for each package."""
    paths = []
    for pkg in ("znicz_tpu", "znicz_tpu_torch"):
        cfg = tmp_path / f"cfg_{pkg}.py"
        cfg.write_text(f"from {pkg}.core.config import root\n{body}\n")
        paths.append([str(cfg)])
    return paths


def _host(params):
    return [{k: np.asarray(v.detach() if hasattr(v, "detach") else v) for k, v in layer.items()}
            for layer in params]


def assert_same_run(got, want):
    """Two runs' decision histories (n_err exactly, losses rtol 1e-4) and
    params (rtol 1e-4, atol 1e-6) agree."""
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert sorted(g) == sorted(w)
        for split in w:
            if isinstance(w[split], dict) and "n_err" in w[split]:
                assert g[split]["n_err"] == w[split]["n_err"], (split, g, w)
                np.testing.assert_allclose(g[split]["loss"], w[split]["loss"], rtol=RTOL)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _outcome(res):
    return {"history": res.workflow.decision.history, "params": _host(res.workflow.state.params)}


def _both(tmp_path, flags, jax_flags=None, config=None):
    """JAX's launcher and the port's on one command line (the port's at
    ``--device cpu``), each from the same registry state, which is not the
    ``--random-seed``'s: a reseed at another point than JAX's shows."""
    cfg = _config(tmp_path, config) if config else [[], []]
    jprng.reset()
    tprng.reset()
    jprng.seed_all(11)
    tprng.seed_all(11)
    want = jlauncher.run_args([_wine(tmp_path, "znicz_tpu")] + cfg[0]
                              + (flags if jax_flags is None else jax_flags))
    sys.modules.pop("__znicz_workflow__", None)
    sys.modules.pop("__znicz_config__", None)
    got = launcher.run_args([_wine(tmp_path)] + cfg[1] + flags + CPU)
    assert_same_run(_outcome(got), _outcome(want))
    return got, want


def _options(parser):
    return {s: (a.dest, a.default, a.nargs, a.const) for a in parser._actions
            for s in a.option_strings}


def test_parser_takes_jaxs_flags_with_jaxs_defaults():
    got, want = launcher.make_parser(), jlauncher.make_parser()
    assert _options(got) == _options(want)
    assert [a.dest for a in got._actions if not a.option_strings] == ["workflow", "config"]
    assert got.allow_abbrev is False
    device = {a.dest: a for a in got._actions}["device"]
    assert device.choices == ["cuda", "cpu", "tpu"]


@pytest.mark.parametrize("flag,device", [("tpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"),
                                         (None, None)])
def test_device_flag_reaches_the_builder(flag, device):
    seen = {}

    def builder(**kw):
        seen.update(kw)
        return "wf"

    args = launcher.make_parser().parse_args(["wf.py"] + (["--device", flag] if flag else []))
    launcher.Launcher(args).load(builder)
    assert seen.get("device", "absent") == (device or "absent")


def test_no_card_and_no_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run_args([_wine(tmp_path), "--stop-after", "1"])


def test_optimize_refuses_naming_the_roadmap(tmp_path):
    for flags in (["--optimize", "2"], ["--optimize-workers", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
            launcher.run_args([_wine(tmp_path)] + CPU + flags)


def test_run_workflow_with_config_override(tmp_path):
    got, want = _both(tmp_path, ["--random-seed", "1234"],
                      config="root.wine.decision.update({'max_epochs': 2})")
    assert got.result.epoch == want.result.epoch == 2


def test_stop_after_flag(tmp_path):
    got, want = _both(tmp_path, ["--random-seed", "1", "--stop-after", "1"])
    assert got.result.epoch == want.result.epoch == 1
    assert got.workflow.device == torch.device("cpu")


def test_epoch_sync_with_interval_snapshots(tmp_path):
    flags = ["--random-seed", "1", "--stop-after", "4", "--epoch-sync", "deferred",
             "--snapshot-interval", "2", "--snapshot-dir"]
    got, want = _both(tmp_path, flags + [str(tmp_path / "snaps")],
                      jax_flags=flags + [str(tmp_path / "jsnaps")])
    assert got.workflow.epoch_sync == "deferred" and got.result.epoch == 4
    snap = got.workflow.snapshotter
    assert snap.interval == 2 and snap.save_best
    names = sorted(os.listdir(tmp_path / "snaps"))
    assert all(any(k in n for n in names) for k in ("epoch1", "epoch3", "best")), names
    assert names == sorted(os.listdir(tmp_path / "jsnaps"))


def test_dry_run(tmp_path):
    res = launcher.run_args([_wine(tmp_path), "--dry-run"] + CPU)
    assert res.result is None and res.workflow.state is not None


def test_snapshot_resume_and_evaluate_match_jax(tmp_path, capsys):
    """A JAX run's best snapshot resumes in the port's CLI and in JAX's to
    epoch 4, the same run; ``--evaluate`` of it prints JAX's JSON (rtol
    1e-4; the confusion exactly)."""
    jwf = _wine(tmp_path, "znicz_tpu")
    jlauncher.run_args([jwf, "--random-seed", "7", "--stop-after", "3",
                        "--snapshot-dir", str(tmp_path / "snaps")])
    sys.modules.pop("__znicz_workflow__", None)
    best = str(tmp_path / "snaps" / "WineWorkflow_best.pickle.gz")
    flags = ["--stop-after", "4", "--snapshot", best, "--snapshot-dir"]
    got, want = _both(tmp_path, flags + [str(tmp_path / "snaps2")],
                      jax_flags=flags + [str(tmp_path / "jsnaps2")])
    assert got.result.epoch == want.result.epoch == 4
    capsys.readouterr()
    jlauncher.run_args([jwf, "--snapshot", best, "--evaluate", "train"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = launcher.run_args([_wine(tmp_path), "--snapshot", best, "--evaluate", "train"] + CPU)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want) and got["split"] == "train"
    assert got["confusion"] == want["confusion"] and np.asarray(got["confusion"]).shape == (3, 3)
    np.testing.assert_allclose([got[k] for k in ("loss", "n_err", "err_pct", "n_samples")],
                               [want[k] for k in ("loss", "n_err", "err_pct", "n_samples")],
                               rtol=1e-4)
    assert res.result == got


def test_evaluate_missing_split_errors(tmp_path):
    with pytest.raises(SystemExit, match="no samples"):
        launcher.run_args([_wine(tmp_path), "--evaluate", "test"] + CPU)
    with pytest.raises(SystemExit, match="conflict"):
        launcher.run_args([_wine(tmp_path), "--optimize", "1", "--evaluate"] + CPU)


def test_export_flag(tmp_path):
    out = tmp_path / "wine.znicz"
    res = launcher.run_args([_wine(tmp_path), "--random-seed", "3", "--stop-after", "1",
                             "--export", str(out)] + CPU)
    blob = out.read_bytes()
    assert blob[:8] == b"ZNICZT01"
    n = int.from_bytes(blob[8:12], "little")
    header = json.loads(blob[12:12 + n])
    w = np.frombuffer(blob[12 + n:], np.float32)
    first = header["layers"][0]["params"]["weights"]
    np.testing.assert_array_equal(
        w[first["offset"] // 4:][:first["size"]].reshape(first["shape"]),
        res.workflow.state.params[0]["weights"].detach().numpy())


def test_cpu_data_parallel_where_a_card_is_visible(tmp_path, monkeypatch):
    """``--device cpu`` builds the mesh on the CPU where torch sees a card
    too: the launcher asks for the workflow's device, not the machine's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for flags in (["--data-parallel"], ["--mesh", "data=1"]):
        res = launcher.run_args([_wine(tmp_path), "--random-seed", "2", "--stop-after", "1"]
                                + flags + CPU)
        assert res.result.epoch == 1
        dp = res.workflow.parallel
        assert dp.mesh.device_type == "cpu" and dp.device == torch.device("cpu")
        sys.modules.pop("__znicz_workflow__", None)


def test_missing_run_convention_errors(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(SystemExit):
        launcher.run_args([str(bad)] + CPU)


@pytest.mark.parametrize("model", MODELS)
def test_every_model_module_builds(model, tmp_path):
    args = [os.path.join(REPO, "znicz_tpu_torch", "models", f"{model}.py")]
    if model == "alexnet":  # full width, a cut loader
        cfg = tmp_path / "cfg.py"
        cfg.write_text("from znicz_tpu_torch.core.config import root\n"
                       "root.alexnet.loader.update({'n_train': 8, 'n_valid': 8, "
                       "'minibatch_size': 4})\n")
        args.append(str(cfg))
    res = launcher.run_args(args + ["--dry-run"] + CPU)
    assert res.result is None and res.workflow.state is not None
    assert res.workflow.device == torch.device("cpu")


_CHILD_MODULE = """
import json
import os
import signal

import numpy as np

from PKG.loader import datasets
from PKG.workflow import StandardWorkflow

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


def run(load, main):
    loader = datasets.mnist(n_train=192, n_test=32, minibatch_size=64)
    wf = load(
        StandardWorkflow, loader, LAYERS,
        decision_config={"max_epochs": 4},
        default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
    )
    sigterm_step = int(os.environ.get("ZNICZ_TEST_SIGTERM_STEP", "0"))
    if sigterm_step:
        def pol(base, step):
            if step == sigterm_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return base
        wf.lr_policy = pol
    main()
    dec = wf.decision
    print("RESULT " + json.dumps({
        "epochs": dec.epoch,
        "history": [[int(h["train"]["n_err"]), float(h["train"]["loss"])] for h in dec.history],
        "params": [{k: np.asarray(v.detach() if hasattr(v, "detach") else v).tolist()
                    for k, v in layer.items()} for layer in wf.state.params],
    }))
"""


def _run_child(module_path, extra_args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("ZNICZ_FAULTS", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", str(module_path), "--random-seed", "7"]
        + CPU + extra_args, capture_output=True, text=True, timeout=240, env=env, cwd=REPO)


def _result(stdout):
    for line in reversed(stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line in the child's output:\n{stdout}")


class TestSupervisedAutoResume:
    """A real crash under a real supervisor, and a real SIGTERM; each
    resumed run's history and params are the uninterrupted run's, bitwise
    (the CPU path is deterministic)."""

    @pytest.fixture(scope="class")
    def child_module(self, tmp_path_factory):
        path = tmp_path_factory.mktemp("mod") / "wf_mod.py"
        path.write_text(_CHILD_MODULE.replace("PKG", "znicz_tpu_torch"))
        return path

    @pytest.fixture(scope="class")
    def baseline(self, child_module, tmp_path_factory):
        snaps = tmp_path_factory.mktemp("base_snaps")
        proc = _run_child(child_module, ["--snapshot-dir", str(snaps),
                                         "--snapshot-interval", "1"])
        assert proc.returncode == 0, proc.stderr
        return _result(proc.stdout)

    def test_uninterrupted_child_is_jaxs(self, baseline, tmp_path, capsys):
        """The child module on JAX's launcher, in the process from a fresh
        registry as the child's is, with the child's flags: the same
        history (n_err exactly, losses rtol 1e-4) and params (rtol 1e-4,
        atol 1e-6)."""
        jmod = tmp_path / "jwf_mod.py"
        jmod.write_text(_CHILD_MODULE.replace("PKG", "znicz_tpu"))
        jprng.reset()
        capsys.readouterr()
        jlauncher.run_args([str(jmod), "--random-seed", "7", "--snapshot-dir",
                            str(tmp_path / "snaps"), "--snapshot-interval", "1"])
        want = _result(capsys.readouterr().out)
        assert baseline["epochs"] == want["epochs"] == 4
        assert [n for n, _ in baseline["history"]] == [n for n, _ in want["history"]]
        np.testing.assert_allclose([loss for _, loss in baseline["history"]],
                                   [loss for _, loss in want["history"]], rtol=RTOL)
        assert_same_run({"history": [], "params": baseline["params"]},
                        {"history": [], "params": want["params"]})

    def test_crash_under_supervisor_resumes_golden(self, child_module, baseline, tmp_path):
        snaps = tmp_path / "snaps"
        proc = _run_child(
            child_module,
            ["--snapshot-dir", str(snaps), "--snapshot-interval", "1", "--resume", "auto",
             "--supervise", "--max-restarts", "2", "--restart-backoff", "0.1"],
            # a crash entering epoch 2; the restarted child's 2 epochs pass
            env_extra={"ZNICZ_FAULTS": "train.crash:after=2:times=1"},
        )
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert _result(proc.stdout) == baseline
        sup = json.loads((snaps / "supervisor.json").read_text())
        assert sup["restarts"] == 1 and sup["max_restarts"] == 2
        assert sup["history"][0]["exit_code"] not in (0, 75)
        assert [h["exit_code"] for h in sup["history"]][1:] == [0]
        assert "-m znicz_tpu_torch" in proc.stderr  # the supervisor's child command

    def test_sigterm_mid_epoch_exits_75_then_resumes_golden(self, child_module, baseline,
                                                           tmp_path):
        snaps = tmp_path / "snaps"
        proc = _run_child(child_module, ["--snapshot-dir", str(snaps)],
                          env_extra={"ZNICZ_TEST_SIGTERM_STEP": "4"})  # mid epoch 1
        assert proc.returncode == 75, (proc.stdout, proc.stderr)
        emergency = find_latest_valid(str(snaps))
        assert emergency and "emergency" in emergency
        proc2 = _run_child(child_module, ["--snapshot-dir", str(snaps), "--resume", "auto"])
        assert proc2.returncode == 0, (proc2.stdout, proc2.stderr)
        assert _result(proc2.stdout) == baseline
