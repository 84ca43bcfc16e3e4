"""The port's genetic search (``genetics/``, ``core/subproc.py`` and the
launcher's ``--optimize``) against the JAX package's, on the CPU.

The GA is pure Python over the named numpy streams, which the port draws
as JAX does: on JAX's quadratic, seeded alike, the history and the best
genome are JAX's exactly, per genome and through ``evaluate_batch``.  Over
Wine with ``Tune(0.3, 0.05, 0.5)`` on the learning rate, in-process, every
evaluation's fitness is within rtol 1e-4 of JAX's and the best genome is
the same; spawned workers (``--device cpu``) give identical results for 1
and 2 workers; the launcher's ``--optimize 2`` takes the same search with
and without ``--export``; ``--optimize-workers`` without ``--optimize``
trains (tests/test_torch_launcher.py).  The shared-card warning asks torch
only once CUDA is initialized and never initializes it.
"""

import logging
import sys
import warnings

import numpy as np
import pytest
import torch

from znicz_tpu import genetics as jgen
from znicz_tpu import launcher as jlauncher
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu_torch import genetics as tgen
from znicz_tpu_torch import launcher as tlauncher
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core import subproc
from znicz_tpu_torch.core.config import root as troot

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _isolate():
    """Searches write their best genome into ``root``, load modules under
    fixed names and the CLI replaces the root logger's handlers: put all
    three back."""
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


def _reset(seed):
    for p in (jprng, tprng):
        p.reset()
        p.seed_all(seed)


# -- the config tree -----------------------------------------------------


def _tree(root, Tune):
    root.g.update({"a": Tune(0.1, 0.0, 1.0), "nested": {"b": Tune(2, 1, 5, "int")}})
    root.g.layers = [
        {"type": "all2all", "<-": {"learning_rate": Tune(0.01, 1e-4, 1.0)},
         "deep": [{"c": Tune(3.0, 1.0, 4.0)}]},
        {"type": "softmax"},
    ]
    root.g.plain = 4
    return root.g


def _found(found):
    return [(getattr(node, "_config_path_", "dict"), key, (t.default, t.min, t.max, t.kind))
            for node, key, t in found]


def test_find_tunables_finds_jaxs_paths_including_layer_dicts():
    want = _found(jgen.find_tunables(_tree(jroot, jgen.Tune)))
    got = _found(tgen.find_tunables(_tree(troot, tgen.Tune)))
    assert got == want
    assert [k for _, k, _ in got] == ["a", "b", "learning_rate", "c"]


@pytest.mark.parametrize("kind,lo,hi", [("float", 0.0, 1.0), ("int", 1, 5),
                                        ("float", -10.0, 10.0)])
def test_clip_is_jaxs(kind, lo, hi):
    values = [-20.0, lo - 0.1, lo, 0.2, 2.5, 3.4, 3.5, 4.5, hi, hi + 0.6, 7.6, 20.0]
    got = [tgen.Tune(lo, lo, hi, kind).clip(v) for v in values]
    want = [jgen.Tune(lo, lo, hi, kind).clip(v) for v in values]
    assert got == want
    assert [type(v) for v in got] == [type(v) for v in want]


# -- the GA on JAX's quadratic -------------------------------------------


def _quadratic(genome):
    x, y = genome
    return (x - 3.0) ** 2 + (y + 1.0) ** 2


def _search(gen_pkg, prng_pkg, root, batch):
    prng_pkg.seed_all(123)
    root.q.update({"x": gen_pkg.Tune(5.0, -10.0, 10.0), "y": gen_pkg.Tune(-5.0, -10.0, 10.0)})
    tunables = gen_pkg.find_tunables(root.q)
    calls = []

    def evaluate_batch(genomes):
        calls.append([list(g) for g in genomes])
        return [_quadratic(g) for g in genomes]

    opt = gen_pkg.GeneticOptimizer(
        None if batch else _quadratic, tunables, population_size=12, mutation_rate=0.4,
        evaluate_batch=evaluate_batch if batch else None,
    )
    result = opt.run(generations=15)
    opt.apply_genome(result["best_genome"])
    return result, opt.history, calls, (root.q.x, root.q.y)


@pytest.mark.parametrize("batch", [False, True], ids=["per_genome", "evaluate_batch"])
def test_quadratic_search_is_jaxs_exactly(batch):
    jprng.reset()
    tprng.reset()
    want = _search(jgen, jprng, jroot, batch)
    got = _search(tgen, tprng, troot, batch)
    assert got == want
    result, history, _, applied = got
    assert len(history) == 15 and result["best_fitness"] < 0.5
    assert applied == tuple(result["best_genome"])


def test_no_tunables_raises_jaxs_message():
    with pytest.raises(ValueError, match="no Tune leaves") as got:
        tgen.GeneticOptimizer(lambda g: 0.0, [])
    assert "znicz_tpu_torch.genetics.Tune" in str(got.value)
    with pytest.raises(ValueError, match="need evaluate or evaluate_batch"):
        tgen.GeneticOptimizer(None, [({}, "x", tgen.Tune(0.0, -1.0, 1.0))])


# -- searches over Wine --------------------------------------------------

WINE_TUNED = (
    "from {pkg}.core.config import root\n"
    "from {pkg}.genetics import Tune\n"
    "import {pkg}.models.wine as wine\n"
    "root.wine.update({{'lr': Tune(0.3, 0.05, 0.5)}})\n"
    "def run(load, main):\n"
    "    lr = root.wine.get('lr')\n"
    "    layers = [dict(l) for l in wine.DEFAULTS['layers']]\n"
    "    for l in layers:\n"
    "        l['<-'] = {{**l['<-'], 'learning_rate': lr}}\n"
    "    root.wine.layers = layers\n"
    "    load(wine.build_workflow)\n"
    "    main()\n"
)


def _wine_tuned(tmp_path, pkg):
    path = tmp_path / f"wf_tuned_{pkg}.py"
    path.write_text(WINE_TUNED.format(pkg=pkg))
    return str(path)


def _recording(launcher_cls):
    """A launcher class that records every evaluation's decision."""

    class Recording(launcher_cls):
        seen = []

        def main(self, **kw):
            dec = super().main(**kw)
            self.seen.append(dec.best_value)
            return dec

    Recording.seen = []
    return Recording


def _optimize(pkg_launcher, pkg_gen, prng_pkg, root, path, flags, n_workers, **ga):
    prng_pkg.reset()
    prng_pkg.seed_all(11)
    args = pkg_launcher.make_parser().parse_args([path, "--random-seed", "11",
                                                  "--stop-after", "2"] + flags)
    module = pkg_launcher._load_module(path, f"wf_search_{id(root)}")
    launcher = _recording(pkg_launcher.Launcher)(args)
    result = pkg_gen.optimize_workflow(
        module, launcher, generations=2 if n_workers == 0 else 1,
        tunables=pkg_gen.find_tunables(root), n_workers=n_workers, **ga,
    )
    return result, launcher.seen


def test_in_process_search_over_wine_matches_jax(tmp_path):
    want, want_seen = _optimize(jlauncher, jgen, jprng, jroot, _wine_tuned(tmp_path, "znicz_tpu"),
                                [], 0, population_size=4)
    got, got_seen = _optimize(tlauncher, tgen, tprng, troot,
                              _wine_tuned(tmp_path, "znicz_tpu_torch"), ["--device", "cpu"], 0,
                              population_size=4)
    assert len(got_seen) == len(want_seen) >= 4
    np.testing.assert_allclose(got_seen, want_seen, rtol=RTOL)
    assert got["best_genome"] == want["best_genome"]
    np.testing.assert_allclose(got["best_fitness"], want["best_fitness"], rtol=RTOL)
    assert [h["generation"] for h in got["history"]] == [0, 1]
    assert troot.wine.lr == got["best_genome"][0]  # the best genome is applied


def test_spawned_workers_give_identical_results_for_one_and_two(tmp_path):
    """Two genomes a generation, each in a fresh interpreter on the CPU
    (four spawns in all)."""
    path = _wine_tuned(tmp_path, "znicz_tpu_torch")
    runs = [
        _optimize(tlauncher, tgen, tprng, troot, path, ["--device", "cpu"], n,
                  population_size=2)[0]
        for n in (2, 1)
    ]
    assert np.isfinite(runs[0]["best_fitness"])
    assert runs[0] == runs[1]


def test_launcher_search_is_the_same_with_and_without_export(tmp_path, monkeypatch):
    path = _wine_tuned(tmp_path, "znicz_tpu_torch")
    out = tmp_path / "best.znicz"
    results, runs = [], []
    main = tlauncher.Launcher.main

    def recorded_main(self, **kw):
        dec = main(self, **kw)
        lrs = {layer["<-"]["learning_rate"] for layer in troot.wine.layers}
        runs.append((bool(self.args.dry_run), bool(self.args.export), lrs))
        return dec

    monkeypatch.setattr(tlauncher.Launcher, "main", recorded_main)
    for extra in ([], ["--export", str(out)]):
        tprng.reset()
        runs.clear()
        sys.modules.pop("__znicz_workflow__", None)
        launcher = tlauncher.run_args([path, "--device", "cpu", "--random-seed", "11",
                                       "--stop-after", "2", "--optimize", "2"] + extra)
        results.append(launcher.result)
    assert results[0] == results[1]
    assert len(results[1]["history"]) == 2 and np.isfinite(results[1]["best_fitness"])
    # the export is written once, after the search, from the best genome's retrain
    assert out.read_bytes()[:8] == b"ZNICZT01"
    # the best genome is applied to root and trains the retrain; at this seed it
    # is neither the Tune's default nor the last evaluation's, so a search that
    # left root at either would fail here
    best = results[1]["best_genome"][0]
    evals = [lrs for dry, exp, lrs in runs if not dry and not exp]
    assert best != 0.3 and evals[-1] != {best}
    assert troot.wine.lr == best
    assert [lrs for dry, exp, lrs in runs if exp and not dry] == [{best}]


def test_optimize_with_evaluate_exits():
    with pytest.raises(SystemExit, match="--optimize and --evaluate conflict"):
        tlauncher.run_args([_wine_cli(), "--device", "cpu", "--optimize", "1",
                            "--evaluate"])


def _wine_cli():
    import znicz_tpu_torch.models.wine as wine

    return wine.__file__


# -- the shared-card warning ---------------------------------------------


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda`` as a process that may or may not have initialized
    CUDA, with ``n`` cards; initializing it fails the test."""
    state = {"initialized": False, "cards": 1}

    def _no_init(*a, **k):
        raise AssertionError("the warning initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: state["initialized"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: state["cards"])
    monkeypatch.setattr(torch.cuda, "init", _no_init)
    monkeypatch.setattr(torch.cuda, "_lazy_init", _no_init)
    return state


def _warned(n_workers, device):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fired = subproc.warn_if_shared_accelerator(n_workers, device)
    msgs = [str(x.message) for x in w if "contend" in str(x.message)]
    assert fired == bool(msgs)
    return msgs


def test_shared_card_warning_fires_only_on_initialized_cuda(fake_cuda):
    assert _warned(4, None) == []  # CUDA not initialized: never asked
    fake_cuda["initialized"] = True
    (msg,) = _warned(4, None)
    assert "4 worker processes will contend for 1 CUDA card(s)" in msg
    assert "--device cpu" in msg
    assert _warned(4, "cuda") and _warned(2, "tpu")
    assert _warned(4, "cpu") == []  # the documented recipe
    assert _warned(1, None) == []
    fake_cuda["cards"] = 4
    assert _warned(4, None) == []  # a card a worker


def test_worker_side_warning_fires_from_the_payload_tag(fake_cuda, capsys):
    subproc._worker_warn_shared_chip({"warn_n_workers": 4})
    assert capsys.readouterr().err == ""  # CUDA not up in the worker yet
    fake_cuda["initialized"] = True
    subproc._worker_warn_shared_chip({"warn_n_workers": 4})
    assert "contend for 1 CUDA card(s)" in capsys.readouterr().err
    subproc._worker_warn_shared_chip({})  # untagged: silent
    subproc._worker_warn_shared_chip({"warn_n_workers": 4, "device": "cpu"})
    assert capsys.readouterr().err == ""


def test_parent_device_reaches_every_payload(tmp_path, monkeypatch):
    """The launcher's ``--device`` travels in each worker's payload, the one
    channel (no pool-level default)."""
    sent = []

    def fake_pool(fn, payloads, n_workers):
        assert fn is subproc.eval_genome and n_workers == 2
        sent.extend(payloads)
        return [float(p["genome"][0]) for p in payloads]

    monkeypatch.setattr(subproc, "run_pool", fake_pool)
    result, _ = _optimize(tlauncher, tgen, tprng, troot, _wine_tuned(tmp_path, "znicz_tpu_torch"),
                          ["--device", "cpu"], 2, population_size=2)
    assert len(sent) >= 2 and {p["device"] for p in sent} == {"cpu"}
    assert result["best_fitness"] == min(p["genome"][0] for p in sent)
