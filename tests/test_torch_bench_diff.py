"""The port's bench-diff reader (``utils/bench_diff.py``) against the JAX
package's, on round files written here.

One round file (a ``"parsed"`` dict) and raw record streams (one
JSON record a line, error records among them): the port's
``load_metrics``, ``compare`` rows and ``main`` exit codes and output are
JAX's, with ``--lower``, ``--higher``, ``--only``, ``--threshold`` and
``--json``; ``python -m znicz_tpu_torch.utils.bench_diff`` runs without
jax.
"""

import json
import os
import subprocess
import sys

import pytest

from znicz_tpu.utils import bench_diff as jdiff
from znicz_tpu_torch.utils import bench_diff as tdiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OLD_PARSED = {
    "rc": 0,
    "parsed": {
        "alexnet_step_ms": 10.0, "mnist_samples_per_sec": 5000.0,
        "serve_ttft_ms": 40.0, "serve_tokens_per_sec": 900.0, "compile_s": 0.0,
        "prefix_hit_rate": 0.5, "preemptions": 0, "lm_mfu": 0.30, "ok": True,
        "only_old": 1.0,
    },
}
NEW_RECORDS = [
    {"metric": "alexnet_step_ms", "value": 11.5, "unit": "ms"},
    {"metric": "mnist_samples_per_sec", "value": 4700.0, "device": "cuda"},
    {"metric": "serve_ttft_ms", "value": 39.0, "serve_tokens_per_sec": 700.0,
     "prefix_hit_rate": 0.52},
    {"metric": "compile_s", "value": 2.0},
    {"metric": "lm_mfu", "value": 0.25, "preemptions": 1},
    {"metric": "broken_section", "error": "boom"},
    {"metric": "only_new", "value": 3.0},
]


@pytest.fixture
def rounds(tmp_path):
    old = tmp_path / "BENCH_old.json"
    old.write_text(json.dumps(OLD_PARSED))
    new = tmp_path / "bench_new.ndjson"
    new.write_text("\n".join(json.dumps(r) for r in NEW_RECORDS) + "\n")
    bad = tmp_path / "failed.json"
    bad.write_text(json.dumps({"rc": 1, "parsed": {}}))
    errors = tmp_path / "errors.ndjson"
    errors.write_text(json.dumps({"metric": "x", "error": "e"}) + "\n")
    junk = tmp_path / "junk.ndjson"
    junk.write_text("{not json\n")
    return {"old": str(old), "new": str(new), "bad": str(bad), "errors": str(errors),
            "junk": str(junk), "absent": str(tmp_path / "absent.json")}


def test_load_metrics_is_jaxs(rounds):
    for name in ("old", "new"):
        assert tdiff.load_metrics(rounds[name]) == jdiff.load_metrics(rounds[name])
    for name in ("bad", "errors", "junk"):
        with pytest.raises(ValueError) as want:
            jdiff.load_metrics(rounds[name])
        with pytest.raises(ValueError) as got:
            tdiff.load_metrics(rounds[name])
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {},
    {"threshold": 0.2},
    {"threshold": 0.0},
    {"only": "serve_"},
    {"lower": {"lm_mfu"}, "higher": {"compile_s"}},
])
def test_compare_rows_are_jaxs(rounds, kw):
    old, new = (jdiff.load_metrics(rounds[n]) for n in ("old", "new"))
    got = tdiff.compare(old, new, **kw)
    assert got == jdiff.compare(old, new, **kw)
    assert any(r["regressed"] for r in got[0]) or kw.get("only")


@pytest.mark.parametrize("argv", [
    ["{old}", "{new}"],
    ["{old}", "{old}"],
    ["{old}", "{new}", "--threshold", "0.5"],
    ["{old}", "{new}", "--only", "serve_", "--threshold", "0.25"],
    ["{old}", "{new}", "--lower", "lm_mfu", "--higher", "compile_s", "--json"],
    ["{old}", "{new}", "--json", "--only", "mnist"],
    ["{old}", "{bad}"],
    ["{errors}", "{new}"],
    ["{old}", "{absent}"],
    ["{old}"],
    ["{old}", "{new}", "--threshold"],
    ["{old}", "{new}", "--threshold", "-1"],
    ["{old}", "{new}", "--bogus"],
])
def test_main_exit_code_and_output_are_jaxs(rounds, argv, capsys):
    argv = [a.format(**rounds) for a in argv]
    want_rc = jdiff.main(list(argv))
    want = capsys.readouterr()
    got_rc = tdiff.main(list(argv))
    got = capsys.readouterr()
    assert got_rc == want_rc
    assert got.out == want.out
    assert got.err == want.err
    assert got_rc in (0, 1, 2)


def test_module_runs_without_jax(rounds):
    code = (
        "import runpy, sys, json\n"
        f"sys.argv = ['bench_diff', {rounds['old']!r}, {rounds['new']!r}, '--json']\n"
        "try:\n"
        "    runpy.run_module('znicz_tpu_torch.utils.bench_diff', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'znicz_tpu.'))]\n"
        "print(json.dumps({'rc': rc, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-1])
    assert report == {"rc": 1, "bad": []}
    assert json.loads(lines[0])["regressions"] >= 1
    cli = subprocess.run([sys.executable, "-m", "znicz_tpu_torch.utils.bench_diff",
                          rounds["old"], rounds["old"]], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert cli.returncode == 0 and "0 regression(s)" in cli.stdout
