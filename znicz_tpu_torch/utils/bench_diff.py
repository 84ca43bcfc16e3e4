"""znicz-bench-diff: a machine-readable gate over two bench rounds (the
port's own copy of ``znicz_tpu/utils/bench_diff.py``, stdlib only).

Compare two rounds per metric against a relative threshold and exit
non-zero on regression.  Run it as ``python -m
znicz_tpu_torch.utils.bench_diff OLD.json NEW.json [flags]``.

Accepted inputs (both sides independently):

* a bench round file — one JSON object with a ``"parsed"`` dict
  of flattened numeric fields (the committed ``BENCH_rNN.json`` shape);
* raw bench output — one JSON record per line, each
  carrying ``"metric"``/``"value"`` plus numeric extras (error records
  and non-numeric fields are skipped).

Direction is inferred per metric name — throughput-shaped names
(``*_per_sec``, ``*_rps``, ``*_hit_rate``, ``*_vs_baseline``,
``*_acceptance_rate``, ``*_bytes_per_second``, ``mfu``...) regress
when they DROP; latency/cost-shaped names (``*ttft*``, ``*latency*``,
``*_ms``, ``*compile*``, ``preemptions``, ``retries``, ``failed``,
``*_bound_frac``, ``*_rollbacks_total``, ``*_restarts_total``...)
regress when they RISE.  Override per metric with ``--lower NAME`` /
``--higher NAME``; scope with ``--only PREFIX``; tune with
``--threshold FRAC`` (default 0.10 — a 10% move).

Exit codes: 0 clean, 1 regression(s), 2 usage/parse error — the same
contract as ``tools/znicz-slo``.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

# substrings marking a metric where SMALLER is better.  Checked before
# the higher-better default, except that explicit throughput markers
# win (a name like lm_serve_frontdoor_ttft_p99_ms is lower-better; a
# name like lm_serve_tokens_per_sec is higher-better even though it
# contains "_sec").
_LOWER_MARKERS = (
    "ttft", "latency", "_ms", "step_ms", "wait", "compile",
    "preemption", "retries", "eviction", "failed", "error", "shed",
    "deadline", "cancelled", "queue_age", "lag", "_bound_frac",
    # self-healing: a round that rolled back / restarted / skipped
    # more than the baseline regressed, whatever its throughput says
    "rollback", "restart", "skipped",
)
_HIGHER_MARKERS = (
    "per_sec", "per_s", "rps", "hit_rate", "mfu", "concurrency",
    "vs_dense", "vs_baseline", "acceptance_rate", "bytes_per_second",
)

# fields of a record that are bookkeeping, not comparable metrics
_SKIP_KEYS = {"value", "n", "rc", "budget_s", "done_unix"}


def metric_direction(name: str, lower: set, higher: set) -> str:
    """``"higher"`` or ``"lower"`` (= which direction is BETTER)."""
    if name in lower:
        return "lower"
    if name in higher:
        return "higher"
    low = name.lower()
    if any(m in low for m in _HIGHER_MARKERS):
        return "higher"
    if any(m in low for m in _LOWER_MARKERS):
        return "lower"
    return "higher"


def _numeric(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _absorb(record: dict, out: Dict[str, float]) -> None:
    """Flatten one bench record's numeric fields into the metric map
    (named metric first, numeric extras under their own key — the same
    merge a round file's ``parsed`` dict holds)."""
    name = record.get("metric")
    value = _numeric(record.get("value"))
    if isinstance(name, str) and value is not None:
        out[name] = value
    for key, v in record.items():
        if key in _SKIP_KEYS or key == "metric":
            continue
        fv = _numeric(v)
        if fv is not None:
            out[key] = fv


def load_metrics(path: str) -> Dict[str, float]:
    """Metric-name -> value for one round file (either accepted
    shape).  Raises ``ValueError`` when the file parses as neither."""
    with open(path) as f:
        text = f.read()
    out: Dict[str, float] = {}
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if isinstance(obj, dict):
        parsed = obj.get("parsed")
        _absorb(parsed if isinstance(parsed, dict) else obj, out)
        if not out:
            # a fully failed round (rc != 0, no parsed metrics — the
            # BENCH_r05 shape) must FAIL the gate, not pass it with
            # "0 compared"
            raise ValueError(
                f"{path}: no numeric metrics in this round "
                "(failed round?)"
            )
        return out
    # NDJSON: one record per line; error records skipped
    records = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as exc:
            raise ValueError(
                f"{path}: unparseable line {line[:80]!r}: {exc}"
            ) from exc
        if not isinstance(rec, dict):
            raise ValueError(f"{path}: line is not a JSON object")
        records += 1
        if "error" in rec:
            continue
        _absorb(rec, out)
    if not out:
        raise ValueError(
            f"{path}: no numeric metrics in this round "
            f"({records} record(s), all errors?)"
        )
    return out


def compare(
    old: Dict[str, float],
    new: Dict[str, float],
    *,
    threshold: float = 0.10,
    only: Optional[str] = None,
    lower: Optional[set] = None,
    higher: Optional[set] = None,
) -> Tuple[List[dict], List[str]]:
    """Per-metric comparison.  Returns ``(rows, missing)`` where each
    row carries the verdict; a metric in one round only is reported as
    missing, never a regression (sections come and go across rounds)."""
    lower = lower or set()
    higher = higher or set()
    rows: List[dict] = []
    names = sorted(set(old) | set(new))
    missing: List[str] = []
    for name in names:
        if only and not name.startswith(only):
            continue
        if name not in old or name not in new:
            missing.append(name)
            continue
        o, n = old[name], new[name]
        direction = metric_direction(name, lower, higher)
        if o == 0.0:
            # no base to take a ratio against: a lower-better metric
            # appearing from zero (compiles 0 -> 2) IS a regression;
            # higher-better from zero can only improve
            regressed = direction == "lower" and n > 0.0
            delta = None
        else:
            delta = (n - o) / abs(o)
            regressed = (
                delta < -threshold
                if direction == "higher"
                else delta > threshold
            )
        rows.append(
            {
                "metric": name,
                "old": o,
                "new": n,
                "delta_frac": round(delta, 4) if delta is not None else None,
                "direction": direction,
                "regressed": bool(regressed),
            }
        )
    return rows, missing


def _fmt_row(row: dict) -> str:
    delta = (
        f"{100.0 * row['delta_frac']:+.1f}%"
        if row["delta_frac"] is not None
        else "n/a"
    )
    mark = "REGRESSION" if row["regressed"] else "ok"
    arrow = "^" if row["direction"] == "higher" else "v"
    return (
        f"{row['metric']:<44} {row['old']:>12.4g} -> "
        f"{row['new']:>12.4g}  {delta:>8}  [{arrow}] {mark}"
    )


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    threshold = 0.10
    only = None
    as_json = False
    lower: set = set()
    higher: set = set()
    paths: List[str] = []
    i = 0
    try:
        while i < len(args):
            a = args[i]
            if a == "--threshold":
                threshold, i = float(args[i + 1]), i + 2
            elif a == "--only":
                only, i = args[i + 1], i + 2
            elif a == "--lower":
                lower.add(args[i + 1])
                i += 2
            elif a == "--higher":
                higher.add(args[i + 1])
                i += 2
            elif a == "--json":
                as_json, i = True, i + 1
            elif a.startswith("--"):
                raise IndexError(a)
            else:
                paths.append(a)
                i += 1
    except (IndexError, ValueError) as exc:
        print(f"znicz-bench-diff: bad arguments: {exc}", file=sys.stderr)
        return 2
    if len(paths) != 2 or threshold < 0:
        print(
            "usage: znicz-bench-diff OLD.json NEW.json "
            "[--threshold FRAC] [--only PREFIX] [--lower NAME] "
            "[--higher NAME] [--json]",
            file=sys.stderr,
        )
        return 2
    try:
        old = load_metrics(paths[0])
        new = load_metrics(paths[1])
    except (OSError, ValueError) as exc:
        print(f"znicz-bench-diff: {exc}", file=sys.stderr)
        return 2
    rows, missing = compare(
        old, new, threshold=threshold, only=only,
        lower=lower, higher=higher,
    )
    regressions = [r for r in rows if r["regressed"]]
    if as_json:
        print(
            json.dumps(
                {
                    "threshold": threshold,
                    "rows": rows,
                    "missing": missing,
                    "regressions": len(regressions),
                }
            )
        )
    else:
        for row in rows:
            print(_fmt_row(row))
        if missing:
            print(
                f"({len(missing)} metric(s) present in only one round: "
                + ", ".join(missing[:8])
                + (" ..." if len(missing) > 8 else "")
                + ")"
            )
        print(
            f"{len(rows)} compared, {len(regressions)} regression(s) "
            f"at threshold {threshold:.0%}"
        )
    return 1 if regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
