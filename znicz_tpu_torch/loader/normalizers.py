"""Input normalizers (port of ``znicz_tpu/loader/normalizers.py``).

Each normalizer is ``fit(kind, data) -> state`` plus ``apply(state, data)``;
the state is plain numpy and the arithmetic is the JAX package's numpy, so
both frameworks normalize to the same bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

KINDS = ("none", "linear", "mean_disp", "range", "external_mean")


def fit(kind: str, data: np.ndarray, **kwargs) -> Dict[str, object]:
    """Normalizer state from training data ``[n, features]``."""
    if kind == "none":
        return {"kind": "none"}
    if kind == "linear":  # per-feature affine onto [-1, 1]
        lo = data.min(axis=0)
        hi = data.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        return {"kind": "linear", "lo": lo, "span": span}
    if kind == "mean_disp":  # per-feature zero mean, unit dispersion
        mean = data.mean(axis=0)
        disp = data.std(axis=0)
        return {"kind": "mean_disp", "mean": mean, "disp": np.where(disp > 0, disp, 1.0)}
    if kind == "range":  # fixed affine x / scale + shift
        return {
            "kind": "range",
            "scale": float(kwargs.get("scale", 255.0)),
            "shift": float(kwargs.get("shift", 0.0)),
        }
    if kind == "external_mean":  # subtract a given mean image
        return {"kind": "external_mean", "mean": np.asarray(kwargs["mean"])}
    raise ValueError(f"unknown normalizer {kind!r}; expected one of {KINDS}")


def apply(state: Dict[str, object], data: np.ndarray) -> np.ndarray:
    kind = state["kind"]
    if kind == "none":
        return data
    data = data.astype(np.float32)
    if kind == "linear":
        return 2.0 * (data - state["lo"]) / state["span"] - 1.0
    if kind == "mean_disp":
        return (data - state["mean"]) / state["disp"]
    if kind == "range":
        return data / state["scale"] + state["shift"]
    if kind == "external_mean":
        return data - state["mean"]
    raise ValueError(f"unknown normalizer {kind!r}; expected one of {KINDS}")
