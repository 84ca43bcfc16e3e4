"""Plotters: training-curve and weight visualizations (port of
``znicz_tpu/services/plotting.py``).

Headless PNGs (matplotlib Agg, imported inside ``on_epoch``) and a CSV
under an output directory after each epoch.  On a host without matplotlib
the plotters raise inside ``on_epoch``, and the workflow's service loop
logs it while training goes on.

Each service implements ``on_epoch(workflow, verdict)``; the Workflow calls
every attached service at epoch end.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np


class MetricsCSVWriter:
    """Append per-epoch metrics to metrics.csv (machine-readable history).

    Appending a run whose columns differ from an existing file's header
    rewrites the file with the merged header (absent values stay empty) —
    rows and header can never silently misalign.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "metrics.csv")

    def on_epoch(self, workflow, verdict) -> None:
        summary = verdict["summary"]
        row = {"epoch": workflow.decision.epoch - 1}
        for split, m in summary.items():
            for key in ("loss", "n_err", "err_pct", "n_samples"):
                if key in m:
                    row[f"{split}_{key}"] = m[key]
        existing_rows: list = []
        fieldnames = list(row)
        if os.path.exists(self._path):
            with open(self._path, newline="") as f:
                reader = csv.DictReader(f)
                existing_rows = list(reader)
                old_fields = reader.fieldnames or []
            fieldnames = list(old_fields) + [
                k for k in row if k not in old_fields
            ]
        with open(self._path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
            w.writeheader()
            for r in existing_rows:
                w.writerow(r)
            w.writerow(row)


class AccumulatingPlotter:
    """Error/loss curves across epochs -> PNG (reference AccumulatingPlotter)."""

    def __init__(
        self,
        directory: str,
        *,
        metric: str = "loss",
        filename: Optional[str] = None,
    ):
        self.directory = directory
        self.metric = metric
        self.filename = filename or f"{metric}.png"
        os.makedirs(directory, exist_ok=True)

    def on_epoch(self, workflow, verdict) -> None:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        history = workflow.decision.history
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for split in ("train", "valid", "test"):
            ys = [
                e[split].get(self.metric)
                for e in history
                if split in e and self.metric in e[split]
            ]
            if ys:
                ax.plot(range(len(ys)), ys, label=split, marker=".")
        ax.set_xlabel("epoch")
        ax.set_ylabel(self.metric)
        ax.set_title(f"{workflow.name}: {self.metric}")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(os.path.join(self.directory, self.filename), dpi=100)
        plt.close(fig)


class Weights2D:
    """First-layer weight tiles -> PNG (reference Weights2D).

    Works for FC weights reshaped to the input sample shape and for conv
    kernels [ky, kx, cin, cout].
    """

    def __init__(
        self,
        directory: str,
        *,
        layer: int = 0,
        max_tiles: int = 64,
        filename: Optional[str] = None,
    ):
        self.directory = directory
        self.layer = layer
        self.max_tiles = max_tiles
        self.filename = filename or f"weights{layer}.png"
        os.makedirs(directory, exist_ok=True)

    def _tiles(self, workflow) -> Optional[np.ndarray]:
        params = workflow.state.params
        layer_params = (
            params[self.layer] if isinstance(params, (list, tuple)) else params
        )
        w = layer_params.get("weights")
        if w is None:
            return None
        w = w.detach().cpu().float().numpy()
        if w.ndim == 2:  # FC [in, out] -> tiles of the input shape
            sample = workflow.loader.sample_shape
            if int(np.prod(sample)) != w.shape[0]:
                return None
            side = sample if len(sample) >= 2 else None
            if side is None:
                n = int(np.sqrt(w.shape[0]))
                if n * n != w.shape[0]:
                    return None
                side = (n, n)
            return w.T.reshape((w.shape[1],) + tuple(side))[..., :, :]
        if w.ndim == 4:  # conv [ky, kx, cin, cout] -> per-kernel mean over cin
            return np.moveaxis(w.mean(axis=2), -1, 0)
        return None

    def on_epoch(self, workflow, verdict) -> None:
        tiles = self._tiles(workflow)
        if tiles is None:
            return
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        tiles = tiles[: self.max_tiles]
        if tiles.ndim == 4:  # drop trailing channel dims beyond 2D
            tiles = tiles.reshape(tiles.shape[0], tiles.shape[1], -1)
        n = len(tiles)
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(cols, rows))
        axes = np.atleast_1d(axes).ravel()
        for ax in axes:
            ax.axis("off")
        for i, tile in enumerate(tiles):
            axes[i].imshow(tile, cmap="gray")
        fig.suptitle(f"{workflow.name}: layer {self.layer} weights")
        fig.savefig(os.path.join(self.directory, self.filename), dpi=100)
        plt.close(fig)
