"""Run-report publishing (port of ``znicz_tpu/services/publishing.py``).

A Markdown file (and its JSON twin) with the config, the per-epoch metrics
and the outcome, written on the stopping epoch by an epoch service.
"""

from __future__ import annotations

import json
import os
import time

from znicz_tpu_torch.utils.profiling import Stopwatch


class MarkdownReporter:
    def __init__(self, directory: str, *, filename: str = "report.md"):
        self.directory = directory
        self.filename = filename
        self._clock = Stopwatch()
        os.makedirs(directory, exist_ok=True)

    def on_epoch(self, workflow, verdict) -> None:
        if not verdict["stop"]:
            return
        dec = workflow.decision
        lines = [
            f"# Run report: {workflow.name}",
            "",
            f"- finished: {time.strftime('%Y-%m-%d %H:%M:%S')}",
            f"- wall time: {self._clock.elapsed():.1f}s",
            f"- epochs: {dec.epoch}",
            f"- best value: {dec.best_value} (epoch {dec.best_epoch})",
            f"- loss function: {workflow.loss_function}",
            "",
            "## Model",
            "",
        ]
        model = workflow.model
        if getattr(model, "layer_types", None):
            lines.append("| # | layer | params |")
            lines.append("|---|-------|--------|")
            for i, (t, p) in enumerate(zip(model.layer_types, model.params)):
                shapes = ", ".join(
                    f"{k}{list(v.shape)}" for k, v in p.items()
                ) or "—"
                lines.append(f"| {i} | {t} | {shapes} |")
        lines += ["", "## Epoch history", ""]
        header_written = False
        for epoch, summary in enumerate(dec.history):
            cols = []
            for split in ("train", "valid", "test"):
                if split in summary:
                    m = summary[split]
                    cols.append(
                        f"{m['loss']:.5f}"
                        + (
                            f" / {m['err_pct']:.2f}%"
                            if m.get("n_err") is not None
                            and workflow.loss_function == "softmax"
                            else ""
                        )
                    )
                else:
                    cols.append("—")
            if not header_written:
                lines.append("| epoch | train | valid | test |")
                lines.append("|---|---|---|---|")
                header_written = True
            lines.append(f"| {epoch} | {cols[0]} | {cols[1]} | {cols[2]} |")
        path = os.path.join(self.directory, self.filename)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        # machine-readable twin
        with open(os.path.join(self.directory, "report.json"), "w") as f:
            json.dump(
                {
                    "workflow": workflow.name,
                    "epochs": dec.epoch,
                    "best_value": dec.best_value,
                    "best_epoch": dec.best_epoch,
                    "history": dec.history,
                },
                f,
                indent=2,
                default=str,
            )
