"""Workflow/model topology introspection (port of
``znicz_tpu/workflow/introspect.py``).

A parameter/shape summary table of a layer-list model and a Graphviz DOT
export of the training topology (loader -> layers -> evaluator ->
decision/services) that any ``dot`` renderer turns into SVG.  The text is
the JAX package's, character for character, for the same layer list (the
train-step group keeps its label, "jit-compiled train step").
"""

from __future__ import annotations

from typing import List

import numpy as np


def _count(params: dict) -> int:
    return int(sum(np.prod(v.shape) for v in params.values()))


def model_summary(model) -> str:
    """Human-readable per-layer table: type, param shapes, param count."""
    lines: List[str] = []
    header = f"{'#':>3}  {'layer':<22} {'params':<40} {'count':>12}"
    lines.append(header)
    lines.append("-" * len(header))
    total = 0
    for i, (kind, p) in enumerate(zip(model.layer_types, model.params)):
        shapes = ", ".join(f"{k}{list(v.shape)}" for k, v in p.items()) or "—"
        n = _count(p)
        total += n
        lines.append(f"{i:>3}  {kind:<22} {shapes:<40} {n:>12,}")
    lines.append("-" * len(header))
    lines.append(
        f"{'':>3}  {'input ' + str(list(model.input_shape)):<22} "
        f"{'output ' + str(list(model.output_shape)):<40} {total:>12,}"
    )
    return "\n".join(lines)


def to_dot(workflow) -> str:
    """Graphviz DOT of the training topology (render: ``dot -Tsvg``): the
    loader feeds the train step (layer chain + evaluator + optimizer in one
    node group), whose metrics drive decision, snapshotter and services.
    """
    model = getattr(workflow, "model", None)
    lines = [
        "digraph workflow {",
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
        f'  loader [label="{type(workflow.loader).__name__}"];',
    ]
    prev = "loader"
    if model is not None and getattr(model, "layer_types", None):
        lines.append("  subgraph cluster_jit {")
        lines.append('    label="jit-compiled train step";')
        for i, kind in enumerate(model.layer_types):
            n = _count(model.params[i])
            label = f"{i}: {kind}" + (f"\\n{n:,} params" if n else "")
            lines.append(f'    layer{i} [label="{label}"];')
            lines.append(f"    {prev} -> layer{i};")
            prev = f"layer{i}"
        lines.append(
            f'    evaluator [label="evaluator ({workflow.loss_function})"];'
        )
        lines.append(f"    {prev} -> evaluator;")
        lines.append('    optimizer [label="grad + update"];')
        lines.append("    evaluator -> optimizer;")
        lines.append("  }")
        prev = "evaluator"
    lines.append('  decision [label="Decision"];')
    lines.append(f"  {prev} -> decision;")
    if workflow.snapshotter is not None:
        lines.append('  snapshotter [label="Snapshotter"];')
        lines.append("  decision -> snapshotter;")
    for i, service in enumerate(getattr(workflow, "services", [])):
        name = type(service).__name__
        node = f"svc_{i}_{name}"  # index: same-class services stay distinct
        lines.append(f'  {node} [label="{name}", style=dashed];')
        lines.append(f"  decision -> {node};")
    lines.append("  decision -> loader [style=dotted, label=\"next epoch\"];")
    lines.append("}")
    return "\n".join(lines)
