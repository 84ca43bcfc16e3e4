"""Model export for the native (C++) inference engine (port of
``znicz_tpu/export.py``).

A trained model becomes a self-describing binary file that
``native/znicz_infer`` runs on the CPU with no Python; for the same params
the file is the JAX package's, byte for byte.

Format (little-endian):
    8 bytes   magic  "ZNICZT01"
    4 bytes   uint32 header_len
    N bytes   JSON header: {"input_shape": [...], "layers": [
                  {"type": ..., "config": {...},
                   "params": {"weights": {"shape": [...], "offset": B,
                              "size": n_floats}, ...}}]}
    ...       float32 parameter blobs at the stated byte offsets
              (relative to the end of the header)

Params arrive as torch tensors on any device (or numpy arrays); each goes
to the host as a contiguous float32 array before it is written.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

MAGIC = b"ZNICZT01"

# layer types native/znicz_infer.cc implements; export refuses anything else
# so deployment failures surface BEFORE training, not at inference time
NATIVE_SUPPORTED_PREFIXES = (
    "all2all", "softmax", "conv", "max_pooling", "avg_pooling",
    "maxabs_pooling", "stochastic_pooling", "norm", "dropout", "activation_",
    "deconv", "cutter",
)

# forward-config keys the native engine understands, per layer type
_CONFIG_KEYS = (
    "kx", "ky", "sliding", "padding", "n_kernels", "n_channels",
    "alpha", "beta", "k", "n", "output_sample_shape", "n_output",
    "include_bias", "dropout_ratio",
)


def validate_exportable(model) -> None:
    """Raise ValueError when the model cannot run on the native engine —
    call this BEFORE training (the launcher's --export precheck does)."""
    if not hasattr(model, "layer_specs"):
        raise ValueError(
            "model has no layer_specs (not a layer-list Model); cannot "
            "export for the native engine"
        )
    unsupported = [
        spec["type"]
        for spec in model.layer_specs
        if not spec["type"].startswith(NATIVE_SUPPORTED_PREFIXES)
    ]
    if unsupported:
        raise ValueError(
            f"layer type(s) {sorted(set(unsupported))} are not implemented "
            "by the native inference engine (native/znicz_infer.cc); the "
            "exported artifact would fail at deployment"
        )
    for spec in model.layer_specs:
        if isinstance(spec.get("padding"), str):
            raise ValueError(
                f"layer {spec['type']!r} uses padding={spec['padding']!r}; "
                "native export needs explicit (left, top, right, bottom) "
                "padding — string padding depends on input size"
            )


def _host(value) -> np.ndarray:
    """A param on the host as a contiguous float32 array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(value, np.float32))


def _write_artifact(
    path: str,
    input_shape,
    output_shape,
    output_kind: str,
    layer_arrays,
) -> Dict[str, Any]:
    """Serialize ``[(type, config, {name: array}), ...]`` to the ZNICZT01
    binary (shared by the layer-list and LM exporters)."""
    layers = []
    blobs = []
    offset = 0
    for ltype, config, params in layer_arrays:
        entry: Dict[str, Any] = {
            "type": ltype,
            "config": config,
            "params": {},
        }
        for name, value in params.items():
            arr = _host(value)
            entry["params"][name] = {
                "shape": list(arr.shape),
                "offset": offset,
                "size": int(arr.size),
            }
            blobs.append(arr)
            offset += arr.nbytes
        layers.append(entry)
    header = {
        "format": 1,
        "input_shape": list(input_shape),
        "output_shape": list(output_shape),
        "output_kind": output_kind,
        "layers": layers,
    }
    payload = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        for blob in blobs:
            f.write(blob.tobytes())
    return header


def export_model(model, path: str) -> Dict[str, Any]:
    """Write ``model`` (workflow.model.Model) to ``path``; returns header."""
    validate_exportable(model)
    layer_arrays = [
        (
            spec["type"],
            {key: _jsonable(spec[key]) for key in _CONFIG_KEYS if key in spec},
            params,
        )
        for spec, params in zip(model.layer_specs, model.params)
    ]
    return _write_artifact(
        path,
        model.input_shape,
        model.output_shape,
        # The ENGINE's output semantics, not the python model's: znicz_infer
        # applies softmax for a softmax head, so a softmax-headed model
        # (returns_logits in python) emits probabilities from the artifact.
        "probabilities" if model.returns_logits else "raw",
        layer_arrays,
    )


_LM_BLOCK_KEYS = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w_up", "up_bias", "w_down", "down_bias",
)


def export_lm_model(
    params, path: str, *, n_heads: int, moe_top_k: Optional[int] = None
) -> Dict[str, Any]:
    """Export a transformer LM for the native engine.

    ``params``: the flat ``init_lm_params`` layout
    ``[embed, block_0..L-1, head]`` (``TransformerLMWorkflow.state.params``
    for non-pipelined runs).  MoE blocks export too: ``moe_top_k`` is then
    REQUIRED and must match the training config — the engine gates with
    dense-dispatch semantics (every capacity-trained model serves fine
    dense-gated at inference; there is no token dropping to reproduce).
    Artifact I/O: input = [T] token ids stored as float32 in the raw
    file; output = [T, vocab] logits (``output_kind="raw"`` — matches
    python ``lm_apply``).
    """
    if not isinstance(params, (list, tuple)) or len(params) < 3:
        raise ValueError(
            "export_lm_model wants the flat [embed, blocks..., head] param "
            "list; pipelined (stacked-stage) params must be exported from "
            "a non-pipelined workflow"
        )
    embed, head, blocks = params[0], params[-1], params[1:-1]
    max_seq, d_model = embed["pos"].shape
    vocab = int(embed["embed"].shape[0])
    layer_arrays = [
        ("lm_embed", {}, {"embed": embed["embed"], "pos": embed["pos"]})
    ]
    from znicz_tpu_torch.workflow.transformer import MOE_KEY_MAP

    _FFN_KEYS = ("w_up", "up_bias", "w_down", "down_bias")
    for block in blocks:
        inner = int(block["wq"].shape[1])
        if inner % n_heads:
            raise ValueError(
                f"block inner dim {inner} not divisible by n_heads {n_heads}"
            )
        config: Dict[str, Any] = {"n_heads": int(n_heads)}
        if "moe_router" in block:
            if moe_top_k is None or int(moe_top_k) < 1:
                # a silent default (or the engine's clamp of a degenerate
                # value) would gate differently than the model trained
                # with — the exact mismatch this kwarg prevents
                raise ValueError(
                    "this LM has mixture-of-experts blocks: pass "
                    "moe_top_k=<the training top_k, >= 1> so the native "
                    "engine gates identically"
                )
            config["top_k"] = int(moe_top_k)
            keys = [
                k for k in _LM_BLOCK_KEYS if k not in _FFN_KEYS
            ] + list(MOE_KEY_MAP)
        else:
            keys = list(_LM_BLOCK_KEYS)
        layer_arrays.append(
            ("lm_block", config, {k: block[k] for k in keys})
        )
    layer_arrays.append(("lm_head", {}, {"head": head["head"]}))
    return _write_artifact(
        path, [max_seq], [max_seq, vocab], "raw", layer_arrays
    )


def _jsonable(v):
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v
