"""Declarative layer-list -> model compiler (port of
``znicz_tpu/workflow/model.py``).

The same layer-spec dialect: ``"type"``, ``"->"`` (forward knobs) and
``"<-"`` (gradient-descent knobs, which become the per-layer
:class:`~znicz_tpu_torch.nn.optimizer.HyperParams`).  Shape inference runs at
build time and every parameter is drawn eagerly from the named numpy stream
in the JAX package's order, so the same seed gives the same weights.

A model is ``params`` (a list of per-layer dicts of tensors, in the JAX
package's layouts) plus a function ``apply(params, x, *, train, generator)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.nn import optimizer
from znicz_tpu_torch.ops import (
    activation as act_op,
    all2all,
    attention as attention_op,
    conv,
    cutter,
    deconv,
    dropout as dropout_op,
    moe as moe_op,
    normalization,
    pooling,
)


class Model(NamedTuple):
    params: List[Dict[str, torch.Tensor]]
    apply: Callable  # (params, x, *, train=False, generator=None) -> output
    hyper: List[optimizer.HyperParams]
    layer_types: Tuple[str, ...]
    input_shape: Tuple[int, ...]  # per-sample shape (no batch dim)
    output_shape: Tuple[int, ...]
    returns_logits: bool  # final "softmax" layer emits logits (CE wants them)
    compute_dtype: Optional[torch.dtype] = None
    layer_shapes: Tuple[Tuple[int, ...], ...] = ()  # per-sample output of each layer
    layer_specs: Tuple[dict, ...] = ()  # {"type": ..., **forward knobs} a layer (export)

    def predict(self, params, x):
        """Inference output: probabilities for a softmax-headed model, the
        raw output otherwise."""
        y = self.apply(params, x, train=False)
        return torch.softmax(y, dim=-1) if self.returns_logits else y


def _split_spec(spec: Dict[str, Any]) -> Tuple[str, dict, dict]:
    spec = dict(spec)
    kind = spec.pop("type")
    fwd = dict(spec.pop("->", {}))
    bwd = dict(spec.pop("<-", {}))
    spec.pop("name", None)
    fwd.update(spec)  # flat kwargs are forward knobs
    return kind, fwd, bwd


def _n_output(fwd: dict) -> int:
    n = fwd.get("output_sample_shape", fwd.get("n_output"))
    if n is None:
        raise ValueError("all2all layer needs output_sample_shape (or n_output)")
    return int(np.prod(n))


_A2A_ACT = {
    "all2all": "linear",
    "all2all_tanh": "tanh",
    "all2all_relu": "relu",
    "all2all_str": "strict_relu",
    "all2all_sigmoid": "sigmoid",
}
_CONV_ACT = {
    "conv": "linear",
    "conv_tanh": "tanh",
    "conv_relu": "relu",
    "conv_str": "strict_relu",
    "conv_sigmoid": "sigmoid",
}
_POOL = {
    "max_pooling": pooling.max_pool,
    "avg_pooling": pooling.avg_pool,
    "maxabs_pooling": pooling.max_abs_pool,
}
_INIT_KEYS = ("weights_stddev", "bias_stddev", "weights_filling", "bias_filling")


def _init_kwargs(fwd: dict) -> dict:
    return {k: fwd[k] for k in _INIT_KEYS if k in fwd}


def _init_kwargs_moe(fwd: dict) -> dict:
    return {k: fwd[k] for k in ("weights_stddev", "weights_filling") if k in fwd}


def build(
    layers: Sequence[Dict[str, Any]],
    input_shape: Sequence[int],
    *,
    rand_name: str = "default",
    default_hyper: Optional[optimizer.HyperParams] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device: device_lib.DeviceLike = None,
) -> Model:
    """Compile a layer list into a Model whose params live on ``device``
    (None: the card, raising without one).

    ``input_shape`` is the per-sample shape: ``(features,)`` for MLPs,
    ``(H, W, C)`` for conv stacks (NHWC).

    ``compute_dtype`` (e.g. ``torch.bfloat16``): params stay float32 master
    weights but are cast per layer, activations flow in the compute dtype,
    and the output is cast back to float32 for the loss.  The casts are
    explicit (no autocast) so bf16 rounds where the JAX package rounds.
    """
    device = device_lib.resolve(device)
    default_hyper = default_hyper or optimizer.HyperParams()
    params: List[Dict[str, torch.Tensor]] = []
    hyper: List[optimizer.HyperParams] = []
    fns: List[Callable] = []  # (params, x, train, generator) -> x
    types: List[str] = []
    shapes: List[Tuple[int, ...]] = []
    shape = (1,) + tuple(int(s) for s in input_shape)  # batch placeholder
    returns_logits = False

    for i, spec in enumerate(layers):
        kind, fwd, bwd = _split_spec(spec)
        h = default_hyper._replace(**bwd) if bwd else default_hyper
        returns_logits = False

        if kind in _A2A_ACT or kind == "softmax":
            n_in = int(np.prod(shape[1:]))
            n_out = _n_output(fwd)
            p = all2all.init_params(
                n_in, n_out, rand_name=rand_name, device=device, **_init_kwargs(fwd)
            )
            activation = _A2A_ACT.get(kind, "linear")
            include_bias = fwd.get("include_bias", True)

            def fn(p, x, train, gen, activation=activation, ib=include_bias):
                return all2all.apply(p, x, activation=activation, include_bias=ib)

            shape = (shape[0], n_out)
            returns_logits = kind == "softmax"

        elif kind in _CONV_ACT:
            if len(shape) != 4:
                raise ValueError(
                    f"layer {i} ({kind}) needs NHWC input, got shape {shape}"
                )
            n_kernels = int(fwd["n_kernels"])
            kx, ky = int(fwd["kx"]), int(fwd["ky"])
            sliding = tuple(fwd.get("sliding", (1, 1)))
            padding = fwd.get("padding", (0, 0, 0, 0))
            p = conv.init_params(
                shape[3], n_kernels, kx, ky,
                rand_name=rand_name, device=device, **_init_kwargs(fwd),
            )
            activation = _CONV_ACT[kind]

            def fn(p, x, train, gen, s=sliding, pad=padding, a=activation):
                return conv.apply(p, x, sliding=s, padding=pad, activation=a)

            shape = conv.output_shape(shape, n_kernels, kx, ky, sliding, padding)

        elif kind in _POOL or kind == "stochastic_pooling":
            kx, ky = int(fwd["kx"]), int(fwd["ky"])
            sliding = fwd.get("sliding")
            if sliding is not None:
                sliding = tuple(sliding)
            p = {}
            if kind == "stochastic_pooling":

                def fn(p, x, train, gen, kx=kx, ky=ky, s=sliding):
                    return pooling.stochastic_pool(
                        x, kx, ky, s, generator=gen, train=train
                    )

            else:
                pool_fn = _POOL[kind]

                def fn(p, x, train, gen, f=pool_fn, kx=kx, ky=ky, s=sliding):
                    return f(x, kx, ky, s)

            shape = pooling.output_shape(shape, kx, ky, sliding)

        elif kind == "deconv":
            # the adjoint of a conv of the same knobs; the output shape is
            # the minimal exact inverse of that conv
            n_channels = int(fwd["n_channels"])
            kx, ky = int(fwd["kx"]), int(fwd["ky"])
            sliding = tuple(fwd.get("sliding", (1, 1)))
            padding = fwd.get("padding", (0, 0, 0, 0))
            p = deconv.init_params(
                n_channels, shape[3], kx, ky,
                rand_name=rand_name, device=device, **_init_kwargs(fwd),
            )

            def fn(p, x, train, gen, s=sliding, pad=padding):
                return deconv.apply(p, x, sliding=s, padding=pad)

            shape = deconv.output_shape(shape, n_channels, kx, ky, sliding, padding)

        elif kind == "norm":
            p = {}
            kwargs = {
                k: fwd[k] for k in ("alpha", "beta", "k", "n", "impl") if k in fwd
            }

            def fn(p, x, train, gen, kw=kwargs):
                return normalization.lrn(x, **kw)

        elif kind == "dropout":
            p = {}
            ratio = float(fwd.get("dropout_ratio", 0.5))

            def fn(p, x, train, gen, r=ratio):
                return dropout_op.dropout(
                    x, dropout_ratio=r, generator=gen, train=train
                )

        elif kind == "cutter":
            p = {}
            padding = fwd["padding"]

            def fn(p, x, train, gen, pad=padding):
                return cutter.cut(x, pad)

            shape = cutter.output_shape(shape, padding)

        elif kind.startswith("activation_"):
            p = {}
            a = act_op.get(kind[len("activation_"):])

            def fn(p, x, train, gen, a=a):
                return a(x)

        elif kind == "moe":
            # residual mixture-of-experts FFN (ops/moe.py) on [B, F]
            # activations or per token on [B, T, D] sequences; output dim ==
            # input dim, combined residually
            d = shape[-1] if len(shape) == 3 else int(np.prod(shape[1:]))
            n_experts = int(fwd["n_experts"])
            n_hidden = int(fwd.get("n_hidden", 4 * d))
            top_k = int(fwd.get("top_k", 1))
            residual = bool(fwd.get("residual", True))
            # dense dispatch through E=16, capacity-bounded above;
            # "dispatch" overrides either way
            dispatch = fwd.get("dispatch", "dense" if n_experts <= 16 else "capacity")
            cap_factor = float(fwd.get("capacity_factor", 1.25))
            p = moe_op.init_params(
                d, n_hidden, n_experts, rand_name=rand_name, device=device,
                **_init_kwargs_moe(fwd),
            )

            def fn(p, x, train, gen, k=top_k, res=residual, disp=dispatch, cf=cap_factor):
                if x.ndim == 3:  # per token on sequences
                    b, t, dd = x.shape
                    y = moe_op.apply(
                        p, x.reshape(b * t, dd), top_k=k, dispatch=disp, capacity_factor=cf,
                    ).reshape(b, t, dd)
                    return x + y if res else y
                flat = x.reshape(x.shape[0], -1)
                y = moe_op.apply(p, flat, top_k=k, dispatch=disp, capacity_factor=cf)
                return flat + y if res else y

            if len(shape) != 3:  # the flattened-token path emits [B, d]
                shape = (shape[0], d)

        elif kind == "attention":
            # pre-LN residual multi-head self-attention block
            # (ops/attention.py): per-sample input must be [T, D]
            if len(shape) != 3:
                raise ValueError(
                    f"layer {i} (attention) needs [T, D] per-sample input, "
                    f"got shape {shape}"
                )
            d = shape[2]
            n_heads = int(fwd.get("n_heads", 4))
            causal = bool(fwd.get("causal", True))
            p = attention_op.init_mha_params(
                d, n_heads, rand_name=rand_name, device=device, **_init_kwargs(fwd)
            )
            p["ln_scale"] = torch.ones((d,), device=device)
            p["ln_bias"] = torch.zeros((d,), device=device)

            def fn(p, x, train, gen, nh=n_heads, c=causal):
                h = normalization.layer_norm(x, p["ln_scale"], p["ln_bias"])
                return x + attention_op.mha(p, h, n_heads=nh, causal=c)

        else:
            raise ValueError(
                f"unknown layer type {kind!r} at index {i}; known: "
                f"{sorted(_A2A_ACT) + sorted(_CONV_ACT) + sorted(_POOL) + ['softmax', 'stochastic_pooling', 'deconv', 'norm', 'dropout', 'cutter', 'moe', 'attention', 'activation_*']}"
            )

        params.append(p)
        hyper.append(h)
        fns.append(fn)
        types.append(kind)
        shapes.append(tuple(shape[1:]))

    needs_rng = any(t in ("dropout", "stochastic_pooling") for t in types)

    def apply(params, x, *, train: bool = False, generator: Optional[torch.Generator] = None):
        if train and needs_rng and generator is None:
            raise ValueError(
                "model has dropout/stochastic layers: apply(train=True) "
                "needs a torch.Generator"
            )
        if compute_dtype is not None:
            x = x.to(compute_dtype)
            params = [
                {k: w.to(compute_dtype) for k, w in layer.items()}
                for layer in params
            ]
        for fn, p in zip(fns, params):
            x = fn(p, x, train, generator)
        if compute_dtype is not None:
            x = x.float()
        return x

    return Model(
        params=params,
        apply=apply,
        hyper=hyper,
        layer_types=tuple(types),
        input_shape=tuple(int(s) for s in input_shape),
        output_shape=tuple(shape[1:]),
        returns_logits=returns_logits,
        compute_dtype=compute_dtype,
        layer_shapes=tuple(shapes),
        layer_specs=tuple(
            {"type": t, **_split_spec(s)[1]} for t, s in zip(types, layers)
        ),
    )


def params_from_jax(params_np, device) -> List[Dict[str, torch.Tensor]]:
    """The JAX model's params (a list of per-layer dicts of numpy arrays, as
    ``jax.device_get(wf.state.params)`` gives them) -> the port's.  The
    layouts are the same, so this is placement only: no transposes."""
    return [
        {k: torch.from_numpy(np.array(v)).to(device) for k, v in layer.items()}
        for layer in params_np
    ]


def params_to_numpy(params) -> List[Dict[str, np.ndarray]]:
    """The port's params -> a list of per-layer dicts of numpy arrays: a
    snapshot, never a view of a CPU tensor that the in-place update will
    change later."""
    return [
        {k: w.detach().to("cpu", copy=True).numpy() for k, w in layer.items()}
        for layer in params
    ]
