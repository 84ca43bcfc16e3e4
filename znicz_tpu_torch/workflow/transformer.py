"""Causal transformer language-model workflow (port of
``znicz_tpu/workflow/transformer.py``, single device).

Pre-LN blocks (layer norm, multi-head attention, a tanh FFN or, with
``moe_experts > 1``, a gated mixture of experts, :mod:`ops.moe`) over learned
token and position embeddings, trained with next-token cross-entropy under
the same momentum-SGD update rule as every other workflow.  Params are a
list of flat per-layer dicts, ``[embed, block_0, ..., block_{L-1}, head]``,
in the JAX package's layouts and draw order, so the same seed gives the same
weights and ``workflow.model.params_from_jax`` moves them across unchanged.

Attention is the dense twin (:func:`ops.attention.dot_product_attention`)
or, with ``attention="flash"`` (and ``"auto"`` on the card when
``max_seq >= 512``, where the JAX package picks its kernel on the TPU), the
hand-written CUDA flash kernels (:mod:`ops.kernels.attention`).

The base loop's host machinery runs here too: the prefetch thread
(``prefetch_batches``), the snapshotter and exact resume, ``epoch_sync``,
the anomaly watch (the gradients' global norm beside the loss), rollback
``recovery`` and the scan dispatch (``epoch_dispatch``; ``"auto"`` takes
it for a device-resident token loader).

``generate()`` decodes from the current params through
:mod:`workflow.generate` (KV cache; on the card one captured decode step
replayed a position).

``parallel=DataParallel(mesh)`` trains over the data axis (each rank its
shard of every batch, the gradients all-reduced; the flash kernels run on
every rank).  ``moe_dispatch="capacity"`` takes its slots and its capacity
from the global batch, as the JAX package's sort over the global batch
does (``ops/moe.py::apply_parallel``).

``tensor_parallel=True`` (with a ``(data, model)`` mesh, model axis > 1)
places the params by :func:`lm_tp_rules` and runs Megatron's forward, the
JAX package's ``_block_forward_tp``: each rank's attention runs over its
``n_heads // n_model`` local heads (the flash kernels on the card), ``wo``
and ``w_down`` give partial products summed over the model axis, their
biases added once; an MoE block holds ``E / n_model`` experts with the
router whole.  The vocab-sharded ``head`` feeds a vocab-parallel
cross-entropy (the max and the sum of exponentials reduced over the model
axis, the target's logit from the rank that owns it: what GSPMD inserts
for the JAX package), so no rank holds the whole logits.  ``generate()``
decodes on the gathered whole params.  Without ``tensor_parallel`` the
params stay whole on every rank, whatever the policy's ``tp`` (the JAX
package lets GSPMD gather leaves its size heuristic shards).

``sequence_parallel=True`` runs attention as ring attention
(``parallel/ring_attention.py``) over the data axis of ``mesh=`` (or of
the policy's mesh): each rank's q, k and v are re-laid out to its
sequence block (a slice where every rank holds the whole batch, an
all-to-all from its rows under ``parallel=DataParallel``), the ring runs
over the data group (on the rank's local heads under
``tensor_parallel``) and the output goes back; everything else runs as
without it.  Its inner blocks are the flash kernels where the attention
would be (``attention="flash"``, or ``"auto"`` on the card at a head dim
the kernels take and ``max_seq >= 512``), else plain PyTorch.

``pipeline_parallel=True`` pipelines the block tower over the mesh's
``pipe`` axis (``parallel/pipeline.py``, GPipe with
``pipeline_microbatches``): the params become ``{"embed", "stages",
"head"}`` (:func:`stack_lm_blocks`), each rank holding its stage's block
of every stacked leaf (:func:`lm_pp_rules`; under ``tensor_parallel`` also
its model block, :func:`lm_pp_tp_rules`), with embed and head whole on
every rank.  With ``mesh=`` alone the workflow places them by a policy of
its own over that mesh.  ``generate()`` refuses the pipelined layout, as
the JAX package's does.
"""

from __future__ import annotations

import logging
import re
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.loader.base import Loader
from znicz_tpu_torch.nn import optimizer
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.nn.train_state import TrainState
from znicz_tpu_torch.ops import attention as attention_op, moe as moe_op
from znicz_tpu_torch.ops.filling import fill
from znicz_tpu_torch.ops.kernels.attention import flash_attention, kernel_head_dim
from znicz_tpu_torch.ops.normalization import layer_norm
from znicz_tpu_torch.parallel import tensor_parallel as tp_ops
from znicz_tpu_torch.parallel.data_parallel import axis_group, axis_index
from znicz_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, axis_size
from znicz_tpu_torch.parallel.ring_attention import ring_blocks
from znicz_tpu_torch.parallel.tensor_parallel import P
from znicz_tpu_torch.workflow.workflow import Workflow, param_paths

logger = logging.getLogger(__name__)

ATTENTIONS = ("dot", "flash", "auto")
METRICS = ["loss", "n_samples", "n_err", "token_accuracy"]


def init_lm_params(
    vocab: int,
    d_model: int,
    n_layers: int,
    n_heads: int,
    max_seq: int,
    *,
    d_ff: Optional[int] = None,
    moe_experts: int = 0,
    rand_name: str = "default",
    device: device_lib.DeviceLike = None,
):
    """``[embed, block_0, ..., block_{L-1}, head]``, flat dicts per layer, on
    ``device`` (None: the card, raising without one).  Draw order: embed,
    pos, then per block the FFN (``w_up``, ``w_down``; or with
    ``moe_experts > 1`` the experts' ``router``, ``w1``, ``w2`` under
    :data:`MOE_KEY_MAP`'s names) and the attention's ``wq, wk, wv, wo``,
    then the head; layer-norm scales are ones and biases zeros."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    d_ff = d_ff or 4 * d_model
    std = 1.0 / np.sqrt(d_model)

    def draw(shape, stddev):
        return torch.from_numpy(fill(gen, shape, "gaussian", stddev)).to(dev)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    params = [{"embed": draw((vocab, d_model), std), "pos": draw((max_seq, d_model), std)}]
    for _ in range(n_layers):
        block = {
            "ln1_scale": ones(d_model),
            "ln1_bias": zeros(d_model),
            "ln2_scale": ones(d_model),
            "ln2_bias": zeros(d_model),
        }
        if moe_experts > 1:
            m = moe_op.init_params(d_model, d_ff, moe_experts, rand_name=rand_name, device=dev)
            # names end in "bias" so HyperParams' *_bias rules classify
            # them like every other workflow's biases
            block.update({k: m[v] for k, v in MOE_KEY_MAP.items()})
        else:
            block["w_up"] = draw((d_model, d_ff), std)
            block["up_bias"] = zeros(d_ff)
            block["w_down"] = draw((d_ff, d_model), 1.0 / np.sqrt(d_ff))
            block["down_bias"] = zeros(d_model)
        block.update(attention_op.init_mha_params(d_model, n_heads, rand_name=rand_name, device=dev))
        params.append(block)
    params.append({"head": draw((d_model, vocab), std)})
    return params


def _token_rows(embed, tokens):
    """Token embedding rows.  An id outside the vocab reads the nearest row
    (a negative one wraps first, as in numpy), as JAX's gather clamps: a
    client's bad id must not raise on the engine thread, nor index out of
    bounds on the card."""
    v = embed["embed"].shape[0]
    return embed["embed"][tokens.long().clamp(-v, v - 1)]


def _embed_tokens(embed, tokens):
    t = tokens.shape[1]
    return _token_rows(embed, tokens) + embed["pos"][:t][None, :, :]


# MoE param names in the block's flat dict -> ops/moe's schema (the JAX
# package's names, so params_from_jax carries them across unchanged)
MOE_KEY_MAP = {
    "moe_router": "router",
    "moe_w_up": "w1",  # [E, D, F]
    "moe_up_bias": "b1",  # [E, F]
    "moe_w_down": "w2",  # [E, F, D]
    "moe_down_bias": "b2",  # [E, D]
}
# every non-router leaf carries a leading expert dim (EP shards it)
_MOE_EXPERT_SHARDED = tuple(k for k in MOE_KEY_MAP if k != "moe_router")


class Shards(NamedTuple):
    """Where a sharded LM step runs: this rank's model ``group`` and
    ``index`` on it (None and 0 without tensor parallelism) and its data
    ``data_group`` (None where the batch is whole here)."""

    group: object = None
    index: int = 0
    n_model: int = 1
    data_group: object = None


def _block_ffn(block, h, *, moe_top_k=1, moe_dispatch="dense", data_group=None):
    """The block's position-wise FFN: dense two-layer tanh, or, when the
    block carries MoE params, a gated mixture of experts over the
    flattened token dim (capacity's slots over the batch split on
    ``data_group``, if any)."""
    if "moe_router" in block:
        b, t, d = h.shape
        moe_params = {v: block[k] for k, v in MOE_KEY_MAP.items()}
        y = moe_op.apply_parallel(moe_params, h.reshape(b * t, d), top_k=moe_top_k,
                                  dispatch=moe_dispatch, data_group=data_group)
        return y.reshape(b, t, d)
    h = torch.tanh(h @ block["w_up"] + block["up_bias"])
    return h @ block["w_down"] + block["down_bias"]


def _block_forward(block, x, *, n_heads, attention_fn=None, moe_top_k=1, moe_dispatch="dense",
                   data_group=None):
    """One pre-LN transformer block."""
    attention_fn = attention_fn or attention_op.dot_product_attention
    h = layer_norm(x, block["ln1_scale"], block["ln1_bias"])
    x = x + attention_op.mha(block, h, n_heads=n_heads, causal=True, attention_fn=attention_fn)
    h = layer_norm(x, block["ln2_scale"], block["ln2_bias"])
    return x + _block_ffn(block, h, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
                          data_group=data_group)


def _block_forward_tp(block, x, *, n_heads_local, shards, attention_fn=None, moe_top_k=1,
                      moe_dispatch="dense"):
    """:func:`_block_forward` over this rank's blocks of a
    :func:`lm_tp_rules` placement (the JAX package's
    ``_block_forward_tp``): column ``wq``/``wk``/``wv``/``w_up`` (so
    ``n_heads_local`` heads and a slice of the FFN), row ``wo``/``w_down``,
    whose partial products are summed over the model group; an MoE block
    holds its expert block with the router whole.  Activations enter and
    leave whole; the same math up to summation order."""
    attention_fn = attention_fn or attention_op.dot_product_attention
    group = shards.group
    h = tp_ops.copy_to_model(layer_norm(x, block["ln1_scale"], block["ln1_bias"]), group)
    # mha over the local heads computes exactly the partial product
    # o @ wo_local this rank owes the sum
    att = attention_op.mha(block, h, n_heads=n_heads_local, causal=True,
                           attention_fn=attention_fn)
    x = x + tp_ops.reduce_from_model(att, group)
    h = tp_ops.copy_to_model(layer_norm(x, block["ln2_scale"], block["ln2_bias"]), group)
    if "moe_router" in block:
        b, t, d = h.shape
        local = {v: block[k] for k, v in MOE_KEY_MAP.items()}
        # every rank's gates reach the router: its gradient sums them
        local["router"] = tp_ops.copy_to_model(local["router"], group)
        y = moe_op.apply_parallel(local, h.reshape(b * t, d), top_k=moe_top_k,
                                  dispatch=moe_dispatch, shard_index=shards.index,
                                  data_group=shards.data_group)
        return x + tp_ops.reduce_from_model(y.reshape(b, t, d), group)
    h = torch.tanh(h @ block["w_up"] + block["up_bias"])
    return x + tp_ops.reduce_from_model(h @ block["w_down"], group) + block["down_bias"]


def lm_apply(params, tokens, *, n_heads, attention_fn=None, remat=False,
             moe_top_k=1, moe_dispatch="dense", shards: Optional[Shards] = None):
    """tokens [B, T] integer -> logits [B, T, vocab].

    ``remat``: each block runs under ``torch.utils.checkpoint``, its
    activations recomputed in the backward instead of stored (the JAX
    package's ``jax.checkpoint``); the numbers are unchanged.  ``shards``:
    the step's placement; with a model group the params are this rank's
    :func:`lm_tp_rules` blocks and the logits its vocab block [B, T,
    vocab / n_model]."""
    if shards is not None and shards.group is not None:
        blk = partial(_block_forward_tp, n_heads_local=n_heads // shards.n_model, shards=shards,
                      attention_fn=attention_fn, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
    else:
        blk = partial(_block_forward, n_heads=n_heads, attention_fn=attention_fn,
                      moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
                      data_group=None if shards is None else shards.data_group)
    x = _embed_tokens(params[0], tokens)
    for block in params[1:-1]:
        x = checkpoint(blk, block, x, use_reentrant=False) if remat else blk(block, x)
    if shards is not None:
        x = tp_ops.copy_to_model(x, shards.group)
    return x @ params[-1]["head"]


def stack_lm_blocks(params, n_stages: int):
    """``[embed, block_0..L-1, head]`` -> ``{"embed", "stages", "head"}``,
    the blocks grouped into ``n_stages`` equal stage groups and stacked on a
    leading stage dim (the :mod:`~znicz_tpu_torch.parallel.pipeline`
    layout); the draw order of :func:`init_lm_params` is untouched."""
    from znicz_tpu_torch.parallel.pipeline import stack_stage_params

    blocks = params[1:-1]
    if len(blocks) % n_stages:
        raise ValueError(
            f"n_layers={len(blocks)} not divisible by pipeline stages {n_stages}"
        )
    g = len(blocks) // n_stages
    groups = [blocks[s * g:(s + 1) * g] for s in range(n_stages)]
    return {"embed": params[0], "stages": stack_stage_params(groups), "head": params[-1]}


def lm_apply_pipelined(
    params_pp, tokens, *, n_heads, mesh, n_microbatches,
    data_axis=None, tp_axis=None, attention_fn=None, remat=False,
    moe_top_k=1, moe_dispatch="dense",
):
    """tokens [B, T] (this data rank's rows under ``data_axis``) -> logits,
    the block tower pipelined over the mesh's ``pipe`` axis (embed and
    head on every rank of it).  ``tp_axis`` runs each stage over this
    rank's model blocks (:func:`_block_forward_tp`, the sums over that
    axis); a stage's MoE takes its capacity from the microbatch rows it
    holds, as the JAX package's ``shard_map`` body sees them."""
    from znicz_tpu_torch.parallel.pipeline import pipelined_model_apply

    param_spec_fn = None
    if tp_axis is not None:
        n_model = axis_size(mesh, tp_axis)
        if n_heads % n_model:
            raise ValueError(f"n_heads={n_heads} not divisible by model axis {n_model}")
        shards = Shards(axis_group(mesh, tp_axis), axis_index(mesh, tp_axis), n_model)
        blk = partial(_block_forward_tp, n_heads_local=n_heads // n_model, shards=shards,
                      attention_fn=attention_fn, moe_top_k=moe_top_k)
        param_spec_fn = _pp_stage_tp_specs(tp_axis)
    else:
        blk = partial(_block_forward, n_heads=n_heads, attention_fn=attention_fn,
                      moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)

    def stage_fn(blocks, x):
        for block in blocks:  # this stage's group of blocks
            x = checkpoint(blk, block, x, use_reentrant=False) if remat else blk(block, x)
        return x

    return pipelined_model_apply(
        params_pp, tokens,
        embed_fn=_embed_tokens, stage_fn=stage_fn, head_fn=lambda p, x: x @ p["head"],
        mesh=mesh, n_microbatches=n_microbatches, data_axis=data_axis,
        param_spec_fn=param_spec_fn,
    )


def lm_pp_rules(path: str, leaf):
    """``DataParallel`` param_rules for the pipelined LM: the stacked stage
    leaves split over ``pipe`` (a stage a rank), embed and head whole."""
    if "'stages'" in path:
        return P(PIPE_AXIS, *([None] * (leaf.ndim - 1)))
    return P()


def _stage_tp_spec(key: str, ndim: int, tp_axis: str = MODEL_AXIS):
    """The spec of one stacked stage leaf [S, ...] under PPxTP: the stage
    dim over ``pipe``, the weight dims by their Megatron role (column:
    wq/wk/wv/w_up and up_bias; row: wo/w_down; the MoE's expert leaves
    their expert dim; the router whole), the rest whole over the model
    axis."""
    if key in _MOE_EXPERT_SHARDED:
        return P(PIPE_AXIS, tp_axis, *([None] * (ndim - 2)))
    if key in ("wq", "wk", "wv", "w_up"):
        return P(PIPE_AXIS, None, tp_axis)
    if key in ("wo", "w_down"):
        return P(PIPE_AXIS, tp_axis, None)
    if key == "up_bias":
        return P(PIPE_AXIS, tp_axis)
    return P(PIPE_AXIS, *([None] * (ndim - 1)))


_KEY_PAT = re.compile(r"\['(\w+)'\]")


def _last_key(path: str) -> str:
    """The last ``['name']`` of a keystr path."""
    keys = _KEY_PAT.findall(path)
    return keys[-1] if keys else ""


def _pp_stage_tp_specs(tp_axis):
    """The pipeline's ``param_spec_fn`` for the LM's stage tower under TP
    (the placement and :func:`_block_forward_tp`'s sums over the same
    axis)."""

    def spec_fn(path: str, leaf):
        return _stage_tp_spec(_last_key(path), leaf.ndim, tp_axis)

    return spec_fn


def lm_pp_tp_rules(path: str, leaf):
    """``DataParallel`` param_rules for the PPxTP LM: the stacked stage
    weights split over (pipe, model) by their Megatron role; embed and
    head whole."""
    if "'stages'" in path:
        return _stage_tp_spec(_last_key(path), leaf.ndim)
    return P()


def auto_microbatches(batch: int, n_stages: int, n_data: int = 1) -> int:
    """The pipelined LM's default microbatch count: 6 a stage bound the
    GPipe bubble (S-1)/(S-1+M) under 1/7 for every stage count; clamped to
    the largest count that divides ``batch`` into microbatches whose rows
    divide by the data axis."""
    m = min(6 * n_stages, batch)
    while m > 1 and (batch % m or (batch // m) % n_data):
        m -= 1
    if batch % m or (batch // m) % n_data:
        raise ValueError(
            f"no pipeline microbatch count divides batch {batch} into "
            f"data-axis-{n_data}-divisible microbatches; choose "
            "minibatch_size as a multiple of n_data"
        )
    return m


def lm_tp_rules(path: str, leaf):
    """Head/row-column-aware tensor-parallel placement for the LM params
    (plugs into ``DataParallel(param_rules=...)``).

    Column-parallel (shard the output-features dim over ``model``): the QKV
    projections (the inner dim is heads*head_dim, so this IS head sharding
    when n_heads divides the axis), ``w_up`` and the vocab dim of the
    ``head`` (the loss's log-softmax reduces over it across the ranks).
    Row-parallel (shard the input dim; the partial products are summed):
    ``wo`` and ``w_down``.  The MoE expert leaves shard their leading
    expert dim.  Everything else (embeddings, layer norms, the router,
    biases except up_bias) is whole.
    """
    if any(f"'{k}'" in path for k in _MOE_EXPERT_SHARDED):
        # expert parallelism: the leading expert dim shards over model
        # (ops/moe.expert_sharding's placement)
        return P(MODEL_AXIS, *([None] * (leaf.ndim - 1)))
    if any(k in path for k in ("'wq'", "'wk'", "'wv'", "'w_up'", "'head'")):
        return P(None, MODEL_AXIS)
    if any(k in path for k in ("'wo'", "'w_down'")):
        return P(MODEL_AXIS, None)
    if "'up_bias'" in path:
        return P(MODEL_AXIS)
    return P()


def _vocab_parallel_nll(lg, tgt, group, index: int):
    """``logsumexp(logits) - logits[target]`` over logits split on the vocab
    dim: ``lg`` [..., V / n] this rank's block (block ``index``); the max
    and the sum of exponentials are reduced over the model group and the
    target's logit comes from the rank that owns it."""
    vl = lg.shape[-1]
    lo = index * vl
    mx = tp_ops.all_reduce(lg.detach().amax(dim=-1), group, "max")
    sumexp = tp_ops.reduce_from_model(torch.exp(lg - mx[..., None]).sum(dim=-1), group)
    owned = (tgt >= lo) & (tgt < lo + vl)
    mine = lg.gather(-1, (tgt - lo).clamp(0, vl - 1)[..., None])[..., 0]
    tgt_logit = tp_ops.reduce_from_model(torch.where(owned, mine, torch.zeros_like(mine)), group)
    return mx + torch.log(sumexp) - tgt_logit


def _vocab_parallel_argmax(lg, group, index: int):
    """The global argmax of logits split on the vocab dim, the lowest global
    index on a tie (``argmax``'s rule): the first rank whose block holds
    the maximum, at its first position."""
    lg = lg.detach()
    val = lg.amax(dim=-1)
    idx = lg.argmax(dim=-1) + index * lg.shape[-1]
    vals = tp_ops.all_gather(val[None], 0, group)
    idxs = tp_ops.all_gather(idx[None], 0, group)
    best = vals.argmax(dim=0)
    return idxs.gather(0, best[None])[0]


class TransformerLMWorkflow(Workflow):
    """Next-token LM training over integer-sequence loaders.

    Loader contract: ``data[split]`` is [N, T] integer tokens; the
    per-sample ``mask`` marks valid rows as usual.  ``attention``: "dot",
    "flash" or "auto"; ``attention_dtype="bf16"`` casts q/k/v to bf16 at the
    attention boundary only (params, activations and the softmax stay f32).
    ``device``: None means the card (raises without one).
    """

    def __init__(
        self,
        loader: Loader,
        *,
        vocab: int,
        d_model: int = 64,
        n_layers: int = 2,
        n_heads: int = 4,
        d_ff: Optional[int] = None,
        max_epochs: int = 10,
        hyper: Optional[optimizer.HyperParams] = None,
        attention: str = "auto",
        attention_dtype: str = "f32",
        remat: bool = False,
        moe_experts: int = 0,
        moe_top_k: int = 1,
        moe_dispatch: str = "dense",
        sequence_parallel: bool = False,
        tensor_parallel: bool = False,
        pipeline_parallel: bool = False,
        pipeline_microbatches: Optional[int] = None,
        mesh=None,
        decision: Optional[Decision] = None,
        snapshotter=None,
        lr_policy=None,
        parallel=None,
        prefetch_batches: int = 2,
        epoch_sync: str = "sync",
        recovery=None,
        epoch_dispatch: str = "auto",
        rand_name: str = "default",
        device=None,
        name: str = "TransformerLMWorkflow",
    ):
        if attention not in ATTENTIONS:
            raise ValueError(f"attention={attention!r}: want one of {ATTENTIONS}")
        if attention_dtype not in ("f32", "bf16"):
            raise ValueError(f"attention_dtype={attention_dtype!r}: want 'f32' or 'bf16'")
        super().__init__(
            loader,
            None,  # the LM draws its params at initialize (init_lm_params)
            loss_function="mse",  # metric label only; the LM has its own loss
            target="labels",
            decision=decision or Decision(metric="loss", max_epochs=max_epochs),
            snapshotter=snapshotter,
            lr_policy=lr_policy,
            parallel=parallel,
            prefetch_batches=prefetch_batches,
            epoch_sync=epoch_sync,
            recovery=recovery,
            epoch_dispatch=epoch_dispatch,
            device=device,
            metric_names=METRICS,
            name=name,
        )
        self.vocab = vocab
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.hyper = hyper or optimizer.HyperParams(learning_rate=0.1, gradient_moment=0.9)
        self.attention = attention
        self.attention_dtype = attention_dtype
        self.remat = remat
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_dispatch = moe_dispatch
        self.rand_name = rand_name
        self.max_seq = int(loader.sample_shape[0])
        self.sequence_parallel = sequence_parallel
        self.tensor_parallel = tensor_parallel
        self.pipeline_parallel = pipeline_parallel
        self.mesh = mesh
        from znicz_tpu_torch.parallel import DataParallel

        if moe_experts > 1 and pipeline_parallel and tensor_parallel and moe_dispatch != "dense":
            # the experts shard over the model axis inside the stage, whose
            # combine is the stage's sum; only dense dispatch has that form
            raise ValueError(
                "pipeline+tensor parallel MoE supports only moe_dispatch='dense' (experts "
                "shard over the model axis with a manual combine sum; capacity dispatch "
                "has no manual-EP formulation here)"
            )
        if pipeline_parallel:
            self._init_pipeline(loader, parallel, mesh, n_layers, n_heads, moe_experts,
                                pipeline_microbatches)
        elif tensor_parallel:
            if not isinstance(self.parallel, DataParallel):
                raise ValueError(
                    "tensor_parallel=True needs parallel=DataParallel(mesh) "
                    "with a model axis"
                )
            n_model = self.parallel.n_model
            if n_model <= 1:
                raise ValueError("tensor_parallel=True but the mesh's model axis is 1")
            if n_heads % n_model:
                raise ValueError(f"n_heads={n_heads} not divisible by model axis {n_model}")
            if moe_experts > 1 and moe_experts % n_model:
                raise ValueError(
                    f"moe_experts={moe_experts} not divisible by model axis {n_model} "
                    "(experts shard over it under tensor parallel)"
                )
            if self.parallel.param_rules is None:
                # never change the caller's DataParallel (it may be shared
                # with workflows whose params want the size heuristic)
                self.parallel = DataParallel(
                    self.parallel.mesh,
                    tp=self.parallel.tp,
                    tp_min_features=self.parallel.tp_min_features,
                    param_rules=lm_tp_rules,
                )
        if sequence_parallel:
            if self.mesh is None and self.parallel is None:
                raise ValueError(
                    "sequence_parallel=True needs mesh= (every rank holds the whole batch) "
                    "or parallel=DataParallel(mesh) (every rank its rows)"
                )
            self.mesh = self.mesh if self.mesh is not None else self.parallel.mesh

    def _init_pipeline(self, loader, parallel, mesh, n_layers, n_heads, moe_experts,
                       pipeline_microbatches) -> None:
        """The JAX package's checks of a pipelined LM, its mesh, its
        placement policy and its microbatch count."""
        from znicz_tpu_torch.parallel import DataParallel

        if self.sequence_parallel:
            raise ValueError(
                "pipeline_parallel is mutually exclusive with "
                "sequence parallel (both want to own the batch layout)"
            )
        if parallel is not None:
            # DPxPP(xTP): batch over data, stages over pipe (weights also
            # over model under TP), on one mesh: the policy's
            if mesh is not None and mesh != parallel.mesh:
                raise ValueError(
                    "pipeline_parallel with parallel=DataParallel: "
                    "pass the (data, pipe) mesh via the DataParallel "
                    "(mesh= must be omitted or identical)"
                )
            mesh = self.mesh = parallel.mesh
        if mesh is None or PIPE_AXIS not in (mesh.mesh_dim_names or ()):
            raise ValueError("pipeline_parallel=True needs a mesh with a 'pipe' axis")
        if self.tensor_parallel:
            n_model = axis_size(mesh, MODEL_AXIS)
            if n_model <= 1:
                raise ValueError("pipeline+tensor parallel needs a mesh with a 'model' axis > 1")
            if n_heads % n_model:
                raise ValueError(f"n_heads={n_heads} not divisible by model axis {n_model}")
            if moe_experts > 1 and moe_experts % n_model:
                raise ValueError(
                    f"moe_experts={moe_experts} not divisible by model axis {n_model} "
                    "(experts shard over it under pipeline+tensor parallel)"
                )
            if parallel is None:
                raise ValueError(
                    "pipeline+tensor parallel needs parallel=DataParallel over the "
                    "(data, pipe, model) mesh (stage weight placement rides its param_rules)"
                )
        rules = lm_pp_tp_rules if self.tensor_parallel else lm_pp_rules
        if parallel is None or parallel.param_rules is None:
            # the stage leaves live a stage a rank; with mesh= alone the
            # workflow's own policy over it places them (and gathers them
            # for snapshots); the caller's policy is never changed
            self.parallel = DataParallel(mesh, param_rules=rules)
        self._n_stages = axis_size(mesh, PIPE_AXIS)
        if n_layers % self._n_stages:
            raise ValueError(
                f"n_layers={n_layers} not divisible by pipe axis {self._n_stages}"
            )
        if pipeline_microbatches:
            self.pipeline_microbatches = pipeline_microbatches
            return
        bs = loader.max_minibatch_size
        n_data = axis_size(mesh, DATA_AXIS) if parallel is not None else 1
        m = auto_microbatches(bs, self._n_stages, n_data)
        self.pipeline_microbatches = m
        from znicz_tpu_torch.parallel.pipeline import bubble_fraction

        bubble = bubble_fraction(self._n_stages, m)
        if bubble > 0.16:  # the documented default bound
            logger.warning(
                "auto-selected %d pipeline microbatches (batch %d, data axis %d) leaves a "
                "GPipe bubble of %.0f%%; raise minibatch_size toward %d*n_data to recover "
                "pipeline efficiency", m, bs, n_data, 100 * bubble, 6 * self._n_stages,
            )

    def _batch_target(self, mb):
        return np.zeros(len(mb.mask), np.int32)  # unused host-side dummy

    def _shards(self) -> Optional[Shards]:
        """The step's placement: None in one process without a policy."""
        dp = self.parallel
        if dp is None or self.pipeline_parallel:
            return None
        data_group = dp.group if dp.n_data > 1 else None
        if not (dp.sharded and self.tensor_parallel):
            return None if data_group is None else Shards(data_group=data_group)
        return Shards(dp.model_group, dp.model_index, dp.n_model, data_group)

    def _setup_parallel(self) -> None:
        """Without ``tensor_parallel`` the params stay whole on every rank
        of the mesh: a policy that would shard them is replaced by a copy
        that does not (the caller's is never changed)."""
        super()._setup_parallel()
        dp = self.parallel
        if (not (self.tensor_parallel or self.pipeline_parallel)
                and (dp.tp or dp.param_rules is not None)):
            from znicz_tpu_torch.parallel import DataParallel

            self.parallel = DataParallel(dp.mesh, tp_min_features=dp.tp_min_features)

    def _whole_batch_ranks(self) -> bool:
        """The sequence-parallel ring over ``mesh=`` alone: every rank
        takes the whole batch."""
        return self.parallel is None and self.mesh is not None

    def _trainable(self, params) -> bool:
        return True  # a list of layers, or the pipelined layout's dict

    def _hyper(self):
        # one for each layer, or for each of the pipelined layout's entries
        return [self.hyper] * len(self.state.params)

    def generate(
        self,
        prompt,
        *,
        max_new_tokens: int,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng=None,
    ):
        """KV-cache decoding from the current params
        (:func:`workflow.generate.generate`); returns ``[B, Tp +
        max_new_tokens]`` int32 tokens, the prompt included, on the
        workflow's device.  Greedy at ``temperature=0``; ``rng`` (a
        ``torch.Generator`` on that device) draws the sampling noise.  The
        decode attention is f32 whatever ``attention_dtype`` is.  Under
        tensor parallelism every rank calls this alike: it decodes on the
        whole params, gathered over the model axis.  The pipelined layout
        trains only, as in the JAX package."""
        if self.pipeline_parallel:
            raise ValueError(
                "generate() wants the flat [embed, blocks..., head] param "
                "layout; pipelined (stacked-stage) params are train-only — "
                "decode from a non-pipelined workflow"
            )
        if self.state is None:
            self.initialize()
        from znicz_tpu_torch.workflow.generate import generate as _generate

        params = self.state.params
        if self.parallel is not None:
            params = self.parallel.gather_state(params)
        return _generate(
            params,
            torch.as_tensor(np.asarray(prompt), device=self.device),
            n_heads=self.n_heads,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            rng=rng,
            moe_top_k=self.moe_top_k,
            moe_dispatch=self.moe_dispatch,
        )

    def _attention_fn_base(self):
        """The flash kernels where the JAX package picks its kernel on the
        TPU (here: on the card, at a head dim the kernels take) or where
        asked; else None (dense).  Under ``sequence_parallel`` the ring,
        whose inner blocks are the flash kernels by the same rule."""
        on_card = self.device.type == "cuda"
        has_kernel = kernel_head_dim(self.d_model // self.n_heads) is not None
        flash = self.attention == "flash" or (
            self.attention == "auto" and on_card and self.max_seq >= 512 and has_kernel
        )
        if self.sequence_parallel:
            return partial(self._ring_attention, inner="flash" if flash else "dense")
        return flash_attention if flash else None

    def _ring_attention(self, q, k, v, *, causal=False, inner="dense"):
        """Ring attention over the data group of :attr:`mesh` on this rank's
        q, k and v [B, T, H, D], re-laid out to its sequence block and back
        in one exchange each way (all three together, so the backward
        cannot pair one rank's dq with another's dk): a slice and a gather
        where every rank holds the whole batch, all-to-alls from and to its
        rows under a data-parallel policy."""
        group = axis_group(self.mesh, DATA_AXIS)
        chain = tp_ops.Chain()
        qkv = torch.stack([q, k, v])  # [3, B, T, H, D]
        rows = self.parallel is not None and self.parallel.n_data > 1
        if rows:
            qkv = tp_ops.all_to_all(qkv, 2, 1, group, chain=chain)
        else:
            qkv = tp_ops.scatter_to_model(qkv, 2, group, chain=chain)
        out = ring_blocks(*qkv.unbind(0), group=group, chain=chain, causal=causal, inner=inner)
        if rows:
            out = tp_ops.all_to_all(out, 0, 1, group, chain=chain)
        else:
            out = tp_ops.gather_from_model(out, 1, group, chain=chain)
        return chain.join(out)

    def _attention_fn(self):
        fn = self._attention_fn_base()
        if self.attention_dtype != "bf16":
            return fn
        base_fn = fn or attention_op.dot_product_attention

        def bf16_fn(q, k, v, **kw):
            # cast at the boundary only; the output returns to the
            # residual dtype
            return base_fn(
                q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), **kw
            ).to(q.dtype)

        return bf16_fn

    def loss_metrics(self, params, tokens, mask):
        """Next-token cross-entropy: ``logsumexp(lg) - lg[tgt]`` over
        ``logits[:, :-1]`` against ``tokens[:, 1:]``, the per-sample mean
        over T-1, then the masked mean over samples.  Returns ``(loss,
        metrics)`` with ``token_accuracy`` from the argmax."""
        tokens = tokens.long()
        shards = self._shards()
        if self.pipeline_parallel:
            logits = lm_apply_pipelined(
                params, tokens, n_heads=self.n_heads, mesh=self.mesh,
                n_microbatches=self.pipeline_microbatches,
                data_axis=DATA_AXIS if self.parallel.n_data > 1 else None,
                tp_axis=MODEL_AXIS if self.tensor_parallel else None,
                attention_fn=self._attention_fn(), remat=self.remat,
                moe_top_k=self.moe_top_k, moe_dispatch=self.moe_dispatch,
            )
        else:
            logits = lm_apply(
                params, tokens, n_heads=self.n_heads,
                attention_fn=self._attention_fn(), remat=self.remat,
                moe_top_k=self.moe_top_k, moe_dispatch=self.moe_dispatch, shards=shards,
            )
        lg = logits[:, :-1]
        tgt = tokens[:, 1:]
        if shards is not None and shards.group is not None:
            nll = _vocab_parallel_nll(lg, tgt, shards.group, shards.index)
            pred = _vocab_parallel_argmax(lg, shards.group, shards.index)
        else:
            nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, tgt[..., None])[..., 0]
            pred = lg.argmax(dim=-1)
        mask = mask.float()
        n_valid = mask.sum().clamp_min(1.0)
        loss = (nll.mean(dim=1) * mask).sum() / n_valid
        hit = (pred == tgt).float()
        acc = (hit.mean(dim=1) * mask).sum() / n_valid
        return loss, {
            "loss": loss,
            "n_samples": n_valid,
            "n_err": torch.zeros((), dtype=torch.int32, device=loss.device),
            "token_accuracy": acc,
        }

    def _forward_metrics(self, params, x, y, mask, *, train: bool):
        return self.loss_metrics(params, x, mask)[1]

    def _create_initial_state(self) -> TrainState:
        params = init_lm_params(
            self.vocab, self.d_model, self.n_layers, self.n_heads, self.max_seq,
            d_ff=self.d_ff, moe_experts=self.moe_experts, rand_name=self.rand_name,
            device=self.device,
        )
        for layer in params:
            for w in layer.values():
                w.requires_grad_(True)
        if self.pipeline_parallel:
            # the policy's lm_pp_rules then keep this rank's stage block
            with torch.no_grad():
                params = stack_lm_blocks(params, self._n_stages)
            for _, w in param_paths(params):
                w.requires_grad_(True)
        return TrainState.create(params, prng.get("workflow").generator(self.device))
