"""Causal transformer language-model workflow (port of
``znicz_tpu/workflow/transformer.py``, single device, dense FFN).

Pre-LN blocks (layer norm, multi-head attention, tanh FFN) over learned
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

Not ported here, and refused with ``NotImplementedError`` naming their
``ROADMAP.md`` item: MoE blocks (``moe_experts``, ``moe_top_k``,
``moe_dispatch``), sequence/tensor/pipeline parallelism
(``pipeline_microbatches``, ``mesh``), the ``parallel=`` placement policy
and ``generate()``; each JAX keyword is taken at its JAX default.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.loader.base import Loader
from znicz_tpu_torch.nn import optimizer
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.nn.train_state import TrainState
from znicz_tpu_torch.ops import attention as attention_op
from znicz_tpu_torch.ops.filling import fill
from znicz_tpu_torch.ops.kernels.attention import flash_attention, kernel_head_dim
from znicz_tpu_torch.ops.normalization import layer_norm
from znicz_tpu_torch.workflow.workflow import Workflow, refuse_unported

ATTENTIONS = ("dot", "flash", "auto")
METRICS = ["loss", "n_samples", "n_err", "token_accuracy"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to znicz_tpu_torch yet (ROADMAP.md {item})"
    )


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
    pos, then per block ``w_up``, ``w_down`` and the attention's ``wq, wk,
    wv, wo``, then the head; layer-norm scales are ones and biases zeros."""
    if moe_experts > 1:
        raise _not_ported("moe_experts > 1 (MoE FFN blocks)", "A7, ops/moe.py")
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
        block["w_up"] = draw((d_model, d_ff), std)
        block["up_bias"] = zeros(d_ff)
        block["w_down"] = draw((d_ff, d_model), 1.0 / np.sqrt(d_ff))
        block["down_bias"] = zeros(d_model)
        block.update(attention_op.init_mha_params(d_model, n_heads, rand_name=rand_name, device=dev))
        params.append(block)
    params.append({"head": draw((d_model, vocab), std)})
    return params


def _embed_tokens(embed, tokens):
    t = tokens.shape[1]
    return embed["embed"][tokens] + embed["pos"][:t][None, :, :]


def _block_ffn(block, h):
    """The block's position-wise FFN: dense two-layer tanh."""
    h = torch.tanh(h @ block["w_up"] + block["up_bias"])
    return h @ block["w_down"] + block["down_bias"]


def _block_forward(block, x, *, n_heads, attention_fn=None):
    """One pre-LN transformer block."""
    attention_fn = attention_fn or attention_op.dot_product_attention
    h = layer_norm(x, block["ln1_scale"], block["ln1_bias"])
    x = x + attention_op.mha(block, h, n_heads=n_heads, causal=True, attention_fn=attention_fn)
    h = layer_norm(x, block["ln2_scale"], block["ln2_bias"])
    return x + _block_ffn(block, h)


def lm_apply(params, tokens, *, n_heads, attention_fn=None, remat=False):
    """tokens [B, T] integer -> logits [B, T, vocab].

    ``remat``: each block runs under ``torch.utils.checkpoint``, its
    activations recomputed in the backward instead of stored (the JAX
    package's ``jax.checkpoint``); the numbers are unchanged."""
    blk = partial(_block_forward, n_heads=n_heads, attention_fn=attention_fn)
    x = _embed_tokens(params[0], tokens)
    for block in params[1:-1]:
        x = checkpoint(blk, block, x, use_reentrant=False) if remat else blk(block, x)
    return x @ params[-1]["head"]


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
        refuse_unported((
            (moe_experts > 1, "moe_experts > 1 (MoE FFN blocks)", "A7, ops/moe.py"),
            (moe_top_k != 1, "moe_top_k != 1 (MoE routing)", "A7, ops/moe.py"),
            (moe_dispatch != "dense", "moe_dispatch != 'dense' (MoE capacity dispatch)",
             "A7, ops/moe.py"),
            (sequence_parallel, "sequence_parallel (ring attention)",
             "A7, parallel/ring_attention.py"),
            (tensor_parallel, "tensor_parallel", "A6, lm_tp_rules"),
            (pipeline_parallel, "pipeline_parallel", "A7, parallel/pipeline.py"),
            (pipeline_microbatches is not None, "pipeline_microbatches (GPipe)",
             "A7, parallel/pipeline.py"),
            (mesh is not None, "a mesh= device mesh", "A6, parallel/mesh.py"),
        ))
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
        self.rand_name = rand_name
        self.max_seq = int(loader.sample_shape[0])

    def _batch_target(self, mb):
        return np.zeros(len(mb.mask), np.int32)  # unused host-side dummy

    def generate(self, *args, **kwargs):
        raise _not_ported("generate() (KV-cache decoding)", "A8, workflow/generate.py")

    def _attention_fn_base(self):
        """The flash kernels where the JAX package picks its kernel on the
        TPU (here: on the card, at a head dim the kernels take) or where
        asked; else None (dense)."""
        on_card = self.device.type == "cuda"
        has_kernel = kernel_head_dim(self.d_model // self.n_heads) is not None
        if self.attention == "flash" or (
            self.attention == "auto" and on_card and self.max_seq >= 512 and has_kernel
        ):
            return flash_attention
        return None

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
        logits = lm_apply(
            params, tokens, n_heads=self.n_heads,
            attention_fn=self._attention_fn(), remat=self.remat,
        )
        lg = logits[:, :-1]
        tgt = tokens[:, 1:]
        nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, tgt[..., None])[..., 0]
        mask = mask.float()
        n_valid = mask.sum().clamp_min(1.0)
        loss = (nll.mean(dim=1) * mask).sum() / n_valid
        hit = (lg.argmax(dim=-1) == tgt).float()
        acc = (hit.mean(dim=1) * mask).sum() / n_valid
        return loss, {
            "loss": loss,
            "n_samples": n_valid,
            "n_err": torch.zeros((), dtype=torch.int32, device=loss.device),
            "token_accuracy": acc,
        }

    def _forward_metrics(self, params, x, y, mask, *, train: bool):
        return self.loss_metrics(params, x, mask)[1]

    def _hyper(self):
        return [self.hyper] * len(self.state.params)

    def _create_initial_state(self) -> TrainState:
        params = init_lm_params(
            self.vocab, self.d_model, self.n_layers, self.n_heads, self.max_seq,
            d_ff=self.d_ff, rand_name=self.rand_name, device=self.device,
        )
        for layer in params:
            for w in layer.values():
                w.requires_grad_(True)
        return TrainState.create(params, prng.get("workflow").generator(self.device))
