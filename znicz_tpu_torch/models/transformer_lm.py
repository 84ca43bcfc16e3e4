"""Causal transformer language model sample (port of
``znicz_tpu/models/transformer_lm.py``).

A causal LM trained on synthetic bigram-structured token sequences, whose
loss floor is the bigram entropy (convergence is measurable without any
dataset on disk).  The chain and the sequences are drawn from the named
"datasets" numpy stream exactly as the JAX package draws them, so both
frameworks train on the same tokens.  ``moe_experts > 1`` makes each block's
FFN a gated mixture of experts.  ``pipeline_stages > 1`` pipelines the block
tower over a ``make_mesh(1, 1, pipeline_stages)`` mesh (one process a stage:
a world of fewer ranks raises, as the JAX package's mesh raises on a host
with fewer devices).
"""

import numpy as np

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.models import (
    effective_config,
    merge_workflow_kwargs,
    translate_unsupervised_overrides,
)
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

DEFAULTS = {
    "loader": {
        "n_train": 512,
        "n_test": 128,
        "seq_len": 64,
        "minibatch_size": 64,
    },
    "vocab": 32,
    "d_model": 64,
    "n_layers": 2,
    "n_heads": 4,
    "max_epochs": 15,
    # >1: pipeline the block tower over that many ranks
    "pipeline_stages": 0,
    "pipeline_microbatches": 0,
    # >1: each block's FFN becomes a gated mixture of experts (top_k and
    # dispatch are read only with it)
    "moe_experts": 0,
    "moe_top_k": 1,
    "moe_dispatch": "dense",
    # "bf16": q/k/v cast to bf16 at the attention boundary
    "attention_dtype": "f32",
}
root.transformer_lm.update(DEFAULTS)


def _bigram_chain(vocab: int) -> np.ndarray:
    """One fixed random bigram transition matrix: train and test come from
    the same language."""
    gen = prng.get("datasets")
    logits = gen.normal((vocab, vocab), 0.0, 2.0)
    return np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)


def _bigram_sequences(probs: np.ndarray, n: int, t: int) -> np.ndarray:
    gen = prng.get("datasets")
    vocab = probs.shape[0]
    out = np.zeros((n, t), np.int32)
    out[:, 0] = gen.integers(0, vocab, (n,))
    for i in range(1, t):
        u = gen.uniform((n,), 0.0, 1.0)
        cdf = probs[out[:, i - 1]].cumsum(axis=1)
        out[:, i] = (u[:, None] > cdf).sum(axis=1)
    return out


def build_workflow(**overrides) -> TransformerLMWorkflow:
    """The LM workflow on the bigram data; ``device=`` picks the device
    (default: the card, raising without one), other overrides go to
    :class:`TransformerLMWorkflow`."""
    # pick the device first: without a card this raises before any data is made
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.transformer_lm, DEFAULTS)
    lcfg = cfg.loader
    vocab = cfg.get("vocab", 32)
    t = lcfg.get("seq_len", 64)
    chain = _bigram_chain(vocab)
    train = _bigram_sequences(chain, lcfg.get("n_train", 512), t)
    test = _bigram_sequences(chain, lcfg.get("n_test", 128), t)
    loader = FullBatchLoader(
        {"train": train, "test": test},
        minibatch_size=lcfg.get("minibatch_size", 64),
    )
    defaults = {
        "vocab": vocab,
        "d_model": cfg.get("d_model", 64),
        "n_layers": cfg.get("n_layers", 2),
        "n_heads": cfg.get("n_heads", 4),
        "max_epochs": cfg.get("max_epochs", 15),
        "remat": bool(cfg.get("remat", False)),
        "attention_dtype": cfg.get("attention_dtype", "f32"),
        "moe_experts": int(cfg.get("moe_experts", 0) or 0),
        "moe_top_k": int(cfg.get("moe_top_k", 1) or 1),
        "moe_dispatch": cfg.get("moe_dispatch", "dense"),
        "name": "TransformerLMWorkflow",
    }
    pp_stages = int(cfg.get("pipeline_stages", 0) or 0)
    if pp_stages > 1:
        from znicz_tpu_torch.parallel import make_mesh

        defaults.update({
            "pipeline_parallel": True,
            # make_mesh checks the rank count: a world with fewer ranks
            # raises instead of running fewer stages than configured
            "mesh": make_mesh(1, 1, pp_stages),
            "pipeline_microbatches": int(cfg.get("pipeline_microbatches", 0) or 0) or None,
        })
    kwargs = merge_workflow_kwargs(defaults, overrides)
    kwargs = translate_unsupervised_overrides(kwargs, "max_epochs")
    return TransformerLMWorkflow(loader, **kwargs)


def run(load, main):
    load(build_workflow)
    main()
