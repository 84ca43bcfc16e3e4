"""The port's workflows take every keyword of the JAX package's, on the CPU.

Each JAX keyword of ``StandardWorkflow`` and ``TransformerLMWorkflow`` is in
the port's signature with the JAX default, so a JAX call site never gets a
``TypeError``.  At its default each is accepted; off its default, a keyword
whose path the port does not have yet raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item.
"""

import inspect

import numpy as np
import pytest

from znicz_tpu.workflow import StandardWorkflow as JaxStandard
from znicz_tpu.workflow.transformer import TransformerLMWorkflow as JaxLM
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.workflow.standard import StandardWorkflow
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

LAYERS = [{"type": "softmax", "->": {"output_sample_shape": 2}}]
PAIRS = [(JaxStandard, StandardWorkflow), (JaxLM, TransformerLMWorkflow)]


def _keywords(cls):
    return {
        n: p.default
        for n, p in inspect.signature(cls.__init__).parameters.items()
        if p.kind is inspect.Parameter.KEYWORD_ONLY
    }


def _standard(**kw):
    loader = FullBatchLoader({"train": np.zeros((4, 3), np.float32)},
                             {"train": np.zeros(4, np.int32)}, minibatch_size=2)
    return StandardWorkflow(loader, LAYERS, device="cpu", **kw)


def _lm(**kw):
    loader = FullBatchLoader({"train": np.zeros((2, 8), np.int32)}, minibatch_size=2)
    return TransformerLMWorkflow(loader, vocab=8, device="cpu", **kw)


@pytest.mark.parametrize("jax_cls,port_cls", PAIRS, ids=["standard", "lm"])
def test_every_jax_keyword_is_in_the_port_with_its_default(jax_cls, port_cls):
    jax_kw, port_kw = _keywords(jax_cls), _keywords(port_cls)
    assert set(jax_kw) <= set(port_kw), sorted(set(jax_kw) - set(port_kw))
    for name, default in jax_kw.items():
        assert port_kw[name] == default, (name, port_kw[name], default)


@pytest.mark.parametrize("make,jax_cls", [(_standard, JaxStandard), (_lm, JaxLM)],
                         ids=["standard", "lm"])
def test_jax_keywords_at_their_defaults_are_taken(make, jax_cls):
    """Every JAX keyword passed explicitly at its JAX default (``anomaly=True``
    included, although the port has no anomaly watch yet)."""
    skip = {"name", "rand_name", "vocab"}
    kw = {n: d for n, d in _keywords(jax_cls).items()
          if d is not inspect.Parameter.empty and n not in skip}
    wf = make(**kw)
    assert wf.device.type == "cpu"


@pytest.mark.parametrize(
    "make,kwargs,item",
    [
        (_standard, {"snapshot_dir": "snapshots"}, "A4"),
        (_standard, {"snapshot_config": {"interval": 1}}, "A4"),
        (_standard, {"prefetch_batches": 0}, "A4"),
        (_standard, {"parallel": object()}, "A6"),
        (_standard, {"epoch_dispatch": "scan"}, "A4"),
        (_standard, {"epoch_sync": "deferred"}, "A4"),
        (_standard, {"anomaly": False}, "A4"),
        (_standard, {"recovery": object()}, "A4"),
        (_lm, {"moe_top_k": 2}, "A7"),
        (_lm, {"moe_dispatch": "capacity"}, "A7"),
        (_lm, {"pipeline_microbatches": 4}, "A7"),
        (_lm, {"mesh": object()}, "A6"),
        (_lm, {"prefetch_batches": 0}, "A4"),
        (_lm, {"epoch_sync": "deferred"}, "A4"),
        (_lm, {"recovery": object()}, "A4"),
    ],
    ids=lambda v: v.__name__.strip("_") if callable(v) else (next(iter(v)) if isinstance(v, dict) else v),
)
def test_jax_keywords_off_their_defaults_are_refused_by_name(make, kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        make(**kwargs)
