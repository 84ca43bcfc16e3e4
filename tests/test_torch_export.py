"""The port's export for the native engine against the JAX package's, on
the CPU.

For the same params (the JAX model's, carried over by ``params_from_jax``)
``znicz_tpu_torch.export`` writes the JAX package's ZNICZT01 artifact byte
for byte: the header JSON with its key order and its int and float
coercion, and the float32 blobs.  The layer lists cover an MLP, a small net
of AlexNet's layer types (conv, LRN, max and average pooling, dropout, FC,
softmax), an autoencoder (cutter, conv, deconv) and the transformer LM,
dense and MoE.  ``validate_exportable`` refuses with JAX's messages.  The
native engine (``native/znicz_infer.cc``, built with g++ as
``tests/test_native.py`` builds it) reproduces the port's forward within
that file's tolerances: rtol 1e-4 / atol 1e-5, 1e-3 / 1e-4 for the conv
stack, 1e-4 / 1e-4 for the LM's logits.
"""

import os
import re
import shutil
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import export as jexport
from znicz_tpu.core import prng as jprng
from znicz_tpu.workflow import build as jbuild
from znicz_tpu.workflow.transformer import init_lm_params as jinit_lm
from znicz_tpu_torch import export as texport
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.workflow import build as tbuild, model as model_lib
from znicz_tpu_torch.workflow.transformer import lm_apply

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NETS = {  # name: (layer list, per-sample input shape, rtol, atol)
    "mlp": ([
        {"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
        {"type": "softmax", "->": {"output_sample_shape": 10}},
    ], (64,), 1e-4, 1e-5),
    "alexnet_types": ([
        {"type": "conv_str", "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2),
                                    "padding": (2, 2, 2, 2)}},
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_relu", "->": {"n_kernels": 6, "kx": 3, "ky": 3,
                                     "padding": (1, 1, 1, 1)}},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 16}},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax", "->": {"output_sample_shape": 7}},
    ], (23, 23, 3), 1e-3, 1e-4),
    "autoencoder": ([
        {"type": "cutter", "->": {"padding": (1, 2, 1, 0)}},
        {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3, "sliding": (2, 2),
                                     "padding": (1, 1, 1, 1)}},
        {"type": "deconv", "->": {"n_channels": 2, "kx": 3, "ky": 3, "sliding": (2, 2),
                                  "padding": (1, 1, 1, 1)}},
    ], (12, 10, 2), 1e-4, 1e-5),
}
LM = dict(vocab=17, d_model=32, n_layers=2, n_heads=4, max_seq=12)


def _carry(jparams):
    """The JAX params as the port's, each dict in its own key order (a
    pytree round trip would sort the keys)."""
    return [{k: model_lib.params_from_jax([{k: jax.device_get(v)}], "cpu")[0][k]
             for k, v in layer.items()} for layer in jparams]


def _models(name, seed=3):
    """The JAX model of ``name`` and the port's with the JAX model's params;
    the port's own build names each layer's params in JAX's order."""
    layers, shape, _, _ = NETS[name]
    jprng.seed_all(seed)
    jm = jbuild(layers, shape)
    tprng.seed_all(seed)
    tm = tbuild(layers, shape, device="cpu")
    assert [list(p) for p in tm.params] == [list(p) for p in jm.params]
    return jm, tm._replace(params=_carry(jm.params))


def _lm_params(moe_experts=0, seed=27):
    jprng.seed_all(seed)
    jp = jinit_lm(LM["vocab"], LM["d_model"], LM["n_layers"], LM["n_heads"],
                  max_seq=LM["max_seq"], moe_experts=moe_experts)
    return jp, _carry(jp)


@pytest.mark.parametrize("name", sorted(NETS))
def test_layer_list_artifact_is_jax_byte_for_byte(name, tmp_path):
    jm, tm = _models(name)
    jh = jexport.export_model(jm, str(tmp_path / "jax.znicz"))
    th = texport.export_model(tm, str(tmp_path / "port.znicz"))
    assert th == jh
    assert (tmp_path / "port.znicz").read_bytes() == (tmp_path / "jax.znicz").read_bytes()


@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_lm_artifact_is_jax_byte_for_byte(moe_experts, tmp_path):
    jp, tp = _lm_params(moe_experts)
    kw = dict(n_heads=LM["n_heads"], moe_top_k=2 if moe_experts else None)
    jexport.export_lm_model(jp, str(tmp_path / "jax.znicz"), **kw)
    texport.export_lm_model(tp, str(tmp_path / "port.znicz"), **kw)
    assert (tmp_path / "port.znicz").read_bytes() == (tmp_path / "jax.znicz").read_bytes()


def test_bf16_and_non_contiguous_params_go_to_the_host_as_f32(tmp_path):
    """A param given in bf16, or as a transposed view, is written as its
    contiguous float32 values."""
    jm, tm = _models("mlp")
    p = [dict(layer) for layer in tm.params]
    w = p[0]["weights"]
    p[0]["weights"] = w.t().contiguous().t()  # the same values, a strided view
    p[1]["bias"] = p[1]["bias"].to(torch.bfloat16)
    texport.export_model(tm._replace(params=p), str(tmp_path / "port.znicz"))
    jparams = [{k: np.asarray(v) for k, v in layer.items()} for layer in jm.params]
    jparams[1]["bias"] = p[1]["bias"].float().numpy()
    jexport.export_model(jm._replace(params=jparams), str(tmp_path / "jax.znicz"))
    assert (tmp_path / "port.znicz").read_bytes() == (tmp_path / "jax.znicz").read_bytes()


REFUSALS = {
    "no_layer_specs": types.SimpleNamespace(),
    "unsupported_type": types.SimpleNamespace(
        layer_specs=({"type": "all2all"}, {"type": "kohonen"}, {"type": "rbm"})),
    "string_padding": types.SimpleNamespace(
        layer_specs=({"type": "conv", "padding": "SAME"},)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_validate_exportable_refuses_as_jax(case):
    model = REFUSALS[case]
    with pytest.raises(ValueError) as jerr:
        jexport.validate_exportable(model)
    with pytest.raises(ValueError) as terr:
        texport.validate_exportable(model)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        texport.export_model(model, os.devnull)


def test_lm_refusals_are_jax_messages():
    jp, tp = _lm_params(moe_experts=4)
    for call in (lambda m, p: m.export_lm_model(p, os.devnull, n_heads=LM["n_heads"]),
                 lambda m, p: m.export_lm_model(p[:2], os.devnull, n_heads=LM["n_heads"]),
                 lambda m, p: m.export_lm_model(p, os.devnull, n_heads=5, moe_top_k=2)):
        with pytest.raises(ValueError) as jerr:
            call(jexport, jp)
        with pytest.raises(ValueError) as terr:
            call(texport, tp)
        assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def znicz_infer(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available: the native engine cannot be built")
    exe = str(tmp_path_factory.mktemp("native") / "znicz_infer")
    subprocess.run(["g++", "-O2", "-std=c++17", os.path.join(REPO, "native", "znicz_infer.cc"),
                    "-o", exe], check=True, capture_output=True)
    return exe


def _engine(exe, model_path, x, tmp_path):
    in_path, out_path = str(tmp_path / "in.f32"), str(tmp_path / "out.f32")
    np.asarray(x, np.float32).tofile(in_path)
    subprocess.run([exe, model_path, in_path, out_path, str(x.shape[0])], check=True,
                   capture_output=True)
    return np.fromfile(out_path, np.float32)


@pytest.mark.parametrize("name", sorted(NETS))
def test_native_engine_gives_the_ports_forward(name, znicz_infer, tmp_path):
    _, tm = _models(name)
    _, shape, rtol, atol = NETS[name]
    x = np.random.default_rng(5).standard_normal((3,) + shape).astype(np.float32)
    path = str(tmp_path / "m.znicz")
    texport.export_model(tm, path)
    with torch.no_grad():
        want = tm.predict(tm.params, torch.from_numpy(x)).numpy()
    got = _engine(znicz_infer, path, x, tmp_path).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_native_lm_gives_the_ports_logits(moe_experts, znicz_infer, tmp_path):
    _, tp = _lm_params(moe_experts)
    top_k = 2 if moe_experts else None
    tokens = np.random.default_rng(7).integers(0, LM["vocab"], (3, LM["max_seq"]))
    with torch.no_grad():
        want = lm_apply(tp, torch.from_numpy(tokens), n_heads=LM["n_heads"],
                        **({"moe_top_k": top_k} if top_k else {})).numpy()
    path = str(tmp_path / "lm.znicz")
    texport.export_lm_model(tp, path, n_heads=LM["n_heads"], moe_top_k=top_k)
    got = _engine(znicz_infer, path, tokens.astype(np.float32), tmp_path).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
