"""Deconv, depooling and the MNIST and video autoencoders of the port
against the JAX package's, on the CPU.

``deconv.init_params`` draws JAX's weights exactly.  ``deconv.apply``'s
forward and its x- and weight-gradients agree with JAX's within 1e-5 of
the reference's largest magnitude (rtol 1e-5) at strides 1, 2 and 3, with
symmetric and asymmetric padding, a non-square kernel and an
``output_size`` above the minimal one; it is the adjoint of the port's
``conv.apply``.  ``depool_with_offset`` and ``upsample`` are exactly
JAX's.  ``mnist_ae`` (n_train 300 / n_test 100, its published widths),
``video_ae`` on its synthetic frames and on a PNG frame tree train 2 epochs
in both frameworks from one seed: initial weights exactly, per-epoch loss
and max_diff within rtol 1e-4, final weights within rtol 1e-4 / atol 1e-5
(f32, matmul precision "highest", TF32 off).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_image_loaders import write_png
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import mnist_ae as jax_mnist_ae, video_ae as jax_video_ae
from znicz_tpu.ops import deconv as jdeconv, pooling as jpooling
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.models import mnist_ae, video_ae
from znicz_tpu_torch.ops import conv, deconv, pooling
from znicz_tpu_torch.workflow import model as model_lib

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 1357
RTOL_OP = 1e-5
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5


def _seed_both():
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(SEED)


def _close(got, want, rtol=RTOL_OP):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize(
    "kw", [dict(), dict(weights_filling="gaussian", weights_stddev=0.05),
           dict(weights_filling="constant", weights_stddev=0.3)],
    ids=["default", "gaussian", "constant"],
)
def test_deconv_init_params_equal_jax_exactly(kw):
    _seed_both()
    want = jdeconv.init_params(3, 5, 4, 6, **kw)["weights"]
    got = deconv.init_params(3, 5, 4, 6, device="cpu", **kw)
    assert got.keys() == {"weights"}  # no bias, as in the reference
    assert tuple(got["weights"].shape) == (6, 4, 3, 5)  # [ky, kx, n_channels, n_kernels]
    np.testing.assert_array_equal(got["weights"].numpy(), np.asarray(want))


# (sliding (sx, sy), padding, kernel (kx, ky), extra output rows and columns,
# each below the stride, so that a conv of the output size gives the input)
DECONV_CASES = {
    "s1": ((1, 1), (0, 0, 0, 0), (3, 3), (0, 0)),
    "s2_sym": ((2, 2), (1, 1), (4, 4), (0, 0)),
    "s3_asym": ((3, 3), (2, 1, 0, 3), (5, 4), (0, 0)),
    "s2x3_nonsquare": ((2, 3), (1, 0, 2, 1), (3, 5), (0, 0)),
    "s2_bigger_output": ((2, 2), (1, 2, 1, 0), (4, 3), (1, 1)),
    "s3_bigger_output": ((3, 3), (0, 0, 0, 0), (10, 10), (2, 1)),
}


def _deconv_inputs(case):
    sliding, padding, (kx, ky), extra = DECONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = rng.standard_normal((ky, kx, 3, 4)).astype(np.float32) * 0.3
    n = deconv.output_shape(x.shape, 3, kx, ky, sliding, padding)
    size = (n[1] + extra[0], n[2] + extra[1]) if any(extra) else None
    g = rng.standard_normal((2, (size or n[1:3])[0], (size or n[1:3])[1], 3)).astype(np.float32)
    return x, w, g, dict(sliding=sliding, padding=padding, output_size=size)


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconv_forward_and_gradients_match_jax(case):
    x, w, g, kw = _deconv_inputs(case)

    def jloss(wj, xj):
        return jnp.sum(jdeconv.apply({"weights": wj}, xj, **kw) * g)

    y_j = jdeconv.apply({"weights": jnp.asarray(w)}, jnp.asarray(x), **kw)
    dw_j, dx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y_t = deconv.apply({"weights": wt}, xt, **kw)
    dw_t, dx_t = torch.autograd.grad((y_t * torch.from_numpy(g)).sum(), (wt, xt))
    _close(y_t.detach().numpy(), y_j)
    _close(dx_t.numpy(), dx_j)
    _close(dw_t.numpy(), dw_j)


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconv_is_the_adjoint_of_conv(case):
    """<conv(u), y> == <u, deconv(y)> with the same weights and geometry."""
    x, w, g, kw = _deconv_inputs(case)
    y = torch.from_numpy(x).double()
    wt = {"weights": torch.from_numpy(w).double()}
    u = torch.from_numpy(g).double()  # a tensor of the deconv's output shape
    cw = {"weights": wt["weights"], "bias": torch.zeros(4, dtype=torch.float64)}
    cu = conv.apply(cw, u, sliding=kw["sliding"], padding=kw["padding"])
    assert cu.shape == y.shape
    lhs = float((cu * y).sum())
    rhs = float((u * deconv.apply(wt, y, **kw)).sum())
    assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs))


def test_deconv_refuses_string_padding_as_jax_does():
    x = torch.zeros((1, 4, 4, 2))
    w = {"weights": torch.zeros((3, 3, 1, 2))}
    with pytest.raises(ValueError, match="explicit reference-style padding"):
        deconv.apply(w, x, padding="SAME")
    with pytest.raises(ValueError, match="explicit reference-style padding"):
        jdeconv.apply({"weights": jnp.zeros((3, 3, 1, 2))}, jnp.zeros((1, 4, 4, 2)),
                      padding="SAME")
    spec = [{"type": "deconv", "->": {"n_channels": 1, "kx": 3, "ky": 3, "padding": "SAME"}}]
    with pytest.raises(ValueError, match="explicit reference-style padding"):
        model_lib.build(spec, (4, 4, 2), device="cpu")


@pytest.mark.parametrize("window", [(2, 2, None), (3, 3, (2, 2)), (3, 2, (1, 2))],
                         ids=["2x2", "3x3_s2_overlapping", "3x2_s1x2"])
def test_depool_with_offset_and_upsample_equal_jax(window):
    kx, ky, sliding = window
    x = np.random.default_rng(kx * 10 + ky).standard_normal((2, 8, 9, 3)).astype(np.float32)
    yt, ot = pooling.max_pool_with_offset(torch.from_numpy(x), kx, ky, sliding)
    yj, oj = jpooling.max_pool_with_offset(jnp.asarray(x), kx, ky, sliding)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    got = deconv.depool_with_offset(yt, ot, x.shape)
    want = jdeconv.depool_with_offset(yj, oj, x.shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(deconv.upsample(yt, kx, ky).numpy(),
                                  np.asarray(jdeconv.upsample(yj, kx, ky)))


def _write_frames(root, seed=8):
    """A frame tree: train/<seq>/*.png and test/<seq>/*.png, drifting grey
    frames of mixed sizes, written by Pillow, matplotlib and the local
    writer (every row filter)."""
    import matplotlib.image as mpimg

    rng = np.random.default_rng(seed)
    k = 0
    for split, n_seq, frames in (("train", 3, 8), ("test", 2, 4)):
        for s in range(n_seq):
            d = root / split / f"seq{s}"
            d.mkdir(parents=True)
            base = rng.uniform(40, 200, (18, 20))
            drift = rng.normal(0, 3, (18, 20))
            for t in range(frames):
                f = np.clip(base + t * drift + rng.normal(0, 5, (18, 20)), 0, 255).astype(np.uint8)
                if k % 3 == 0:
                    write_png(str(d / f"{t:03d}.png"), f[..., None], 0, 8, [0, 1, 2, 3, 4])
                elif k % 3 == 1:
                    Image.fromarray(f).resize((16, 16)).save(d / f"{t:03d}.png")
                else:
                    mpimg.imsave(str(d / f"{t:03d}.png"), np.repeat(f[..., None], 3, axis=2))
                k += 1
    return str(root)


# name: (port module, JAX module, its root node, root overrides)
MODELS = {
    "mnist_ae": (mnist_ae, jax_mnist_ae, "mnist_ae", {"loader": {"n_train": 300, "n_test": 100}}),
    "video_ae_synthetic": (video_ae, jax_video_ae, "video_ae", {}),
    "video_ae_tree": (video_ae, jax_video_ae, "video_ae",
                      {"loader": {"data_dir": "tree", "minibatch_size": 7}}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    name = request.param
    tmod, jmod, node, over = MODELS[name]
    frames = _write_frames(tmp_path_factory.mktemp("frames"))
    saved = (jroot.to_dict(), troot.to_dict())
    _seed_both()
    try:
        for root in (jroot, troot):
            o = json.loads(json.dumps(over))
            if o.get("loader", {}).get("data_dir") == "tree":
                o["loader"]["data_dir"] = frames
            getattr(root, node).update(o)
        dc = {"max_epochs": 2}
        jwf = jmod.build_workflow(prefetch_batches=0, decision_config=dc)
        twf = tmod.build_workflow(device="cpu", decision_config=dc)
    finally:
        for root, t in zip((jroot, troot), saved):
            root.clear()
            root.update(t)
    out = {"name": name, "jax_init": jax.device_get(jwf.model.params),
           "torch_init": model_lib.params_to_numpy(twf.model.params),
           "jax_epochs": [], "torch_epochs": [],
           "shapes": (jwf.model.layer_shapes if hasattr(jwf.model, "layer_shapes") else None,
                      twf.model.layer_shapes, jwf.model.output_shape, twf.model.output_shape)}
    jwf.initialize()
    twf.initialize()
    for _ in range(2):
        out["jax_epochs"].append(jwf.run_epoch()["summary"])
        out["torch_epochs"].append(twf.run_epoch()["summary"])
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    shutil.rmtree(frames, ignore_errors=True)
    tprng.reset()
    return out


def test_autoencoder_init_and_shapes_equal_jax(runs):
    _, tshapes, jout, tout = runs["shapes"]
    assert tout == jout
    if runs["name"] == "mnist_ae":
        assert tshapes == ((7, 7, 12), (28, 28, 1))
    for lj, lt in zip(runs["jax_init"], runs["torch_init"]):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_autoencoder_epochs_equal_jax(runs):
    for ej, et in zip(runs["jax_epochs"], runs["torch_epochs"]):
        assert sorted(et) == sorted(ej)
        for split in ej:
            assert et[split]["n_samples"] == ej[split]["n_samples"]
            for key in ("loss", "max_diff"):
                np.testing.assert_allclose(et[split][key], ej[split][key], rtol=RTOL_EPOCH,
                                           err_msg=f"{runs['name']} {split} {key}")


def test_autoencoder_final_weights_equal_jax(runs):
    for lj, lt in zip(runs["jax_final"], runs["torch_final"]):
        for k in lj:
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)
