"""The port stands alone: znicz_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and never fall back to the CPU unasked."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import znicz_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "znicz_tpu_torch")


def _forbidden(name: str) -> bool:
    # exact matches: "znicz_tpu_torch" itself starts with "znicz_tpu"
    return name in ("jax", "znicz_tpu") or name.startswith(("jax.", "znicz_tpu."))


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(znicz_tpu_torch.__path__, "znicz_tpu_torch.")
    )


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for name in (
        "core.prng", "core.config", "core.device", "ops.filling", "ops.activation",
        "ops.all2all", "ops.conv", "ops.pooling", "ops.dropout", "ops.normalization",
        "ops.kernels.lrn", "nn.optimizer", "nn.evaluator", "nn.decision",
        "nn.lr_adjust", "nn.train_state", "loader.base", "loader.fullbatch",
        "loader.datasets", "workflow.model", "workflow.workflow",
        "workflow.standard", "models.alexnet", "ops.attention",
        "ops.kernels.attention", "ops.kernels.cuda_build",
        "workflow.transformer", "models.transformer_lm", "loader.normalizers",
        "ops.kohonen", "ops.rbm", "ops.kernels.kohonen", "ops.kernels.rbm",
        "workflow.unsupervised", "models.kohonen", "models.mnist_rbm",
        "ops.cutter", "ops.accumulator", "ops.weights_zerofilling",
        "ops.resizable_all2all", "models.mnist", "models.wine", "models.cifar",
        "loader.image", "loader.native", "loader.imagenet", "models.kanji",
        "models.yale_faces", "ops.deconv", "models.mnist_ae", "models.video_ae",
        "utils.faults", "utils.profiling", "observability", "observability.registry",
        "observability.tracing", "observability.phases", "observability.pipeline",
        "observability.anomaly", "loader.prefetch", "workflow.snapshotter",
        "workflow.recovery", "ops.moe", "observability.device", "workflow.generate",
        "services", "services.engine", "services.errors",
        "observability.aggregate", "observability.collector", "observability.slo",
        "services.frontdoor", "services.serve", "cluster", "cluster.affinity",
        "cluster.registry", "cluster.router", "cluster.proxy", "observability.doctor",
        "parallel", "parallel.mesh", "parallel.multihost", "parallel.data_parallel",
        "loader.pool_sharded", "launcher", "core.subproc", "genetics", "ensemble",
        "utils.bench_diff",
    ):
        assert f"znicz_tpu_torch.{name}" in mods


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys, runpy\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "znicz_tpu_torch.ops.kernels.lrn" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert "triton" not in loaded  # imported only at a kernel's first launch
    # the image decoders need neither image library (JPEG imports Pillow
    # when it reads one)
    assert [m for m in loaded if m.split(".")[0] in ("PIL", "matplotlib")] == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_no_card_means_an_error_not_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from znicz_tpu_torch.core import device
    from znicz_tpu_torch.models import (
        alexnet, cifar, kanji, kohonen, mnist, mnist_ae, mnist_rbm, transformer_lm, video_ae,
        wine, yale_faces,
    )

    for model in (kohonen, mnist_rbm, mnist, wine, cifar, mnist_ae, video_ae, kanji, yale_faces):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.build_workflow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alexnet.build_workflow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer_lm.build_workflow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device.resolve("meta")


def test_param_builders_default_to_the_card():
    """The public builders put params on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from znicz_tpu_torch.ops import (
        accumulator, all2all, attention, conv, deconv, kohonen, rbm, weights_zerofilling,
    )
    from znicz_tpu_torch.workflow import model, transformer

    layers = [{"type": "softmax", "->": {"output_sample_shape": 3}}]
    for build in (
        lambda **kw: model.build(layers, (4,), **kw),
        lambda **kw: conv.init_params(2, 3, 3, 3, **kw),
        lambda **kw: deconv.init_params(1, 3, 3, 3, **kw),
        lambda **kw: all2all.init_params(4, 3, **kw),
        lambda **kw: attention.init_mha_params(8, 2, **kw),
        lambda **kw: transformer.init_lm_params(8, 8, 1, 2, 4, **kw),
        lambda **kw: kohonen.init_params(2, 2, 5, **kw),
        lambda **kw: kohonen.grid_coords(2, 2, **kw),
        lambda **kw: rbm.init_params(5, 3, **kw),
        lambda **kw: accumulator.init(4, **kw),
        lambda **kw: weights_zerofilling.make_group_mask(4, 2, 2, **kw),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert build(device="cpu") is not None


def test_loading_a_jax_snapshot_imports_neither_jax_nor_its_package(tmp_path):
    """The port reads a snapshot the JAX package wrote through its own
    restricted unpickler: the JAX class names map to port-local stand-ins."""
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
    from znicz_tpu.workflow import StandardWorkflow as JaxStandard

    jprng.reset()
    rng = np.random.default_rng(0)
    loader = JaxLoader({"train": rng.random((12, 5), np.float32)},
                       {"train": rng.integers(0, 3, 12)}, minibatch_size=4)
    wf = JaxStandard(loader, [{"type": "softmax", "->": {"output_sample_shape": 3}}],
                     snapshot_dir=str(tmp_path), prefetch_batches=0)
    wf.initialize()
    wf.run_epoch()
    path = wf.snapshotter.best_path
    code = (
        "import json, sys\n"
        "from znicz_tpu_torch.loader.fullbatch import FullBatchLoader\n"
        "from znicz_tpu_torch.workflow.snapshotter import load_snapshot\n"
        "from znicz_tpu_torch.workflow.standard import StandardWorkflow\n"
        "import numpy as np\n"
        f"state, host = load_snapshot({path!r})\n"
        "loader = FullBatchLoader({'train': np.zeros((12, 5), np.float32)},\n"
        "                         {'train': np.zeros(12, np.int32)}, minibatch_size=4)\n"
        "wf = StandardWorkflow(loader, [{'type': 'softmax', '->': {'output_sample_shape': 3}}],\n"
        "                      device='cpu')\n"
        f"wf.initialize(snapshot={path!r})\n"
        "print(json.dumps([type(state).__name__, wf.state.step, sorted(sys.modules)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    kind, step, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert (kind, step) == ("JaxTrainState", 3)
    assert [m for m in loaded if _forbidden(m)] == []
