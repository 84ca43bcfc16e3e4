"""The port's topology introspection against the JAX package's, on the CPU:
``model_summary`` and ``to_dot`` give JAX's text character for character
for the same layer list (AlexNet's layer types, an MLP, an autoencoder)
and the same workflow shape (loader, snapshotter, services)."""

import pytest

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import datasets as jdatasets
from znicz_tpu.services import MetricsCSVWriter as JCSV, StatusWriter as JStatus
from znicz_tpu.workflow import (
    StandardWorkflow as JWF,
    build as jbuild,
    model_summary as jsummary,
    to_dot as jdot,
)
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import datasets as tdatasets
from znicz_tpu_torch.services import MetricsCSVWriter as TCSV, StatusWriter as TStatus
from znicz_tpu_torch.workflow import (
    StandardWorkflow as TWF,
    build as tbuild,
    model_summary as tsummary,
    to_dot as tdot,
)

NETS = {
    "mlp": ([{"type": "all2all_tanh", "->": {"output_sample_shape": 100}},
             {"type": "softmax", "->": {"output_sample_shape": 10}}], (784,)),
    "alexnet_types": ([
        {"type": "conv_relu", "->": {"n_kernels": 12, "kx": 5, "ky": 5, "sliding": (2, 2)}},
        {"type": "norm", "->": {"n": 5}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 4096}},
        {"type": "softmax", "->": {"output_sample_shape": 1000}},
    ], (31, 31, 3)),
    "autoencoder": ([
        {"type": "conv_tanh", "->": {"n_kernels": 6, "kx": 5, "ky": 5, "sliding": (3, 3)}},
        {"type": "deconv", "->": {"n_channels": 1, "kx": 5, "ky": 5, "sliding": (3, 3)}},
    ], (14, 14, 1)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_model_summary_is_jaxs_text(name):
    layers, shape = NETS[name]
    jprng.seed_all(1)
    tprng.seed_all(1)
    want = jsummary(jbuild(layers, shape))
    assert tsummary(tbuild(layers, shape, device="cpu")) == want


@pytest.mark.parametrize("snapshot", [False, True], ids=["bare", "snapshotter_services"])
def test_to_dot_is_jaxs_text(snapshot, tmp_path):
    layers, _ = NETS["mlp"]
    wfs = []
    for side, (data, wf_cls, csv, status) in enumerate((
            (jdatasets, JWF, JCSV, JStatus), (tdatasets, TWF, TCSV, TStatus))):
        loader = data.mnist(n_train=200, n_test=50, minibatch_size=50)
        kw = {"device": "cpu"} if side else {}
        if snapshot:
            kw["snapshot_dir"] = str(tmp_path / f"s{side}")
        wf = wf_cls(loader, layers, **kw)
        if snapshot:
            wf.services += [csv(str(tmp_path / f"c{side}")), status(str(tmp_path / f"w{side}")),
                            csv(str(tmp_path / f"d{side}"))]
        wfs.append(wf)
    want = jdot(wfs[0])
    assert tdot(wfs[1]) == want
    assert ("svc_2_MetricsCSVWriter" in want) == snapshot
