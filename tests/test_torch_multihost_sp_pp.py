"""Sequence and pipeline parallelism of the port's LM on the CPU, over gloo
process groups, against the JAX package on the same mesh of its virtual
devices.

One job of two ranks and one of four (``python -c`` workers, as
``tests/test_torch_multihost.py`` starts them; each job runs every workload
once, module-scoped) train the small LM for two epochs: with
``sequence_parallel`` over ``mesh=`` alone (every rank the whole batch),
with ``parallel=DataParallel`` (every rank its rows), with the flash inner
(the kernels' plain versions here; the JAX side runs its Pallas kernel in
interpret mode), with the MoE and, on four ranks, with
``tensor_parallel`` on ``(2, 2)``; with ``pipeline_parallel`` on ``(1, 1,
2)`` and ``(1, 1, 4)`` (dot and flash), on ``(2, 1, 2)`` with data
parallelism (dense, and the MoE in both dispatches: the microbatches hold
the JAX package's rows), and on ``(1, 2, 2)`` with tensor parallelism
(dot, flash and the dense MoE).  Per-epoch loss within rtol 1e-4 of the
JAX package's run (2e-4 where the JAX package's own test allows it, bf16
attention within its 2e-2 of the f32 run); every rank's history is the
same.  A pipelined snapshot holds the JAX package's ``{"embed", "stages",
"head"}`` layout whole and resumes exactly; the ``pipeline_stages``
config route trains; the automatic microbatch counts are the JAX
package's; ``generate()`` refuses pipelined params as the JAX package
does.
"""

import os

import numpy as np
import pytest

from test_torch_multihost import RTOL, run_ranks

LM = dict(vocab=16, d_model=32, n_heads=2, max_epochs=2)
# label -> (mesh (data, model, pipe), tokens, batch, seed, how, keywords)
# how: "mesh" passes mesh= alone, "dp" parallel=DataParallel(mesh) (and
# mesh= too under sequence parallelism)
MOE = dict(moe_experts=4, moe_top_k=2)
WORKLOADS = {
    "sp_mesh": ((2, 1, 1), "t16x32", 16, 5, "mesh", dict(n_layers=2, sequence_parallel=True)),
    "sp_dp": ((2, 1, 1), "t16x32", 16, 5, "dp", dict(n_layers=2, sequence_parallel=True)),
    "sp_flash": ((2, 1, 1), "t8x64", 8, 21, "mesh",
                 dict(n_layers=1, sequence_parallel=True, attention="flash")),
    "sp_moe": ((2, 1, 1), "t16x64", 8, 43, "dp", dict(n_layers=2, sequence_parallel=True, **MOE)),
    "sp_dp_flash": ((2, 1, 1), "t32x64", 16, 67, "dp",
                    dict(n_layers=2, sequence_parallel=True, attention="flash")),
    "sp_dp_flash_bf16": ((2, 1, 1), "t32x64", 16, 67, "dp",
                         dict(n_layers=2, sequence_parallel=True, attention="flash",
                              attention_dtype="bf16")),
    "pp2": ((1, 1, 2), "t16x16", 16, 6, "mesh",
            dict(n_layers=4, pipeline_parallel=True, pipeline_microbatches=4)),
    "pp2_flash": ((1, 1, 2), "t8x16", 8, 14, "mesh",
                  dict(n_layers=2, attention="flash", pipeline_parallel=True,
                       pipeline_microbatches=2)),
    "sp_tp": ((2, 2, 1), "t16x32", 16, 5, "dp",
              dict(n_layers=2, sequence_parallel=True, tensor_parallel=True)),
    "pp4": ((1, 1, 4), "t16x16", 16, 6, "mesh",
            dict(n_layers=4, pipeline_parallel=True, pipeline_microbatches=4)),
    "dp_pp": ((2, 1, 2), "t32x16", 16, 33, "dp",
              dict(n_layers=4, pipeline_parallel=True, pipeline_microbatches=4)),
    "dp_pp_moe_dense": ((2, 1, 2), "t32x16", 16, 53, "dp",
                        dict(n_layers=4, pipeline_parallel=True, pipeline_microbatches=4,
                             **MOE)),
    "dp_pp_moe_capacity": ((2, 1, 2), "t32x16", 16, 53, "dp",
                           dict(n_layers=4, pipeline_parallel=True, pipeline_microbatches=4,
                                moe_dispatch="capacity", **MOE)),
    "pp_tp": ((1, 2, 2), "t32x16", 16, 33, "dp",
              dict(n_layers=4, pipeline_parallel=True, tensor_parallel=True,
                   pipeline_microbatches=4)),
    "pp_tp_flash": ((1, 2, 2), "t32x64", 16, 33, "dp",
                    dict(n_layers=4, attention="flash", pipeline_parallel=True,
                         tensor_parallel=True, pipeline_microbatches=4)),
    "pp_tp_moe": ((1, 2, 2), "t32x16", 16, 57, "dp",
                  dict(n_layers=4, pipeline_parallel=True, tensor_parallel=True,
                       pipeline_microbatches=4, **MOE)),
}
TOKENS = {"t16x32": (2, 16, 32), "t8x64": (11, 8, 64), "t16x64": (5, 16, 64),
          "t32x64": (5, 32, 64), "t16x16": (4, 16, 16), "t8x16": (9, 8, 16),
          "t32x16": (5, 32, 16)}
JAX_RTOL = {"pp_tp_flash": 2e-4}


def _tokens(name):
    seed, n, t = TOKENS[name]
    return np.random.default_rng(seed).integers(0, 16, (n, t)).astype(np.int32)


WORK = (f"LM = {LM!r}\nWORKLOADS = {WORKLOADS!r}\nTOKENS = {TOKENS!r}\n"
        + r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader import FullBatchLoader
from znicz_tpu_torch.models import transformer_lm
from znicz_tpu_torch.workflow import TransformerLMWorkflow
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
world, out_dir = int(ARGS[0]), ARGS[1]
exec(ARGS[2])  # _tokens
out = {}

def make(label, snapshotter=None):
    shape, tok, mb, seed, how, kw = WORKLOADS[label]
    mesh = make_mesh(*shape)
    place = {"mesh": mesh} if how == "mesh" else {"parallel": DataParallel(mesh)}
    if how == "dp" and kw.get("sequence_parallel"):
        place["mesh"] = mesh
    prng.reset()
    prng.seed_all(seed)
    return TransformerLMWorkflow(FullBatchLoader({"train": _tokens(tok)}, minibatch_size=mb),
                                 device="cpu", snapshotter=snapshotter, **LM, **kw, **place)

for label, (shape, *_rest) in WORKLOADS.items():
    if shape[0] * shape[1] * shape[2] != world:
        continue
    snap = Snapshotter(os.path.join(out_dir, "snaps"), "pplm", interval=1, compress=False) \
        if label == "pp2" else None
    wf = make(label, snap)
    wf.initialize(seed=WORKLOADS[label][3])
    out[label] = [e["train"]["loss"] for e in wf.run().history]
    if label == "pp2":
        # the first epoch's snapshot resumes exactly: the second epoch's
        # loss, then every stage leaf, gathered whole, as the run's
        wf2 = make(label)
        wf2.initialize(snapshot=os.path.join(out_dir, "snaps", "pplm_epoch0.pickle"))
        resumed = {"step": int(wf2.state.step), "epoch": wf2.decision.epoch,
                   "loss": wf2.run_epoch()["summary"]["train"]["loss"]}
        a = wf.parallel.gather_state(wf.state.params)
        b = wf2.parallel.gather_state(wf2.state.params)
        out["resume"] = dict(resumed, local_w_up=list(wf2.state.params["stages"][0]["w_up"].shape),
                             same=all(torch.equal(x, y) for (_, x), (_, y) in
                                      zip(_paths(a), _paths(b), strict=True)))
    if label == "pp_tp":
        out["pp_tp_local_wq"] = list(wf.state.params["stages"][0]["wq"].shape)
if world == 2:  # the config route: root.transformer_lm.pipeline_stages
    prng.reset()
    prng.seed_all(8)
    troot.transformer_lm.loader.update({"n_train": 64, "n_test": 0, "seq_len": 16,
                                        "minibatch_size": 32})
    troot.transformer_lm.update({"n_layers": 4, "pipeline_stages": 2,
                                 "pipeline_microbatches": 2})
    wf = transformer_lm.build_workflow(device="cpu", max_epochs=2)
    wf.initialize(seed=8)
    out["config"] = {"stages": wf._n_stages, "micro": wf.pipeline_microbatches,
                     "pp": wf.pipeline_parallel,
                     "loss": [e["train"]["loss"] for e in wf.run().history]}
if world == 4:  # the automatic microbatch counts on a (1, 1, 4) mesh
    auto = {}
    for bs in (24, 32):
        wf = TransformerLMWorkflow(
            FullBatchLoader({"train": np.zeros((48, 16), np.int32)}, minibatch_size=bs),
            vocab=16, d_model=32, n_layers=4, n_heads=2, device="cpu",
            pipeline_parallel=True, mesh=make_mesh(1, 1, 4))
        auto[bs] = wf.pipeline_microbatches
    out["auto"] = auto
report(**out)
''')

HELPERS = __import__("inspect").getsource(_tokens) + r'''
def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]
'''


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each world's job, run once: ``{world: (reports, its directory)}``."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"sp_pp{world}")
        out[world] = (run_ranks(WORK, world, d, HELPERS, world=world, timeout=600), d)
    return out


def _jax_losses(label):
    """The JAX package's run of ``label`` on the same mesh of its virtual
    devices: the per-epoch train losses."""
    import jax

    from znicz_tpu.core import prng
    from znicz_tpu.loader import FullBatchLoader
    from znicz_tpu.parallel import DataParallel, make_mesh
    from znicz_tpu.workflow import TransformerLMWorkflow

    (nd, nm, npp), tok, mb, seed, how, kw = WORKLOADS[label]
    kw = dict(kw)
    if label == "sp_dp_flash_bf16":  # held to the f32 run, as the JAX package's test
        kw.pop("attention_dtype")
    mesh = make_mesh(nd, nm, npp, devices=jax.devices()[:nd * nm * npp])
    place = {"mesh": mesh} if how == "mesh" else {"parallel": DataParallel(mesh)}
    if how == "dp" and kw.get("sequence_parallel"):
        place["mesh"] = mesh
    prng.reset()
    prng.seed_all(seed)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": _tokens(tok)}, minibatch_size=mb),
                               prefetch_batches=0, **LM, **kw, **place)
    wf.initialize(seed=seed)
    return [e["train"]["loss"] for e in wf.run().history]


@pytest.mark.parametrize("label", list(WORKLOADS))
def test_lm_matches_jax_on_the_same_mesh(jobs, label):
    shape = WORKLOADS[label][0]
    reports = jobs[shape[0] * shape[1] * shape[2]][0]
    got = reports[0][label]
    for r in reports[1:]:
        assert r[label] == got  # one history on every rank
    assert all(np.isfinite(got))
    rtol = 2e-2 if label.endswith("bf16") else JAX_RTOL.get(label, RTOL)
    np.testing.assert_allclose(got, _jax_losses(label), rtol=rtol)


def test_pipelined_snapshot_holds_jax_layout_and_resumes(jobs):
    """The coordinator's pipelined snapshot holds the JAX package's
    ``{"embed", "stages", "head"}`` layout with every stage leaf whole
    ([2, ...], a rank holding [1, ...]), loads in the JAX package, and
    resumes exactly on both ranks, which train on from it."""
    from znicz_tpu.workflow.snapshotter import load_snapshot

    reports, d = jobs[2]
    state, _ = load_snapshot(os.path.join(d, "snaps", "pplm_epoch0.pickle"))
    params = state[0]
    assert sorted(params) == ["embed", "head", "stages"]
    assert len(params["stages"]) == 2  # 4 blocks: 2 a stage
    assert np.asarray(params["stages"][0]["w_up"]).shape == (2, 32, 128)
    for r in reports:
        assert r["resume"]["local_w_up"] == [1, 32, 128]
        assert r["resume"]["step"] == 1 and r["resume"]["epoch"] == 1
        # the resumed second epoch is the run's, bit for bit
        assert r["resume"]["loss"] == r["pp2"][1] and r["resume"]["same"]


def test_pp_tp_holds_a_stage_and_a_model_block(jobs):
    """Under PP x TP a rank holds ``wq``'s block of its stage and its
    model position: [1, d, d / n_model] of the stacked [S, d, d]."""
    for r in jobs[4][0]:
        assert r["pp_tp_local_wq"] == [1, 32, 16]


def test_pipeline_via_config_tree(jobs):
    """``root.transformer_lm.pipeline_stages = 2``: the model module builds
    a (1, 1, 2) mesh and a pipelined workflow, which trains."""
    for r in jobs[2][0]:
        cfg = r["config"]
        assert cfg["pp"] and cfg["stages"] == 2 and cfg["micro"] == 2
        assert all(np.isfinite(cfg["loss"]))


def test_automatic_microbatches_are_jax(jobs):
    """The default count: 6 S clamped to the batch (24 on four stages at
    batch 24, 16 at batch 32), and on a data axis to a count whose
    microbatch rows divide by it (batch 24, two stages, data axis 4: 6),
    as the JAX package's."""
    import jax

    from znicz_tpu.loader import FullBatchLoader
    from znicz_tpu.parallel import DataParallel, make_mesh
    from znicz_tpu.workflow import TransformerLMWorkflow

    def jax_count(bs, mesh, parallel=None):
        return TransformerLMWorkflow(
            FullBatchLoader({"train": np.zeros((48, 16), np.int32)}, minibatch_size=bs),
            vocab=16, d_model=32, n_layers=4, n_heads=2, pipeline_parallel=True,
            mesh=None if parallel else mesh, parallel=parallel).pipeline_microbatches

    four = make_mesh(1, 1, 4, devices=jax.devices()[:4])
    for r in jobs[4][0]:
        assert r["auto"] == {"24": jax_count(24, four), "32": jax_count(32, four)}
        assert r["auto"] == {"24": 24, "32": 16}
    # a (4, 1, 2) mesh needs eight ranks: the same search, held to JAX's
    from znicz_tpu_torch.workflow import transformer as tt

    dp = DataParallel(make_mesh(4, 1, 2))
    assert jax_count(24, None, dp) == tt.auto_microbatches(24, 2, 4) == 6


def test_generate_refuses_pipelined_params_as_jax_does():
    import jax
    import torch
    from jax.sharding import Mesh
    from torch.distributed.device_mesh import DeviceMesh

    from znicz_tpu.loader import FullBatchLoader as JLoader
    from znicz_tpu.workflow import TransformerLMWorkflow as JLM
    from znicz_tpu_torch.loader import FullBatchLoader
    from znicz_tpu_torch.workflow import TransformerLMWorkflow

    tokens = np.zeros((8, 16), np.int32)
    jwf = JLM(JLoader({"train": tokens}, minibatch_size=8), vocab=16, d_model=32, n_layers=2,
              n_heads=2, pipeline_parallel=True, pipeline_microbatches=2,
              mesh=Mesh(np.array(jax.devices()[:2]), ("pipe",)))
    with pytest.raises(ValueError) as want:
        jwf.generate(tokens[:1, :4], max_new_tokens=2)
    mesh = DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("pipe",), _init_backend=False,
                      _rank=0)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=8), vocab=16,
                               d_model=32, n_layers=2, n_heads=2, device="cpu",
                               pipeline_parallel=True, pipeline_microbatches=2, mesh=mesh)
    with pytest.raises(ValueError) as got:
        wf.generate(tokens[:1, :4], max_new_tokens=2)
    assert str(got.value) == str(want.value)
