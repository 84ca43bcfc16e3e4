"""The GPipe pipeline of the port (``parallel/pipeline.py``) on the CPU,
over gloo process groups, against sequential application and against the
JAX package's ``pipeline_apply`` on a ``("pipe",)`` mesh of its virtual
devices; ``bubble_fraction`` and ``update_pytree`` against the JAX
package's.

One job of two ranks and one of four (``python -c`` workers, module-scoped)
over a one-dim ``DeviceMesh`` named ``("pipe",)``: a tanh tower of S
stages, M in {S, 1.5 S, 2 S} microbatches, its output and the gradients of
``sum(out^2)`` with respect to the whole stacked leaves and the input
within rtol 1e-4 (atol 1e-5); the storage a rank holds (ceil(M/S)
microbatches); embed -> tower -> head (``pipelined_model_apply``).  The
four-rank job also runs the tower on a ``(data=2, model=1, pipe=2)`` mesh
with ``data_axis``, against the JAX package's on the same mesh shape.
"""

import os

import numpy as np
import pytest

from test_torch_multihost import run_ranks

WIDTH = 8
RANKS = (2, 4)


def _micro_counts(s):
    return sorted({s, (3 * s) // 2, 2 * s})


def _stage_arrays(n_stages, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((WIDTH, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32),
             "b": (0.1 * rng.standard_normal(WIDTH)).astype(np.float32)}
            for _ in range(n_stages)]


def _x(m, seed=1):
    return np.random.default_rng(seed).standard_normal((2 * m, WIDTH)).astype(np.float32)


WORK = f"WIDTH = {WIDTH}\n" + r'''
from torch.distributed.device_mesh import DeviceMesh
from znicz_tpu_torch.parallel import pipeline as pipe_mod
n, out_dir = int(ARGS[0]), ARGS[1]
exec(ARGS[2])  # the shared helpers: _micro_counts, _stage_arrays, _x

def apply_one(p, x):
    return torch.tanh(x @ p["w"] + p["b"])

def stacked_leaves(per):
    st = pipe_mod.stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                      for p in per])
    for v in st.values():
        v.requires_grad_(True)
    return st

mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("pipe",))
arrays, seen = {}, {}
orig = pipe_mod._local_pipeline

def spy(params, x, **kw):
    seen["store"] = list(x.shape)
    return orig(params, x, **kw)

pipe_mod._local_pipeline = spy
for m in _micro_counts(n):
    st = stacked_leaves(_stage_arrays(n, 0))
    x = torch.from_numpy(_x(m)).requires_grad_(True)
    out = pipe_mod.pipeline_apply(st, x, apply_one=apply_one, mesh=mesh, n_microbatches=m)
    (out * out).sum().backward()
    arrays.update({f"m{m}_out": out.detach().numpy(), f"m{m}_dx": x.grad.numpy(),
                   f"m{m}_dw": st["w"].grad.numpy(), f"m{m}_db": st["b"].grad.numpy()})
    seen[f"store_m{m}"] = seen.pop("store")
# JAX's storage case: batch 16 in 8 microbatches
st = stacked_leaves(_stage_arrays(n, 11))
pipe_mod.pipeline_apply(st, torch.from_numpy(_x(8)), apply_one=apply_one, mesh=mesh,
                        n_microbatches=8)
seen["store_16_8"] = seen.pop("store")
pipe_mod._local_pipeline = orig
# embed -> tower -> head
gen = np.random.default_rng(7)
params = {"embed": {"w": torch.from_numpy((0.4 * gen.standard_normal((5, WIDTH))).astype(np.float32))},
          "stages": stacked_leaves(_stage_arrays(n, 8)),
          "head": {"w": torch.from_numpy((0.4 * gen.standard_normal((WIDTH, 3))).astype(np.float32))}}
params["embed"]["w"].requires_grad_(True)
params["head"]["w"].requires_grad_(True)
xe = torch.from_numpy(gen.standard_normal((8, 5)).astype(np.float32))
y = pipe_mod.pipelined_model_apply(params, xe, embed_fn=lambda p, x: torch.tanh(x @ p["w"]),
                                   stage_fn=apply_one, head_fn=lambda p, x: x @ p["w"],
                                   mesh=mesh, n_microbatches=4)
(y * y).sum().backward()
arrays.update(model_out=y.detach().numpy(), model_dembed=params["embed"]["w"].grad.numpy(),
              model_dhead=params["head"]["w"].grad.numpy())
if n == 4:  # the tower on a (data=2, model=1, pipe=2) mesh, each data rank its rows
    mesh3 = make_mesh(2, 1, 2)
    d = RANK // 2
    st = stacked_leaves(_stage_arrays(2, 3))
    for m in (2, 3, 4):
        xg = _x(2 * m, seed=5)
        rows = slice(d * len(xg) // 2, (d + 1) * len(xg) // 2)
        x = torch.from_numpy(xg[rows].copy()).requires_grad_(True)
        out = pipe_mod.pipeline_apply(st, x, apply_one=apply_one, mesh=mesh3, n_microbatches=m,
                                      data_axis="data")
        (out * out).sum().backward()
        arrays.update({f"dp_m{m}_out": out.detach().numpy(), f"dp_m{m}_dx": x.grad.numpy(),
                       f"dp_m{m}_dw": st["w"].grad.numpy().copy()})
        st["w"].grad = None
        st["b"].grad = None
        # the rows regrouped into the JAX package's microbatches, and back
        from znicz_tpu_torch.parallel.data_parallel import data_group
        from znicz_tpu_torch.parallel.tensor_parallel import Chain
        ids = torch.arange(d * len(xg) // 2, (d + 1) * len(xg) // 2, dtype=torch.float32)
        ids.requires_grad_(True)
        there = pipe_mod._regroup_rows(ids, data_group(mesh3), m, inverse=False, chain=Chain())
        back = pipe_mod._regroup_rows(there, data_group(mesh3), m, inverse=True, chain=Chain())
        back.backward(ids.detach() + 0.5)
        arrays.update({f"dp_m{m}_rows": there.detach().numpy(), f"dp_m{m}_back": back.detach().numpy(),
                       f"dp_m{m}_rows_grad": ids.grad.numpy()})
errors = {}
if n == 2:  # a microbatch's rows that do not divide over a data axis of 2
    try:
        pipe_mod.pipeline_apply(stacked_leaves(_stage_arrays(1, 0)), torch.zeros(3, WIDTH),
                                apply_one=apply_one, mesh=make_mesh(2), n_microbatches=2,
                                data_axis="data")
    except ValueError as e:
        errors["data"] = str(e)
np.savez(os.path.join(out_dir, f"rank{RANK}.npz"), **arrays)
report(seen=seen, errors=errors)
'''

HELPERS = "\n".join(
    __import__("inspect").getsource(f) for f in (_micro_counts, _stage_arrays, _x))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each pipeline's job, run once: ``{n: (reports, each rank's arrays)}``."""
    out = {}
    for n in RANKS:
        d = tmp_path_factory.mktemp(f"pipe{n}")
        reports = run_ranks(WORK, n, d, HELPERS, world=n, timeout=300)
        out[n] = (reports, [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)])
    return out


def _apply_np(p, x):
    return np.tanh(x @ p["w"] + p["b"])


def _jax_tower(n, m, seed=0, x=None, mesh=None, data_axis=None):
    """The JAX package's pipeline of the tanh tower: ``(out, dw, db, dx)``
    of ``sum(out^2)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from znicz_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

    mesh = mesh or Mesh(np.array(jax.devices()[:n]), ("pipe",))
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in _stage_arrays(n, seed)])
    x = jnp.asarray(_x(m) if x is None else x)

    def loss(sp, x):
        out = pipeline_apply(sp, x, apply_one=lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                             mesh=mesh, n_microbatches=m, data_axis=data_axis)
        return jnp.sum(out * out), out

    (_, out), (g, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(stacked, x)
    return np.asarray(out), np.asarray(g["w"]), np.asarray(g["b"]), np.asarray(dx)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("which", [0, 1, 2], ids=["M=S", "M=1.5S", "M=2S"])
def test_tower_matches_sequential_and_jax(jobs, n, which):
    """Every rank's output and whole gradients: the sequential tower's
    output, and the JAX package's output and gradients on its pipe mesh."""
    m = _micro_counts(n)[which]
    per = _stage_arrays(n, 0)
    ref = _x(m)
    for p in per:
        ref = _apply_np(p, ref)
    out, dw, db, dx = _jax_tower(n, m)
    for arrays in jobs[n][1]:
        _close(arrays[f"m{m}_out"], ref)
        _close(arrays[f"m{m}_out"], out)
        _close(arrays[f"m{m}_dw"], dw)
        _close(arrays[f"m{m}_db"], db)
        _close(arrays[f"m{m}_dx"], dx)


@pytest.mark.parametrize("n", RANKS)
def test_storage_is_a_chunk_a_rank(jobs, n):
    """Each rank's input store is the padded chunk ceil(M/S) of
    microbatches, as the JAX package pins it: batch 16 in 8 microbatches
    is (2, 2, 8) a rank on 4 stages, (4, 2, 8) on 2."""
    for r in jobs[n][0]:
        assert r["seen"]["store_16_8"] == [8 // n, 2, WIDTH]
        for m in _micro_counts(n):
            assert r["seen"][f"store_m{m}"] == [-(-m // n), 2, WIDTH]


@pytest.mark.parametrize("n", RANKS)
def test_embed_tower_head_matches_sequential(jobs, n):
    gen = np.random.default_rng(7)
    we = (0.4 * gen.standard_normal((5, WIDTH))).astype(np.float32)
    wh = (0.4 * gen.standard_normal((WIDTH, 3))).astype(np.float32)
    x = gen.standard_normal((8, 5)).astype(np.float32)
    h = np.tanh(x @ we)
    for p in _stage_arrays(n, 8):
        h = _apply_np(p, h)
    for arrays in jobs[n][1]:
        _close(arrays["model_out"], h @ wh)
        assert np.isfinite(arrays["model_dembed"]).all() and np.abs(arrays["model_dembed"]).sum() > 0
        np.testing.assert_array_equal(arrays["model_dhead"], jobs[n][1][0]["model_dhead"])


@pytest.mark.parametrize("m", [2, 3, 4])
def test_data_and_pipe_match_jax(jobs, m):
    """``data_axis`` on a (2, 1, 2) mesh: each data rank's rows of the
    output and of the input's gradient, and the stage gradients summed
    over the data axis, are the JAX package's on its (2, 1, 2) mesh."""
    import jax

    from znicz_tpu.parallel import make_mesh

    xg = _x(2 * m, seed=5)
    out, dw, _, dx = _jax_tower(2, m, seed=3, x=xg, data_axis="data",
                                mesh=make_mesh(2, 1, 2, devices=jax.devices()[:4]))
    ranks = jobs[4][1]
    half = len(xg) // 2
    for r, arrays in enumerate(ranks):
        rows = slice((r // 2) * half, (r // 2 + 1) * half)
        _close(arrays[f"dp_m{m}_out"], out[rows])
        _close(arrays[f"dp_m{m}_dx"], dx[rows])
    _close(ranks[0][f"dp_m{m}_dw"] + ranks[2][f"dp_m{m}_dw"], dw)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_data_rows_form_jax_microbatches(jobs, m):
    """Under ``data_axis`` a data rank's local microbatch ``i`` holds the
    JAX package's rows of global microbatch ``i`` (its ``1/D`` of rows
    ``[i*mb, (i+1)*mb)``), also where M does not divide over the data
    axis (the route's splits differ between ranks); the inverse puts every
    row back, and the backward carries each row's gradient home."""
    rows = 4 * m  # _x(2 * m) has 4m rows; a data rank holds half
    mb = rows // m
    for r, arrays in enumerate(jobs[4][1]):
        d = r // 2
        want = [i * mb + d * (mb // 2) + j for i in range(m) for j in range(mb // 2)]
        own = np.arange(d * rows // 2, (d + 1) * rows // 2, dtype=np.float32)
        np.testing.assert_array_equal(arrays[f"dp_m{m}_rows"], np.asarray(want, np.float32))
        np.testing.assert_array_equal(arrays[f"dp_m{m}_back"], own)
        np.testing.assert_array_equal(arrays[f"dp_m{m}_rows_grad"], own + 0.5)


def test_errors_are_jax_errors(jobs):
    """A stage count that is not the pipe axis's, a batch that does not
    divide into the microbatches, and a microbatch whose rows do not divide
    over the data axis raise the JAX package's ValueErrors."""
    import jax
    import jax.numpy as jnp
    import torch

    from znicz_tpu.parallel import make_mesh as jmake_mesh
    from znicz_tpu.parallel.pipeline import pipeline_apply as jpipe, stack_stage_params as jstack
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    def apply_one(p, x):
        return x

    torch_st = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                   for p in _stage_arrays(3, 0)])
    with pytest.raises(ValueError, match="stage dim"):
        pipeline_apply(torch_st, torch.zeros(4, WIDTH), apply_one=apply_one,
                       mesh=make_mesh(1, 1, 1), n_microbatches=2)
    one = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                              for p in _stage_arrays(1, 0)])
    with pytest.raises(ValueError, match="batch 5 not divisible by n_microbatches 2"):
        pipeline_apply(one, torch.zeros(5, WIDTH), apply_one=apply_one,
                       mesh=make_mesh(1, 1, 1), n_microbatches=2)
    jst = jstack([{k: jnp.asarray(v) for k, v in p.items()} for p in _stage_arrays(2, 0)])
    with pytest.raises(ValueError) as err:
        jpipe(jst, jnp.zeros((6, WIDTH)), apply_one=apply_one, n_microbatches=2,
              mesh=jmake_mesh(2, 1, 2, devices=jax.devices()[:4]), data_axis="data")
    assert [r["errors"]["data"] for r in jobs[2][0]] == [str(err.value)] * 2


def test_bubble_fraction_is_jax():
    from znicz_tpu.parallel.pipeline import bubble_fraction as jbubble
    from znicz_tpu_torch.parallel.pipeline import bubble_fraction

    for s, m in ((4, 8), (1, 4), (4, 2), (4, 32), (2, 3), (8, 48), (16, 1)):
        assert bubble_fraction(s, m) == jbubble(s, m)


def test_update_pytree_is_jax():
    """Two momentum steps over a nested tree (the pipelined LM's layout):
    the bias rules key on the innermost dict key, as the JAX package's."""
    import jax.numpy as jnp
    import torch

    from znicz_tpu.nn import optimizer as jopt
    from znicz_tpu_torch.nn import optimizer

    rng = np.random.default_rng(2)

    def tree():
        return {"embed": {"embed": rng.standard_normal((4, 3)), "pos_bias": rng.standard_normal(3)},
                "stages": [{"w_up": rng.standard_normal((2, 3, 5)),
                            "up_bias": rng.standard_normal((2, 5))}],
                "head": {"head": rng.standard_normal((3, 4))}}

    def tmap(fn, t):
        if isinstance(t, dict):
            return {k: tmap(fn, v) for k, v in t.items()}
        if isinstance(t, list):
            return [tmap(fn, v) for v in t]
        return fn(t)

    params, g1, g2 = (tmap(lambda a: a.astype(np.float32), tree()) for _ in range(3))
    hyper = dict(learning_rate=0.1, gradient_moment=0.9, weights_decay=0.01,
                 learning_rate_bias=0.3, weights_decay_bias=0.0, gradient_moment_bias=0.5)
    jp, jv = tmap(jnp.asarray, params), tmap(lambda a: jnp.zeros_like(a), params)
    tp, tv = tmap(lambda a: torch.from_numpy(a.copy()), params), tmap(
        lambda a: torch.zeros(a.shape), params)
    for g in (g1, g2):
        jp, jv = jopt.update_pytree(jp, tmap(jnp.asarray, g), jv, jopt.HyperParams(**hyper))
        optimizer.update_pytree(tp, tmap(torch.from_numpy, g), tv, optimizer.HyperParams(**hyper))
    def flat(t, path=""):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k], f"{path}/{k}")]
        if isinstance(t, list):
            return [x for i, v in enumerate(t) for x in flat(v, f"{path}/{i}")]
        return [(path, np.asarray(t))]

    for got, want in ((tp, jp), (tv, jv)):
        for (pa, a), (pb, b) in zip(flat(got), flat(want), strict=True):
            assert pa == pb
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=pa)
