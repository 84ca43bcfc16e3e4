"""Ring attention of the port (``parallel/ring_attention.py``) on the CPU,
over gloo process groups, against the JAX package's ``ring_attention`` on
the same ``make_mesh(n, 1)`` of its virtual devices and against plain
attention on the whole sequence.

One job of two ranks and one of four (``python -c`` workers, as
``tests/test_torch_multihost.py`` starts them; each job runs every case
once, module-scoped).  Each rank holds its sequence block of q, k and v
(drawn whole from one numpy seed), runs the ring with the dense and the
flash inner (the flash kernels' plain versions here; the JAX side runs its
Pallas kernel in interpret mode), causal and not, in float32 and bfloat16,
and the gradients of ``sum(out * w)`` with respect to its blocks.  The
blocks put together are held to JAX's output and gradients within rtol
1e-4 (atol 1e-5) in float32, within 5e-2 in bfloat16 (the tolerance of the
JAX package's own bf16 ring test).  K and V differ, so gradients paired
with the wrong exchange would show: the causal flash case skips other
blocks on every rank, and its dK and dV are held apart.
"""

import functools
import os

import numpy as np
import pytest

from test_torch_multihost import run_ranks

B, T_RANK, H, D = 2, 8, 2, 8
RANKS = (2, 4)
CASES = [(inner, causal, dtype) for inner in ("dense", "flash") for causal in (False, True)
         for dtype in ("float32", "bfloat16")]
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}  # (rtol, atol)

WORK = f"B, T_RANK, H, D = {B}, {T_RANK}, {H}, {D}\nCASES = {CASES!r}\n" + r'''
from znicz_tpu_torch.parallel.ring_attention import ring_attention
n, out_dir = int(ARGS[0]), ARGS[1]
mesh = make_mesh(n)
rng = np.random.default_rng(7)
q0, k0, v0, w0 = (rng.standard_normal((B, T_RANK * n, H, D)).astype(np.float32)
                  for _ in range(4))
sl = slice(RANK * T_RANK, (RANK + 1) * T_RANK)
arrays = {}
for inner, causal, dtype in CASES:
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x[:, sl].copy()).to(dt).requires_grad_(True)
               for x in (q0, k0, v0))
    o = ring_attention(q, k, v, mesh=mesh, causal=causal, inner=inner)
    assert o.dtype == dt, o.dtype
    (o.float() * torch.from_numpy(w0[:, sl].copy())).sum().backward()
    key = f"{inner}_{int(causal)}_{dtype}"
    for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        arrays[f"{key}_{name}"] = t.detach().float().numpy()
try:
    ring_attention(q, k, v, mesh=mesh, inner="blockwise")
    bad = None
except ValueError as e:
    bad = str(e)
np.savez(os.path.join(out_dir, f"rank{RANK}.npz"), **arrays)
report(bad_inner=bad)
'''


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each ring's job, run once: ``{n: (reports, arrays put together)}``."""
    out = {}
    for n in RANKS:
        d = tmp_path_factory.mktemp(f"ring{n}")
        reports = run_ranks(WORK, n, d, world=n, timeout=300)
        ranks = [np.load(os.path.join(d, f"rank{r}.npz")) for r in range(n)]
        whole = {k: np.concatenate([r[k] for r in ranks], axis=1) for k in ranks[0].files}
        out[n] = (reports, whole)
    return out


def _inputs(n):
    rng = np.random.default_rng(7)
    return [rng.standard_normal((B, T_RANK * n, H, D)).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_ring(n, inner, causal, dtype):
    """The JAX package's ring on ``make_mesh(n, 1)``: ``(out, dq, dk, dv)``
    as float32 numpy."""
    import jax
    import jax.numpy as jnp

    from znicz_tpu.parallel import make_mesh
    from znicz_tpu.parallel.ring_attention import ring_attention

    mesh = make_mesh(n, 1, devices=jax.devices()[:n])
    q, k, v, w = _inputs(n)
    q, k, v = (jnp.asarray(x).astype(dtype) for x in (q, k, v))

    def loss(q, k, v):
        o = ring_attention(q, k, v, mesh=mesh, causal=causal, inner=inner)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("inner,causal,dtype", CASES,
                         ids=[f"{i}-{'causal' if c else 'full'}-{d}" for i, c, d in CASES])
def test_ring_matches_jax_on_the_same_mesh(jobs, n, inner, causal, dtype):
    whole = jobs[n][1]
    key = f"{inner}_{int(causal)}_{dtype}"
    rtol, atol = TOL[dtype]
    for name, want in zip(("o", "dq", "dk", "dv"), _jax_ring(n, inner, causal, dtype)):
        np.testing.assert_allclose(whole[f"{key}_{name}"], want, rtol=rtol, atol=atol,
                                   err_msg=f"{key} {name}")


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("inner", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_is_plain_attention_on_the_whole_sequence(jobs, n, inner, causal):
    """float32: the blocks put together are the port's plain attention
    over the whole sequence, output and gradients."""
    import torch

    from znicz_tpu_torch.ops.attention import dot_product_attention

    torch.set_float32_matmul_precision("highest")
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(n))
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = dot_product_attention(q, k, v, causal=causal)
    (o * w).sum().backward()
    whole = jobs[n][1]
    key = f"{inner}_{int(causal)}_float32"
    for name, want in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(whole[f"{key}_{name}"], want.detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{key} {name}")


@pytest.mark.parametrize("n", RANKS)
def test_k_and_v_gradients_are_not_swapped(jobs, n):
    """The causal flash ring, where rank r computes r + 1 blocks and skips
    the rest: each rank's dK and dV are JAX's, and they differ from each
    other by far more than the tolerance, so K's and V's gradients
    travelling in the wrong exchange would fail the check."""
    whole = jobs[n][1]
    _, _, dk, dv = _jax_ring(n, "flash", True, "float32")
    assert np.abs(dk - dv).max() > 100 * (1e-4 * np.abs(dk).max() + 1e-5)
    np.testing.assert_allclose(whole["flash_1_float32_dk"], dk, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(whole["flash_1_float32_dv"], dv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_bad_inner_is_refused_as_jax_refuses_it(jobs, n):
    """An unknown inner raises the JAX package's ValueError on every rank."""
    import jax

    from znicz_tpu.parallel import make_mesh
    from znicz_tpu.parallel.ring_attention import ring_attention

    q = np.zeros((1, 16, 1, 8), np.float32)
    with pytest.raises(ValueError) as err:
        ring_attention(q, q, q, mesh=make_mesh(n, 1, devices=jax.devices()[:n]),
                       inner="blockwise")
    assert [r["bad_inner"] for r in jobs[n][0]] == [str(err.value)] * n


def test_ring_of_one_is_flash_attention_bitwise():
    """A ring of one process: one diagonal block, whose merge weights are
    exactly 1 and 0, so the output and the gradients are flash attention's
    bit for bit (the lse cotangent cancels to zero)."""
    import torch

    from znicz_tpu_torch.ops.kernels.attention import flash_attention
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator().manual_seed(3)
    q0, k0, v0, w = (torch.randn(2, 16, 2, 8, generator=gen) for _ in range(4))
    got, want = [], []
    for fn, out in ((lambda q, k, v: ring_attention(q, k, v, mesh=make_mesh(1), causal=True,
                                                   inner="flash"), got),
                    (lambda q, k, v: flash_attention(q, k, v, causal=True), want)):
        q, k, v = (x.clone().requires_grad_(True) for x in (q0, k0, v0))
        o = fn(q, k, v)
        (o * w).sum().backward()
        out.extend([o.detach(), q.grad, k.grad, v.grad])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
