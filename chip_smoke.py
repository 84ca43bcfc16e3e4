#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (znicz_tpu_torch) end to end on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, builds every Hopper kernel of the ported paths from
the sources here (the LRN pair in Triton, compiled at first launch; the
flash-attention kernels in CUDA C++, built with nvcc up front), and fails
(non-zero exit, no result line) when any phase fails:

1. the card's ``nvidia-smi`` name and power limit, and the versions;
2. each LRN kernel against its plain PyTorch version on the same CUDA
   tensors, at AlexNet's two norm shapes (batch 128), in f32 and bf16;
3. the LRN kernels' times beside their memory bound, the plain versions'
   and the ``F.local_response_norm`` yardstick's (timed here only; the port
   never calls it), with CUDA events;
4. the AlexNet slice: ``alexnet.build_workflow(device="cuda")`` at the
   published geometry (227x227x3, 1000 classes, batch 128, bf16) runs one
   epoch (4 train steps and the eval pass) with the launch counters set to 0
   just before and read just after, then timed train steps; and a 4-image
   f32 forward (TF32 off) on the card against the CPU from identical
   weights;
5. the flash-attention build: nvcc's seconds, and ptxas' registers and
   spills with the dynamic shared memory of each kernel;
6. each flash kernel (forward, dQ, dK/dV) against its plain version on the
   same CUDA tensors, with O(1) ``dout`` and ``dlse``: the LM slice's shape
   (B 16, T 2048, H 8, D 64, causal), D 32 and 128, a non-causal and a
   ragged (T 2000) case, each in f32 and bf16;
7. the flash kernels' times at the slice shape beside their bound, the
   plain versions' and ``F.scaled_dot_product_attention``'s forward and
   autograd backward (timed here only; the port never calls it);
8. the LM slice: ``transformer_lm.build_workflow(device="cuda",
   attention="flash")`` at the repo's mid LM's width and depth (vocab 8192,
   d_model 512, 12 layers, 8 heads, T 2048, batch 16) runs one epoch (4
   train steps, 1 eval step) with the flash counters set to 0 just before
   and read just after, then timed train steps with f32 and bf16 attention
   (tokens/sec), and a 512-token f32 forward on the card against the CPU
   from identical weights;
9. the ``kernels`` JSON line, then the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

ALEXNET_NORMS = {  # NHWC inputs of AlexNet's two norm layers at batch 128
    "norm1": (128, 55, 55, 96),
    "norm2": (128, 27, 27, 256),
}
LRN = dict(alpha=1e-4, beta=0.75, k=2.0, n=5)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# operations per element: window sum of squares (2n), s (2), s^-beta (3),
# the product (1); the backward adds the inner term (3), the adjoint window
# (n) and the two-term output (4)
FWD_OPS = 2 * LRN["n"] + 6
BWD_OPS = 3 * LRN["n"] + 12
REPLACES = {
    "lrn_fwd": "znicz_tpu/ops/pallas/lrn.py:123",
    "lrn_bwd": "znicz_tpu/ops/pallas/lrn.py:142",
}
SOURCE = "znicz_tpu_torch/ops/kernels/lrn.py"

# the repo's mid LM (bench.py's LM_MID: ~50M parameters), T 2048, batch 16
LM_MID = dict(vocab=8192, d_model=512, n_layers=12, n_heads=8)
LM_T, LM_B = 2048, 16
LM_N_TRAIN, LM_N_TEST = 64, 16  # 4 train steps and 1 eval step an epoch
FLASH_CASES = [  # (tag, B, T, H, D, causal)
    ("slice", LM_B, LM_T, 8, 64, True),
    ("d32", 4, 1024, 8, 32, True),
    ("d128", 2, 1024, 8, 128, True),
    ("full", 2, 1024, 8, 64, False),
    ("ragged", 2, 2000, 8, 64, True),
]
# of the reference's largest magnitude: f32 sums run in another order; bf16
# rounds p and ds before their products at other places (running maxima)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": 989e12}  # H100 SXM, dense
# products of 2*D flops for each live (q, k) pair
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
FLASH_SOURCE = "znicz_tpu_torch/csrc/flash_attention.cu"
REPLACES.update({
    "flash_fwd": "znicz_tpu/ops/pallas/attention.py:212",
    "flash_dq": "znicz_tpu/ops/pallas/attention.py:265",
    "flash_dkv": "znicz_tpu/ops/pallas/attention.py:277",
})
FLASH = tuple(FLASH_PRODUCTS)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, *, warmup: int = 3, iters: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean per-call time of ``iters`` calls,
    by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def compare(name, got, ref, dtype_name, *, strict=True):
    """Max abs/rel error of ``got`` against ``ref``; fails past TOL when
    ``strict``."""
    rtol, atol = TOL[dtype_name]
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / r.abs().clamp_min(1e-30)).max())
    bad = int((diff > atol + rtol * r.abs()).sum())
    print(
        f"check {name} {dtype_name}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol}, atol {atol}) "
        f"{'ok' if bad == 0 else f'{bad} elements out of tolerance'}"
    )
    if strict and (bad or not math.isfinite(max_abs)):
        fail(f"{name} {dtype_name} disagrees with its plain version")
    return max_abs


def phase_kernels(torch, lrn_kernel):
    """Phase 2 and 3: correctness at both shapes and dtypes, then times."""
    args = (LRN["alpha"], LRN["beta"], LRN["k"], LRN["n"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {"lrn_fwd": 0.0, "lrn_bwd": 0.0}
    rows = {"lrn_fwd": [], "lrn_bwd": []}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for tag, shape in ALEXNET_NORMS.items():
            # softplus-like positive activations, as after conv_relu; an O(1)
            # output gradient, so that |dx| (up to ~10) stands well above
            # atol and a zero or misplaced dx fails the check
            x = (torch.randn(shape, generator=gen, device="cuda") * 3).exp().log1p()
            g = torch.randn(shape, generator=gen, device="cuda") * 3
            x, g = x.to(dtype), g.to(dtype)
            y = lrn_kernel.lrn_forward(x, *args)
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            e_f = compare(f"lrn_fwd {tag}", y, lrn_kernel.lrn_reference(x, *args), dname)
            e_b = compare(
                f"lrn_bwd {tag}", dx, lrn_kernel.lrn_bwd_reference(x, g, *args), dname
            )
            if dtype is not torch.bfloat16:
                continue
            # the main path's dtype: these feed the kernels line
            err["lrn_fwd"] = max(err["lrn_fwd"], e_f)
            err["lrn_bwd"] = max(err["lrn_bwd"], e_b)
            nbytes = x.numel() * x.element_size()
            xc = x.permute(0, 3, 1, 2)  # NCHW view for the yardstick
            lib = lambda: torch.nn.functional.local_response_norm(  # noqa: E731
                xc, LRN["n"], alpha=LRN["alpha"] * LRN["n"], beta=LRN["beta"], k=LRN["k"]
            )
            compare(f"yardstick F.local_response_norm {tag}", lib().permute(0, 2, 3, 1),
                    lrn_kernel.lrn_reference(x, *args), dname, strict=False)
            xr = xc.detach().requires_grad_(True)
            y_lib = torch.nn.functional.local_response_norm(
                xr, LRN["n"], alpha=LRN["alpha"] * LRN["n"], beta=LRN["beta"], k=LRN["k"]
            )
            gc = g.permute(0, 3, 1, 2)
            t = {
                "fwd_ms": cuda_ms(lambda: lrn_kernel.lrn_forward(x, *args)),
                "fwd_plain_ms": cuda_ms(lambda: lrn_kernel.lrn_reference(x, *args)),
                "fwd_lib_ms": cuda_ms(lib),
                "bwd_ms": cuda_ms(lambda: lrn_kernel.lrn_backward(x, g, *args)),
                "bwd_plain_ms": cuda_ms(lambda: lrn_kernel.lrn_bwd_reference(x, g, *args)),
                "bwd_lib_ms": cuda_ms(
                    lambda: torch.autograd.grad(y_lib, xr, gc, retain_graph=True)
                ),
            }
            n_el = x.numel()
            # (bytes over the memory rate, operations over the f32 rate)
            limits = {
                "lrn_fwd": (2 * nbytes / HBM_BYTES_PER_S, FWD_OPS * n_el / F32_FLOPS),
                "lrn_bwd": (3 * nbytes / HBM_BYTES_PER_S, BWD_OPS * n_el / F32_FLOPS),
            }
            for kname, short in (("lrn_fwd", "fwd"), ("lrn_bwd", "bwd")):
                row = {
                    "shape": tag,
                    "ms": t[f"{short}_ms"],
                    "plain_ms": t[f"{short}_plain_ms"],
                    "library_ms": t[f"{short}_lib_ms"],
                    "bound_ms": max(limits[kname]) * 1e3,
                    "bound_by": "bytes" if limits[kname][0] >= limits[kname][1] else "operations",
                }
                rows[kname].append(row)
                print(
                    f"time {kname} {tag} {list(shape)} bf16: kernel {row['ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.4f} ms, "
                    f"F.local_response_norm {'fwd' if short == 'fwd' else 'autograd bwd'} "
                    f"{row['library_ms']:.4f} ms"
                )
            del xr, y_lib
    return err, rows


def phase_slice(torch, lrn_kernel, alexnet, model_lib, prng):
    """Phase 4: the port's main path at AlexNet's published geometry."""
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = alexnet.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"slice: built AlexNet workflow in {time.perf_counter() - t0:.1f} s; "
          f"layer shapes {list(wf.model.layer_shapes)}")
    n_train = wf.loader.n_minibatches("train")
    n_eval = wf.loader.n_minibatches("valid")
    torch.backends.cudnn.benchmark = True

    # the main path: counts set to 0 just before, read just after
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {
        "lrn_fwd": lrn_kernel.lrn_forward.launches,
        "lrn_bwd": lrn_kernel.lrn_backward.launches,
    }
    summary = verdict["summary"]
    print(f"slice: epoch 1 (first, with cuDNN autotuning) {epoch_s:.2f} s: "
          + json.dumps(summary))
    for split, n in (("train", 512), ("valid", 128)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{split} split saw {m and m['n_samples']} samples, want {n}")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"non-finite {split} metrics: {m}")
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    print(f"slice: launches {launches}, want {want} "
          f"({n_train} train steps, {n_eval} eval steps, 2 norm layers)")
    if launches != want:
        fail(f"LRN launch counts {launches} != {want}")

    # step times: train steps on one minibatch, synchronised each step
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.as_tensor(mb.labels, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s[2:])
    batch = x.shape[0]
    print(f"slice: train step (batch {batch}, bf16) median {med * 1e3:.2f} ms over "
          f"{len(step_s) - 2} steps after 2 warm-up; {batch / med:.1f} images/sec; "
          f"all steps ms {[round(s * 1e3, 2) for s in step_s]}")
    t0 = time.perf_counter()
    verdict2 = wf.run_epoch()
    torch.cuda.synchronize()
    print(f"slice: epoch 2 {time.perf_counter() - t0:.2f} s "
          f"({n_train} train + {n_eval} eval steps, host loop included): "
          + json.dumps(verdict2["summary"]))

    # card vs CPU: 4-image f32 forward from identical weights, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(
        alexnet.DEFAULTS["layers"], wf.loader.sample_shape, device="cpu"
    )
    host = model_lib.params_to_numpy(wf.state.params)
    xb = torch.as_tensor(mb.data[:4]).float() * (1.0 / 255.0) - 0.5
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"slice: 4-image f32 forward, card vs CPU: max |diff| / max |logit| = "
          f"{rel:.3e} (limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 1000):
        fail("card and CPU forwards disagree")
    return launches, {"step_ms": med * 1e3, "images_per_s": batch / med}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?(fwd|dq|dkv)_kernelI(f|13__nv_bfloat16)Li(\d+)E")


def phase_flash_build(cuda_build, fa):
    """Phase 5: build the CUDA library from the sources here."""
    built = cuda_build.build("flash_attention")
    print(f"build: {built.path.name}: nvcc {built.seconds:.1f} s"
          + ("" if built.seconds else " (the library was there already)"))
    rows, cur = [], None
    for line in built.log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1), "dtype": "f32" if m.group(2) == "f" else "bf16",
                   "d": int(m.group(3)), "regs": None, "spill": None}
            rows.append(cur)
        elif cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if regs:
                cur["regs"] = int(regs.group(1))
            if spill:
                cur["spill"] = (int(spill.group(1)), int(spill.group(2)))
    if len(rows) != 24:
        fail(f"ptxas reported {len(rows)} flash kernels, want 24 (3 kernels x 2 dtypes x 4 D)")
    for r in sorted(rows, key=lambda r: (r["kernel"], r["dtype"], r["d"])):
        print(f"ptxas flash_{r['kernel']} {r['dtype']} D={r['d']}: {r['regs']} registers, "
              f"spill stores/loads {r['spill']} bytes, "
              f"{fa.smem_bytes(r['kernel'], r['d'])} bytes dynamic shared memory a block")


def _flash_inputs(torch, b, t, h, d, dtype, seed):
    """q, k, v, dout (O(1), so a zero or misplaced gradient fails) and dlse."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, dout = (
        torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    dlse = torch.randn((b, t, h), generator=gen, device="cuda")
    return q, k, v, dout, dlse


def _near(name, got, ref, tol):
    """Max abs error of ``got`` against ``ref``; fails past ``tol`` times the
    reference's largest magnitude."""
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    ok = math.isfinite(err) and err <= tol * max(scale, 1e-6)
    print(f"check {name}: max_abs_err={err:.3e} of max |ref| {scale:.3e} "
          f"(limit {tol} of it) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def phase_flash_checks(torch, fa):
    """Phase 6: each flash kernel against its plain version."""
    err = {}
    for seed, (tag, b, t, h, d, causal) in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, seed)
            kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
            label = f"{tag} [{b},{t},{h},{d}] {'causal' if causal else 'full'} {dname}"
            out, lse = fa.flash_fwd(q, k, v, **kw)
            out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
            # both backward kernels from the same residuals and delta as
            # their plain versions
            delta = ((dout.float() * out_r.float()).sum(-1) - dlse).contiguous()
            dq = fa.flash_dq(q, k, v, dout, lse_r, delta, **kw)
            dk, dv = fa.flash_dkv(q, k, v, dout, lse_r, delta, **kw)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            e = {"flash_fwd": _near(f"flash_fwd out {label}", out, out_r, tol)}
            _near(f"flash_fwd lse {label}", lse, lse_r, FLASH_TOL["float32"])
            del out_r
            e["flash_dq"] = _near(
                f"flash_dq {label}", dq,
                fa.flash_dq_reference(q, k, v, dout, lse_r, delta, **kw), tol,
            )
            dk_r, dv_r = fa.flash_dkv_reference(q, k, v, dout, lse_r, delta, **kw)
            e["flash_dkv"] = max(_near(f"flash_dkv dk {label}", dk, dk_r, tol),
                                 _near(f"flash_dkv dv {label}", dv, dv_r, tol))
            if tag == "slice" and dtype is torch.float32:  # the counted epoch's
                err = e
            del q, k, v, dout, dlse, out, lse, lse_r, delta, dq, dk, dv, dk_r, dv_r
            torch.cuda.empty_cache()
    return err


def _flash_bounds(b, t, h, d, causal, esize, dname):
    """Per kernel: (bound ms, "bytes" or "operations") for these inputs:
    the live (q, k) pairs they need, each input read once, each output
    written once."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, stat = b * t * h * d * esize, b * t * h * 4
    nbytes = {
        "flash_fwd": 4 * tensor + stat,  # q, k, v in; out, lse out
        "flash_dq": 5 * tensor + 2 * stat,  # q, k, v, dout, lse, delta in; dq out
        "flash_dkv": 6 * tensor + 2 * stat,  # and dk, dv out
    }
    out = {}
    for name, n_products in FLASH_PRODUCTS.items():
        t_ops = n_products * 2 * d * pairs / PEAK_FLOPS[dname]
        t_bytes = nbytes[name] / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash_times(torch, fa):
    """Phase 7: times at the LM slice's shape, f32 and bf16."""
    _, b, t, h, d, causal = FLASH_CASES[0]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, 100)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = ((dout.float() * out.float()).sum(-1) - dlse).contiguous()
        bwd = (q, k, v, dout, lse, delta)
        heavy = dict(warmup=1, iters=3, repeats=3)
        ms = {
            "flash_fwd": (cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw), iters=5, repeats=3),
                          cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, **kw), **heavy)),
            "flash_dq": (cuda_ms(lambda: fa.flash_dq(*bwd, **kw), iters=5, repeats=3),
                         cuda_ms(lambda: fa.flash_dq_reference(*bwd, **kw), **heavy)),
            "flash_dkv": (cuda_ms(lambda: fa.flash_dkv(*bwd, **kw), iters=5, repeats=3),
                          cuda_ms(lambda: fa.flash_dkv_reference(*bwd, **kw), **heavy)),
        }
        # the yardstick: one PyTorch call, on [B, H, T, D] views
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), iters=5, repeats=3)
        xr = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        o_lib = sdpa(*xr, is_causal=causal)
        g_lib = dout.transpose(1, 2)
        lib_bwd = cuda_ms(
            lambda: torch.autograd.grad(o_lib, xr, g_lib, retain_graph=True), iters=5, repeats=3
        )
        bounds = _flash_bounds(b, t, h, d, causal, q.element_size(), dname)
        for name in FLASH:
            kernel_ms, plain_ms = ms[name]
            bound_ms, bound_by = bounds[name]
            lib = lib_fwd if name == "flash_fwd" else lib_bwd
            rows[(name, dname)] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib,
            }
            print(f"time {name} [{b},{t},{h},{d}] causal {dname}: kernel {kernel_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention "
                  f"{'fwd' if name == 'flash_fwd' else 'autograd bwd (dq, dk, dv together)'} "
                  f"{lib:.4f} ms")
        del q, k, v, dout, dlse, out, lse, delta, bwd, qt, kt, vt, xr, o_lib, g_lib
        torch.cuda.empty_cache()
    return rows


def _timed_steps(torch, wf, label):
    """Median of 10 synchronised train steps after 2 warm-up, on the first
    train minibatch; returns (step ms, tokens/sec)."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.zeros((x.shape[0],), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s[2:])
    tokens = x.shape[0] * x.shape[1]
    print(f"lm: train step ({label}, batch {x.shape[0]} x T {x.shape[1]}) median "
          f"{med * 1e3:.2f} ms over {len(step_s) - 2} steps after 2 warm-up; "
          f"{tokens / med:.1f} tokens/sec; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"all steps ms {[round(v * 1e3, 2) for v in step_s]}")
    return med * 1e3, tokens / med


def phase_lm(torch, fa, transformer_lm, transformer, model_lib, troot, prng):
    """Phase 8: the LM slice at the mid LM's width and depth."""
    troot.transformer_lm.update({
        **LM_MID,
        "loader": {"seq_len": LM_T, "n_train": LM_N_TRAIN, "n_test": LM_N_TEST,
                   "minibatch_size": LM_B},
    })
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = transformer_lm.build_workflow(device="cuda", attention="flash")
    wf.initialize()
    torch.cuda.synchronize()
    n_params = sum(w.numel() for layer in wf.state.params for w in layer.values())
    print(f"lm: built the workflow (bigram data on the host, {n_params} parameters on the "
          f"card) in {time.perf_counter() - t0:.1f} s")
    n_train = wf.loader.n_minibatches("train")
    n_eval = wf.loader.n_minibatches("test")
    # the initial weights, for the card-vs-CPU check below: SGD at the
    # LM's default lr 0.1 diverges at this depth within a few steps (so does
    # the JAX package's), which the timed steps do not mind
    host = model_lib.params_to_numpy(wf.state.params)

    # the main path: counts set to 0 just before, read just after
    for name in FLASH:
        getattr(fa, name).launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {name: getattr(fa, name).launches for name in FLASH}
    summary = verdict["summary"]
    print(f"lm: epoch 1 {epoch_s:.2f} s: " + json.dumps(summary))
    for split, n in (("train", LM_N_TRAIN), ("test", LM_N_TEST)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{split} split saw {m and m['n_samples']} samples, want {n}")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"non-finite {split} metrics: {m}")
    layers = LM_MID["n_layers"]
    want = {"flash_fwd": layers * (n_train + n_eval), "flash_dq": layers * n_train,
            "flash_dkv": layers * n_train}
    print(f"lm: launches {launches}, want {want} "
          f"({n_train} train steps, {n_eval} eval steps, {layers} layers)")
    if launches != want:
        fail(f"flash launch counts {launches} != {want}")

    steps = {"f32": _timed_steps(torch, wf, "f32 attention")}

    # card vs CPU: one 512-token sequence, f32, TF32 off, identical weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tokens = torch.as_tensor(wf.loader.data["test"][:1, :512]).long()
    kw = dict(n_heads=LM_MID["n_heads"], attention_fn=fa.flash_attention)
    with torch.no_grad():
        lg_card = transformer.lm_apply(
            model_lib.params_from_jax(host, "cuda"), tokens.cuda(), **kw).cpu()
        lg_cpu = transformer.lm_apply(model_lib.params_from_jax(host, "cpu"), tokens, **kw)
    if not bool(torch.isfinite(lg_cpu).all()):
        fail("non-finite CPU logits")
    rel = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    print(f"lm: 512-token f32 forward, card (kernels) vs CPU (plain): max |diff| / "
          f"max |logit| = {rel:.3e} (limit 1e-4); logits shape {list(lg_card.shape)}")
    if not rel < 1e-4 or tuple(lg_card.shape) != (1, 512, LM_MID["vocab"]):
        fail("card and CPU LM forwards disagree")
    loader = wf.loader
    del wf, host, lg_card
    torch.cuda.empty_cache()

    wf16 = transformer.TransformerLMWorkflow(
        loader, **LM_MID, attention="flash", attention_dtype="bf16", device="cuda"
    )
    wf16.initialize()
    steps["bf16"] = _timed_steps(torch, wf16, "bf16 attention")
    return launches, steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.models import alexnet, transformer_lm
    from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build, lrn as lrn_kernel
    from znicz_tpu_torch.workflow import model as model_lib, transformer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    import triton

    print(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}; "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    err, rows = phase_kernels(torch, lrn_kernel)
    launches, _ = phase_slice(torch, lrn_kernel, alexnet, model_lib, prng)
    t0 = time.perf_counter()
    phase_flash_build(cuda_build, fa)
    flash_err = phase_flash_checks(torch, fa)
    flash_rows = phase_flash_times(torch, fa)
    flash_launches, _ = phase_lm(
        torch, fa, transformer_lm, transformer, model_lib, troot, prng
    )
    print(f"flash phases: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for kname in ("lrn_fwd", "lrn_bwd"):
        rs = rows[kname]  # one train step's work: norm1 + norm2
        kernels.append({
            "name": kname,
            "route": "triton",
            "source": SOURCE,
            "replaces": REPLACES[kname],
            "launches": launches[kname],
            "max_abs_err": err[kname],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
        })
    for kname in FLASH:
        row = flash_rows[(kname, "float32")]  # the counted epoch's dtype
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": REPLACES[kname],
            "launches": flash_launches[kname],
            "max_abs_err": flash_err[kname],
            **row,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
