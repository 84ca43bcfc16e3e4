#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (znicz_tpu_torch) end to end on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, builds every Hopper kernel of the ported paths from
the sources here (the LRN pair in Triton, compiled at first launch; the
flash-attention, Kohonen and RBM kernels in CUDA C++, built with nvcc up
front, one process a source, in parallel), and fails (non-zero exit, no
result line) when any phase fails:

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
5. the flash-attention build (made before phase 2): nvcc's seconds, and ptxas' registers and
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
9. the Kohonen and RBM builds (made with the flash build): nvcc's seconds, ptxas' registers, spills and
   static shared memory of each kernel, and the RBM chain's rows a block
   and dynamic shared memory at each check shape;
10. the Kohonen kernel against its plain version (num, den and the updated
    weights within 1e-5 of the largest magnitude, on the synthetic MNIST
    blobs): the model's shape (B 100, 8x8, F 784, masked tail), B 600 with
    500 valid (6x6, F 256), B 300 (6x6, F 64) and B 4096 (32x32, F 784); a
    repeat launch must be bitwise equal; samples whose winner differs are
    counted (the plain version then takes the kernel's winners);
11. the RBM kernel against its plain version: the saturated regime exact;
    with injected uniforms and with the kernel's own draws against the
    plain version fed the generator twin's uniforms, at (B 100, 784x128,
    k 1), (B 1024, 784x1024, k 1) and (B 256, 784x1024, k 3) with a masked
    tail, within 1e-4 when no sampled unit flipped and at most 1e-5 of the
    draws flipped; the same seed bitwise equal, another seed different; the
    kernel's generator bitwise equal to its twin; Bernoulli frequencies at
    p 0.1, 0.5, 0.9 within 5 sigma;
12. both kernels' times at the model's shape and the large check shape
    beside their bound and their plain version's (no PyTorch call computes
    either: library none);
13. the Kohonen model (``kohonen.build_workflow(device="cuda")``: 8x8 map,
    784 features, batch 100) and 14. the MNIST RBM (``mnist_rbm``: 784 x
    128, CD-1, batch 100), each on the synthetic MNIST stand-in at MNIST's
    split sizes (60000 / 10000): one epoch with the kernel's counter set to 0
    just before and read just after (one launch a train step, 600), timed
    train steps (images/sec), and one step on the card against the CPU from
    identical weights (the RBM with the same seed: the same chain);
15. the ``kernels`` JSON line, then the result line.

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


def build_all(cuda_build):
    """Every CUDA C++ source of the port built from the sources here, one
    nvcc each, all started together; returns {name: Built}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        built = dict(zip(CUDA_SOURCES, pool.map(cuda_build.build, CUDA_SOURCES)))
    print(f"build: {len(built)} CUDA sources in parallel, {time.perf_counter() - t0:.1f} s wall")
    return built


def phase_flash_build(built, fa):
    """Phase 5: the flash-attention library's build."""
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


# -- the unsupervised slice: Kohonen SOM and RBM -------------------------------

CUDA_SOURCES = ("flash_attention", "kohonen", "rbm")
UNSUP_SOURCE = {"kohonen_accumulate": "znicz_tpu_torch/csrc/kohonen.cu",
                "rbm_cd": "znicz_tpu_torch/csrc/rbm.cu"}
REPLACES.update({
    "kohonen_accumulate": "znicz_tpu/ops/pallas/kohonen.py:93",
    "rbm_cd": "znicz_tpu/ops/pallas/rbm.py:161",
})
# of the reference's largest magnitude: f32 sums run in another order
KOHONEN_TOL, RBM_TOL = 1e-5, 1e-4
KOHONEN_CASES = [  # (tag, B, map side, F, valid rows)
    ("model", 100, 8, 784, 93),
    ("multi_tile", 600, 6, 256, 500),
    ("ragged", 300, 6, 64, 300),
    ("large", 4096, 32, 784, 4096),
]
RBM_CASES = [  # (tag, B, V, H, cd_k, valid rows)
    ("model", 100, 784, 128, 1, 93),
    ("large", 1024, 784, 1024, 1, 1000),
    ("k3", 256, 784, 1024, 3, 250),
]
MNIST_SPLITS = {"train": 60000, "test": 10000}  # MNIST's own split sizes


def _ptxas_rows(log):
    """(kernel name, registers, (spill stores, loads), static smem bytes) of
    each entry nvcc's ptxas reported."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+([a-z]+_kernel)(ILi(\d+)EE)?", m.group(1))
            cur = [name.group(1) + (f"<{name.group(3)}>" if name.group(3) else ""), None, None, 0]
            rows.append(cur)
        elif cur is not None:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if regs:
                cur[1] = int(regs.group(1))
            if spill:
                cur[2] = (int(spill.group(1)), int(spill.group(2)))
            if smem:
                cur[3] = int(smem.group(1))
    return rows


def phase_unsup_build(built, rbk):
    """Phase 9: the Kohonen and RBM libraries' builds."""
    want = {"kohonen": {"winners_kernel", "accum_kernel"},
            "rbm": {"chain_kernel<4>", "chain_kernel<8>", "chain_kernel<16>", "stats_kernel",
                    "uniforms_kernel"}}
    for name in ("kohonen", "rbm"):
        b = built[name]
        print(f"build: {b.path.name}: nvcc {b.seconds:.1f} s"
              + ("" if b.seconds else " (the library was there already)"))
        rows = _ptxas_rows(b.log)
        if {r[0] for r in rows} != want[name]:
            fail(f"ptxas reported {sorted(r[0] for r in rows)} for {name}.cu, want {sorted(want[name])}")
        for kname, regs, spill, smem in sorted(rows):
            print(f"ptxas {name} {kname}: {regs} registers, spill stores/loads {spill} bytes, "
                  f"{smem} bytes static shared memory a block")
    for tag, b, v, h, _, _ in RBM_CASES:
        rows, smem = rbk.chain_rows(b, v, h)
        print(f"rbm chain_kernel at {tag} (B {b}, {v} x {h}): {rows} rows a block, "
              f"{smem} bytes dynamic shared memory, {-(-b // rows)} blocks")


def _mnist_rows(datasets, n, normalization):
    """n rows of the synthetic MNIST stand-in (its well-separated blobs),
    normalized as the models normalize them, as float32 [n, 784]."""
    loader = datasets.mnist(n_train=n, n_test=0, normalization=normalization)
    return loader.data["train"]


def _rel_err(name, got, ref, tol, *, strict=True):
    """Max abs error, checked against ``tol`` of max |ref| when ``strict``."""
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = math.isfinite(err) and err <= tol * max(scale, 1e-12)
    print(f"check {name}: max_abs_err={err:.3e} of max |ref| {scale:.3e} "
          f"(limit {tol} of it) {'ok' if ok else 'FAILED' if strict else 'not held: units flipped'}")
    if strict and not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def phase_kohonen_checks(torch, khk, kh, datasets, prng):
    """Phase 10: the Kohonen kernel against its plain version."""
    prng.seed_all(11)
    xs = torch.as_tensor(_mnist_rows(datasets, 4096, "mean_disp"), device="cuda")
    err = 0.0
    for tag, b, side, f, n_valid in KOHONEN_CASES:
        m = side * side
        x = xs[:b, :f].contiguous()
        w = kh.init_params(side, side, f, device="cuda")["weights"]
        # a map that has started to learn: units near some samples
        w = (w + xs[torch.arange(m, device="cuda") * 7 % 4096, :f]).contiguous()
        mask = (torch.arange(b, device="cuda") < n_valid).float()
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        sigma, lr = 2.5, 0.3
        win = torch.empty((b,), dtype=torch.int32, device="cuda")
        num, den = khk.accumulate(w, x, mask, d2m, sigma, winners_out=win)
        num2, den2 = khk.accumulate(w, x, mask, d2m, sigma)
        torch.cuda.synchronize()
        same = torch.equal(num, num2) and torch.equal(den, den2)
        differ = int((kh.winners({"weights": w}, x) != win).sum())
        label = f"kohonen {tag} (B {b}, {side}x{side}, F {f}, {b - n_valid} masked)"
        print(f"check {label}: repeat launch bitwise equal: {same}; samples whose winner "
              f"differs from the plain version's: {differ}"
              + (" (plain version run with the kernel's winners)" if differ else ""))
        if not same:
            fail(f"{label}: two launches on the same inputs differ")
        if differ > max(1, b // 1000):
            fail(f"{label}: {differ} winners differ, more than near-ties explain")
        ref_num, ref_den = khk.accumulate_reference(w, x, mask, d2m, sigma,
                                                    win=win if differ else None)
        e = max(_rel_err(f"{label} num", num, ref_num, KOHONEN_TOL),
                _rel_err(f"{label} den", den, ref_den, KOHONEN_TOL))
        _rel_err(f"{label} updated weights", khk._apply_update(w, num, den, lr),
                 khk._apply_update(w, ref_num, ref_den, lr), KOHONEN_TOL)
        if tag == "model":
            err = e
    return err


def _flip_count(chain, ref_chain, uh, uv, cd_k):
    """Sampled units whose draw differs between the kernel's chain and the
    plain version's: the first hidden draws and the last visible draws."""
    return int(((uh[0] < chain["h0p"]) != (uh[0] < ref_chain["h0p"])).sum()
               + ((uv[cd_k - 1] < chain["vp"]) != (uv[cd_k - 1] < ref_chain["vp"])).sum())


def _rbm_inputs(torch, xs, b, v, h, n_valid, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {
        "weights": torch.randn((v, h), generator=gen, device="cuda") * (1.0 / math.sqrt(v)),
        "vbias": torch.randn((v,), generator=gen, device="cuda") * 0.1,
        "hbias": torch.randn((h,), generator=gen, device="cuda") * 0.1,
    }
    v0 = xs[:b, :v].contiguous()
    mask = (torch.arange(b, device="cuda") < n_valid).float()
    return params, v0, mask


def phase_rbm_checks(torch, rbk, datasets, prng):
    """Phase 11: the RBM kernel against its plain version."""
    prng.seed_all(12)
    xs = torch.as_tensor((_mnist_rows(datasets, 1024, "linear") + 1.0) / 2.0, device="cuda")
    err = 0.0
    # the saturated regime: sampling cannot depend on the draws
    v, h = 128, 64
    params = {"weights": torch.zeros((v, h), device="cuda"),
              "vbias": torch.full((v,), -20.0, device="cuda"),
              "hbias": torch.full((h,), 20.0, device="cuda")}
    v0 = (xs[:32, :v] > 0.5).float().contiguous()
    mask = (torch.arange(32, device="cuda") < 30).float()
    for cd_k in (1, 2):
        got = rbk.statistics(params, v0, mask, 5, cd_k=cd_k)
        uh, uv = rbk.chain_uniforms(5, 32, v, h, cd_k, "cuda")
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        exact = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"check rbm saturated (biases +-20, B 32, {v} x {h}, k {cd_k}): exact {exact}")
        if not exact:
            fail("rbm saturated regime is not exact")
    for seed, (tag, b, v, h, cd_k, n_valid) in enumerate(RBM_CASES):
        params, v0, mask = _rbm_inputs(torch, xs, b, v, h, n_valid, seed)
        uh, uv = rbk.chain_uniforms(seed, b, v, h, cd_k, "cuda")
        draws = b * h * cd_k + b * v * cd_k
        ref_chain = {}
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=ref_chain)
        label = f"rbm {tag} (B {b}, {v} x {h}, k {cd_k}, {b - n_valid} masked)"
        for how, uniforms in (("injected uniforms", (uh, uv)), ("in-kernel draws", None)):
            chain = {}
            got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k, uniforms=uniforms, chain=chain)
            torch.cuda.synchronize()
            flips = _flip_count(chain, ref_chain, uh, uv, cd_k)
            print(f"check {label}, {how}: {flips} of {draws} sampled units flipped "
                  f"(limit {1e-5 * draws:.1f})")
            if flips > 1e-5 * draws:
                fail(f"{label}, {how}: {flips} flips")
            # the statistics are held to the tolerance when no unit flipped
            e = max(_rel_err(f"{label}, {how}, {name}", g, r, RBM_TOL, strict=flips == 0)
                    for name, g, r in zip(("dW", "dvb", "dhb", "stats"), got, ref))
            if tag == "model":
                err = max(err, e)
        again = rbk.statistics(params, v0, mask, seed, cd_k=cd_k)
        other = rbk.statistics(params, v0, mask, seed + 1000, cd_k=cd_k)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        changed = not torch.equal(got[0], other[0])
        print(f"check {label}: same seed bitwise equal {same}; another seed changes dW {changed}")
        if not (same and changed):
            fail(f"{label}: the seed does not key the chain")
    for stream, shape in ((rbk.HIDDEN, (2, 1024, 1024)), (rbk.VISIBLE, (1, 1024, 784))):
        same = torch.equal(rbk.uniforms_cuda(77, stream, shape), rbk.philox_uniforms(77, stream, shape, "cuda"))
        print(f"check rbm generator stream {stream} {list(shape)}: kernel draws bitwise equal "
              f"to the PyTorch twin: {same}")
        if not same:
            fail("the kernel's generator and its twin differ")
    b = 1 << 20
    for p in (0.1, 0.5, 0.9):
        # one visible and one hidden unit: vp is 1 where the hidden unit was
        # drawn and 2e-9 where not, so -dvb / B is the draws' frequency
        params = {"weights": torch.full((1, 1), 40.0, device="cuda"),
                  "vbias": torch.full((1,), -20.0, device="cuda"),
                  "hbias": torch.full((1,), math.log(p / (1 - p)), device="cuda")}
        chain = {}
        _, dvb, _, _ = rbk.statistics(params, torch.zeros((b, 1), device="cuda"),
                                      torch.ones((b,), device="cuda"), 99, cd_k=1, chain=chain)
        p_exact = float(chain["h0p"][0, 0])
        freq = -float(dvb[0]) / b
        sd = math.sqrt(p_exact * (1 - p_exact) / b)
        print(f"check rbm Bernoulli frequency at p {p_exact:.7f} over {b} draws: {freq:.7f} "
              f"({(freq - p_exact) / sd:+.2f} sigma, limit 5)")
        if abs(freq - p_exact) > 5 * sd:
            fail("rbm Bernoulli frequency off")
    return err


def _unsup_bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_unsup_times(torch, khk, kh, rbk):
    """Phase 12: each kernel's time at the model's shape and at the large
    check shape, beside its bound and its plain version's."""
    rows = {}
    for tag, b, side, f, _ in (KOHONEN_CASES[0], KOHONEN_CASES[3]):
        m = side * side
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        x = torch.randn((b, f), generator=gen, device="cuda")
        w = torch.randn((m, f), generator=gen, device="cuda") * 0.1
        mask = torch.ones((b,), device="cuda")
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        ms = cuda_ms(lambda: khk.accumulate(w, x, mask, d2m, 2.0))
        plain = cuda_ms(lambda: khk.accumulate_reference(w, x, mask, d2m, 2.0))
        # x, w, mask and d2m read once; num and den written once
        bound, by = _unsup_bound(4 * b * m * f, 4 * (b * f + m * f + b + m * m + m * f + m))
        rows[("kohonen_accumulate", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                                 bound_by=by, library_ms=None)
        print(f"time kohonen_accumulate {tag} (B {b}, {side}x{side}, F {f}): kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), plain {plain:.4f} ms, library: none (no single "
              f"PyTorch call computes it)")
    for tag, b, v, h, cd_k, _ in RBM_CASES[:2]:
        params, v0, mask = _rbm_inputs(torch, torch.rand((b, v), device="cuda"), b, v, h, b, 3)
        uh, uv = rbk.chain_uniforms(3, b, v, h, cd_k, "cuda")
        ms = cuda_ms(lambda: rbk.statistics(params, v0, mask, 3, cd_k=cd_k))
        plain = cuda_ms(lambda: rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k))
        # v0, mask, W and the biases read once; dW, dvb, dhb, stats written once
        nbytes = 4 * (b * v + b + 2 * v * h + 2 * (v + h) + 2)
        bound, by = _unsup_bound((2 * cd_k + 3) * 2 * b * v * h, nbytes)
        rows[("rbm_cd", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                     library_ms=None)
        print(f"time rbm_cd {tag} (B {b}, {v} x {h}, k {cd_k}): kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), plain {plain:.4f} ms (uniforms given), library: none "
              f"(no single PyTorch call computes it)")
    return rows


def _unsup_epoch(torch, wf, counter, label):
    """One epoch of ``wf`` with ``counter`` (the kernel wrapper) set to 0 just
    before and read just after; checks the samples and the finite loss."""
    n_train = wf.loader.n_minibatches("train")
    counter.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = counter.launches
    summary = verdict["summary"]
    print(f"{label}: epoch 1 {epoch_s:.2f} s: " + json.dumps(summary))
    for split, n in MNIST_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n:
            fail(f"{label}: {split} split saw {m and m['n_samples']} samples, want {n}")
        if not math.isfinite(m["loss"]):
            fail(f"{label}: non-finite {split} loss {m['loss']}")
    print(f"{label}: launches {launches}, want {n_train} (one a train step; eval steps "
          f"launch nothing)")
    if launches != n_train:
        fail(f"{label}: {launches} kernel launches in the epoch, want {n_train}")
    return launches


def _unsup_steps(torch, wf, label):
    """Median of 10 synchronised train steps after 2 warm-up, images/sec."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.zeros((x.shape[0],), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s[2:])
    print(f"{label}: train step (batch {x.shape[0]}) median {med * 1e3:.3f} ms over "
          f"{len(step_s) - 2} steps after 2 warm-up; {x.shape[0] / med:.1f} images/sec; "
          f"all steps ms {[round(v * 1e3, 3) for v in step_s]}")
    return med * 1e3, x.shape[0] / med, mb


def phase_kohonen_model(torch, kohonen, khk, kh, troot, prng):
    """Phase 13: the Kohonen SOM model at its published widths."""
    troot.kohonen.update({"loader": {"n_train": MNIST_SPLITS["train"],
                                     "n_test": MNIST_SPLITS["test"]}})
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = kohonen.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"kohonen: built the workflow (8x8 map, 784 features, batch 100, synthetic MNIST "
          f"stand-in {MNIST_SPLITS}) in {time.perf_counter() - t0:.1f} s")
    launches = _unsup_epoch(torch, wf, khk.accumulate, "kohonen")
    step_ms, ips, mb = _unsup_steps(torch, wf, "kohonen")
    # card vs CPU: one step from identical weights
    w = wf.state.params["weights"]
    x = torch.as_tensor(mb.data)
    mask = torch.as_tensor(mb.mask)
    lr, sigma = kh.decay_schedule(wf.state.step, wf._total_steps, lr0=wf.lr0, lr1=wf.lr1,
                                  sigma1=wf.sigma1, sx=wf.sx, sy=wf.sy)
    kw = dict(learning_rate=lr, sigma=sigma)
    coords = kh.grid_coords(wf.sx, wf.sy, device="cpu")
    card = khk.train_step({"weights": w}, x.cuda(), coords.cuda(), mask=mask.cuda(), **kw)
    cpu = khk.train_step({"weights": w.cpu()}, x, coords, mask=mask, **kw)
    differ = int((kh.winners({"weights": w}, x.cuda()).cpu() != kh.winners({"weights": w.cpu()}, x)).sum())
    print(f"kohonen: one train step card vs CPU from identical weights (lr {lr}, sigma "
          f"{sigma}): winners that differ {differ}")
    if differ:
        fail("kohonen: card and CPU pick other winners on the model's data")
    _rel_err("kohonen card vs CPU updated weights", card["weights"].cpu(), cpu["weights"],
             KOHONEN_TOL)
    return launches, step_ms, ips


def phase_rbm_model(torch, mnist_rbm, rbk, troot, prng):
    """Phase 14: the MNIST RBM at its published widths."""
    troot.mnist_rbm.update({"loader": {"n_train": MNIST_SPLITS["train"],
                                       "n_test": MNIST_SPLITS["test"]}})
    prng.seed_all(1234)
    t0 = time.perf_counter()
    wf = mnist_rbm.build_workflow(device="cuda")
    wf.initialize()
    torch.cuda.synchronize()
    print(f"rbm: built the workflow (784 x 128, CD-1, batch 100, synthetic MNIST stand-in "
          f"{MNIST_SPLITS}) in {time.perf_counter() - t0:.1f} s")
    launches = _unsup_epoch(torch, wf, rbk.statistics, "rbm")
    step_ms, ips, mb = _unsup_steps(torch, wf, "rbm")
    # card vs CPU: one CD-1 step from identical weights and the same seed,
    # which is the same chain through the generator's twin
    params = wf.state.params
    cpu_params = {k: t.cpu() for k, t in params.items()}
    v0, mask = torch.as_tensor(mb.data), torch.as_tensor(mb.mask)
    seed, b, v, h = wf.state.step, v0.shape[0], v0.shape[1], wf.n_hidden
    chain, ref_chain = {}, {}
    stats_card = rbk.statistics(params, v0.cuda(), mask.cuda(), seed, cd_k=1, chain=chain)
    stats_cpu = rbk.statistics(cpu_params, v0, mask, seed, cd_k=1, chain=ref_chain)
    uh, uv = rbk.chain_uniforms(seed, b, v, h, 1)
    flips = _flip_count({k: t.cpu() for k, t in chain.items()}, ref_chain, uh, uv, 1)
    draws = b * (v + h)
    print(f"rbm: one CD-1 step card vs CPU from identical weights, seed {seed}: {flips} of "
          f"{draws} sampled units flipped")
    if flips > 1e-5 * draws:
        fail("rbm: card and CPU chains diverge")
    if flips == 0:
        new_card, err_card = rbk._apply_update(params, *stats_card, wf.learning_rate)
        new_cpu, err_cpu = rbk._apply_update(cpu_params, *stats_cpu, wf.learning_rate)
        for k in new_cpu:
            _rel_err(f"rbm card vs CPU updated {k}", new_card[k].cpu(), new_cpu[k], RBM_TOL)
        _rel_err("rbm card vs CPU reconstruction error", err_card.cpu(), err_cpu, RBM_TOL)
    return launches, step_ms, ips


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.models import alexnet, kohonen, mnist_rbm, transformer_lm
    from znicz_tpu_torch.ops import kohonen as kh_op
    from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build, lrn as lrn_kernel
    from znicz_tpu_torch.ops.kernels import kohonen as khk, rbm as rbk
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

    built = build_all(cuda_build)
    err, rows = phase_kernels(torch, lrn_kernel)
    launches, _ = phase_slice(torch, lrn_kernel, alexnet, model_lib, prng)
    t0 = time.perf_counter()
    phase_flash_build(built["flash_attention"], fa)
    flash_err = phase_flash_checks(torch, fa)
    flash_rows = phase_flash_times(torch, fa)
    flash_launches, _ = phase_lm(
        torch, fa, transformer_lm, transformer, model_lib, troot, prng
    )
    print(f"flash phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_unsup_build(built, rbk)
    unsup_err = {
        "kohonen_accumulate": phase_kohonen_checks(torch, khk, kh_op, datasets, prng),
        "rbm_cd": phase_rbm_checks(torch, rbk, datasets, prng),
    }
    unsup_rows = phase_unsup_times(torch, khk, kh_op, rbk)
    unsup_launches = {
        "kohonen_accumulate": phase_kohonen_model(torch, kohonen, khk, kh_op, troot, prng)[0],
        "rbm_cd": phase_rbm_model(torch, mnist_rbm, rbk, troot, prng)[0],
    }
    print(f"unsupervised phases: {time.perf_counter() - t0:.1f} s")

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
    for kname in UNSUP_SOURCE:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": UNSUP_SOURCE[kname],
            "replaces": REPLACES[kname],
            "launches": unsup_launches[kname],
            "max_abs_err": unsup_err[kname],
            **unsup_rows[(kname, "model")],  # the main path's shape
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
