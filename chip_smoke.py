#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (znicz_tpu_torch) end to end on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, builds every Hopper kernel of the ported paths from
the sources here (the LRN forward in Triton, compiled at first launch; the
LRN backward, flash-attention, Kohonen and RBM kernels in CUDA C++, built
with nvcc up front, one process a source, in parallel), and fails (non-zero
exit, no result line) when any phase fails:

1. the card's ``nvidia-smi`` name and power limit, and the versions; the
   LRN backward's build: nvcc's seconds, ptxas' registers, spills and
   shared memory of each of its 32 instantiations (it fails on a spill);
2. each LRN kernel against its plain PyTorch version on the same CUDA
   tensors, at AlexNet's two norm shapes (batch 128), in f32 and bf16; the
   backward's second launch bitwise equal to its first, and a canary (its C
   entry with dx at the front of a NaN-filled larger buffer: nothing past
   dx written, dx bitwise the wrapper's);
3. the LRN kernels' times beside their memory bound, the plain versions'
   and the ``F.local_response_norm`` yardstick's (timed here only; the port
   never calls it), with CUDA events, in bf16 and f32;
   3b. the backward at views 1 and 2 elements past an allocation (its
   narrower instantiations) and at C 16,384 (n 5 and 7; whole rows in
   shared memory), in f32 and bf16, against the plain version, each with a
   canary;
4. the AlexNet slice: ``alexnet.build_workflow(device="cuda")`` at the
   published geometry (227x227x3, 1000 classes, batch 128, bf16) runs one
   epoch (4 train steps and the eval pass) with the launch counters set to 0
   just before and read just after, then timed train steps; and a 4-image
   f32 forward (TF32 off) on the card against the CPU from identical
   weights;
5. the flash-attention build (made before phase 2): nvcc's seconds, and ptxas' registers and
   spills with the dynamic shared memory of each kernel; then the tensor-core
   instructions (SASS ``HMMA``, and ``HGMMA`` for ``wgmma``) of each kernel,
   counted in ``cuobjdump -sass`` of the built library: it fails if one of
   the 24 kernels (the bf16 forward, dQ and dK/dV; the f32 ones in 3xTF32)
   has none;
6. each flash kernel (forward, dQ, dK/dV) against its plain version on the
   same CUDA tensors, with O(1) ``dout`` and ``dlse``: the LM slice's shape
   (B 16, T 2048, H 8, D 64, causal), D 32 and 128, a non-causal and a
   ragged (T 2000) case, each in f32 and bf16; at the slice shape a second
   launch of the forward, dQ and dK/dV must be bitwise equal to the first,
   in both dtypes; the f32 forward's ``out`` and ``lse`` (at the slice
   shape, D 128 and without the mask) and dQ and dK/dV (at the slice shape)
   against a float64 plain version, within 10 times the f32 plain
   version's error;
   6b. ``flash_attention_lse`` at a head dim the kernels take zero-padded
   (96, on non-contiguous views), forward and gradients against autograd
   through the plain forward, in f32 and bf16; and the three wrappers at a
   B*H of 65600, launched as two batch slices, against their plain versions;
7. the flash kernels' times at the slice shape beside their bound (the f32
   kernels at the 3xTF32 rate, their f32-FMA bound beside it), the
   plain versions' and ``F.scaled_dot_product_attention``'s forward and
   autograd backward (timed here only; the port never calls it), in f32 and
   bf16;
8. the LM slice: ``transformer_lm.build_workflow(device="cuda",
   attention="flash")`` at the repo's mid LM's width and depth (vocab 8192,
   d_model 512, 12 layers, 8 heads, T 2048, batch 16) runs one epoch (4
   train steps, 1 eval step) with the flash counters set to 0 just before
   and read just after, then timed train steps with f32 and bf16 attention
   (tokens/sec), each with the flash counters read around them (12 of each
   kernel a train step: the bf16 steps run all three on the tensor cores),
   and a 512-token f32 forward on the card against the CPU from identical
   weights;
9. the Kohonen and RBM builds (made with the flash build): nvcc's seconds, ptxas' registers, spills and
   static shared memory of each kernel; the SASS ``HMMA`` count of each of
   the four Kohonen GEMM instantiations (``scores_kernel``,
   ``accum_kernel``) and the six RBM ones (``hidden_kernel``,
   ``visible_kernel``, ``stats_kernel``), each with 16- and 4-byte copies:
   it fails if one has none; both kernels' launches and grids at each check
   shape;
10. the Kohonen kernel against its plain version (num, den and the updated
    weights within 1e-5 of the largest magnitude, on the synthetic MNIST
    blobs): the model's shape (B 100, 8x8, F 784, masked tail), B 600 with
    500 valid (6x6, F 256), B 300 (6x6, F 64) and B 4096 (32x32, F 784); a
    repeat launch must be bitwise equal; one launch count a call; samples
    whose winner differs are counted, at most max(1, B // 1000) near-ties
    (the plain version then takes the kernel's winners); num and den
    against a float64 plain version along the kernel's winners within 10
    times the f32 plain version's error; a canary (every output and scratch
    buffer at the front of a NaN-filled larger one, with 16- and 4-byte
    copies) unchanged past them;
11. the RBM kernel against its plain version: the saturated regime exact;
    with injected uniforms and with the kernel's own draws against the
    plain version fed the generator twin's uniforms, at (B 100, 784x128,
    k 1), (B 1024, 784x1024, k 1) and (B 256, 784x1024, k 3) with a masked
    tail, and at (B 8, 784x14000, k 1) with injected uniforms: one launch
    count a call; every draw of the chain counted as a flip where the plain
    version, led along the kernel's own samples, would have drawn the other
    way, at most 1e-5 of the draws; within 1e-4 when none flipped; dW, dvb
    and dhb against a float64 plain version along the kernel's samples
    within 10 times the f32 plain version's error, never skipped; the same
    seed bitwise equal, another seed different; a canary (every output and
    scratch buffer at the front of a NaN-filled larger one, with 16- and
    4-byte copies) unchanged past them; the kernel's generator bitwise equal
    to its twin; Bernoulli frequencies at p 0.1, 0.5, 0.9 within 5 sigma;
12. both kernels' times at the model's shape and the large check shape
    (the RBM's k 3 case too) beside their bound (at the 3xTF32 rate, the
    f32-FMA bound beside it) and their plain version's (no PyTorch call
    computes either: library none);
13. the Kohonen model (``kohonen.build_workflow(device="cuda")``: 8x8 map,
    784 features, batch 100) and 14. the MNIST RBM (``mnist_rbm``: 784 x
    128, CD-1, batch 100), each on the synthetic MNIST stand-in at MNIST's
    split sizes (60000 / 10000): one epoch with the kernel's counter set to 0
    just before and read just after (one launch a train step, 600), timed
    train steps (images/sec), and one step on the card against the CPU from
    identical weights (the Kohonen kernel's own winners within max(1, B //
    1000) near-ties of the CPU's; the RBM with the same seed: the same
    chain);
15. the whole script's seconds, the ``kernels`` JSON line (each flash row
    with its bf16 times, bound, launches and error beside the f32 ones under
    ``"bf16"``; the f32 flash, Kohonen and RBM rows also with their f32-FMA
    bound and their float64 errors beside the plain version's), then the
    result line.

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
LRN_ROUTE = {  # (route, source)
    "lrn_fwd": ("triton", "znicz_tpu_torch/ops/kernels/lrn.py"),
    "lrn_bwd": ("cuda", "znicz_tpu_torch/csrc/lrn.cu"),
}

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
# the 3xTF32 f32 flash kernels against float64: within this factor of the
# f32 plain version's error (one TF32 product would be ~1000 times it)
FLOAT64_FACTOR = 10
PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": 989e12}  # H100 SXM, dense
TF32_FLOPS = 495e12  # H100 SXM, dense; 3xTF32 takes three products for one
# products of 2*D flops for each live (q, k) pair
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
FLASH_SOURCE = "znicz_tpu_torch/csrc/flash_attention.cu"
REPLACES.update({
    "flash_fwd": "znicz_tpu/ops/pallas/attention.py:212",
    "flash_dq": "znicz_tpu/ops/pallas/attention.py:265",
    "flash_dkv": "znicz_tpu/ops/pallas/attention.py:277",
})
FLASH = tuple(FLASH_PRODUCTS)
F64_OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",), "flash_dkv": ("dk", "dv")}


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


def _lrn_inputs(torch, gen, shape, dtype):
    """Softplus-like positive activations, as after conv_relu, and an O(1)
    output gradient, so that |dx| (up to ~10) stands well above atol and a
    zero or misplaced dx fails the check."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).exp().log1p()
    g = torch.randn(shape, generator=gen, device="cuda") * 3
    return x.to(dtype), g.to(dtype)


def _lrn_canary(torch, lrn_kernel, label, x, g, want, args):
    """The backward's C entry with dx at the front of a NaN-filled larger
    buffer: fails if anything past dx changed or dx differs from ``want``
    (the wrapper's)."""
    numel = x.numel()
    buf = torch.full((numel + 4096,), math.nan, dtype=x.dtype, device="cuda")
    lrn_kernel._launch_bwd(x, g, buf[:numel].view(x.shape), *args)
    torch.cuda.synchronize()
    past = not bool(torch.isnan(buf[numel:]).all())
    same = torch.equal(buf[:numel].view(x.shape), want)
    print(f"check lrn_bwd {label} canary: dx at the front of a NaN-filled buffer: written "
          f"past it: {past}; values bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"lrn_bwd {label}: the kernel wrote past dx or differs from the wrapper")


def phase_kernels(torch, lrn_kernel):
    """Phase 2 and 3: correctness at both shapes and dtypes (the backward
    also a bitwise repeat and a canary), then times."""
    args = (LRN["alpha"], LRN["beta"], LRN["k"], LRN["n"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: max over the shapes}
    rows = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: [a row a shape]}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for tag, shape in ALEXNET_NORMS.items():
            x, g = _lrn_inputs(torch, gen, shape, dtype)
            y = lrn_kernel.lrn_forward(x, *args)
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            e_f = compare(f"lrn_fwd {tag}", y, lrn_kernel.lrn_reference(x, *args), dname)
            e_b = compare(
                f"lrn_bwd {tag}", dx, lrn_kernel.lrn_bwd_reference(x, g, *args), dname
            )
            err["lrn_fwd"][dname] = max(err["lrn_fwd"].get(dname, 0.0), e_f)
            err["lrn_bwd"][dname] = max(err["lrn_bwd"].get(dname, 0.0), e_b)
            same = torch.equal(lrn_kernel.lrn_backward(x, g, *args), dx)
            print(f"check lrn_bwd {tag} {dname}: a second launch bitwise equal to the first: "
                  f"{same}")
            if not same:
                fail(f"lrn_bwd {tag} {dname}: a repeat launch differs")
            _lrn_canary(torch, lrn_kernel, f"{tag} {dname}", x, g, dx, args)
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
                rows[kname].setdefault(dname, []).append(row)
                print(
                    f"time {kname} {tag} {list(shape)} {dname}: kernel {row['ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.4f} ms, "
                    f"F.local_response_norm {'fwd' if short == 'fwd' else 'autograd bwd'} "
                    f"{row['library_ms']:.4f} ms"
                )
            del xr, y_lib
    return err, rows


# the backward's other instantiations: contiguous views that start 1 and 2
# elements past an allocation (narrower vectors), and C 16,384 (whole rows in
# shared memory), each on 128 rows; the C 16,384 case also at n 7
LRN_BWD_EXTRA = [  # (tag, shape, view offset in elements, n)
    ("misaligned+1", ALEXNET_NORMS["norm1"], 1, LRN["n"]),
    ("misaligned+2", ALEXNET_NORMS["norm1"], 2, LRN["n"]),
    ("c16384", (128, 16384), 0, LRN["n"]),
    ("c16384_n7", (128, 16384), 0, 7),
]


def phase_lrn_bwd_extra(torch, lrn_kernel):
    """Phase 3b: the backward at the shapes and views the wrappers route to
    its other instantiations, against the plain version, with a canary;
    returns {tag: {dtype name: max abs error}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for tag, shape, offset, n in LRN_BWD_EXTRA:
        args = (LRN["alpha"], LRN["beta"], LRN["k"], n)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x0, g0 = _lrn_inputs(torch, gen, shape, dtype)
            numel = x0.numel()
            x = torch.empty(numel + offset, dtype=dtype, device="cuda")[offset:].view(shape)
            g = torch.empty(numel + offset, dtype=dtype, device="cuda")[offset:].view(shape)
            x.copy_(x0)
            g.copy_(g0)
            geo = lrn_kernel.launch_geometry(numel // shape[-1], shape[-1], x.element_size(),
                                             lrn_kernel._alignment(x, g), n)
            launches = lrn_kernel.lrn_backward.launches
            dx = lrn_kernel.lrn_backward(x, g, *args)
            torch.cuda.synchronize()
            if lrn_kernel.lrn_backward.launches != launches + 1:
                fail(f"lrn_bwd {tag}: the wrapper did not launch the kernel")
            print(f"lrn_bwd {tag} {list(shape)} {dname} n {n}: "
                  f"{'halo' if geo.halo else 'rows'} kernel, {geo.vec}-element vectors, "
                  f"{geo.rows_per_block} rows a block of {geo.threads} threads")
            e = compare(f"lrn_bwd {tag}", dx, lrn_kernel.lrn_bwd_reference(x, g, *args), dname)
            out.setdefault(tag, {})[dname] = e
            _lrn_canary(torch, lrn_kernel, f"{tag} {dname}", x, g, dx, args)
    return out


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


# a flash kernel's mangled name: (fwd|dq|dkv)_mma_kernel<D> (bf16) and
# (fwd|dq|dkv)_tf32_kernel<D> (f32, 3xTF32), all on the tensor cores
_FLASH_KERNEL = re.compile(r"(fwd|dq|dkv)_(mma|tf32)_kernelILi(\d+)E")
_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?" + _FLASH_KERNEL.pattern)


def build_all(cuda_build):
    """Every CUDA C++ source of the port built from the sources here, one
    nvcc each, all started together; returns {name: Built}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        built = dict(zip(CUDA_SOURCES, pool.map(cuda_build.build, CUDA_SOURCES)))
    print(f"build: {len(built)} CUDA sources in parallel, {time.perf_counter() - t0:.1f} s wall")
    return built


def _flash_key(m):
    """(kernel, dtype, D) of a _FLASH_KERNEL match."""
    return m.group(1), "bf16" if m.group(2) == "mma" else "f32", int(m.group(3))


def _sass_mma_counts(cuda_build, lib_path):
    """{(kernel, dtype, D): (HMMA, HGMMA)} of each flash kernel: the
    tensor-core instructions in ``cuobjdump -sass`` of the built library."""
    from pathlib import Path

    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = _FLASH_KERNEL.search(line)
            cur = _flash_key(m) if m else None
            if cur is not None:
                counts[cur] = [0, 0]
        elif cur is not None:
            op = re.search(r"\b(HMMA|HGMMA)\.", line)
            if op:
                counts[cur][op.group(1) == "HGMMA"] += 1
    return {key: tuple(c) for key, c in counts.items()}


def phase_flash_build(built, fa, cuda_build, torch):
    """Phase 5: the flash-attention library's build and its tensor-core
    instructions."""
    print(f"build: {built.path.name}: nvcc {built.seconds:.1f} s"
          + ("" if built.seconds else " (the library was there already)"))
    rows, cur = [], None
    for line in built.log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            kernel, dtype, d = _flash_key(m)
            cur = {"kernel": kernel, "dtype": dtype, "d": d, "regs": None, "spill": None}
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
    sass = _sass_mma_counts(cuda_build, built.path)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for r in sorted(rows, key=lambda r: (r["kernel"], r["dtype"], r["d"])):
        key = (r["kernel"], r["dtype"], r["d"])
        hmma, hgmma = sass.get(key, (0, 0))
        print(f"ptxas flash_{r['kernel']} {r['dtype']} D={r['d']}: {r['regs']} registers, "
              f"spill stores/loads {r['spill']} bytes, "
              f"{fa.smem_bytes(r['kernel'], r['d'], dtypes[r['dtype']])} bytes dynamic shared "
              f"memory a block; SASS tensor-core instructions: {hmma} HMMA, {hgmma} HGMMA")
        # all on the tensor cores (the f32 ones in 3xTF32)
        if hmma + hgmma == 0:
            fail(f"flash_{r['kernel']} {r['dtype']} D={r['d']} has no tensor-core instructions")


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


def _flash_bwd_float64(torch, q, k, v, dout, lse, delta, causal, scale):
    """dq, dk, dv in float64 from the same inputs: the answer that the f32
    kernels and the f32 plain versions both approximate."""
    q, k, v, dout, lse, delta = (x.double() for x in (q, k, v, dout, lse, delta))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    del s
    if causal:
        p = p.tril()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta.permute(0, 2, 1)[..., None])
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k),
            scale * torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, dout))


def _flash_fwd_float64(torch, q, k, v, causal, scale):
    """out and lse in float64 from the same inputs: the answer that the f32
    forward kernel and the f32 plain version both approximate."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=s.device).tril(),
                          -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    s = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", s, v.double()), lse.permute(0, 2, 1)


def _float64_check(torch, label, names, got, plain, exact):
    """Each f32 result's max error against float64, the kernel's within
    FLOAT64_FACTOR of the plain version's; returns {name: (kernel's, plain
    version's max error)}."""
    out = {}
    for name, g, p, e in zip(names, got, plain, exact):
        ek = float((g.double() - e).abs().max())
        ep = float((p.double() - e).abs().max())
        ok = math.isfinite(ek) and ek <= FLOAT64_FACTOR * ep
        print(f"check {label} {name} against float64: kernel (3xTF32) max_abs_err={ek:.3e}, "
              f"f32 plain version {ep:.3e}, ratio {ek / max(ep, 1e-30):.2f} (limit "
              f"{FLOAT64_FACTOR}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label} {name}: the f32 kernel is not f32-accurate against float64")
        out[name] = (ek, ep)
    return out


def phase_flash_checks(torch, fa):
    """Phase 6: each flash kernel against its plain version; at the slice
    shape every kernel launched twice; the f32 forward (slice, D 128, no
    mask) and the f32 dQ and dK/dV (slice) against float64.  Returns the
    slice shape's max errors in f32 and bf16, and the f32 kernels' float64
    errors there."""
    err, bf16_err, f64_err = {}, {}, {}
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
            dq_r = fa.flash_dq_reference(q, k, v, dout, lse_r, delta, **kw)
            e["flash_dq"] = _near(f"flash_dq {label}", dq, dq_r, tol)
            dk_r, dv_r = fa.flash_dkv_reference(q, k, v, dout, lse_r, delta, **kw)
            e["flash_dkv"] = max(_near(f"flash_dkv dk {label}", dk, dk_r, tol),
                                 _near(f"flash_dkv dv {label}", dv, dv_r, tol))
            if dtype is torch.float32 and tag in ("slice", "d128", "full"):
                out_r, _ = fa.flash_fwd_reference(q, k, v, **kw)
                exact = _flash_fwd_float64(torch, q, k, v, causal, kw["scale"])
                f64 = _float64_check(torch, f"flash_fwd {label}", ("out", "lse"), (out, lse),
                                     (out_r, lse_r), exact)
                del out_r, exact
                if tag == "slice":
                    f64_err.update(f64)
            if tag == "slice":
                if dtype is torch.float32:  # the counted epoch's
                    err = e
                    exact = _flash_bwd_float64(torch, q, k, v, dout, lse_r, delta, causal,
                                               kw["scale"])
                    f64_err.update(_float64_check(torch, f"{label}", ("dq", "dk", "dv"),
                                                  (dq, dk, dv), (dq_r, dk_r, dv_r), exact))
                    del exact
                else:
                    bf16_err = e
                # one owner per output tile, no atomics: the same bits again
                out2, lse2 = fa.flash_fwd(q, k, v, **kw)
                dq2 = fa.flash_dq(q, k, v, dout, lse_r, delta, **kw)
                dk2, dv2 = fa.flash_dkv(q, k, v, dout, lse_r, delta, **kw)
                torch.cuda.synchronize()
                same = {"flash_fwd": torch.equal(out, out2) and torch.equal(lse, lse2),
                        "flash_dq": torch.equal(dq, dq2),
                        "flash_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
                print(f"check {label}: a second launch bitwise equal to the first: {same}")
                if not all(same.values()):
                    fail(f"{dname} launches at {label} are not bitwise repeatable")
                del out2, lse2, dq2, dk2, dv2
            del q, k, v, dout, dlse, out, lse, lse_r, delta, dq, dk, dv, dq_r, dk_r, dv_r
            torch.cuda.empty_cache()
    return err, bf16_err, f64_err


def phase_flash_inputs(torch, fa):
    """Phase 6b: what JAX's kernel takes and the kernels' grid does not hold
    as it is.  A head dim between the kernels' (96: zero-padded to 128 in
    the autograd layer) and non-contiguous views through
    ``flash_attention_lse``, forward and gradients against autograd through
    the plain forward on the same tensors, each kernel launched once; and a
    B*H above the grid's 65535, launched a batch slice at a time."""
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        b, t, h, d = 2, 1024, 8, 96
        q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, dtype, 7)
        label = f"padded head dim [{b},{t},{h},{d}] causal {dname}"

        def grads(fn):
            xs = [x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]  # non-contiguous views
            out, lse = fn(*xs)
            g = torch.autograd.grad((out, lse), xs, (dout, dlse))
            return (out.detach(), lse.detach(), *g)

        before = {name: getattr(fa, name).launches for name in FLASH}
        got = grads(lambda *xs: fa.flash_attention_lse(*xs, causal=True))
        torch.cuda.synchronize()
        launched = {name: getattr(fa, name).launches - before[name] for name in FLASH}
        want = grads(lambda *xs: fa.flash_fwd_reference(*xs, causal=True, scale=d ** -0.5))
        print(f"check {label}: launches {launched}")
        if launched != dict.fromkeys(FLASH, 1):
            fail(f"{label}: launches {launched}, want one of each kernel")
        for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if g.shape != r.shape:
                fail(f"{label}: {name} shape {tuple(g.shape)} != {tuple(r.shape)}")
            _near(f"{label} {name}", g, r,
                  FLASH_TOL["float32"] if name == "lse" else FLASH_TOL[dname])
        del q, k, v, dout, dlse, got, want
    b, t, h, d = 4100, 64, 16, 16  # B*H = 65600
    q, k, v, dout, dlse = _flash_inputs(torch, b, t, h, d, torch.float32, 8)
    kw = dict(causal=True, scale=0.25)
    label = f"B*H {b * h} [{b},{t},{h},{d}] causal float32"
    before = {name: getattr(fa, name).launches for name in FLASH}
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = ((dout * out).sum(-1) - dlse).contiguous()
    dq = fa.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    launched = {name: getattr(fa, name).launches - before[name] for name in FLASH}
    print(f"check {label}: launches {launched} (a batch slice each)")
    if launched != dict.fromkeys(FLASH, 2):
        fail(f"{label}: launches {launched}, want two of each kernel")
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    _near(f"flash_fwd out {label}", out, out_r, FLASH_TOL["float32"])
    _near(f"flash_fwd lse {label}", lse, lse_r, FLASH_TOL["float32"])
    del out_r, lse_r
    _near(f"flash_dq {label}", dq, fa.flash_dq_reference(q, k, v, dout, lse, delta, **kw),
          FLASH_TOL["float32"])
    for name, g, r in zip(("dk", "dv"), (dk, dv),
                          fa.flash_dkv_reference(q, k, v, dout, lse, delta, **kw)):
        _near(f"flash_dkv {name} {label}", g, r, FLASH_TOL["float32"])
    del q, k, v, dout, dlse, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()


def _flash_rate(name, dname):
    """The card's peak rate for the products a kernel takes: 3xTF32 (three
    TF32 products for one) for the f32 kernels, bf16 for the bf16 ones."""
    return TF32_FLOPS / 3 if dname == "float32" else PEAK_FLOPS[dname]


def _flash_bounds(b, t, h, d, causal, esize, dname, rate=_flash_rate):
    """Per kernel: (bound ms, "bytes" or "operations") for these inputs:
    the live (q, k) pairs they need, each input read once, each output
    written once; the operations at ``rate(kernel, dtype)``."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, stat = b * t * h * d * esize, b * t * h * 4
    nbytes = {
        "flash_fwd": 4 * tensor + stat,  # q, k, v in; out, lse out
        "flash_dq": 5 * tensor + 2 * stat,  # q, k, v, dout, lse, delta in; dq out
        "flash_dkv": 6 * tensor + 2 * stat,  # and dk, dv out
    }
    out = {}
    for name, n_products in FLASH_PRODUCTS.items():
        t_ops = n_products * 2 * d * pairs / rate(name, dname)
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
        # the f32 kernels' bound on f32 FMAs too, beside their 3xTF32 one
        fma = _flash_bounds(b, t, h, d, causal, q.element_size(), dname,
                            rate=lambda name, dname: PEAK_FLOPS[dname])
        for name in FLASH:
            kernel_ms, plain_ms = ms[name]
            bound_ms, bound_by = bounds[name]
            lib = lib_fwd if name == "flash_fwd" else lib_bwd
            rows[(name, dname)] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib,
            }
            extra = ""
            if dname == "float32":
                rows[(name, dname)]["f32_fma_bound_ms"] = fma[name][0]
                extra = f" (3xTF32; {fma[name][0]:.4f} ms on f32 FMAs)"
            print(f"time {name} [{b},{t},{h},{d}] causal {dname}: kernel {kernel_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}){extra}, plain {plain_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention "
                  f"{'fwd' if name == 'flash_fwd' else 'autograd bwd (dq, dk, dv together)'} "
                  f"{lib:.4f} ms")
        del q, k, v, dout, dlse, out, lse, delta, bwd, qt, kt, vt, xr, o_lib, g_lib
        torch.cuda.empty_cache()
    return rows


def _timed_steps(torch, fa, wf, label):
    """Median of 10 synchronised train steps after 2 warm-up, on the first
    train minibatch, with the flash counters set to 0 just before and read
    just after (one launch of each kernel a layer and step); returns (step
    ms, tokens/sec, launches)."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.zeros((x.shape[0],), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for name in FLASH:
        getattr(fa, name).launches = 0
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])  # the step's metrics on the host: a full sync
        step_s.append(time.perf_counter() - t0)
    launches = {name: getattr(fa, name).launches for name in FLASH}
    med = statistics.median(step_s[2:])
    tokens = x.shape[0] * x.shape[1]
    print(f"lm: train step ({label}, batch {x.shape[0]} x T {x.shape[1]}) median "
          f"{med * 1e3:.2f} ms over {len(step_s) - 2} steps after 2 warm-up; "
          f"{tokens / med:.1f} tokens/sec; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"all steps ms {[round(v * 1e3, 2) for v in step_s]}")
    want = LM_MID["n_layers"] * len(step_s)
    print(f"lm: launches over the {len(step_s)} {label} steps {launches}, want {want} of each")
    if launches != dict.fromkeys(FLASH, want):
        fail(f"flash launch counts over the {label} steps {launches} != {want} of each")
    return med * 1e3, tokens / med, launches


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

    steps = {"f32": _timed_steps(torch, fa, wf, "f32 attention")}

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
    steps["bf16"] = _timed_steps(torch, fa, wf16, "bf16 attention")
    return launches, steps


# -- the unsupervised slice: Kohonen SOM and RBM -------------------------------

CUDA_SOURCES = ("lrn", "flash_attention", "kohonen", "rbm")
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


RBM_GEMMS = {f"{k}_kernel<{copy}>" for k in ("hidden", "visible", "stats") for copy in (4, 16)}
KOHONEN_GEMMS = {f"{k}_kernel<{copy}>" for k in ("scores", "accum") for copy in (4, 16)}


def _kernel_name(mangled):
    """A csrc kernel's name from its mangled one: ``hidden_kernel<16>``,
    ``uniforms_kernel``; None for anything else."""
    name = re.search(r"\d+([a-z]+_kernel)(ILi(\d+)EE)?", mangled)
    if name is None:
        return None
    return name.group(1) + (f"<{name.group(3)}>" if name.group(3) else "")


def _ptxas_rows(log, name=_kernel_name):
    """(kernel name, registers, (spill stores, loads), static smem bytes) of
    each entry nvcc's ptxas reported."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [name(m.group(1)), None, None, 0]
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


# csrc/lrn.cu's instantiations: halo_kernel<BF16, VEC, beta kind> (the main
# path) and rows_kernel<BF16, VEC>
_LRN_KERNEL = re.compile(r"(halo|rows)_kernelILb([01])ELi(\d+)E(?:Li(\d)E)?")
LRN_BETAS = ("0.75", "0.5", "0.25", "1", "any")  # the source's BetaKind, in order
LRN_KERNELS = ({f"halo_kernel<{t}, {v}, beta {b}>"
                for t, vs in (("f32", (2, 4)), ("bf16", (2, 4, 8))) for v in vs for b in LRN_BETAS}
               | {f"rows_kernel<{t}, {v}>" for t, vs in (("f32", (1, 2, 4)), ("bf16", (1, 2, 4, 8)))
                  for v in vs})


def _lrn_kernel_name(mangled):
    m = _LRN_KERNEL.search(mangled)
    return m and (f"{m.group(1)}_kernel<{'bf16' if m.group(2) == '1' else 'f32'}, {m.group(3)}"
                  + (f", beta {LRN_BETAS[int(m.group(4))]}>" if m.group(4) else ">"))


def phase_lrn_build(b):
    """Phase 1 (the build): the LRN backward's nvcc seconds and each
    instantiation's registers, spills and shared memory; fails on a spill.
    Returns {instantiation: [registers, spill store bytes]}."""
    print(f"build: {b.path.name}: nvcc {b.seconds:.1f} s"
          + ("" if b.seconds else " (the library was there already)"))
    rows = _ptxas_rows(b.log, _lrn_kernel_name)
    if {r[0] for r in rows} != LRN_KERNELS:
        fail(f"ptxas reported {sorted(map(str, (r[0] for r in rows)))} for lrn.cu, "
             f"want {sorted(LRN_KERNELS)}")
    out = {}
    for kname, regs, spill, smem in sorted(rows):
        print(f"ptxas lrn {kname}: {regs} registers, spill stores/loads {spill} bytes, "
              f"{smem} bytes static shared memory a block (dynamic: "
              f"{'32 bytes a thread' if kname.startswith('halo') else '8 bytes a row channel'})")
        if spill is None or spill != (0, 0):
            fail(f"lrn {kname} spills registers: {spill}")
        out[kname] = [regs, spill[0]]
    return out


def _sass_hmma(cuda_build, lib_path):
    """{kernel name: SASS HMMA count} of each kernel of a built library."""
    from pathlib import Path

    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = _kernel_name(line.split("Function :")[1])
            counts.setdefault(cur, 0)
        elif cur is not None and re.search(r"\bHMMA\.", line):
            counts[cur] += 1
    return counts


def phase_unsup_build(built, khk, rbk, cuda_build):
    """Phase 9: the Kohonen and RBM libraries' builds; every Kohonen and RBM
    GEMM instantiation on the tensor cores (SASS HMMA)."""
    want = {"kohonen": KOHONEN_GEMMS | {"winners_kernel"},
            "rbm": RBM_GEMMS | {"uniforms_kernel"}}
    for name in ("kohonen", "rbm"):
        b = built[name]
        print(f"build: {b.path.name}: nvcc {b.seconds:.1f} s"
              + ("" if b.seconds else " (the library was there already)"))
        rows = _ptxas_rows(b.log)
        if {r[0] for r in rows} != want[name]:
            fail(f"ptxas reported {sorted(map(str, (r[0] for r in rows)))} for {name}.cu, "
                 f"want {sorted(want[name])}")
        for kname, regs, spill, smem in sorted(rows):
            print(f"ptxas {name} {kname}: {regs} registers, spill stores/loads {spill} bytes, "
                  f"{smem} bytes static shared memory a block")
    for name, gemms in (("kohonen", KOHONEN_GEMMS), ("rbm", RBM_GEMMS)):
        hmma = _sass_hmma(cuda_build, built[name].path)
        for kname in sorted(gemms):
            print(f"sass {name} {kname}: {hmma.get(kname, 0)} HMMA")
            if not hmma.get(kname):
                fail(f"{name} {kname} has no tensor-core instructions")
    for tag, b, side, f, _ in KOHONEN_CASES:
        m, t = side * side, lambda n: -(-n // khk.TILE)  # noqa: E731
        print(f"kohonen launches at {tag} (B {b}, {side}x{side}, F {f}): 3 a call: scores grid "
              f"{t(m)} x {t(b)} x {khk.split_count(b, m, f)} (F split), winners "
              f"{-(-b // 8)} + table blocks of 256 threads, accum {t(f + 1)} x {t(m)} blocks of "
              f"128 threads; {'16' if f % 4 == 0 and m % 4 == 0 else '4'}-byte copies")
    for tag, b, v, h, cd_k, _ in RBM_CASES:
        t = lambda n: -(-n // rbk.TILE)  # noqa: E731
        print(f"rbm launches at {tag} (B {b}, {v} x {h}, k {cd_k}): {2 * cd_k + 2} a step: "
              f"hidden grid {t(h)} x {t(b)}, visible {t(v)} x {t(b)}, stats {t(h)} x {t(v)} "
              f"blocks of 128 threads; {'16' if v % 4 == 0 and h % 4 == 0 else '4'}-byte copies")


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


def _kohonen_canary(torch, khk, label, w, x, mask, d2m, sigma):
    """The C entry with every output and scratch buffer taken from the front
    of a NaN-filled larger one: fails if anything past them changed or the
    results differ from the wrapper's own."""
    want = khk.accumulate(w, x, mask, d2m, sigma)
    carved, own = {}, khk._buffers

    def canary_buffers(b, m, f, device):
        ptr = {}
        for name, shape in khk.buffer_shapes(b, m, f).items():
            n = math.prod(shape)
            carved[name] = (torch.full((n + 4096,), math.nan, device=device), n)
            ptr[name] = carved[name][0].data_ptr()
        return (carved["num"][0][:m * f].view(m, f), carved["den"][0][:m].view(m, 1), ptr)

    khk._buffers = canary_buffers
    try:
        got = khk.accumulate(w, x, mask, d2m, sigma)
        torch.cuda.synchronize()
    finally:
        khk._buffers = own
    past = [name for name, (full, n) in carved.items() if not bool(torch.isnan(full[n:]).all())]
    same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
    print(f"check {label} canary: {len(carved)} buffers each at the front of a NaN-filled "
          f"one: written past {past or 'none'}; results bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"{label}: the kernel wrote past its buffers or read what it did not write")


def phase_kohonen_checks(torch, khk, kh, datasets, prng):
    """Phase 10: the Kohonen kernel against its plain version and against
    float64 along its own winners.  Returns the model shape's max error
    against the plain version and its float64 errors by output."""
    prng.seed_all(11)
    xs = torch.as_tensor(_mnist_rows(datasets, 4096, "mean_disp"), device="cuda")
    err, f64 = 0.0, {}
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
        before = khk.accumulate.launches
        num, den = khk.accumulate(w, x, mask, d2m, sigma, winners_out=win)
        num2, den2 = khk.accumulate(w, x, mask, d2m, sigma)
        torch.cuda.synchronize()
        if khk.accumulate.launches - before != 2:
            fail(f"kohonen {tag}: {khk.accumulate.launches - before} launch counts for two calls")
        same = torch.equal(num, num2) and torch.equal(den, den2)
        differ = int((kh.winners({"weights": w}, x) != win).sum())
        label = f"kohonen {tag} (B {b}, {side}x{side}, F {f}, {b - n_valid} masked)"
        print(f"check {label}: repeat launch bitwise equal: {same}; samples whose winner "
              f"differs from the plain version's: {differ} (limit {max(1, b // 1000)})"
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
        # float64 along the kernel's winners, beside the f32 plain version there
        plain = khk.accumulate_reference(w, x, mask, d2m, sigma, win=win)
        exact = khk.accumulate_reference(w.double(), x.double(), mask.double(), d2m.double(),
                                         sigma, win=win)
        e64 = _float64_check(torch, label, ("num", "den"), (num, den), plain, exact)
        if tag == "model":
            err, f64 = e, e64
    # the canary, with 16-byte copies (the model's shape) and 4-byte ones
    for b, side, f in ((100, 8, 784), (70, 5, 50)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(b)
        x = torch.rand((b, f), generator=gen, device="cuda")
        w = torch.rand((side * side, f), generator=gen, device="cuda")
        mask = (torch.arange(b, device="cuda") < b - 3).float()
        d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
        _kohonen_canary(torch, khk, f"kohonen (B {b}, {side}x{side}, F {f})", w, x, mask, d2m,
                        1.3)
    return err, f64


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


def _rbm_against_plain(torch, rbk, label, params, v0, mask, seed, cd_k, uniforms, uh, uv):
    """One kernel call against the plain version: every draw of the chain a
    flip where the plain version, led along the kernel's samples, would have
    drawn the other way; dW, dvb, dhb and stats within RBM_TOL where none
    flipped; dW, dvb and dhb against float64 along the kernel's samples,
    within FLOAT64_FACTOR of the f32 plain version's error, never skipped.
    Returns (the statistics, max error against the plain version where no
    draw flipped, else 0, and the float64 errors by output)."""
    chain, led = {}, {}
    before = rbk.statistics.launches
    got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k, uniforms=uniforms, chain=chain)
    torch.cuda.synchronize()
    if rbk.statistics.launches - before != 1:
        fail(f"{label}: {rbk.statistics.launches - before} launch counts for one call")
    samples = (chain["hidden_samples"], chain["visible_samples"])
    plain = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=led,
                                     samples=samples)
    flips = rbk.count_flips(chain, led, uh, uv)
    draws = samples[0].numel() + samples[1].numel()
    print(f"check {label}: {flips} of {draws} draws flipped (every draw of the chain; "
          f"limit {1e-5 * draws:.1f})")
    if flips > 1e-5 * draws:
        fail(f"{label}: {flips} flips")
    err = 0.0
    if flips == 0:  # then the kernel's chain is the plain version's own
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        err = max(_rel_err(f"{label}, {name}", g, r, RBM_TOL)
                  for name, g, r in zip(("dW", "dvb", "dhb", "stats"), got, ref))
    p64 = {k: t.double() for k, t in params.items()}
    exact = rbk.statistics_reference(p64, v0.double(), mask.double(), None, None, cd_k=cd_k,
                                     samples=samples)
    f64 = _float64_check(torch, label, ("dW", "dvb", "dhb"), got[:3], plain[:3], exact[:3])
    return got, err, f64


def _rbm_canary(torch, rbk, label, params, v0, mask, seed, cd_k):
    """The C entry with every output and scratch buffer taken from the front
    of a NaN-filled larger one: fails if anything past them changed or the
    results differ from the wrapper's own."""
    want = rbk.statistics(params, v0, mask, seed, cd_k=cd_k)
    carved, own = {}, rbk._buffers

    def canary_buffers(b, v, h, k, device):
        out = {}
        for name, shape in rbk.buffer_shapes(b, v, h, k).items():
            n = math.prod(shape)
            carved[name] = (torch.full((n + 4096,), math.nan, device=device), n)
            out[name] = carved[name][0][:n].view(shape)
        return out

    rbk._buffers = canary_buffers
    try:
        got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k)
        torch.cuda.synchronize()
    finally:
        rbk._buffers = own
    past = [name for name, (full, n) in carved.items() if not bool(torch.isnan(full[n:]).all())]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"check {label} canary: {len(carved)} buffers each at the front of a NaN-filled "
          f"one: written past {past or 'none'}; results bitwise the wrapper's: {same}")
    if past or not same:
        fail(f"{label}: the kernel wrote past its buffers or read what it did not write")


def phase_rbm_checks(torch, rbk, datasets, prng):
    """Phase 11: the RBM kernel against its plain version."""
    prng.seed_all(12)
    xs = torch.as_tensor((_mnist_rows(datasets, 1024, "linear") + 1.0) / 2.0, device="cuda")
    err, f64 = 0.0, {}
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
        label = f"rbm {tag} (B {b}, {v} x {h}, k {cd_k}, {b - n_valid} masked)"
        for how, uniforms in (("injected uniforms", (uh, uv)), ("in-kernel draws", None)):
            got, e, e64 = _rbm_against_plain(torch, rbk, f"{label}, {how}", params, v0, mask,
                                             seed, cd_k, uniforms, uh, uv)
            if tag == "model":
                err, f64 = max(err, e), e64
        again = rbk.statistics(params, v0, mask, seed, cd_k=cd_k)
        other = rbk.statistics(params, v0, mask, seed + 1000, cd_k=cd_k)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        changed = not torch.equal(got[0], other[0])
        print(f"check {label}: same seed bitwise equal {same}; another seed changes dW {changed}")
        if not (same and changed):
            fail(f"{label}: the seed does not key the chain")
    # a wide hidden layer (C4: beyond one block's shared memory in the old design)
    b, v, h = 8, 784, 14_000
    params, v0, mask = _rbm_inputs(torch, xs, b, v, h, 7, 40)
    uh, uv = rbk.chain_uniforms(40, b, v, h, 1, "cuda")
    _rbm_against_plain(torch, rbk, f"rbm wide (B {b}, {v} x {h}, k 1, 1 masked), injected "
                       "uniforms", params, v0, mask, 40, 1, (uh, uv), uh, uv)
    # the canary, with 16-byte copies (the model's shape) and 4-byte ones
    for b, v, h, cd_k in ((100, 784, 128, 1), (70, 50, 33, 3)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(b)
        params, v0, mask = _rbm_inputs(torch, torch.rand((b, v), generator=gen, device="cuda"),
                                       b, v, h, b - 3, 41)
        _rbm_canary(torch, rbk, f"rbm (B {b}, {v} x {h}, k {cd_k})", params, v0, mask, 21, cd_k)
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
    return err, f64


def _unsup_bound(flops, nbytes, rate=F32_FLOPS):
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
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
        # x, w, mask and d2m read once; num and den written once; the two
        # products at the 3xTF32 rate (three TF32 products for one), and on
        # f32 FMAs beside it
        nbytes = 4 * (b * f + m * f + b + m * m + m * f + m)
        bound, by = _unsup_bound(4 * b * m * f, nbytes, TF32_FLOPS / 3)
        fma_bound, _ = _unsup_bound(4 * b * m * f, nbytes)
        rows[("kohonen_accumulate", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                                 bound_by=by, library_ms=None,
                                                 f32_fma_bound_ms=fma_bound)
        print(f"time kohonen_accumulate {tag} (B {b}, {side}x{side}, F {f}): kernel {ms:.4f} ms "
              f"(3 launches), bound {bound:.4f} ms ({by}; 3xTF32; {fma_bound:.4f} ms on f32 "
              f"FMAs), plain {plain:.4f} ms, library: none (no single PyTorch call computes "
              f"it)")
    for tag, b, v, h, cd_k, _ in RBM_CASES:
        params, v0, mask = _rbm_inputs(torch, torch.rand((b, v), device="cuda"), b, v, h, b, 3)
        uh, uv = rbk.chain_uniforms(3, b, v, h, cd_k, "cuda")
        ms = cuda_ms(lambda: rbk.statistics(params, v0, mask, 3, cd_k=cd_k))
        plain = cuda_ms(lambda: rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k))
        # v0, mask, W and the biases read once; dW, dvb, dhb, stats written once;
        # the products at the 3xTF32 rate (three TF32 products for one), and on
        # f32 FMAs beside it
        nbytes = 4 * (b * v + b + 2 * v * h + 2 * (v + h) + 2)
        flops = (2 * cd_k + 3) * 2 * b * v * h
        bound, by = _unsup_bound(flops, nbytes, TF32_FLOPS / 3)
        fma_bound, _ = _unsup_bound(flops, nbytes)
        rows[("rbm_cd", tag)] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                     library_ms=None, f32_fma_bound_ms=fma_bound)
        print(f"time rbm_cd {tag} (B {b}, {v} x {h}, k {cd_k}): kernel {ms:.4f} ms "
              f"({2 * cd_k + 2} launches), bound {bound:.4f} ms ({by}; 3xTF32; {fma_bound:.4f} "
              f"ms on f32 FMAs), plain {plain:.4f} ms (uniforms given), library: none (no "
              f"single PyTorch call computes it)")
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
    # the kernel's own winners on the same data against the CPU plain version's
    win = torch.empty((x.shape[0],), dtype=torch.int32, device="cuda")
    khk.accumulate(w, x.cuda(), mask.cuda(), khk.pairwise_d2(coords.cuda()), sigma,
                   winners_out=win)
    differ = int((win.cpu() != kh.winners({"weights": w.cpu()}, x)).sum())
    limit = max(1, x.shape[0] // 1000)
    print(f"kohonen: one train step card vs CPU from identical weights (lr {lr}, sigma "
          f"{sigma}): the kernel's winners that differ from the CPU's {differ} (limit {limit})")
    if differ > limit:
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
    chain, led = {}, {}
    stats_card = rbk.statistics(params, v0.cuda(), mask.cuda(), seed, cd_k=1, chain=chain)
    uh, uv = rbk.chain_uniforms(seed, b, v, h, 1)
    card_chain = {k: t.cpu() for k, t in chain.items()}
    samples = (card_chain["hidden_samples"], card_chain["visible_samples"])
    # the CPU step led along the card's draws: every draw a flip where the
    # CPU would have drawn the other way
    stats_cpu = rbk.statistics_reference(cpu_params, v0, mask, uh, uv, cd_k=1, chain=led,
                                         samples=samples)
    flips = rbk.count_flips(card_chain, led, uh, uv)
    draws = samples[0].numel() + samples[1].numel()
    print(f"rbm: one CD-1 step card vs CPU from identical weights, seed {seed}: {flips} of "
          f"{draws} draws flipped")
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
    t_start = time.perf_counter()
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
    lrn_ptxas = phase_lrn_build(built["lrn"])
    err, rows = phase_kernels(torch, lrn_kernel)
    lrn_extra = phase_lrn_bwd_extra(torch, lrn_kernel)
    launches, _ = phase_slice(torch, lrn_kernel, alexnet, model_lib, prng)
    t0 = time.perf_counter()
    phase_flash_build(built["flash_attention"], fa, cuda_build, torch)
    flash_err, flash_bf16_err, flash_f64_err = phase_flash_checks(torch, fa)
    phase_flash_inputs(torch, fa)
    flash_rows = phase_flash_times(torch, fa)
    flash_launches, lm_steps = phase_lm(
        torch, fa, transformer_lm, transformer, model_lib, troot, prng
    )
    print(f"flash phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_unsup_build(built, khk, rbk, cuda_build)
    unsup_err, unsup_f64 = {}, {}
    unsup_err["kohonen_accumulate"], unsup_f64["kohonen_accumulate"] = phase_kohonen_checks(
        torch, khk, kh_op, datasets, prng)
    unsup_err["rbm_cd"], unsup_f64["rbm_cd"] = phase_rbm_checks(torch, rbk, datasets, prng)
    unsup_rows = phase_unsup_times(torch, khk, kh_op, rbk)
    unsup_launches = {
        "kohonen_accumulate": phase_kohonen_model(torch, kohonen, khk, kh_op, troot, prng)[0],
        "rbm_cd": phase_rbm_model(torch, mnist_rbm, rbk, troot, prng)[0],
    }
    print(f"unsupervised phases: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for kname in ("lrn_fwd", "lrn_bwd"):
        rs = rows[kname]["bfloat16"]  # one train step's work: norm1 + norm2, bf16
        entry = {
            "name": kname,
            "route": LRN_ROUTE[kname][0],
            "source": LRN_ROUTE[kname][1],
            "replaces": REPLACES[kname],
            "launches": launches[kname],
            "max_abs_err": err[kname]["bfloat16"],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            # each shape and dtype beside its bound; the f32 check's error
            "shapes": {f"{r['shape']} {d}": {k: v for k, v in r.items() if k != "shape"}
                       for d, dr in rows[kname].items() for r in dr},
            "f32_max_abs_err": err[kname]["float32"],
        }
        if kname == "lrn_bwd":  # phases 2-3b passed: bitwise repeats, canaries untouched
            entry.update(repeat="bitwise", canary="untouched", other_shapes_max_abs_err=lrn_extra,
                         ptxas_registers_spill_bytes=lrn_ptxas)
        kernels.append(entry)
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
            # the f32 kernel against float64, beside the f32 plain version
            "float64_err": {g: dict(zip(("kernel", "plain"), e))
                            for g, e in flash_f64_err.items() if g in F64_OUTPUTS[kname]},
            # bf16 attention: its timed steps' launches, the slice shape's check
            "bf16": {
                "launches": lm_steps["bf16"][2][kname],
                "max_abs_err": flash_bf16_err[kname],
                **flash_rows[(kname, "bfloat16")],
            },
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
            # the check shapes' times beside their bounds
            "shapes": {tag: row for (k, tag), row in unsup_rows.items()
                       if k == kname and tag != "model"},
            # the outputs against float64 at the model's shape, beside the
            # f32 plain version's
            "float64_err": {g: dict(zip(("kernel", "plain"), e))
                            for g, e in unsup_f64[kname].items()},
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
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
