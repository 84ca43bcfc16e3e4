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
15. the MNIST MLP (``mnist.build_workflow(device="cuda")``: 784 -> tanh 100
    -> softmax 10, batch 100, the synthetic 2000 / 500 with 15% held out,
    f32 without TF32; no hand kernel on its path) runs 3 epochs (17 train, 3
    valid and 5 test steps each), then the same seed on the CPU: per-epoch
    loss within 1e-4 relative and n_err within 1 a split;
    ``evaluate("test", confusion=True)`` on both from the card's weights
    (each matrix sums to n_samples with trace n_samples - n_err; the two
    equal, or every sample classed otherwise a near-tie, top-2 logits within
    1e-5); BASELINE's "MNIST MLP step latency", the median of 50
    synchronized train steps, beside the card's name and power limit;
16. CIFAR-10 (``cifar.build_workflow(device="cuda")``: conv 32 -> max-pool
    -> LRN -> conv 64 -> avg-pool -> FC 64 -> softmax 10, f32 without TF32,
    batch 100, the synthetic 2000 / 500) runs one epoch with the LRN
    counters set to 0 just before and read just after (20 forward and 20
    backward launches from the train steps, 5 forward from the test steps);
    a 4-image f32 forward on the card against the CPU from the same weights;
    20 timed train steps (images/sec); then both LRN kernels at the norm
    layer's ``[100, 15, 15, 32]`` as in phases 2-3, in f32 and bf16;
17. the image-file loaders, with no image library needed: a Kanji-shaped
    PNG tree (4 classes, 60 images in colour types 0, 2 and 6, every row
    filter) written by the script's own encoder under ``build/chip_smoke/``,
    each file decoded bitwise to its samples / 255, served by
    ``ImageDirectoryLoader`` (grey 24x24) and packed by ``pack_image_dir``
    equal to the expected; ``native/batch_assembler.cc`` built with g++
    (its seconds); ``crop_gather_u8`` on a ``[640, 256, 256, 3]`` u8 pool
    at batch 128, crop 227, with flips, bitwise equal to its numpy version,
    and its ms and GB/s a batch; the pool saved as packed ImageNet files
    (512 train, 128 valid, 1000 classes);
18. AlexNet from disk: ``alexnet.build_workflow(device="cuda")`` with that
    ``data_dir`` (the ImageNet loader, crop 227, batch 128, bf16, a
    1000-class head) runs one epoch with the LRN counters set to 0 just
    before and read just after (phase 4's counts), then 10 timed train
    steps split into the host's fill, the u8 batch's H2D copy and the step,
    as images/sec beside phase 4's synthetic rate, and a 4-image f32
    forward on the card against the CPU from the same weights;
19. ``mnist_ae`` at its published widths (batch 100, f32 without TF32): 3
    epochs on the card against the CPU from one seed (per-epoch loss within
    1e-4 relative), its step time (median of 20), the deconv and both its
    gradients at the model's shape on the card against the CPU (within
    1e-5 of the largest magnitude); one epoch each of ``video_ae``,
    ``kanji`` and ``yale_faces`` on their synthetic data and of ``kanji``
    on phase 17's tree, with images/sec;
20. the host loop around the step, on phase 17's packed files at phase
    18's geometry: ``run_epoch`` through the prefetch thread (depth 2, the
    default; the producer copies each batch into pinned memory, the
    consumer issues its copies on the step's stream), one epoch with the
    LRN counters set to 0 just before and read just after (phase 18's
    counts), every batch's int64 sum on the card equal to the loader's on
    the host, then windows of 10 epochs through the thread and through the
    serial loop in turns: images/sec over each whole window beside phase
    18's serial split, the per-step means of the step wall, dispatch,
    wait and producer stages, the pinned and pageable copy of one batch by
    CUDA events and the pipeline attribution; what the thread costs the
    SOM, the RBM, MNIST and CIFAR-10 (``run_epoch`` at depth 0 and 2 in
    turns) beside the bare hand-off of one item; a ``snapshot_dir`` run's
    'best' snapshot (MB, save and load ms) and a fresh workflow resumed
    from it evaluating as the saved one (cuDNN deterministic: equal n_err,
    loss within 1e-6); the registry's Prometheus text written to
    ``build/chip_smoke/metrics.prom``;
21. self-healing training: the anomaly watch's cost (``run_epoch`` with
    the watch on and off in turns: ms a step over whole windows, the
    per-step means of ``dispatch/train`` and the step wall, how many steps
    late the detector read its vectors, and one epoch each under
    ``torch.cuda.set_sync_debug_mode("warn")``, where the watch may add no
    synchronizing call) on AlexNet at phase 4's geometry and on the SOM,
    the RBM and MNIST at prefetch depth 0; then, with cuDNN deterministic,
    AlexNet runs of 3 epochs: a loader that returns NaN data for one train
    batch, once, under ``RecoveryPolicy(perturb=False, lr_backoff=1.0)``
    (``non_finite_loss`` within 3 steps, the epoch-start buffer restored
    bitwise, the rollback counter +1, the run bitwise equal to the
    unfaulted one, the LRN counters set to 0 just before and read just
    after; the rollback's and the clone's ms and the clone's MB);
    ``request_stop()`` mid-epoch with emergency snapshots (the snapshot's MB
    and seconds, a fresh workflow resumed from it bitwise equal to the
    uninterrupted run); deferred against sync epoch sync in turns
    (images/sec over whole runs, the same stop epoch, the same params);
    the SOM, the RBM and the LM (the mid LM's width at 2 layers, flash
    attention) each saved after one epoch and resumed, bitwise equal to
    its uninterrupted run;
22. the device-resident pool and the scan dispatch as CUDA graph replays,
    cuDNN deterministic: MNIST at ``bench.py``'s ``mnist_epoch`` shape
    (784 -> tanh 256 -> softmax 10, batch 128, 12,800 u8 images in the
    resident pool), the graph dispatch (``epoch_dispatch="scan"``) and the
    step dispatch from one seed for 3 epochs, the weights and histories
    bitwise equal, then images/sec over windows of whole epochs of at
    least ``SCAN_WINDOW_S`` seconds, 3 for each dispatch in turns, each
    ratio with its spread over the windows; a NaN fed
    into one drained watch row under ``RecoveryPolicy(perturb=False,
    lr_backoff=1.0)``: the graph and the step dispatch each roll back once
    and end bitwise equal to the unfaulted graph run; the SOM (8x8) and the
    RBM (784 x 128, CD-1) on the same pool with deferred sync, bitwise and
    in turns; every run's launches counted twice: through the wrappers'
    counters, set to 0 just before and read just after the run (the step
    dispatch's every launch; the graph dispatch's warm-up and capture
    calls), and, for the epochs after the first (the graph dispatch's
    replays only), as the kernel records of a ``torch.profiler`` (CUPTI)
    trace of those epochs, by kernel name, exact for both dispatches; AlexNet at full
    width (batch 128, bf16, 227^2, 1000 classes) from a resident FullBatch
    pool and from ``ImageNetLoader(device_resident=True)`` over packed
    256^2 files (1,024 train and 128 valid images), each bitwise against
    the step dispatch over 2 epochs with the LRN launches exact, the card's
    crops of an epoch equal to the host's native crops bitwise (and one
    batch's crop timed beside its bound), images/sec
    in turns beside phase 20's prefetch thread; for MNIST, the SOM, the RBM
    and AlexNet one train split of replays timed: the host's µs to issue a
    replay against the device's µs a step, the kernels' busy time
    (``torch.profiler``) and the idle share; the mid LM's width at 2
    layers through the graph with flash (its traced launches exact, the losses
    within 1e-4 of the step dispatch's: the embedding's backward adds with
    atomics);
23. the whole script's seconds, the ``kernels`` JSON line (each flash row
    with its bf16 times, bound, launches and error beside the f32 ones under
    ``"bf16"``; the f32 flash, Kohonen and RBM rows also with their f32-FMA
    bound and their float64 errors beside the plain version's; the LRN rows
    with the CIFAR path's launches and f32 times under ``"cifar"``, the
    disk path's launches under ``"alexnet_disk"``, the host loop's under
    ``"host_loop"`` and the poisoned run's of phase 21 under
    ``"self_healing"``; every row with the launches that phase 22's traces
    read from the graph dispatch's replayed epochs under ``"scan"``), then
    the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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


def phase_kernels(torch, lrn_kernel, shapes=ALEXNET_NORMS, seed=0):
    """Phase 2 and 3 (and 16's kernel part at CIFAR's shape): correctness at
    each of ``shapes`` in both dtypes (the backward also a bitwise repeat
    and a canary), then times."""
    args = (LRN["alpha"], LRN["beta"], LRN["k"], LRN["n"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: max over the shapes}
    rows = {"lrn_fwd": {}, "lrn_bwd": {}}  # {dtype name: [a row a shape]}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for tag, shape in shapes.items():
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


def _kohonen_canary(torch, khk, label, w, x, mask, d2m, tss):
    """The C entry with every output and scratch buffer taken from the front
    of a NaN-filled larger one: fails if anything past them changed or the
    results differ from the wrapper's own."""
    want = khk.accumulate(w, x, mask, d2m, tss)
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
        got = khk.accumulate(w, x, mask, d2m, tss)
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
        tss, lr = khk.sigma_tensor(2.5, "cuda"), 0.3
        win = torch.empty((b,), dtype=torch.int32, device="cuda")
        before = khk.accumulate.launches
        num, den = khk.accumulate(w, x, mask, d2m, tss, winners_out=win)
        num2, den2 = khk.accumulate(w, x, mask, d2m, tss)
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
        ref_num, ref_den = khk.accumulate_reference(w, x, mask, d2m, tss,
                                                    win=win if differ else None)
        e = max(_rel_err(f"{label} num", num, ref_num, KOHONEN_TOL),
                _rel_err(f"{label} den", den, ref_den, KOHONEN_TOL))
        _rel_err(f"{label} updated weights", khk._apply_update(w, num, den, lr),
                 khk._apply_update(w, ref_num, ref_den, lr), KOHONEN_TOL)
        # float64 along the kernel's winners, beside the f32 plain version there
        plain = khk.accumulate_reference(w, x, mask, d2m, tss, win=win)
        exact = khk.accumulate_reference(w.double(), x.double(), mask.double(), d2m.double(),
                                         tss, win=win)
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
                        khk.sigma_tensor(1.3, "cuda"))
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
    got = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k,
                         uniforms=uniforms, chain=chain)
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
    want = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
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
        got = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
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
        got = rbk.statistics(params, v0, mask, rbk.seed_tensor(5, "cuda"), cd_k=cd_k)
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
        again = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed, "cuda"), cd_k=cd_k)
        other = rbk.statistics(params, v0, mask, rbk.seed_tensor(seed + 1000, "cuda"),
                               cd_k=cd_k)
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
                                      torch.ones((b,), device="cuda"), rbk.seed_tensor(99, "cuda"),
                                      cd_k=1, chain=chain)
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
        # 2 sigma^2 on the card, as the workflow's step hands it to the kernel
        tss = khk.sigma_tensor(2.0, "cuda")
        ms = cuda_ms(lambda: khk.accumulate(w, x, mask, d2m, tss))
        plain = cuda_ms(lambda: khk.accumulate_reference(w, x, mask, d2m, tss))
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
        seed = rbk.seed_tensor(3, "cuda")  # on the card, as the workflow's step hands it
        ms = cuda_ms(lambda: rbk.statistics(params, v0, mask, seed, cd_k=cd_k))
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
    coords = kh.grid_coords(wf.sx, wf.sy, device="cpu")
    card = khk.train_step({"weights": w}, x.cuda(), coords.cuda(), mask=mask.cuda(),
                          learning_rate=lr, tss=khk.sigma_tensor(sigma, "cuda"))
    cpu = khk.train_step({"weights": w.cpu()}, x, coords, mask=mask, learning_rate=lr,
                         tss=khk.sigma_tensor(sigma, "cpu"))
    # the kernel's own winners on the same data against the CPU plain version's
    win = torch.empty((x.shape[0],), dtype=torch.int32, device="cuda")
    khk.accumulate(w, x.cuda(), mask.cuda(), khk.pairwise_d2(coords.cuda()),
                   khk.sigma_tensor(sigma, "cuda"), winners_out=win)
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
    stats_card = rbk.statistics(params, v0.cuda(), mask.cuda(), rbk.seed_tensor(seed, "cuda"),
                                cd_k=1, chain=chain)
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


MNIST_STEPS = {"train": 17, "valid": 3, "test": 5}  # batch 100 over 1700 / 300 / 500
MNIST_EPOCHS = 3
CIFAR_NORM = {"cifar": (100, 15, 15, 32)}  # the norm layer's input, batch 100
NEAR_TIE = 1e-5  # top-2 logits this close may be ordered either way


def _f32_exact(torch):
    """f32 products and convolutions without TF32, as the CPU computes them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _epochs(wf, n):
    return [wf.run_epoch()["summary"] for _ in range(n)]


def _step_seconds(torch, wf, n, warmup):
    """Seconds of ``n`` train steps on the first train minibatch (its
    labels, or the batch itself for an autoencoder), each synchronized,
    after ``warmup`` more."""
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x, mask = (torch.as_tensor(a, device="cuda") for a in (mb.data, mb.mask))
    y = x if wf.target == "input" else torch.as_tensor(mb.labels, device="cuda")
    step_s = []
    for _ in range(warmup + n):
        t0 = time.perf_counter()
        wf.train_step(x, y, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s[warmup:]


def _copy_params(dst, src):
    import torch

    with torch.no_grad():
        for ld, ls in zip(dst.state.params, src.state.params):
            for k in ld:
                ld[k].copy_(ls[k].to(ld[k].device))


def _confusion_against_cpu(torch, label, wf, wf_cpu, split):
    """``evaluate(split, confusion=True)`` on the card and on the CPU from the
    card's weights: each matrix sums to n_samples with trace n_samples -
    n_err, and the two are equal or differ only by near-ties (samples whose
    top-2 logits are within NEAR_TIE)."""
    _copy_params(wf_cpu, wf)
    card, cpu = wf.evaluate(split, confusion=True), wf_cpu.evaluate(split, confusion=True)
    for side, r in (("card", card), ("cpu", cpu)):
        c = r["confusion"]
        if c.dtype.name != "int32" or c.sum() != r["n_samples"] or (
                c.trace() != r["n_samples"] - r["n_err"]):
            fail(f"{label}: the {side} confusion {c.dtype} sums to {c.sum()} with trace "
                 f"{c.trace()}, want {r['n_samples']} and {r['n_samples'] - r['n_err']}")
    differ = int((card["confusion"] != cpu["confusion"]).sum())
    ties = []
    if differ:  # name every sample whose class differs; each must be a near-tie
        with torch.no_grad():
            for mb in wf.loader.batches(split, shuffle=False):
                x = torch.as_tensor(mb.data)
                lc = wf.model.apply(wf.state.params, x.cuda()).cpu()
                lh = wf_cpu.model.apply(wf_cpu.state.params, x)
                for i in torch.nonzero((lc.argmax(1) != lh.argmax(1)) & (
                        torch.as_tensor(mb.mask) > 0)).flatten().tolist():
                    top = lh[i].topk(2).values
                    ties.append((int(mb.indices[i]), float(top[0] - top[1])))
    print(f"{label}: evaluate({split!r}, confusion=True) card {json.dumps(card['confusion'].tolist())}"
          f", n_err {card['n_err']:.0f} of {card['n_samples']:.0f}, loss {card['loss']:.6f}; CPU "
          f"n_err {cpu['n_err']:.0f}, loss {cpu['loss']:.6f}; {differ} cells differ; samples "
          f"classed otherwise (index, top-2 gap) {ties}")
    if any(gap > NEAR_TIE for _, gap in ties) or (differ and not ties):
        fail(f"{label}: the card's confusion differs from the CPU's beyond near-ties")
    return card


def _epochs_against_cpu(label, card, cpu, rtol=1e-4):
    """Per-epoch loss within ``rtol`` relative and n_err within 1 a split."""
    for e, (ec, eh) in enumerate(zip(card, cpu)):
        for split in eh:
            c, h = ec[split], eh[split]
            rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
            print(f"{label}: epoch {e} {split}: card loss {c['loss']:.7f} n_err {c['n_err']:.0f}; "
                  f"CPU loss {h['loss']:.7f} n_err {h['n_err']:.0f} (loss rel diff {rel:.2e}, "
                  f"limit {rtol}; n_err within 1)")
            if not rel <= rtol or abs(c["n_err"] - h["n_err"]) > 1:
                fail(f"{label}: epoch {e} {split} differs between the card and the CPU")


def phase_mnist(torch, mnist, prng, smi):
    """Phase 15: the MNIST MLP at its published widths (784 -> tanh 100 ->
    softmax 10, batch 100, synthetic 2000 / 500 with 15% held out)."""
    _f32_exact(torch)
    prng.seed_all(1234)
    wf = mnist.build_workflow(device="cuda")
    wf.initialize()
    steps = {s: wf.loader.n_minibatches(s) for s in MNIST_STEPS}
    print(f"mnist: layer shapes {list(wf.model.layer_shapes)}; steps an epoch {steps}")
    if steps != MNIST_STEPS:
        fail(f"mnist: {steps} steps an epoch, want {MNIST_STEPS}")
    t0 = time.perf_counter()
    card = _epochs(wf, MNIST_EPOCHS)
    torch.cuda.synchronize()
    print(f"mnist: {MNIST_EPOCHS} epochs on the card in {time.perf_counter() - t0:.2f} s "
          "(no hand kernel on this path: cuBLAS products)")
    prng.seed_all(1234)
    wf_cpu = mnist.build_workflow(device="cpu")
    wf_cpu.initialize()
    _epochs_against_cpu("mnist", card, _epochs(wf_cpu, MNIST_EPOCHS))
    _confusion_against_cpu(torch, "mnist", wf, wf_cpu, "test")
    step_s = _step_seconds(torch, wf, 50, 5)
    med = statistics.median(step_s)
    print(f"mnist: MNIST MLP step latency (batch 100, f32): median {med * 1e3:.4f} ms over 50 "
          f"synchronized train steps after 5 warm-up, on {smi}; min "
          f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f} ms")
    return med * 1e3


def phase_cifar(torch, cifar, lrn_kernel, model_lib, prng, smi):
    """Phase 16: the CIFAR-10 model at its published geometry (f32, batch
    100, synthetic 2000 / 500): one epoch with the LRN counters set to 0
    just before and read just after, a card-vs-CPU forward, timed train
    steps."""
    _f32_exact(torch)
    prng.seed_all(1234)
    wf = cifar.build_workflow(device="cuda")
    wf.initialize()
    torch.backends.cudnn.benchmark = True
    n_train, n_test = wf.loader.n_minibatches("train"), wf.loader.n_minibatches("test")
    print(f"cifar: layer shapes {list(wf.model.layer_shapes)}; {n_train} train and {n_test} "
          "test steps an epoch")
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    summary = verdict["summary"]
    print(f"cifar: epoch 1 (first, with cuDNN autotuning) {epoch_s:.2f} s: {json.dumps(summary)}")
    for split, n in (("train", 2000), ("test", 500)):
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(
                math.isfinite(float(v)) for v in m.values()):
            fail(f"cifar: {split} saw {m}, want {n} samples and finite metrics")
    want = {"lrn_fwd": n_train + n_test, "lrn_bwd": n_train}
    print(f"cifar: launches {launches}, want {want} ({n_train} train steps: one forward and one "
          f"backward each; {n_test} test steps: one forward each)")
    if (n_train, n_test) != (20, 5) or launches != want:
        fail(f"cifar: LRN launch counts {launches} != {want}")

    # card vs CPU: 4-image f32 forward from identical weights
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(cifar.DEFAULTS["layers"], wf.loader.sample_shape, device="cpu")
    host = model_lib.params_to_numpy(wf.state.params)
    mb = next(iter(wf.loader.batches("test", shuffle=False)))
    xb = torch.as_tensor(mb.data[:4])
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"cifar: 4-image f32 forward, card vs CPU: max |diff| / max |logit| = {rel:.3e} "
          f"(limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 10):
        fail("cifar: card and CPU forwards disagree")

    torch.backends.cudnn.benchmark = True
    step_s = _step_seconds(torch, wf, 20, 2)
    med = statistics.median(step_s)
    print(f"cifar: train step (batch 100, f32, TF32 off) median {med * 1e3:.4f} ms over 20 "
          f"synchronized steps after 2 warm-up; {100 / med:.1f} images/sec on {smi}; all "
          f"steps ms {[round(v * 1e3, 3) for v in step_s]}")
    geo = lrn_kernel.launch_geometry(100 * 15 * 15, 32, 4, 16, LRN["n"])
    print(f"cifar: lrn_bwd at {list(CIFAR_NORM['cifar'])} f32: "
          f"{'halo' if geo.halo else 'rows'} kernel, {geo.vec}-element vectors, "
          f"{geo.rows_per_block} rows a block of {geo.threads} threads, {geo.grid} blocks")
    err, rows = phase_kernels(torch, lrn_kernel, CIFAR_NORM, seed=2)
    return launches, err, rows, {"step_ms": med * 1e3, "images_per_s": 100 / med}


# -- the image-file loaders, AlexNet from disk, the autoencoders -------------
WORK_DIR = "build/chip_smoke"  # under the checkout (gitignored), made anew each run
PNG_FILTERS = ("None", "Sub", "Up", "Average", "Paeth")
TREE_SPLITS = {"train": 12, "test": 3}  # images a class
TREE_CLASSES = ("ka", "ki", "ku", "ke")
TREE_SIZES = ((24, 24), (28, 20), (20, 30))  # (H, W): nearest resizes to 24x24 too
CROP_POOL = (640, 256, 256, 3)  # phase 18's 512 train + 128 valid images
CROP, CROP_BATCH = 227, 128
DISK_SPLITS = {"train": 512, "valid": 128}
AE_EPOCHS = 3


def _png_bytes(samples, ctype, filters):
    """An 8-bit, non-interlaced PNG of ``samples`` ``[H, W, S]`` (colour
    type 0, 2 or 6), row ``r`` filtered by ``filters[r % len(filters)]``:
    the script's own encoder (``zlib``), so that no image library is
    needed to write the tree."""
    import struct
    import zlib

    h, w, s = samples.shape
    rows = samples.reshape(h, w * s).tolist()
    raw, prev = bytearray(), [0] * (w * s)
    for r, cur in enumerate(rows):
        kind = filters[r % len(filters)]
        raw.append(kind)
        for i, x in enumerate(cur):
            a = cur[i - s] if i >= s else 0
            b = prev[i]
            c = prev[i - s] if i >= s else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            raw.append((x - (0, a, b, (a + b) >> 1, paeth)[kind]) & 0xFF)
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _nearest(img, h, w):
    """Nearest-neighbour resize, written out here: the check's own."""
    import numpy as np

    ih, iw = img.shape[:2]
    return img[(np.arange(h) * ih / h).astype(np.int64)][:, (np.arange(w) * iw / w).astype(np.int64)]


def _write_png_tree(root):
    """A Kanji-shaped tree (``<split>/<class>/*.png``, 4 classes) in colour
    types 0, 2 and 6 and every row filter, each image alone and all five in
    turn; returns {path: the expected float32 image [H, W, C]}."""
    import numpy as np

    rng = np.random.default_rng(17)
    expected, k = {}, 0
    for split, n in TREE_SPLITS.items():
        for ci, cls in enumerate(TREE_CLASSES):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = TREE_SIZES[k % len(TREE_SIZES)]
                ctype = (0, 2, 6)[k % 3]
                s = {0: 1, 2: 3, 6: 4}[ctype]
                samples = np.clip(40 + 50 * ci + rng.normal(0, 30, (h, w, s)), 0, 255).astype(
                    np.uint8)
                filters = [k % 5] if k % 6 else [0, 1, 2, 3, 4]
                path = d / f"{i:03d}.png"
                path.write_bytes(_png_bytes(samples, ctype, filters))
                expected[str(path)] = np.divide(samples[..., :3], 255, dtype=np.float32)
                k += 1
    return expected


def phase_loaders(torch, image_lib, imagenet_lib, native_lib, smi):
    """Phase 17: the loaders on this machine (no image library needed): a
    PNG tree written by the script's encoder, decoded bitwise, served by
    ``ImageDirectoryLoader`` and packed by ``pack_image_dir``; the native
    crop gather built with g++, held bitwise against its numpy version at
    AlexNet's batch and timed; the packed ImageNet-shaped files of phase
    18.  Returns the tree's path, the packed dir's path and the crop's
    numbers."""
    import importlib.util
    import shutil
    from pathlib import Path

    import numpy as np

    work = Path(__file__).resolve().parent / WORK_DIR
    shutil.rmtree(work, ignore_errors=True)
    libs = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}
    print(f"loaders: image libraries importable here: {libs} (the port decodes PNG and BMP "
          "itself)")
    t0 = time.perf_counter()
    expected = _write_png_tree(work / "tree")
    tree = str(work / "tree")
    bad = [p for p, want in expected.items()
           if not np.array_equal(image_lib._read_image(p), want)]
    print(f"loaders: wrote {len(expected)} PNGs (colour types 0, 2, 6; filters "
          f"{', '.join(PNG_FILTERS)}) in {time.perf_counter() - t0:.2f} s; decoded bitwise "
          f"equal to the encoded samples / 255: {len(expected) - len(bad)} of {len(expected)}")
    if bad:
        fail(f"loaders: {len(bad)} PNGs decode to other values, e.g. {bad[0]}")
    dl = image_lib.ImageDirectoryLoader(tree, target_shape=(24, 24, 1), grayscale=True,
                                        minibatch_size=10)
    n_rows = 0
    for split in ("train", "test"):
        for mb in dl.batches(split, shuffle=False):
            for row, idx in enumerate(mb.indices[mb.mask > 0]):
                path, label = dl.index[split][int(idx)]
                want = _nearest(expected[path], 24, 24).mean(axis=-1, keepdims=True)
                if not np.array_equal(mb.data[row], want) or mb.labels[row] != label:
                    fail(f"loaders: ImageDirectoryLoader row {row} of {split} ({path}) differs")
                n_rows += 1
    if dl.classes != sorted(TREE_CLASSES) or n_rows != len(expected):
        fail(f"loaders: ImageDirectoryLoader classes {dl.classes}, {n_rows} rows")
    counts = imagenet_lib.pack_image_dir(tree, str(work / "packed_tree"), size=32)
    packed = np.load(work / "packed_tree" / "train_images.npy")
    labels = np.load(work / "packed_tree" / "train_labels.npy")
    want = np.stack([imagenet_lib._to_u8_rgb(expected[p], 32) for p, _ in dl.index["train"]])
    print(f"loaders: ImageDirectoryLoader served {n_rows} grey 24x24 rows equal to the "
          f"expected; pack_image_dir {counts}, train images {list(packed.shape)} equal to the "
          f"expected: {np.array_equal(packed, want)}")
    if not np.array_equal(packed, want) or labels.tolist() != [
            lab for _, lab in dl.index["train"]]:
        fail("loaders: pack_image_dir wrote other images or labels")

    t0 = time.perf_counter()
    built = native_lib.build()
    print(f"loaders: native/batch_assembler.cc built by g++ in {built.seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with the load) -> {built.path.name}")
    native_lib.load()
    rng = np.random.default_rng(23)
    pool = rng.integers(0, 256, CROP_POOL, dtype=np.uint8)
    n, h, w, _ = pool.shape
    args = (rng.integers(0, n, CROP_BATCH), rng.integers(0, h - CROP + 1, CROP_BATCH),
            rng.integers(0, w - CROP + 1, CROP_BATCH), rng.integers(0, 2, CROP_BATCH), CROP, CROP)
    got = native_lib.crop_gather_u8(pool, *args)
    same = np.array_equal(got, native_lib.crop_gather_u8_reference(pool, *args))
    print(f"loaders: crop_gather_u8 on a {list(CROP_POOL)} u8 pool, batch {CROP_BATCH}, crop "
          f"{CROP}, {int(args[3].sum())} flips: native bitwise equal to the numpy version: {same}")
    if not same:
        fail("loaders: the native crop differs from its numpy version")
    ms = []
    for _ in range(23):
        t0 = time.perf_counter()
        native_lib.crop_gather_u8(pool, *args)
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    native_lib.crop_gather_u8_reference(pool, *args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    med = statistics.median(ms[3:])
    nbytes = got.nbytes
    print(f"loaders: crop_gather_u8 {med:.3f} ms a batch (median of 20 after 3 warm-up; "
          f"{nbytes / 1e6:.2f} MB out, the same read), {nbytes / med / 1e6:.2f} GB/s written; "
          f"numpy version {plain_ms:.3f} ms; {smi}")

    out = work / "imagenet"  # phase 18's data: pack_image_dir's layout at 256
    out.mkdir()
    n_train = DISK_SPLITS["train"]
    labels = rng.integers(0, 1000, n).astype(np.int32)
    for split, sl in (("train", slice(0, n_train)), ("valid", slice(n_train, n))):
        np.save(out / f"{split}_images.npy", pool[sl])
        np.save(out / f"{split}_labels.npy", labels[sl])
    (out / "classes.json").write_text(json.dumps([f"n{i:08d}" for i in range(1000)]))
    mean = pool[:n_train].reshape(-1, 3).mean(axis=0) / 255.0
    (out / "mean_rgb.json").write_text(json.dumps(mean.tolist()))
    return tree, str(out), {"crop_ms": med, "crop_gb_per_s": nbytes / med / 1e6,
                            "crop_plain_ms": plain_ms, "gxx_s": built.seconds}


def phase_alexnet_disk(torch, lrn_kernel, alexnet, imagenet_lib, model_lib, prng, troot,
                       data_dir, synthetic, smi):
    """Phase 18: AlexNet at its published geometry (227 crops, batch 128,
    1000 classes, bf16) from phase 17's packed files: one epoch with the
    LRN counters set to 0 just before and read just after, timed steps
    split into the host's fill, the u8 batch's H2D copy and the step, and a
    4-image f32 forward on the card against the CPU."""
    saved = troot.to_dict()
    try:
        troot.alexnet.loader.update({"data_dir": data_dir})
        prng.seed_all(1234)
        t0 = time.perf_counter()
        wf = alexnet.build_workflow(device="cuda")
    finally:
        troot.clear()
        troot.update(saved)
    wf.initialize()
    loader = wf.loader
    print(f"alexnet disk: built in {time.perf_counter() - t0:.1f} s on {type(loader).__name__} "
          f"({loader.data_dir}): {loader.class_lengths}, {loader.n_classes()} classes, crops "
          f"{loader.sample_shape}, head {wf.model.output_shape}, {wf.model.compute_dtype}")
    if not isinstance(loader, imagenet_lib.ImageNetLoader) or wf.model.output_shape != (1000,) \
            or loader.sample_shape != (CROP, CROP, 3) or loader.class_lengths != DISK_SPLITS:
        fail("alexnet disk: not the ImageNet loader at the published geometry")
    n_train, n_eval = loader.n_minibatches("train"), loader.n_minibatches("valid")
    torch.backends.cudnn.benchmark = True
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    summary = verdict["summary"]
    print(f"alexnet disk: epoch 1 {epoch_s:.2f} s: {json.dumps(summary)}")
    for split, n in DISK_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(math.isfinite(float(v))
                                                        for v in m.values()):
            fail(f"alexnet disk: {split} saw {m}, want {n} samples and finite metrics")
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    print(f"alexnet disk: launches {launches}, want {want} (as phase 4: {n_train} train steps, "
          f"{n_eval} eval steps, 2 norm layers)")
    if launches != want:
        fail(f"alexnet disk: LRN launch counts {launches} != {want}")

    def train_batches():
        while True:
            yield from loader.batches("train")

    batches = train_batches()
    parts = {"fill": [], "h2d": [], "step": [], "total": []}
    for i in range(12):
        t0 = time.perf_counter()
        mb = next(batches)  # the shuffle draw, the crop draws, the native crop
        t1 = time.perf_counter()
        x = torch.as_tensor(mb.data).to("cuda")
        y = torch.as_tensor(mb.labels).to("cuda")
        mask = torch.as_tensor(mb.mask).to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        acc = wf.train_step(x, y, mask)
        float(acc[0])
        t3 = time.perf_counter()
        if i >= 2:
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                parts[k].append(v * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    rate = CROP_BATCH / med["total"] * 1e3
    print(f"alexnet disk: train step from disk (batch {CROP_BATCH}, bf16) median "
          f"{med['total']:.2f} ms over 10 steps after 2 warm-up: host fill (crop) "
          f"{med['fill']:.2f} ms, H2D of the u8 batch {med['h2d']:.2f} ms "
          f"({x.numel() / 1e6:.1f} MB), step {med['step']:.2f} ms; {rate:.1f} images/sec, "
          f"beside phase 4's synthetic {synthetic['images_per_s']:.1f} images/sec "
          f"({synthetic['step_ms']:.2f} ms a step); {smi}; all totals ms "
          f"{[round(v, 2) for v in parts['total']]}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    m32 = model_lib.build(alexnet.DEFAULTS["layers"], loader.sample_shape, device="cpu")
    host = model_lib.params_to_numpy(wf.state.params)
    mb = next(iter(loader.batches("valid")))
    xb = loader.device_preproc()(torch.as_tensor(mb.data[:4]))
    with torch.no_grad():
        out_gpu = m32.apply(model_lib.params_from_jax(host, "cuda"), xb.cuda()).cpu()
        out_cpu = m32.apply(model_lib.params_from_jax(host, "cpu"), xb)
    rel = float((out_gpu - out_cpu).abs().max() / out_cpu.abs().max())
    print(f"alexnet disk: 4-image f32 forward of the valid crops, card vs CPU: max |diff| / "
          f"max |logit| = {rel:.3e} (limit 1e-4); logits shape {list(out_gpu.shape)}")
    if not rel < 1e-4 or out_gpu.shape != (4, 1000):
        fail("alexnet disk: card and CPU forwards disagree")
    return launches, {**med, "images_per_s": rate}


def phase_autoencoders(torch, models, deconv, troot, prng, tree, smi):
    """Phase 19: mnist_ae at its published widths (batch 100, f32 without
    TF32) 3 epochs on the card against the CPU from one seed, its step
    time, the deconv at its shape card against CPU; one epoch each of
    video_ae, kanji and yale_faces (synthetic) and kanji from phase 17's
    tree on the card."""
    _f32_exact(torch)
    torch.backends.cudnn.benchmark = False
    mnist_ae = models["mnist_ae"]
    prng.seed_all(1234)
    wf = mnist_ae.build_workflow(device="cuda")
    wf.initialize()
    print(f"mnist_ae: layer shapes {list(wf.model.layer_shapes)}; "
          f"{wf.loader.n_minibatches('train')} train and {wf.loader.n_minibatches('test')} test "
          "steps an epoch")
    if wf.model.layer_shapes != ((7, 7, 12), (28, 28, 1)):
        fail(f"mnist_ae: layer shapes {wf.model.layer_shapes}")
    t0 = time.perf_counter()
    card = _epochs(wf, AE_EPOCHS)
    torch.cuda.synchronize()
    print(f"mnist_ae: {AE_EPOCHS} epochs on the card in {time.perf_counter() - t0:.2f} s "
          "(conv and deconv: cuDNN; no hand kernel on this path)")
    prng.seed_all(1234)
    wf_cpu = mnist_ae.build_workflow(device="cpu")
    wf_cpu.initialize()
    _epochs_against_cpu("mnist_ae", card, _epochs(wf_cpu, AE_EPOCHS))
    step_s = _step_seconds(torch, wf, 20, 5)
    med = statistics.median(step_s) * 1e3
    print(f"mnist_ae: train step (batch 100, f32, TF32 off) median {med:.4f} ms over 20 "
          f"synchronized steps after 5 warm-up, on {smi}; min {min(step_s) * 1e3:.4f}, max "
          f"{max(step_s) * 1e3:.4f} ms")

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((100, 7, 7, 12), generator=gen)
    w = torch.randn((10, 10, 1, 12), generator=gen) * 0.05
    g = torch.randn((100, 28, 28, 1), generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        xd, wd = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
        y = deconv.apply({"weights": wd}, xd, sliding=(3, 3))
        dx, dw = torch.autograd.grad((y * g.to(dev)).sum(), (xd, wd))
        res[dev] = [t.detach().cpu() for t in (y, dx, dw)]
    errs = {name: float((c - h).abs().max() / h.abs().max())
            for name, c, h in zip(("y", "dx", "dw"), res["cuda"], res["cpu"])}
    print(f"mnist_ae: deconv at [100, 7, 7, 12] -> [100, 28, 28, 1] (10x10, stride 3), card vs "
          f"CPU, max |diff| / max |ref|: {errs} (limit 1e-5)")
    if not all(v < 1e-5 for v in errs.values()):
        fail("mnist_ae: the deconv or its gradients differ between the card and the CPU")

    rates = {}
    runs = [(name, None) for name in ("video_ae", "kanji", "yale_faces")] + [("kanji", tree)]
    for name, data_dir in runs:
        saved = troot.to_dict()
        try:
            if data_dir:
                getattr(troot, name).loader.update({"data_dir": data_dir})
            prng.seed_all(1234)
            wf = models[name].build_workflow(device="cuda")
        finally:
            troot.clear()
            troot.update(saved)
        wf.initialize()
        t0 = time.perf_counter()
        summary = wf.run_epoch()["summary"]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = sum(m["n_samples"] for m in summary.values())
        label = f"{name}{' (PNG tree)' if data_dir else ''}"
        if n != sum(wf.loader.class_lengths.values()) or not all(
                math.isfinite(float(v)) for m in summary.values() for v in m.values()):
            fail(f"{label}: epoch saw {n} samples or non-finite metrics: {summary}")
        if data_dir and wf.model.output_shape != (len(TREE_CLASSES),):
            fail(f"{label}: head {wf.model.output_shape}, want {len(TREE_CLASSES)} classes")
        rates[label] = n / secs
        print(f"{label}: one epoch on the card (first, synthetic data unless said) "
              f"{secs:.3f} s, {n:.0f} images (train and eval), {n / secs:.1f} images/sec: "
              + json.dumps(summary))
    return {"mnist_ae_step_ms": med, "rates": rates}



# -- the host loop around the step: prefetch, pinned copies, snapshots --------
HOST_LOOP_CHECKED = 2  # epochs whose every batch is summed on both sides
HOST_LOOP_EPOCHS = 10  # epochs a timed window: 40 train and 10 eval steps
# the thread on the small models: epochs a window, at depth 0 and 2 in turns
THREAD_COST_EPOCHS = {"kohonen": 1, "mnist_rbm": 1, "mnist": 8, "cifar": 4}


def _window(torch, wf, epochs):
    """``epochs`` epochs of ``wf.run_epoch()`` after the attribution window
    is reset: the window's seconds, the mean (ms, the series' sum over its
    count in the window) of the host loop's histograms, and the
    attribution.  Series the loop did not observe (the serial loop has no
    fetch, enqueue or wait) are None."""
    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.observability import pipeline

    pipeline.reset_window()
    t0 = time.perf_counter()
    for _ in range(epochs):
        wf.run_epoch()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fams = obs.get_registry().metrics()

    def mean_ms(name, *labels):
        child = fams[name].children().get(labels) if name in fams else None
        return child.sum / child.count * 1e3 if child is not None and child.count else None

    stages = (pipeline.STAGE_FETCH, pipeline.STAGE_H2D, pipeline.STAGE_ENQUEUE)
    return {
        "seconds": secs,
        "step_wall_ms": mean_ms(pipeline.STEP_WALL_METRIC),
        "dispatch_train_ms": mean_ms(pipeline.PHASE_METRIC, "dispatch/train"),
        "wait_ms": mean_ms(pipeline.WAIT_METRIC),
        **{f"{st}_ms": mean_ms(pipeline.STAGE_METRIC, st) for st in stages},
        "attribution": pipeline.PipelineAttribution.from_registry().attribution(),
    }


def _ms(v):
    return "-" if v is None else f"{v:.3f}"


def _pinned_copy_ms(torch, shape, reps=20):
    """Median ms (CUDA events) of one ``non_blocking`` copy of a u8 array
    of ``shape`` from pinned memory to the card, and of the same copy from
    pageable memory, in turns."""
    import numpy as np

    host = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    src = {"pinned": torch.from_numpy(host).pin_memory(), "pageable": torch.from_numpy(host)}
    times = {k: [] for k in src}
    for _ in range(reps + 2):
        for k, t in src.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = t.to("cuda", non_blocking=True)
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
            if not torch.equal(out[0].cpu(), t[0]):
                fail(f"host loop: the {k} copy changed the batch")
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def phase_host_loop(torch, lrn_kernel, alexnet, prng, troot, data_dir, serial, smi):
    """Phase 20: AlexNet from phase 17's packed files through the
    workflow's own host loop: the prefetch thread (depth 2).  One epoch
    with the LRN counters set to 0 just before and read just after; two
    epochs whose every batch's int64 sum on the card is held against the
    loader's on the host; timed windows of the thread and of the serial
    loop (``prefetch_batches=0``) in turns, read through the registry's
    series; one batch's copy from pinned and from pageable memory; the
    attribution; a snapshot and an exact resume; the Prometheus text."""
    import tempfile

    import numpy as np

    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.workflow import snapshotter as snap_lib

    def build(**kw):
        saved = troot.to_dict()
        try:
            troot.alexnet.loader.update({"data_dir": data_dir})
            prng.seed_all(1234)
            return alexnet.build_workflow(device="cuda", **kw)
        finally:
            troot.clear()
            troot.update(saved)

    torch.backends.cudnn.benchmark = True
    wf = build()
    if wf.prefetch_batches != 2:
        fail(f"host loop: prefetch_batches {wf.prefetch_batches}, want the default 2")
    wf.initialize()
    loader = wf.loader
    n_train, n_eval = loader.n_minibatches("train"), loader.n_minibatches("valid")
    # every batch of the checked epochs: its sum on the host as the loader
    # made it (the producer thread), and on the card as the step received it
    host_sums, card_sums = [], []
    fill, train_step, eval_step = loader.fill, wf.train_step, wf.eval_step

    def fill_spy(indices, split):
        mb = fill(indices, split)
        host_sums.append(int(mb.data.sum(dtype=np.int64)))
        return mb

    def train_spy(x, y, mask, *args):
        card_sums.append(x.sum(dtype=torch.int64))
        return train_step(x, y, mask, *args)

    def eval_spy(x, y, mask, *args):
        card_sums.append(x.sum(dtype=torch.int64))
        return eval_step(x, y, mask, *args)

    loader.fill, wf.train_step, wf.eval_step = fill_spy, train_spy, eval_spy
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    verdict = wf.run_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    want = {"lrn_fwd": 2 * (n_train + n_eval), "lrn_bwd": 2 * n_train}
    summary = verdict["summary"]
    print(f"host loop: epoch 1 through the prefetch thread {epoch_s:.2f} s: {json.dumps(summary)}")
    print(f"host loop: launches {launches}, want {want} (phase 18's counts)")
    if launches != want:
        fail(f"host loop: LRN launch counts {launches} != {want}")
    for split, n in DISK_SPLITS.items():
        m = summary.get(split)
        if m is None or m["n_samples"] != n or not all(math.isfinite(float(v))
                                                        for v in m.values()):
            fail(f"host loop: {split} saw {m}, want {n} samples and finite metrics")
    for _ in range(HOST_LOOP_CHECKED - 1):
        wf.run_epoch()
    loader.fill, wf.train_step, wf.eval_step = fill, train_step, eval_step
    got = [int(v) for v in card_sums]
    bad = [i for i, (a, b) in enumerate(zip(got, host_sums)) if a != b]
    n_items = HOST_LOOP_CHECKED * (n_train + n_eval)
    print(f"host loop: {len(got)} batches of {HOST_LOOP_CHECKED} epochs checked on the card "
          f"against the loader's int64 sums ({len(host_sums)} filled): {len(bad)} differ")
    if len(got) != n_items or len(host_sums) != n_items or bad:
        fail(f"host loop: batches changed on their way to the step (first at {bad[:3]})")

    # the timed windows: the thread, the serial loop, the serial loop, the thread
    ser = build(prefetch_batches=0)
    ser.initialize()
    ser.run_epoch()
    rounds = {"thread": [], "serial": []}
    for kind in ("thread", "serial", "serial", "thread"):
        rounds[kind].append(_window(torch, wf if kind == "thread" else ser, HOST_LOOP_EPOCHS))
    win, ser_win = rounds["thread"][-1], rounds["serial"][-1]
    att = win["attribution"]
    epoch_images = HOST_LOOP_EPOCHS * sum(DISK_SPLITS.values())
    rates = {k: [epoch_images / w["seconds"] for w in ws] for k, ws in rounds.items()}
    copy = _pinned_copy_ms(torch, (CROP_BATCH, CROP, CROP, 3))
    batch_bytes = CROP_BATCH * CROP * CROP * 3
    res = {
        "images_per_s": rates["thread"],
        "serial_images_per_s": rates["serial"],
        **{k: win[k] for k in ("step_wall_ms", "dispatch_train_ms", "wait_ms", "fetch_ms",
                               "h2d_ms", "enqueue_ms")},
        "serial_step_wall_ms": ser_win["step_wall_ms"],
        "serial_dispatch_train_ms": ser_win["dispatch_train_ms"],
        "serial_h2d_ms": ser_win["h2d_ms"],
        "pinned_copy_ms": copy["pinned"],
        "pinned_copy_gb_per_s": batch_bytes / copy["pinned"] / 1e6,
        "pageable_copy_ms": copy["pageable"],
        "verdict": att["verdict"],
        "fractions": att["fractions"],
        "serial_verdict": ser_win["attribution"]["verdict"],
    }
    print(f"host loop: {HOST_LOOP_EPOCHS} epochs a window ({epoch_images} images, train and "
          f"eval, the epoch ends and the final sync included), run_epoch through the prefetch "
          f"thread (batch {CROP_BATCH}, bf16, depth 2, pinned copies) "
          f"{', '.join(f'{r:.1f}' for r in rates['thread'])} images/sec in its two windows, "
          f"beside the serial run_epoch (prefetch_batches=0) "
          f"{', '.join(f'{r:.1f}' for r in rates['serial'])} and phase 18's split "
          f"{serial['total']:.2f} ms a step (fill {serial['fill']:.2f} + pageable H2D "
          f"{serial['h2d']:.2f} + synchronized step {serial['step']:.2f}; "
          f"{serial['images_per_s']:.1f} images/sec) in this run; {smi}")
    print(f"host loop: per-step means of the last thread window (ms, the registry's sum over "
          f"count): step wall {_ms(win['step_wall_ms'])}, dispatch/train "
          f"{_ms(win['dispatch_train_ms'])}, consumer wait {_ms(win['wait_ms'])}; producer "
          f"stages fetch {_ms(win['fetch_ms'])}, h2d (the copy into pinned memory) "
          f"{_ms(win['h2d_ms'])}, enqueue {_ms(win['enqueue_ms'])}; serial: step wall "
          f"{_ms(ser_win['step_wall_ms'])}, dispatch/train {_ms(ser_win['dispatch_train_ms'])}, "
          f"h2d (pageable, synchronous) {_ms(ser_win['h2d_ms'])}; one batch's copy to the card "
          f"(CUDA events) from pinned memory {copy['pinned']:.3f} ms "
          f"({res['pinned_copy_gb_per_s']:.2f} GB/s), from pageable {copy['pageable']:.3f} ms; "
          f"{smi}")
    print(f"host loop: attribution {att['verdict']} ({att['confidence']}), fractions "
          f"{json.dumps(att['fractions'])} (serial: {res['serial_verdict']}, "
          f"{json.dumps(ser_win['attribution']['fractions'])})")

    # snapshot and exact resume
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        saver = build(snapshot_dir=tmp)
        saver.initialize()
        save_s = []
        save = saver.snapshotter.save

        def timed_save(*args, **kw):
            t = time.perf_counter()
            try:
                return save(*args, **kw)
            finally:
                save_s.append(time.perf_counter() - t)

        saver.snapshotter.save = timed_save
        saver.run_epoch()
        path = saver.snapshotter.best_path
        if len(save_s) != 1 or not snap_lib.is_valid_snapshot(path):
            fail(f"host loop: the epoch wrote {len(save_s)} snapshots, want one valid 'best'")
        mb = os.path.getsize(path) / 1e6
        t = time.perf_counter()
        snap_lib.load_snapshot(path)
        load_s = time.perf_counter() - t
        want_eval = saver.evaluate("valid")
        resumed = build()
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        got_eval = resumed.evaluate("valid")
    torch.backends.cudnn.deterministic = False
    rel = abs(got_eval["loss"] - want_eval["loss"]) / max(abs(want_eval["loss"]), 1e-30)
    res.update(snapshot_mb=mb, save_ms=save_s[0] * 1e3, load_ms=load_s * 1e3,
               resume_ms=resume_s * 1e3, resume_loss_rel=rel)
    print(f"host loop: snapshot 'best' of epoch 1 {mb:.1f} MB (gzip) saved in "
          f"{res['save_ms']:.0f} ms; load_snapshot {res['load_ms']:.0f} ms, initialize(snapshot=) "
          f"on the card {res['resume_ms']:.0f} ms; evaluate('valid') saved {json.dumps(want_eval)} "
          f"vs resumed {json.dumps(got_eval)}: loss rel diff {rel:.3e} (limit 1e-6); {smi}")
    if got_eval["n_err"] != want_eval["n_err"] or not rel <= 1e-6:
        fail("host loop: the resumed workflow does not evaluate as the saved one")

    prom = obs.prometheus_text()
    out = os.path.join(WORK_DIR, "metrics.prom")
    with open(out, "w") as f:
        f.write(prom)
    families = sorted(obs.get_registry().metrics())
    print(f"host loop: {out} {len(prom.encode())} bytes, {len(families)} families: "
          + ", ".join(families))
    return launches, res


def _bare_loop_seconds(torch, wf, epochs, depth):
    """``epochs`` epochs of the loader's batches through ``prefetch`` (no
    transform: the producer only fills, in numpy) or in series (depth 0),
    the consumer copying each batch from pageable memory and calling the
    workflow's public steps, one fetch a split an epoch: the thread's own
    cost, without the workflow's staging and telemetry.  Seconds."""
    from znicz_tpu_torch.loader.prefetch import prefetch

    labels = wf.loss_function == "softmax"
    t0 = time.perf_counter()
    for _ in range(epochs):
        accs = {}
        batches = wf.loader.epoch()
        for split, mb in (prefetch(batches, depth) if depth else batches):
            x = torch.as_tensor(mb.data, device=wf.device)
            y = torch.as_tensor(mb.labels, device=wf.device) if labels else x
            mask = torch.as_tensor(mb.mask, device=wf.device)
            step = wf.train_step if split == "train" else wf.eval_step
            accs[split] = step(x, y, mask, acc=accs.get(split))
        for acc in accs.values():
            acc.cpu()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_thread_cost(torch, models, troot, prng, smi):
    """Phase 20, continued: what the prefetch thread (the default) costs
    the host-bound models at their phases' sizes (the SOM and the RBM on
    MNIST's 60,000 / 10,000, MNIST and CIFAR-10): ``run_epoch`` of two
    workflows from one seed, ``prefetch_batches`` 0 and 2, one warm-up
    epoch each, then windows of ``THREAD_COST_EPOCHS`` epochs at depth 0,
    2, 2, 0, and the same for the bare loop (``_bare_loop_seconds``); ms a
    step and the per-step means of each window's series; beside them the
    bare hand-off of one item through ``prefetch`` with no work on either
    side."""
    from znicz_tpu_torch.loader.prefetch import prefetch

    for name in ("kohonen", "mnist_rbm"):
        getattr(troot, name).update({"loader": {"n_train": MNIST_SPLITS["train"],
                                                "n_test": MNIST_SPLITS["test"]}})
    n = 20000
    t0 = time.perf_counter()
    for _ in prefetch(iter(range(n)), 2):
        pass
    out = {"handoff_us": (time.perf_counter() - t0) / n * 1e6}
    print(f"thread cost: the bare hand-off of one item through prefetch (depth 2, no work) "
          f"{out['handoff_us']:.2f} us, mean of {n}")
    for name, epochs in THREAD_COST_EPOCHS.items():
        wfs = {}
        for depth in (0, 2):
            prng.seed_all(1234)
            wfs[depth] = models[name].build_workflow(device="cuda", prefetch_batches=depth)
            wfs[depth].initialize()
            wfs[depth].run_epoch()
        wins, bare = {0: [], 2: []}, {0: [], 2: []}
        for depth in (0, 2, 2, 0):
            wins[depth].append(_window(torch, wfs[depth], epochs))
        for depth in (0, 2, 2, 0):
            bare[depth].append(_bare_loop_seconds(torch, wfs[0], epochs, depth))
        loader = wfs[0].loader
        steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
        per_step = {d: [w["seconds"] / steps * 1e3 for w in ws] for d, ws in wins.items()}
        bare_step = {d: [v / steps * 1e3 for v in vs] for d, vs in bare.items()}
        means = {d: {k: statistics.mean(w[k] for w in ws) if ws[0][k] is not None else None
                     for k in ("step_wall_ms", "dispatch_train_ms", "wait_ms", "fetch_ms",
                               "h2d_ms")}
                 for d, ws in wins.items()}
        out[name] = {"steps": steps, "ms_a_step": per_step, "bare_ms_a_step": bare_step,
                     "means": means}
        print(f"thread cost: {name} ({steps} steps a window, train and eval) run_epoch ms a "
              f"step at depth 0 {[round(v, 4) for v in per_step[0]]}, at depth 2 "
              f"{[round(v, 4) for v in per_step[2]]}; the bare loop at depth 0 "
              f"{[round(v, 4) for v in bare_step[0]]}, at depth 2 "
              f"{[round(v, 4) for v in bare_step[2]]}; run_epoch's per-step means (ms) at "
              "depth 0 / 2: "
              + "; ".join(f"{k[:-3]} {_ms(means[0][k])} / {_ms(means[2][k])}"
                          for k in means[0])
              + f"; {smi}")
    return out


# -- self-healing training (phase 21) -------------------------------------------

HEAL_EPOCHS = 3  # the golden AlexNet runs: 12 train and 3 eval steps
HEAL_POISON = 5  # the train batch (in fill order) filled with NaN once: epoch 1's second
HEAL_STOP = 6  # the train step whose lr asks for the stop: mid epoch 1
# epochs a window of the watch's cost: AlexNet 300 steps (~3 s), the others 400-1,400
WATCH_EPOCHS = {"alexnet": 60, "kohonen": 2, "mnist_rbm": 2, "mnist": 16}
WATCH_TURNS = (True, False, False, True) * 2 + (True, False)  # the watch on / off a window
TRANSPORT_CALLS = 2000  # calls of each watch transport, in turns
# deferred against sync: a stop driven by fail_iterations after ~20 epochs (~100 steps)
DEFERRED_DECISION = {"max_epochs": 40, "fail_iterations": 20}
DEFERRED_RUNS = ("sync", "deferred", "deferred", "sync", "sync", "deferred")
RESUME_EPOCHS = 3  # SOM, RBM and LM: uninterrupted against 1 + snapshot + 2 resumed
LM_RESUME = dict(LM_MID, n_layers=2)  # the mid LM's width at a smaller depth
LM_RESUME_N = 48  # 3 train steps an epoch at batch 16, T 2048


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _differ(torch, a, b):
    """(tensors of ``a`` not bitwise equal to ``b``'s, the largest |diff|)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        fail(f"states of {len(la)} and {len(lb)} tensors compared")
    bad = [(x, y) for x, y in zip(la, lb) if not torch.equal(x, y)]
    worst = max((float((x.float() - y.float()).abs().max()) for x, y in bad), default=0.0)
    return len(bad), worst


def _sync_warnings(torch, wf):
    """One ``run_epoch`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    the synchronizing calls it made (count, distinct first lines)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            wf.run_epoch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's one-time "prototype feature" notice is not a call
    msgs = [str(w.message).splitlines()[0][:100] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    return len(msgs), sorted(set(msgs))


def _spread(on, off):
    """The difference of two lists' means with its spread, the least and
    the largest difference of one element of each."""
    return (statistics.mean(on) - statistics.mean(off), min(on) - max(off), max(on) - min(off))


def _watch_parts(torch, wf, epochs):
    """One window of ``epochs`` epochs of ``wf`` (the watch on) with each
    part of the watch timed on the host: the norms (``tensor_norms`` or the
    unsupervised ``update_norms``, patched in their modules), the watch
    vector's stack, pinned copy and event (``_watch_vector``), the lagged
    read (``_feed_watch`` less the detector) and the detector
    (``observe_step``); µs a train step, the window's ms a step, the reads,
    the reads whose event had not completed, and the mean lag in train
    steps."""
    from znicz_tpu_torch.workflow import unsupervised as unsup_mod
    from znicz_tpu_torch.workflow import workflow as wf_mod

    secs = {"norms": 0.0, "vector": 0.0, "feed": 0.0, "detector": 0.0}
    counts = {"reads": 0, "waits": 0, "lag": 0}

    def timed(fn, key):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key] += time.perf_counter() - t
        return call

    feed = wf._feed_watch

    def counted_feed(step, watch, step_seconds=None):
        event = watch[1]
        counts["reads"] += 1
        counts["waits"] += int(event is not None and not event.query())
        counts["lag"] += wf.state.step - 1 - int(step)
        return feed(step, watch, step_seconds)

    patched = [(wf_mod, "tensor_norms"), (unsup_mod, "update_norms")]
    saved = [getattr(m, n) for m, n in patched]
    for m, n in patched:
        setattr(m, n, timed(getattr(m, n), "norms"))
    wf._watch_vector = timed(wf._watch_vector, "vector")
    wf._feed_watch = timed(counted_feed, "feed")
    wf.anomaly.observe_step = timed(wf.anomaly.observe_step, "detector")
    try:
        loader = wf.loader
        steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
        win = _window(torch, wf, epochs)
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
        for name in ("_watch_vector", "_feed_watch"):
            del wf.__dict__[name]
        del wf.anomaly.__dict__["observe_step"]
    n = max(counts["reads"], 1)
    us = {k: v / n * 1e6 for k, v in secs.items()}
    us["read"] = us.pop("feed") - us["detector"]
    return {"us_a_train_step": us, "ms_a_step": win["seconds"] / steps * 1e3,
            "reads": counts["reads"], "waits": counts["waits"],
            "lag_steps_mean": counts["lag"] / n}


def _watch_transport(torch, smi):
    """The watch vector's way to the host, host µs a call over
    ``TRANSPORT_CALLS`` calls each, in turns: the stack of a loss and 16
    norms (AlexNet's tensors), the shipped copy into a fresh pinned tensor
    with a fresh event (``_fetch_async``), and a copy into a reused ring of
    pinned rows with reused events."""
    from znicz_tpu_torch.workflow.workflow import WATCH_LAG, _fetch_async

    loss = torch.rand((), device="cuda")
    norms = list(torch.rand(16, device="cuda").unbind())
    vec = torch.stack([loss, *norms])
    ring = torch.empty((WATCH_LAG + 2, vec.numel()), dtype=torch.float32, pin_memory=True)
    events = [torch.cuda.Event() for _ in range(len(ring))]

    def stack(i):
        torch.stack([loss, *norms])

    def fresh(i):
        _fetch_async([vec])

    def reused(i):
        j = i % len(ring)
        ring[j].copy_(vec, non_blocking=True)
        events[j].record()

    us = {f.__name__: [] for f in (stack, fresh, reused)}
    for f in (stack, fresh, reused, reused, fresh, stack):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(TRANSPORT_CALLS):
            f(i)
        us[f.__name__].append((time.perf_counter() - t) / TRANSPORT_CALLS * 1e6)
        torch.cuda.synchronize()
    print(f"self-healing: the watch vector's transport, host µs a call ({TRANSPORT_CALLS} "
          f"calls a run, two runs each): stack of 17 {[round(v, 2) for v in us['stack']]}; "
          f"copy into a fresh pinned tensor + fresh event {[round(v, 2) for v in us['fresh']]}; "
          f"copy into a reused pinned ring + reused event {[round(v, 2) for v in us['reused']]}; "
          f"{smi}")
    return us


def _watch_cost(torch, make, epochs, label, smi):
    """``run_epoch`` of two workflows from one seed, the anomaly watch on
    (the default) and off, one warm-up epoch each, then windows of
    ``epochs`` epochs on and off in ``WATCH_TURNS``: ms a step over each whole
    window, the difference of the means with its spread, and the per-step
    means of ``dispatch/train`` and the step wall; then one window with the
    watch's parts timed (:func:`_watch_parts`), and one epoch of each under
    the sync debug mode, where the watch may add no synchronizing call."""
    wfs = {}
    for on in (True, False):
        wfs[on] = make()
        if not on:
            wfs[on].anomaly = None  # what anomaly=False builds
        wfs[on].initialize()
        wfs[on].run_epoch()
    wins = {True: [], False: []}
    for on in WATCH_TURNS:
        wins[on].append(_window(torch, wfs[on], epochs))
    loader = wfs[True].loader
    steps = epochs * sum(loader.n_minibatches(s) for s in loader.class_lengths)
    per_step = {on: [w["seconds"] / steps * 1e3 for w in ws] for on, ws in wins.items()}
    means = {on: {k: statistics.mean(w[k] for w in ws) for k in ("step_wall_ms",
                                                                   "dispatch_train_ms")}
             for on, ws in wins.items()}
    diff = _spread(per_step[True], per_step[False])
    parts = _watch_parts(torch, wfs[True], epochs)
    syncs = {on: _sync_warnings(torch, wfs[on]) for on in (True, False)}
    out = {"steps": steps, "ms_a_step": {"on": per_step[True], "off": per_step[False]},
           "diff_ms": diff, "means_on": means[True], "means_off": means[False],
           "parts": parts, "sync_calls_an_epoch": {"on": syncs[True][0], "off": syncs[False][0]}}
    us = parts["us_a_train_step"]
    print(f"self-healing: watch cost, {label} ({steps} steps a window, train and eval): "
          f"run_epoch ms a step with the watch {[round(v, 4) for v in per_step[True]]}, "
          f"without {[round(v, 4) for v in per_step[False]]}: on - off {diff[0]:+.4f} ms "
          f"(spread {diff[1]:+.4f} .. {diff[2]:+.4f}); per-step means (ms) on / off: "
          f"dispatch/train {_ms(means[True]['dispatch_train_ms'])} / "
          f"{_ms(means[False]['dispatch_train_ms'])}, step wall "
          f"{_ms(means[True]['step_wall_ms'])} / {_ms(means[False]['step_wall_ms'])}; "
          f"the watch's parts, host µs a train step (a timed window of "
          f"{parts['ms_a_step']:.4f} ms a step): norms {us['norms']:.1f}, stack + pinned copy "
          f"+ event {us['vector']:.1f}, lagged read {us['read']:.1f}, detector "
          f"{us['detector']:.1f}; the detector read {parts['reads']} vectors "
          f"{parts['lag_steps_mean']:.3f} train steps late on average ({parts['waits']} "
          f"found their copy incomplete); synchronizing calls in one epoch under the sync "
          f"debug mode: {syncs[True][0]} with the watch, {syncs[False][0]} without "
          f"({syncs[True][1]}); {smi}")
    if syncs[True][0] > syncs[False][0]:
        fail(f"self-healing: the watch synchronizes the host with the card ({label}: "
             f"{syncs[True][1]})")
    return out


def _poisoned_rollback(torch, lrn_kernel, build, ref, cfg, smi):
    """AlexNet with a loader whose ``fill`` returns NaN data for one train
    batch, once, under ``RecoveryPolicy(perturb=False, lr_backoff=1.0)``:
    the detector raises ``non_finite_loss`` within 3 steps, the rollback
    restores the epoch-start buffer bitwise and the run ends bitwise equal
    to ``ref``, the unfaulted run of the same seed.  The LRN counters are
    set to 0 just before the run and read just after."""
    import numpy as np

    from znicz_tpu_torch import observability as obs
    from znicz_tpu_torch.observability import pipeline
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy

    pol = RecoveryPolicy(perturb=False, lr_backoff=1.0)
    wf = build(recovery=pol, **cfg)
    fill, train_step, eval_step = wf.loader.fill, wf.train_step, wf.eval_step
    seen = {"fills": 0, "poisoned": False, "train": 0, "eval": 0}

    def poisoned(idx, split):
        mb = fill(idx, split)
        if split == "train":
            if seen["fills"] == HEAL_POISON and not seen["poisoned"]:
                seen["poisoned"] = True
                mb = mb._replace(data=np.full(mb.data.shape, np.nan, np.float32))
            seen["fills"] += 1
        return mb

    def train_spy(*args, **kw):
        seen["train"] += 1
        return train_step(*args, **kw)

    def eval_spy(*args, **kw):
        seen["eval"] += 1
        return eval_step(*args, **kw)

    retain, rollback = wf._retain_epoch_start, wf._execute_rollback
    clone_ms, rb = [], {}

    def timed_retain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = retain()
        torch.cuda.synchronize()
        clone_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_rollback(reason):
        buf = wf._epoch_start[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        rollback(reason)
        torch.cuda.synchronize()
        rb["ms"] = (time.perf_counter() - t) * 1e3
        rb["differ"] = _differ(torch, list(buf[:2]), [wf.state.params, wf.state.velocity])
        rb["steps"] = (wf.state.step, int(buf[2]))
        rb["mb"] = sum(t.numel() * t.element_size() for t in _leaves(list(buf[:2]))) / 1e6

    wf.loader.fill, wf.train_step, wf.eval_step = poisoned, train_spy, eval_spy
    wf._retain_epoch_start, wf._execute_rollback = timed_retain, timed_rollback
    fam = obs.get_registry().metrics().get(pipeline.ROLLBACKS_METRIC)
    before = fam.children().get(("non_finite_loss",)) if fam is not None else None
    before = before.value if before is not None else 0.0
    wf.initialize()
    lrn_kernel.lrn_forward.launches = 0
    lrn_kernel.lrn_backward.launches = 0
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_kernel.lrn_forward.launches,
                "lrn_bwd": lrn_kernel.lrn_backward.launches}
    after = obs.get_registry().metrics()[pipeline.ROLLBACKS_METRIC].children()[
        ("non_finite_loss",)].value
    ev = pol.events[0] if pol.events else {}
    lag = ev.get("step", -1) - HEAL_POISON
    differ = _differ(torch, wf.state.params, ref.state.params)
    same_history = wf.decision.history == ref.decision.history
    want = {"lrn_fwd": 2 * (seen["train"] + seen["eval"]), "lrn_bwd": 2 * seen["train"]}
    res = {"rollback_ms": rb.get("ms"), "clone_ms": clone_ms, "clone_mb": rb.get("mb"),
           "detected_steps_after": lag, "events": [{k: v for k, v in e.items() if k != "unix"}
                                                   for e in pol.events],
           "counter_delta": after - before, "final_differ": differ, "run_s": run_s,
           "launches": launches, "steps": {k: seen[k] for k in ("train", "eval")}}
    print(f"self-healing: poisoned batch (train batch {HEAL_POISON}, NaN data once): "
          f"{json.dumps(res['events'])}; the detector raised {lag} steps after the poisoned "
          f"step; znicz_train_rollbacks_total{{reason=\"non_finite_loss\"}} +{after - before:g}; "
          f"rollback {rb.get('ms', float('nan')):.2f} ms; epoch-start clones "
          f"{[round(v, 3) for v in clone_ms]} ms of {rb.get('mb', float('nan')):.1f} MB "
          f"(params and momentum); restored against the buffer {rb.get('differ')} "
          f"(tensors that differ, max |diff|); the run ({seen['train']} train and "
          f"{seen['eval']} eval steps, {run_s:.2f} s) against the unfaulted one: {differ}, "
          f"history {'equal' if same_history else 'differs'}; LRN launches {launches}, "
          f"want {want}; {smi}")
    if not seen["poisoned"] or pol.rollbacks_used != 1 or ev.get("reason") != "non_finite_loss":
        fail(f"self-healing: the poisoned batch was not rolled back once: {pol.events}")
    if ev.get("source") != "epoch-start buffer" or not 0 < lag <= 3:
        fail(f"self-healing: rollback from {ev.get('source')}, {lag} steps after the poison")
    if rb["differ"] != (0, 0.0) or rb["steps"][0] != rb["steps"][1]:
        fail(f"self-healing: the rollback did not restore the buffer bitwise: {rb}")
    if after - before != 1:
        fail(f"self-healing: the rollback counter moved by {after - before}")
    if differ != (0, 0.0) or not same_history:
        fail(f"self-healing: the recovered run differs from the unfaulted one: {differ}")
    if launches != want:
        fail(f"self-healing: LRN launches {launches} != {want}")
    return res


def _graceful_stop(torch, build, ref, cfg, smi):
    """``request_stop()`` mid-epoch with emergency snapshots on: the
    ``TrainingPreempted`` path writes one snapshot (its MB and seconds), and
    a fresh workflow resumed from it ends bitwise equal to ``ref``."""
    import tempfile
    from pathlib import Path

    from znicz_tpu_torch.workflow.recovery import TrainingPreempted

    work = Path(__file__).resolve().parent / WORK_DIR
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        # save_best off: the emergency snapshot is the run's only one
        wf = build(snapshot_dir=tmp, snapshot_config={"save_best": False}, **cfg)
        wf.enable_emergency_snapshots()
        policy, save, save_s = wf.lr_policy, wf.snapshotter.save, []

        def stop_at(base, step):
            if step == HEAL_STOP:
                wf.request_stop()
            return policy(base, step) if policy else base

        def timed_save(*args, **kw):
            t = time.perf_counter()
            try:
                return save(*args, **kw)
            finally:
                save_s.append(time.perf_counter() - t)

        wf.lr_policy, wf.snapshotter.save = stop_at, timed_save
        wf.initialize()
        path = None
        try:
            wf.run()
        except TrainingPreempted as exc:
            path = exc.snapshot_path
        stopped_at = wf.state.step
        if path is None or not os.path.exists(path) or len(save_s) != 1:
            fail(f"self-healing: the stop wrote {len(save_s)} snapshots ({path}), want one")
        mb = os.path.getsize(path) / 1e6
        del wf
        resumed = build(**cfg)
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    epoch = resumed.decision.epoch
    resumed.run()
    torch.cuda.synchronize()
    differ = _differ(torch, resumed.state.params, ref.state.params)
    same_history = resumed.decision.history == ref.decision.history
    res = {"snapshot_mb": mb, "save_s": save_s[0], "resume_s": load_s, "stopped_at_step":
           stopped_at, "resumed_epoch": epoch, "final_differ": differ}
    print(f"self-healing: request_stop() at train step {HEAL_STOP} (mid epoch 1): stopped "
          f"before step {stopped_at}; emergency snapshot {mb:.1f} MB (gzip) written in "
          f"{save_s[0]:.2f} s; a fresh workflow resumed from it in {load_s:.2f} s at epoch "
          f"{epoch} and ran to the end: against the uninterrupted run {differ}, history "
          f"{'equal' if same_history else 'differs'}; {smi}")
    if stopped_at != HEAL_STOP + 1 or epoch != 1:
        fail(f"self-healing: stopped before step {stopped_at}, resumed at epoch {epoch}")
    if differ != (0, 0.0) or not same_history:
        fail(f"self-healing: the resumed run differs from the uninterrupted one: {differ}")
    return res


def _deferred_against_sync(torch, build, smi):
    """``run()`` in sync and deferred mode in turns (``DEFERRED_RUNS``),
    each a fresh workflow from one seed under ``DEFERRED_DECISION``:
    images/sec over each whole run (train and eval, the epoch ends
    included), the difference of the modes' means with its spread, and the
    epoch each stopped at, which must be the same; the first deferred run's
    params and history bitwise the first sync run's."""
    runs, finals = {"sync": [], "deferred": []}, {}
    for mode in DEFERRED_RUNS:
        wf = build(epoch_sync=mode, decision_config=DEFERRED_DECISION)
        wf.initialize()
        images = sum(wf.loader.class_lengths.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec = wf.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        runs[mode].append({"seconds": secs, "epochs": dec.epoch,
                           "images_per_s": dec.epoch * images / secs})
        finals.setdefault(mode, (wf.state.params, dec.history))
        del wf
    stops = {r["epochs"] for rs in runs.values() for r in rs}
    differ = _differ(torch, finals["sync"][0], finals["deferred"][0])
    rate = {m: [r["images_per_s"] for r in rs] for m, rs in runs.items()}
    diff = _spread(rate["deferred"], rate["sync"])
    pct = [100 * d / statistics.mean(rate["sync"]) for d in diff]
    print(f"self-healing: deferred against sync, run() under {DEFERRED_DECISION}: images/sec "
          f"sync {[round(v, 1) for v in rate['sync']]}, deferred "
          f"{[round(v, 1) for v in rate['deferred']]}: deferred - sync {diff[0]:+.1f} "
          f"({pct[0]:+.2f}%, spread {pct[1]:+.2f}% .. {pct[2]:+.2f}%); seconds a run "
          f"{[round(r['seconds'], 3) for r in runs['sync']]} / "
          f"{[round(r['seconds'], 3) for r in runs['deferred']]}; stopped after "
          f"{[r['epochs'] for r in runs['sync']]} / {[r['epochs'] for r in runs['deferred']]} "
          f"epochs; deferred params against sync {differ}; {smi}")
    if len(stops) != 1 or differ != (0, 0.0) or finals["sync"][1] != finals["deferred"][1]:
        fail(f"self-healing: deferred and sync runs disagree: stops {stops}, params {differ}")
    return {"runs": runs, "diff_pct": pct}


def _resume_golden(torch, label, make, smi):
    """``RESUME_EPOCHS`` uninterrupted epochs against one epoch, its
    snapshot (uncompressed), a fresh workflow resumed from it and the rest:
    the params and the history bitwise equal."""
    import tempfile
    from pathlib import Path

    from znicz_tpu_torch.workflow.snapshotter import Snapshotter

    ref = make(None)
    ref.initialize()
    for _ in range(RESUME_EPOCHS):
        ref.run_epoch()
    work = Path(__file__).resolve().parent / WORK_DIR
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        snap = Snapshotter(tmp, label, interval=1, compress=False, save_best=False)
        saver = make(snap)
        saver.initialize()
        saver.run_epoch()
        path = snap._path("epoch0")
        mb = os.path.getsize(path) / 1e6
        resumed = make(None)
        t = time.perf_counter()
        resumed.initialize(snapshot=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    for _ in range(RESUME_EPOCHS - 1):
        resumed.run_epoch()
    torch.cuda.synchronize()
    differ = _differ(torch, resumed.state.params, ref.state.params)
    same = resumed.decision.history == ref.decision.history
    print(f"self-healing: {label} resume: snapshot of epoch 0 {mb:.1f} MB, resumed in "
          f"{load_s:.2f} s at step {saver.state.step}, {RESUME_EPOCHS - 1} more epochs against "
          f"{RESUME_EPOCHS} uninterrupted: {differ} (tensors that differ, max |diff|), history "
          f"{'equal' if same else 'differs'}; {smi}")
    if differ != (0, 0.0) or not same or resumed.state.step != ref.state.step:
        fail(f"self-healing: the resumed {label} differs from its uninterrupted run: {differ}")
    return {"snapshot_mb": mb, "resume_s": load_s}


def phase_self_healing(torch, lrn_kernel, alexnet, models, prng, smi):
    """Phase 21: self-healing training.  The anomaly watch's cost on AlexNet
    (the synthetic stand-in at the published geometry, as phase 4) and on
    the SOM, the RBM and MNIST at depth 0; then, with cuDNN deterministic, a
    real poisoned batch rolled back, a graceful stop resumed, deferred
    against sync, and snapshots of the SOM, the RBM and the LM resumed."""
    import numpy as np

    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.nn.optimizer import HyperParams
    from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

    def build(**kw):
        prng.seed_all(1234)
        return alexnet.build_workflow(device="cuda", **kw)

    def model(name, **kw):
        def make():
            prng.seed_all(1234)
            return models[name].build_workflow(device="cuda", **kw)
        return make

    out = {"watch": {}}
    torch.backends.cudnn.benchmark = True
    out["watch"]["alexnet"] = _watch_cost(torch, build, WATCH_EPOCHS["alexnet"], "alexnet", smi)
    out["watch"]["transport_us"] = _watch_transport(torch, smi)
    for name in ("kohonen", "mnist_rbm", "mnist"):
        out["watch"][name] = _watch_cost(torch, model(name, prefetch_batches=0),
                                         WATCH_EPOCHS[name], name, smi)
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = {"decision_config": {"max_epochs": HEAL_EPOCHS}}
        ref = build(**cfg)
        ref.initialize()
        ref.run()
        torch.cuda.synchronize()
        out["rollback"] = _poisoned_rollback(torch, lrn_kernel, build, ref, cfg, smi)
        out["stop"] = _graceful_stop(torch, build, ref, cfg, smi)
        del ref
        out["deferred"] = _deferred_against_sync(torch, build, smi)

        def unsup(name):
            def make(snap):
                prng.seed_all(1234)
                return models[name].build_workflow(
                    device="cuda", snapshotter=snap,
                    decision_config={"max_epochs": RESUME_EPOCHS})
            return make

        tokens = np.random.default_rng(5).integers(
            0, LM_RESUME["vocab"], (LM_RESUME_N, LM_T)).astype(np.int32)

        def lm(snap):
            prng.seed_all(1234)
            loader = FullBatchLoader({"train": tokens, "test": tokens[:LM_B]},
                                     minibatch_size=LM_B)
            # lr 0.01: the default 0.1 diverges at this width (as in JAX)
            return TransformerLMWorkflow(
                loader, **LM_RESUME, attention="flash", max_epochs=RESUME_EPOCHS,
                hyper=HyperParams(learning_rate=0.01, gradient_moment=0.9),
                snapshotter=snap, device="cuda")

        out["resume"] = {name: _resume_golden(torch, name, make, smi) for name, make in (
            ("kohonen", unsup("kohonen")), ("mnist_rbm", unsup("mnist_rbm")), ("lm", lm))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    return out["rollback"]["launches"], out


SCAN_IMAGES = 12800  # bench.py's mnist_epoch: 100 train steps of 128
SCAN_BATCH = 128
SCAN_EPOCHS = 3  # the runs held bitwise: graph against step dispatch
SCAN_WINDOW_S = 2.0  # a timed window: whole epochs, at least this long
SCAN_TURNS = ("graph", "step", "step", "graph", "graph", "step")  # timed windows, in turns
SCAN_POOL = {"train": 1024, "valid": 128}  # AlexNet's pools: 8 train and 1 eval step
SCAN_POISON = 150  # the watch row the rollback runs poison: epoch 1's 51st train step
SCAN_LM_N = {"train": 48, "test": 16}  # 3 train steps and 1 eval step at batch 16
# each counted wrapper's one kernel a call, as the trace names it (a
# Kohonen call also launches scores_kernel and winners_kernel, an RBM call
# hidden_kernel and visible_kernel)
TRACE_NAMES = {"lrn_fwd": "lrn_fwd_kernel", "lrn_bwd": "halo_kernel|rows_kernel",
               "kohonen_accumulate": "accum_kernel", "rbm_cd": "stats_kernel",
               "flash_fwd": "fwd_mma_kernel|fwd_tf32_kernel",
               "flash_dq": "dq_mma_kernel|dq_tf32_kernel",
               "flash_dkv": "dkv_mma_kernel|dkv_tf32_kernel"}


def _mnist_u8(n, seed):
    import numpy as np

    gen = np.random.default_rng(seed)
    return (gen.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
            gen.integers(0, 10, n).astype(np.int32))


def _traced_launches(torch, prof, names):
    """Each of ``names``' kernel records in the trace of ``prof``: what the
    card launched, whether through a wrapper or from a graph's replay."""
    pats = {n: re.compile(r"(?:^|\s|::)(?:%s)\b" % TRACE_NAMES[n]) for n in names}
    got = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n, pat in pats.items():
                if pat.search(e.key):
                    got[n] += e.count
    return got


def _traced_epochs(torch, wf, epochs, names):
    """``epochs`` epochs of ``wf``: the first untraced (the graph
    dispatch's warm-up and captures), the rest under ``torch.profiler``
    with ``names``' kernel records counted (:func:`_traced_launches`; no
    trace when ``names`` is empty).  Returns the epochs' results, the
    first epoch's seconds and the traced counts."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    out = [wf.run_epoch()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not names:
        out += [wf.run_epoch() for _ in range(epochs - 1)]
        return out, first_s, {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out += [wf.run_epoch() for _ in range(epochs - 1)]
        torch.cuda.synchronize()
    return out, first_s, _traced_launches(torch, prof, names)


def _scan_runs(torch, prng, make, label, counters=(), epochs=SCAN_EPOCHS, deferred=False):
    """The graph dispatch (``epoch_dispatch="scan"`` on the card) and the
    step dispatch of ``make(dispatch)``, ``epochs`` epochs each from the
    same seed (the initial weights drawn after ``prng.seed_all``), the
    histories and the final state bitwise equal.  ``counters`` (``(name,
    wrapper, launches an epoch)``) are set to 0 just before each run and
    read just after: the step dispatch's must be exact; the graph
    dispatch's hold its warm-up and capture calls only, so the launches of
    the epochs after the first are read from their trace
    (:func:`_traced_epochs`) and must be exact in both dispatches.
    Returns ``{dispatch: workflow}`` and the graph dispatch's traced
    launches."""
    names = [name for name, _, _ in counters]
    wfs, first_s, traced = {}, {}, {}
    for dispatch in ("scan", "step"):
        prng.seed_all(3)
        wf = make(dispatch)
        wf.initialize(seed=3)
        if wf._use_epoch_scan() != (dispatch == "scan"):
            fail(f"{label}: epoch_dispatch={dispatch!r} took the other dispatch")
        for _, fn, _ in counters:
            fn.launches = 0
        _, first_s[dispatch], traced[dispatch] = _traced_epochs(torch, wf, epochs, names)
        if deferred:
            wf.sync_epoch()
        torch.cuda.synchronize()
        wrapped = {name: fn.launches for name, fn, _ in counters}
        want = {name: n * (epochs - 1) for name, _, n in counters}
        print(f"{label}: {dispatch} dispatch, {epochs} epochs: wrapper counts {wrapped}; "
              f"traced launches of epochs 2-{epochs} {traced[dispatch]}, want {want}")
        if traced[dispatch] != want:
            fail(f"{label}: {dispatch} dispatch's trace shows {traced[dispatch]} launches "
                 f"in epochs 2-{epochs}, want {want}")
        if dispatch == "step" and wrapped != {name: n * epochs for name, _, n in counters}:
            fail(f"{label}: the step dispatch's wrappers counted {wrapped} launches")
        if dispatch == "scan" and any(v == 0 for v in wrapped.values()):
            fail(f"{label}: the graph dispatch's capture went through no wrapper: {wrapped}")
        wfs[dispatch] = wf
    graph, step = wfs["scan"], wfs["step"]
    if not any(r.graph is not None for r in graph._splits.values()):
        fail(f"{label}: the scan dispatch captured no CUDA graph")
    n_bad, worst = _differ(torch, graph.state.params, step.state.params)
    same_hist = graph.decision.history == step.decision.history
    print(f"{label}: graph against step dispatch after {epochs} epochs: {n_bad} tensors differ "
          f"(largest |diff| {worst:.3e}), histories {'equal' if same_hist else 'DIFFER'}; "
          f"{len(graph._splits)} captured split steps; first epoch (with the capture) "
          f"{first_s['scan']:.2f} s, step dispatch {first_s['step']:.2f} s")
    if n_bad or not same_hist:
        fail(f"{label}: the graph dispatch is not bitwise the step dispatch")
    return wfs, traced["scan"]


def _scan_turns(torch, wfs, images, label, smi):
    """Images/sec of the two dispatches over windows of whole epochs, each
    at least ``SCAN_WINDOW_S`` long, in turns (``SCAN_TURNS``), after one
    epoch each as warm-up: the ratio of the means, and its spread from
    the slowest graph window over the fastest step window to the fastest
    over the slowest."""
    for wf in wfs.values():
        wf.run_epoch()
        wf.sync_epoch()
    rates = {"graph": [], "step": []}
    for turn in SCAN_TURNS:
        wf = wfs["scan" if turn == "graph" else "step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < SCAN_WINDOW_S:
            wf.run_epoch()
            n += 1
        wf.sync_epoch()
        torch.cuda.synchronize()
        rates[turn].append(images * n / (time.perf_counter() - t0))
    g, s = rates["graph"], rates["step"]
    ratio = statistics.mean(g) / statistics.mean(s)
    spread = (min(g) / max(s), max(g) / min(s))
    print(f"{label}: images/sec over windows of at least {SCAN_WINDOW_S} s in turns: graph "
          f"{', '.join(f'{r:.0f}' for r in g)}, step {', '.join(f'{r:.0f}' for r in s)} "
          f"(graph/step {ratio:.2f}x, {spread[0]:.2f}-{spread[1]:.2f}x over the windows); {smi}")
    return {"graph": g, "step": s, "speedup": ratio, "speedup_spread": list(spread)}


def _replay_profile(torch, wf, label, smi):
    """The captured train step of ``wf`` replayed over one split (``n``
    replays, no Python between them but the loop): the host µs to issue a
    replay, the device's µs a step between CUDA events around the split,
    then the kernels' device time a step under ``torch.profiler`` (CUPTI)
    and the device's idle share; "not measured" when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    run = next(r for (s, _), r in wf._splits.items() if s == "train")
    n = int(run.rows["x"].shape[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    wf._run_split("train", run, n)
    host_us = (time.perf_counter() - t0) / n * 1e6
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wf._run_split("train", run, n)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0) / n
    out = {"host_us_a_replay": host_us, "device_us_a_step": wall_us,
           "busy_us_a_step": busy_us or None,
           "idle_share": 1.0 - busy_us / wall_us if busy_us else None}
    idle = "not measured" if not busy_us else f"{out['idle_share']:.1%}"
    print(f"{label}: {n} replays of the captured train step: {host_us:.1f} µs of host time "
          f"to issue one, {wall_us:.1f} µs of device time a step (CUDA events), kernels busy "
          f"{busy_us:.1f} µs a step (profiler), idle {idle}; {smi}")
    return out


def _alexnet_resident(alexnet, loader, dispatch, n_classes, **kw):
    import copy

    from znicz_tpu_torch.workflow.standard import StandardWorkflow

    layers = copy.deepcopy(alexnet.DEFAULTS["layers"])
    layers[-1]["->"]["output_sample_shape"] = n_classes
    return StandardWorkflow(
        loader, layers, decision_config={"max_epochs": 10000},
        lr_policy=alexnet.DEFAULTS["lr_policy"], compute_dtype=alexnet.DEFAULTS["compute_dtype"],
        epoch_dispatch=dispatch, device="cuda", name=f"AlexNetResident-{dispatch}", **kw)


def _pool_crops_against_host(torch, imagenet_lib, native_lib, wf, label, smi):
    """One epoch of the resident ImageNet loader's payloads: the crops cut on
    the card from the workflow's pool against ``crop_gather_u8`` on the host
    from the packed files, bitwise; then the crop of one train batch timed
    on the card (CUDA events) beside its bound (each crop's bytes read once
    from the pool and written once)."""
    import numpy as np

    ld = wf.loader
    pool = wf._ctx["pool"]
    n, flips, train = 0, 0, None
    for split, mb in ld.epoch():
        p = mb.data
        rows = p[:, 0].astype(np.int64) - ld._pool_offsets[split]
        host = native_lib.crop_gather_u8(ld.images[split], rows, p[:, 1], p[:, 2], p[:, 3],
                                         ld.crop_size, ld.crop_size)
        card = imagenet_lib.crop_from_pool(pool, torch.as_tensor(p, device="cuda"),
                                           ld.crop_size).cpu().numpy()
        if not np.array_equal(card, host):
            fail(f"{label}: the card's crops of a {split} batch differ from the host's")
        n += len(p)
        flips += int(p[:, 3].sum())
        if split == "train":
            train = p
    print(f"{label}: {n} crops cut on the card from the resident pool equal the host's "
          f"native crops bitwise ({flips} flipped)")
    payload = torch.as_tensor(train, device="cuda")
    ms = cuda_ms(lambda: imagenet_lib.crop_from_pool(pool, payload, ld.crop_size))
    nbytes = 2 * len(train) * ld.crop_size * ld.crop_size * pool.shape[-1]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{label}: crop_from_pool of a batch of {len(train)} ({ld.crop_size}^2, u8) on the card "
          f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), bound {bound:.4f} ms (bytes); {smi}")
    return {"crop_ms": ms, "crop_bound_ms": bound}


def phase_scan(torch, models, libs, prng, thread_rate, smi):
    """Phase 22: the device-resident pool and the scan dispatch as CUDA
    graph replays (see the module docstring)."""
    import numpy as np

    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.nn.optimizer import HyperParams
    from znicz_tpu_torch.ops.kernels import attention as fa, kohonen as khk, lrn as lrn_kernel
    from znicz_tpu_torch.ops.kernels import rbm as rbk
    from znicz_tpu_torch.utils import faults
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
    from znicz_tpu_torch.workflow.standard import StandardWorkflow
    from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow
    from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow, RBMWorkflow

    alexnet, imagenet_lib, native_lib = models["alexnet"], libs["imagenet"], libs["native"]
    res = {}
    launches = dict.fromkeys(TRACE_NAMES, 0)  # the graph dispatch's, from its traces
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    _f32_exact(torch)
    imgs, labels = _mnist_u8(SCAN_IMAGES, 1)
    n_steps = SCAN_IMAGES // SCAN_BATCH

    # MNIST at bench.py's mnist_epoch shape
    def mnist(dispatch, **kw):
        ld = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=SCAN_BATCH,
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return StandardWorkflow(
            ld, [{"type": "all2all_tanh", "->": {"output_sample_shape": 256}},
                 {"type": "softmax", "->": {"output_sample_shape": 10}}],
            decision_config={"max_epochs": 10000},
            default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
            epoch_dispatch=dispatch, device="cuda", name=f"MnistResident-{dispatch}", **kw)

    wfs, _ = _scan_runs(torch, prng, mnist, "scan mnist")
    res["mnist"] = _scan_turns(torch, wfs, SCAN_IMAGES, "scan mnist", smi)
    res["mnist"]["replay"] = _replay_profile(torch, wfs["scan"], "scan mnist", smi)
    del wfs

    # the rollback under the graph dispatch: a NaN in one drained watch row
    pol_kw = dict(max_rollbacks=2, perturb=False, lr_backoff=1.0)
    runs = {}
    for key, dispatch, fault in (("golden", "scan", False), ("graph", "scan", True),
                                 ("step", "step", True)):
        pol = RecoveryPolicy(**pol_kw)
        prng.seed_all(3)
        wf = mnist(dispatch, recovery=pol)
        wf.initialize(seed=3)
        if fault:
            faults.inject("train.step_nan", flag=True, times=1, after=SCAN_POISON)
        try:
            while wf.decision.epoch < SCAN_EPOCHS:
                wf.run_epoch()
        finally:
            faults.clear()
        torch.cuda.synchronize()
        runs[key] = (wf, pol)
    (g, gp), (s, sp), (ref, _) = runs["graph"], runs["step"], runs["golden"]
    diffs = {k: _differ(torch, w.state.params, ref.state.params)
             for k, w in (("graph", g), ("step", s))}
    events = {k: [(e["kind"], e["reason"], e["step"]) for e in p.events]
              for k, p in (("graph", gp), ("step", sp))}
    print(f"scan rollback: NaN in the watch row of step {SCAN_POISON}: graph events "
          f"{events['graph']}, step events {events['step']}; against the unfaulted graph run "
          f"after {SCAN_EPOCHS} epochs (tensors differing, largest |diff|): {diffs}")
    if (gp.rollbacks_used != 1 or sp.rollbacks_used != 1 or any(n for n, _ in diffs.values())
            or g.decision.history != ref.decision.history
            or s.decision.history != ref.decision.history):
        fail("scan rollback: the graph dispatch's rollback is not bitwise the step dispatch's")
    res["rollback"] = {"events_graph": events["graph"], "events_step": events["step"]}
    del runs, g, s, ref

    # the SOM and the RBM, resident and deferred
    def som(dispatch):
        ld = FullBatchLoader({"train": imgs}, minibatch_size=SCAN_BATCH, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return KohonenWorkflow(ld, sx=8, sy=8, total_epochs=10000, epoch_sync="deferred",
                               epoch_dispatch=dispatch, device="cuda")

    def rbm(dispatch):
        ld = FullBatchLoader({"train": imgs}, minibatch_size=SCAN_BATCH, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": 0.0},
                             device_resident=True)
        return RBMWorkflow(ld, n_hidden=128, learning_rate=0.1, cd_k=1, max_epochs=10000,
                           epoch_sync="deferred", epoch_dispatch=dispatch, device="cuda")

    for name, make, kname, fn in (("kohonen", som, "kohonen_accumulate", khk.accumulate),
                                  ("mnist_rbm", rbm, "rbm_cd", rbk.statistics)):
        wfs, traced = _scan_runs(torch, prng, make, f"scan {name}", [(kname, fn, n_steps)],
                                 deferred=True)
        launches[kname] += traced[kname]
        res[name] = _scan_turns(torch, wfs, SCAN_IMAGES, f"scan {name}", smi)
        res[name]["replay"] = _replay_profile(torch, wfs["scan"], f"scan {name}", smi)
        del wfs

    # AlexNet at full width from a resident FullBatch pool and from the
    # packed ImageNet files' resident pool
    lrn_counters = [("lrn_fwd", lrn_kernel.lrn_forward, 2 * (8 + 1)),
                    ("lrn_bwd", lrn_kernel.lrn_backward, 2 * 8)]
    gen = np.random.default_rng(0)
    data = {s: gen.integers(0, 256, (n, 227, 227, 3), dtype=np.uint8)
            for s, n in SCAN_POOL.items()}
    lab = {s: gen.integers(0, 1000, n).astype(np.int32) for s, n in SCAN_POOL.items()}

    def alex_fb(dispatch):
        ld = FullBatchLoader(data, lab, minibatch_size=128, normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True)
        return _alexnet_resident(alexnet, ld, dispatch, 1000)

    wfs, traced = _scan_runs(torch, prng, alex_fb, "scan alexnet", lrn_counters, epochs=2)
    for name in traced:
        launches[name] += traced[name]
    res["alexnet"] = _scan_turns(torch, wfs, SCAN_POOL["train"], "scan alexnet", smi)
    res["alexnet"]["replay"] = _replay_profile(torch, wfs["scan"], "scan alexnet", smi)
    del wfs, data
    pack = os.path.join(WORK_DIR, "imagenet_resident")
    os.makedirs(pack, exist_ok=True)
    for s, n in SCAN_POOL.items():
        np.save(os.path.join(pack, f"{s}_images.npy"),
                gen.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8))
        np.save(os.path.join(pack, f"{s}_labels.npy"), gen.integers(0, 1000, n).astype(np.int32))
    with open(os.path.join(pack, "mean_rgb.json"), "w") as f:
        json.dump([0.485, 0.456, 0.406], f)

    def alex_im(dispatch):
        ld = imagenet_lib.ImageNetLoader(pack, crop_size=227, minibatch_size=128,
                                         device_resident=True)
        return _alexnet_resident(alexnet, ld, dispatch, 1000)

    wfs, traced = _scan_runs(torch, prng, alex_im, "scan imagenet", lrn_counters, epochs=2)
    for name in traced:
        launches[name] += traced[name]
    crop = _pool_crops_against_host(torch, imagenet_lib, native_lib, wfs["scan"],
                                    "scan imagenet", smi)
    res["imagenet"] = _scan_turns(torch, wfs, SCAN_POOL["train"], "scan imagenet", smi)
    res["imagenet"]["crop"] = crop
    print(f"scan imagenet: graph {statistics.mean(res['imagenet']['graph']):.1f} images/sec "
          f"from the resident packed pool, beside phase 20's prefetch thread "
          f"{', '.join(f'{r:.1f}' for r in thread_rate)} images/sec from the same geometry's "
          f"packed files; {smi}")
    del wfs
    torch.cuda.empty_cache()

    # the mid LM's width at 2 layers through the graph with flash
    tokens = np.random.default_rng(7).integers(0, LM_RESUME["vocab"],
                                              (sum(SCAN_LM_N.values()), LM_T))
    split_tok = {"train": tokens[:SCAN_LM_N["train"]], "test": tokens[SCAN_LM_N["train"]:]}
    n_tr, n_ev = SCAN_LM_N["train"] // LM_B, SCAN_LM_N["test"] // LM_B
    depth = LM_RESUME["n_layers"]
    lm_counters = [("flash_fwd", fa.flash_fwd, depth * (n_tr + n_ev)),
                   ("flash_dq", fa.flash_dq, depth * n_tr),
                   ("flash_dkv", fa.flash_dkv, depth * n_tr)]
    lm_wfs = {}
    for dispatch in ("scan", "step"):
        ld = FullBatchLoader(split_tok, minibatch_size=LM_B, device_resident=True)
        prng.seed_all(3)
        wf = TransformerLMWorkflow(ld, **LM_RESUME, attention="flash", max_epochs=10000,
                                   hyper=HyperParams(learning_rate=0.001, gradient_moment=0.9),
                                   epoch_dispatch=dispatch, device="cuda")
        wf.initialize(seed=3)
        for _, fn, _ in lm_counters:
            fn.launches = 0
        out, _, traced = _traced_epochs(torch, wf, 2, [name for name, _, _ in lm_counters])
        hist = [r["summary"] for r in out]
        torch.cuda.synchronize()
        wrapped = {name: fn.launches for name, fn, _ in lm_counters}
        want = {name: n for name, _, n in lm_counters}
        print(f"scan lm: {dispatch} dispatch, 2 epochs: wrapper counts {wrapped}; traced "
              f"launches of epoch 2 {traced}, want {want}; " + json.dumps(hist))
        if (traced != want or (dispatch == "step" and wrapped != {n: 2 * v for n, v in want.items()})
                or not all(math.isfinite(m["loss"]) for e in hist for m in e.values())):
            fail(f"scan lm: {dispatch} dispatch launched {traced} in epoch 2 (want {want}; "
                 f"wrapper counts {wrapped}) or lost finiteness")
        if dispatch == "scan":
            for name in traced:
                launches[name] += traced[name]
        lm_wfs[dispatch] = (wf, hist)
    # the embedding's backward adds with atomics: the two dispatches agree
    # to a float32 sum's order, not bitwise
    rel = max(abs(a[s]["loss"] - b[s]["loss"]) / abs(b[s]["loss"])
              for a, b in zip(lm_wfs["scan"][1], lm_wfs["step"][1]) for s in a)
    print(f"scan lm: graph against step dispatch, per-epoch loss rel diff {rel:.2e} (limit 1e-4)")
    if not rel <= 1e-4:
        fail("scan lm: the graph dispatch's losses differ from the step dispatch's")
    res["lm"] = _scan_turns(torch, {k: w for k, (w, _) in lm_wfs.items()}, SCAN_LM_N["train"],
                            "scan lm", smi)
    del lm_wfs
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return launches, res


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.loader import image as image_lib, imagenet as imagenet_lib
    from znicz_tpu_torch.loader import native as native_lib
    from znicz_tpu_torch.models import alexnet, cifar, kohonen, mnist, mnist_rbm, transformer_lm
    from znicz_tpu_torch.models import kanji, mnist_ae, video_ae, yale_faces
    from znicz_tpu_torch.ops import deconv, kohonen as kh_op
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
    launches, synthetic = phase_slice(torch, lrn_kernel, alexnet, model_lib, prng)
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
    t0 = time.perf_counter()
    phase_mnist(torch, mnist, prng, smi)
    cifar_launches, cifar_err, cifar_rows, _ = phase_cifar(
        torch, cifar, lrn_kernel, model_lib, prng, smi)
    print(f"mnist and cifar phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tree, imagenet_dir, crop = phase_loaders(torch, image_lib, imagenet_lib, native_lib, smi)
    disk_launches, disk = phase_alexnet_disk(
        torch, lrn_kernel, alexnet, imagenet_lib, model_lib, prng, troot, imagenet_dir,
        synthetic, smi)
    ae = phase_autoencoders(
        torch, {"mnist_ae": mnist_ae, "video_ae": video_ae, "kanji": kanji,
                "yale_faces": yale_faces}, deconv, troot, prng, tree, smi)
    print(f"loader, AlexNet-from-disk and autoencoder phases: {time.perf_counter() - t0:.1f} s; "
          + json.dumps({"crop": crop, "alexnet_disk": disk, "synthetic": synthetic, **ae}))
    t0 = time.perf_counter()
    loop_launches, host_loop = phase_host_loop(
        torch, lrn_kernel, alexnet, prng, troot, imagenet_dir, disk, smi)
    host_loop["thread_cost"] = phase_thread_cost(
        torch, {"kohonen": kohonen, "mnist_rbm": mnist_rbm, "mnist": mnist, "cifar": cifar},
        troot, prng, smi)
    print(f"host loop phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(host_loop))
    t0 = time.perf_counter()
    heal_launches, heal = phase_self_healing(
        torch, lrn_kernel, alexnet, {"kohonen": kohonen, "mnist_rbm": mnist_rbm, "mnist": mnist},
        prng, smi)
    print(f"self-healing phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(heal))
    t0 = time.perf_counter()
    scan_launches, scan = phase_scan(
        torch, {"alexnet": alexnet}, {"imagenet": imagenet_lib, "native": native_lib}, prng,
        host_loop["images_per_s"], smi)
    print(f"scan phase: {time.perf_counter() - t0:.1f} s; " + json.dumps(scan))

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
        # the CIFAR-10 path (f32): its epoch's launches, the kernel at its
        # norm shape in f32, with bf16 beside it
        (c32,), (c16,) = cifar_rows[kname]["float32"], cifar_rows[kname]["bfloat16"]
        entry["cifar"] = {
            "shape": list(CIFAR_NORM["cifar"]),
            "launches": cifar_launches[kname],
            "max_abs_err": cifar_err[kname]["float32"],
            **{k: v for k, v in c32.items() if k != "shape"},
            "bf16": {"max_abs_err": cifar_err[kname]["bfloat16"],
                     **{k: v for k, v in c16.items() if k != "shape"}},
        }
        # AlexNet from packed files on disk (phase 18): its epoch's launches
        entry["alexnet_disk"] = {"launches": disk_launches[kname]}
        # the same through the workflow's host loop (phase 20): prefetch
        # thread, pinned copies
        entry["host_loop"] = {"launches": loop_launches[kname]}
        # the self-healing phase's poisoned AlexNet run (phase 21): its
        # train and eval steps, the rolled-back ones included
        entry["self_healing"] = {"launches": heal_launches[kname]}
        # the graph dispatch's AlexNet runs (phase 22), both resident pools:
        # their replayed epochs' launches, read from the trace
        entry["scan"] = {"launches": scan_launches[kname]}
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
            # the graph dispatch's LM run (phase 22): its replayed epoch's
            # launches, read from the trace
            "scan": {"launches": scan_launches[kname]},
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
            # the graph dispatch's resident, deferred run (phase 22): its
            # replayed epochs' launches, read from the trace
            "scan": {"launches": scan_launches[kname]},
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
