#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (znicz_tpu_torch) end to end on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, builds every Hopper kernel of the slice from the
sources here (Triton, compiled at first launch), and fails (non-zero exit,
no result line) when any phase fails:

1. the card's ``nvidia-smi`` name and power limit, and the versions;
2. each LRN kernel against its plain PyTorch version on the same CUDA
   tensors, at AlexNet's two norm shapes (batch 128), in f32 and bf16;
3. the kernels' times beside their memory bound, the plain versions' and
   the ``F.local_response_norm`` yardstick's (timed here only; the port
   never calls it), with CUDA events;
4. the slice: ``alexnet.build_workflow(device="cuda")`` at the published
   geometry (227x227x3, 1000 classes, batch 128, bf16) runs one epoch
   (4 train steps and the eval pass) with the launch counters set to 0 just
   before and read just after, then timed train steps; and a 4-image f32
   forward (TF32 off) on the card against the CPU from identical weights;
5. the ``kernels`` JSON line, then the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.ops.kernels import lrn as lrn_kernel
    from znicz_tpu_torch.workflow import model as model_lib

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
