#!/usr/bin/env python3
"""Where a train step of the PyTorch port's AlexNet spends its device time.

    python3 tools/profile_torch_alexnet.py [--steps 5]

Runs on one CUDA card (run from the repository root): builds
``znicz_tpu_torch.models.alexnet`` at its published geometry (batch 128,
bf16), warms up, then profiles ``--steps`` train steps with
``torch.profiler``.  Prints the card's ``nvidia-smi`` name and power limit,
the step's wall time under the profiler, the device-busy time (the sum of
the kernels' device time, one stream), kernel time by family, and the top
kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

FAMILIES = (  # first match wins; matched against the lower-cased kernel name
    ("lrn (hand-written)", ("lrn_fwd_kernel", "lrn_bwd_kernel")),
    ("pooling", ("pool",)),
    ("conv (cuDNN)", ("cudnn", "conv", "implicit", "wgrad", "dgrad", "fprop", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "nvjet")),
    ("reduce / softmax", ("reduce", "softmax", "norm_kernel")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.models import alexnet

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    prng.seed_all(1234)
    wf = alexnet.build_workflow(device="cuda")
    wf.initialize()
    torch.backends.cudnn.benchmark = True
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    x = torch.as_tensor(mb.data, device="cuda")
    y = torch.as_tensor(mb.labels, device="cuda")
    mask = torch.as_tensor(mb.mask, device="cuda")
    for _ in range(5):
        wf.train_step(x, y, mask)
    torch.cuda.synchronize()
    n = args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            wf.train_step(x, y, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print("torch.profiler recorded no device time on this machine", file=sys.stderr)
        return 1
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    print(f"steps {n}, batch {x.shape[0]}: wall {wall_ms:.3f} ms/step under the profiler; "
          f"device busy {busy_ms:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% of wall); "
          f"{sum(e.count for e in kernels) // n} kernel launches/step")
    fams = defaultdict(float)
    for e in kernels:
        fams[family(e.key)] += e.self_device_time_total / 1e3 / n
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"family {fam:20s} {ms:8.3f} ms/step {100 * ms / busy_ms:5.1f}% of busy")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"kernel {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:4d}x/step  [{family(e.key)}] {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
