#!/usr/bin/env python3
"""Where a train step of one of the PyTorch port's models spends its device time.

    python3 tools/profile_torch_step.py [--model alexnet|lm|kohonen|rbm]
                                        [--steps 5] [--attention-dtype f32|bf16]

Runs on one CUDA card (run from the repository root): builds the model at
the size ``chip_smoke.py`` trains it (``alexnet``: the published geometry,
batch 128, bf16; ``lm``: the mid LM, vocab 8192, d_model 512, 12 layers, 8
heads, T 2048, batch 16, flash attention with ``--attention-dtype``;
``kohonen``: the 8x8 SOM over 784 features, batch 100; ``rbm``: the MNIST
RBM, 784 x 128, CD-1, batch 100), warms up, then profiles ``--steps`` train steps with ``torch.profiler``.  Prints
the card's ``nvidia-smi`` name and power limit, the step's wall time under
the profiler, the device-busy time (the sum of the kernels' device time, one
stream), kernel time by family, and the top kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

FAMILIES = (  # first match wins; matched against the lower-cased kernel name
    # the Triton forward; csrc/lrn.cu's backward, mangled or demangled
    ("lrn (hand-written)", ("lrn_fwd_kernel", "lrn_cu",
                            "namespace)::halo_kernel", "namespace)::rows_kernel")),
    # csrc/flash_attention.cu's kernels, mangled or demangled
    ("flash (hand-written)", ("flash_attention_cu", "namespace)::fwd_mma_kernel",
                              "namespace)::dq_mma_kernel", "namespace)::dkv_mma_kernel",
                              "namespace)::fwd_tf32_kernel", "namespace)::dq_tf32_kernel",
                              "namespace)::dkv_tf32_kernel")),
    # csrc/kohonen.cu's and csrc/rbm.cu's kernels
    ("kohonen (hand-written)", ("kohonen_cu", "namespace)::scores_kernel",
                                "namespace)::winners_kernel", "namespace)::accum_kernel")),
    ("rbm (hand-written)", ("rbm_cu", "namespace)::hidden_kernel", "namespace)::visible_kernel",
                            "namespace)::stats_kernel")),
    ("pooling", ("pool",)),
    ("conv (cuDNN)", ("cudnn", "conv", "implicit", "wgrad", "dgrad", "fprop", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "nvjet")),
    ("reduce / softmax", ("reduce", "softmax", "norm_kernel", "logsumexp")),
    ("gather / index", ("index", "gather", "scatter", "embedding")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _alexnet(torch):
    from znicz_tpu_torch.models import alexnet

    wf = alexnet.build_workflow(device="cuda")
    wf.initialize()
    torch.backends.cudnn.benchmark = True
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    y = torch.as_tensor(mb.labels, device="cuda")
    return wf, mb, y


def _lm(torch, attention_dtype):
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.models import transformer_lm

    root.transformer_lm.update({
        "vocab": 8192, "d_model": 512, "n_layers": 12, "n_heads": 8,
        "loader": {"seq_len": 2048, "n_train": 16, "n_test": 0, "minibatch_size": 16},
    })
    wf = transformer_lm.build_workflow(
        device="cuda", attention="flash", attention_dtype=attention_dtype
    )
    wf.initialize()
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    y = torch.zeros((len(mb.mask),), dtype=torch.int32, device="cuda")
    return wf, mb, y


def _unsupervised(torch, name):
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.models import kohonen, mnist_rbm

    model, node = {"kohonen": (kohonen, root.kohonen), "rbm": (mnist_rbm, root.mnist_rbm)}[name]
    node.update({"loader": {"n_train": 1000, "n_test": 0}})  # one step's data is a batch
    wf = model.build_workflow(device="cuda")
    wf.initialize()
    mb = next(iter(wf.loader.batches("train", shuffle=False)))
    y = torch.zeros((len(mb.mask),), dtype=torch.int32, device="cuda")
    return wf, mb, y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("alexnet", "lm", "kohonen", "rbm"), default="alexnet")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--attention-dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from znicz_tpu_torch.core import prng

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    prng.seed_all(1234)
    if args.model == "alexnet":
        wf, mb, y = _alexnet(torch)
    elif args.model == "lm":
        wf, mb, y = _lm(torch, args.attention_dtype)
    else:
        wf, mb, y = _unsupervised(torch, args.model)
    x = torch.as_tensor(mb.data, device="cuda")
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
    print(f"model {args.model}, steps {n}, batch {x.shape[0]}: "
          f"wall {wall_ms:.3f} ms/step under the profiler; "
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
