#!/usr/bin/env python3
"""Time the RBM CD-k kernel of other versions of the CUDA source beside this tree's, in turns, on one card.

    python3 tools/ab_rbm_kernels.py OTHER.cu [OTHER.cu ...]

Run from the repository root on one CUDA card; each ``OTHER.cu`` is another
version of ``znicz_tpu_torch/csrc/rbm.cu`` with the same C interface (a
copy with another pipeline depth, say, in a directory ``.gitignore``
lists).  Builds this tree's source and every other one with the flags of
``ops/kernels/cuda_build.py`` into ``build/ab_rbm/``, in parallel, and
prints each version's registers and spills (ptxas).  At the MNIST RBM's
shape (B 100, 784 x 128, k 1), ``chip_smoke.py``'s large and k 3 check
shapes (B 1024, 784 x 1024, k 1; B 256, 784 x 1024, k 3) and a ragged one
(B 70, 50 x 33, k 3): checks each version against the plain version (the
draws that flip, counted over the whole chain, and the statistics' largest
error relative to the reference's largest magnitude) and against this
tree's (bitwise); then times each shape in turns (this tree first, then the
others, then the reverse order, two rounds), each turn the median of 5 x 20
calls by CUDA events; then each launch's device time at the large shape
with ``torch.profiler`` (20 calls).  Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SHAPES = {  # tag: (B, V, H, cd_k)
    "model": (100, 784, 128, 1),
    "large": (1024, 784, 1024, 1),
    "k3": (256, 784, 1024, 3),
    "ragged": (70, 50, 33, 3),
}


def _build(cuda_build, name: str, src: Path, out: Path):
    """nvcc of ``src`` into ``out/<name>.so``; returns (path, ptxas lines)."""
    so = out / f"{name}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return so, [line.strip() for line in log if "Used" in line or "spill" in line]


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the seed by pointer, as this tree's kernel reads it
    lib.znicz_rbm_cd.argtypes = [ptr] * 19 + [i32] * 4 + [ptr, ptr]
    lib.znicz_rbm_cd.restype = i32
    lib.znicz_rbm_error_string.argtypes = [i32]
    lib.znicz_rbm_error_string.restype = ctypes.c_char_p
    return lib


def _inputs(torch, b, v, h, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {"weights": torch.randn((v, h), generator=gen, device="cuda") / math.sqrt(v),
              "vbias": torch.randn((v,), generator=gen, device="cuda") * 0.1,
              "hbias": torch.randn((h,), generator=gen, device="cuda") * 0.1}
    v0 = torch.rand((b, v), generator=gen, device="cuda")
    mask = (torch.arange(b, device="cuda") < b - 5).float()
    return params, v0, mask


def _ms(torch, fn, iters=20, repeats=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main() -> int:
    sys.path.insert(0, ".")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from znicz_tpu_torch.ops.kernels import cuda_build, rbm as rbk

    if not torch.cuda.is_available():
        print("ab_rbm_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = {"this": cuda_build.CSRC_DIR / "rbm.cu"}
    sources.update({Path(a).stem + f"#{i}": Path(a) for i, a in enumerate(sys.argv[1:])})
    out = cuda_build.BUILD_DIR.parent / "ab_rbm"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda kv: _build(cuda_build, kv[0].replace("#", "_"),
                                                            kv[1], out), sources.items())))
    libs = {}
    for name, (so, ptxas) in built.items():
        libs[name] = _load(so)
        print(f"ptxas {name} ({sources[name]}): " + " | ".join(ptxas))
    names = list(libs)

    def use(name):
        rbk._lib = lambda: libs[name]

    for tag, (b, v, h, k) in SHAPES.items():
        params, v0, mask = _inputs(torch, b, v, h, 7)
        uh, uv = rbk.chain_uniforms(7, b, v, h, k, "cuda")
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=k)
        first = None
        for name in names:
            use(name)
            chain, led = {}, {}
            got = rbk.statistics(params, v0, mask, rbk.seed_tensor(7, "cuda"), cd_k=k,
                                 chain=chain)
            torch.cuda.synchronize()
            rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=k, chain=led,
                                     samples=(chain["hidden_samples"], chain["visible_samples"]))
            flips = rbk.count_flips(chain, led, uh, uv)
            err = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
            same = first is None or all(torch.equal(a, c) for a, c in zip(got, first))
            first = first or got
            print(f"check {tag} (B {b}, {v} x {h}, k {k}) {name}: {flips} draws flipped, "
                  f"max error {err:.2e} of the largest magnitude, bitwise this tree's: {same}")
    seed3 = rbk.seed_tensor(3, "cuda")  # on the card, as the workflow's step hands it
    for rnd in range(2):
        order = names if rnd == 0 else names[::-1]
        for tag, (b, v, h, k) in SHAPES.items():
            params, v0, mask = _inputs(torch, b, v, h, 3)
            row = []
            for name in order:
                use(name)
                ms = _ms(torch, lambda: rbk.statistics(params, v0, mask, seed3, cd_k=k))
                row.append(f"{name} {ms:.4f}")
            print(f"time round {rnd} {tag} (B {b}, {v} x {h}, k {k}) ms a call: " + ", ".join(row))
    b, v, h, k = SHAPES["large"]
    params, v0, mask = _inputs(torch, b, v, h, 3)
    for name in names:
        use(name)
        for _ in range(3):
            rbk.statistics(params, v0, mask, seed3, cd_k=k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                rbk.statistics(params, v0, mask, seed3, cd_k=k)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if any(f"{kind}_kernel" in e.key for kind in ("hidden", "visible", "stats")):
                t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                kname = re.search(r"\w+_kernel<\d+>", e.key).group(0)
                rows.append(f"{kname} {t / max(e.count, 1) / 1000:.4f} ms a launch, "
                            f"{e.count // 20} a call")
        print(f"profile large {name}: " + "; ".join(sorted(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
