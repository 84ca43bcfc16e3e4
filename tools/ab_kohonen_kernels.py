#!/usr/bin/env python3
"""Time the Kohonen accumulate of other versions of the CUDA source beside this tree's, in turns, on one card.

    python3 tools/ab_kohonen_kernels.py OTHER.cu [OTHER.cu ...]

Run from the repository root on one CUDA card; each ``OTHER.cu`` is another
version of ``znicz_tpu_torch/csrc/kohonen.cu`` with the same C interface (a
copy with another warp tile, say, in a directory ``.gitignore`` lists).
Builds this tree's source and every other one with the flags of
``ops/kernels/cuda_build.py`` into ``build/ab_kohonen/``, in parallel, and
prints each version's registers and spills (ptxas).  At the Kohonen SOM's
shape (B 100, 8x8 map, F 784), ``chip_smoke.py``'s large check shape (B
4096, 32x32, F 784) and a ragged one (B 300, 7x7, F 781): checks each
version against the plain version (the samples whose winner differs, and
the largest error of ``num`` and ``den`` relative to the reference's
largest magnitude, the reference taking the kernel's winners) and against
this tree's (bitwise); then times each shape in turns (this tree first,
then the others, then the reverse order, two rounds), each turn the median
of 5 x 20 calls by CUDA events, with the plain version's time beside them;
then each launch's device time at the model's and the large shape with
``torch.profiler`` (20 calls).  Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SHAPES = {  # tag: (B, map side, F)
    "model": (100, 8, 784),
    "large": (4096, 32, 784),
    "ragged": (300, 7, 781),
}


def _build(cuda_build, name: str, src: Path, out: Path):
    """nvcc of ``src`` into ``out/<name>.so``; returns (path, each kernel's
    registers and spill stores from ptxas)."""
    so = out / f"{name}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    rows, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d+([a-z]+_kernel)(ILi(\d+)E)?", line)
        if entry:
            name = entry.group(1) + (f"<{entry.group(3)}>" if entry.group(3) else "")
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if regs:
            rows.append(f"{name} {regs.group(1)} registers")
        elif spill:
            rows.append(f"{name} {spill.group(1)} bytes spilled")
    return so, rows


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.znicz_kohonen_accumulate.argtypes = [ptr] * 10 + [i32] * 4 + [f32, ptr]
    lib.znicz_kohonen_accumulate.restype = i32
    lib.znicz_kohonen_error_string.argtypes = [i32]
    lib.znicz_kohonen_error_string.restype = ctypes.c_char_p
    return lib


def _inputs(torch, kh, khk, b, side, f, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((b, f), generator=gen, device="cuda")
    w = torch.randn((side * side, f), generator=gen, device="cuda") * 0.1
    mask = (torch.arange(b, device="cuda") < b - 5).float()
    d2m = khk.pairwise_d2(kh.grid_coords(side, side, device="cuda"))
    return w, x, mask, d2m


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

    from znicz_tpu_torch.ops import kohonen as kh
    from znicz_tpu_torch.ops.kernels import cuda_build, kohonen as khk

    if not torch.cuda.is_available():
        print("ab_kohonen_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = {"this": cuda_build.CSRC_DIR / "kohonen.cu"}
    sources.update({Path(a).stem + f"#{i}": Path(a) for i, a in enumerate(sys.argv[1:])})
    out = cuda_build.BUILD_DIR.parent / "ab_kohonen"
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
        khk._lib = lambda: libs[name]

    for tag, (b, side, f) in SHAPES.items():
        w, x, mask, d2m = _inputs(torch, kh, khk, b, side, f, 7)
        plain_win = kh.winners({"weights": w}, x)
        first = None
        for name in names:
            use(name)
            win = torch.empty((b,), dtype=torch.int32, device="cuda")
            got = khk.accumulate(w, x, mask, d2m, 2.0, winners_out=win)
            torch.cuda.synchronize()
            ref = khk.accumulate_reference(w, x, mask, d2m, 2.0, win=win)
            differ = int((win != plain_win).sum())
            err = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
            same = first is None or all(torch.equal(a, c) for a, c in zip(got, first))
            first = first or got
            print(f"check {tag} (B {b}, {side}x{side}, F {f}) {name}: {differ} winners differ "
                  f"from the plain version's, max error {err:.2e} of the largest magnitude, "
                  f"bitwise this tree's: {same}")
    for rnd in range(2):
        order = names if rnd == 0 else names[::-1]
        for tag, (b, side, f) in SHAPES.items():
            w, x, mask, d2m = _inputs(torch, kh, khk, b, side, f, 3)
            row = []
            for name in order:
                use(name)
                ms = _ms(torch, lambda: khk.accumulate(w, x, mask, d2m, 2.0))
                row.append(f"{name} {ms:.4f}")
            plain = _ms(torch, lambda: khk.accumulate_reference(w, x, mask, d2m, 2.0))
            print(f"time round {rnd} {tag} (B {b}, {side}x{side}, F {f}) ms a call: "
                  + ", ".join(row) + f"; plain {plain:.4f}")
    for tag in ("model", "large"):
        b, side, f = SHAPES[tag]
        w, x, mask, d2m = _inputs(torch, kh, khk, b, side, f, 3)
        for name in names:
            use(name)
            for _ in range(3):
                khk.accumulate(w, x, mask, d2m, 2.0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    khk.accumulate(w, x, mask, d2m, 2.0)
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                kname = re.search(r"(scores|winners|accum)_kernel(<\d+>)?", e.key)
                if kname is None:
                    continue
                t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                rows.append(f"{kname.group(0)} {t / max(e.count, 1) / 1000:.4f} ms a launch, "
                            f"{e.count // 20} a call")
            print(f"profile {tag} {name}: " + "; ".join(sorted(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
