#!/usr/bin/env python3
"""Time the LRN backward of other versions of the CUDA source beside this tree's, in turns, on one card.

    python3 tools/ab_lrn_kernels.py [OTHER.cu ...] [--triton OLD_LRN.py]

Run from the repository root on one CUDA card; each ``OTHER.cu`` is another
version of ``znicz_tpu_torch/csrc/lrn.cu`` with the same C interface (a copy
with another lever, say, in a directory ``.gitignore`` lists).  ``--triton``
names an earlier ``ops/kernels/lrn.py`` whose ``lrn_backward`` launches the
Triton kernel (its ``_kernels()`` returning ``(triton, fwd, bwd)``, as before
the CUDA backward): it is timed in the same turns, checked against the plain
version, and its compiled kernel's SASS counted.

Builds this tree's source and every other one with the flags of
``ops/kernels/cuda_build.py`` into ``build/ab_lrn/``, in parallel, and
prints each kernel's registers and spills (ptxas) and its SASS instruction
counts by class (``cuobjdump -sass``), per element for the halo kernel (its
static count over the VEC elements a thread owns in a tile: the tile loop
runs the same code for each tile) and for the Triton kernel (no loops).  At AlexNet's norm1 (``[128, 55, 55, 96]``) and norm2
(``[128, 27, 27, 256]``), in bf16 and f32, with ``chip_smoke.py``'s inputs
and window (alpha 1e-4, beta 0.75, k 2, n 5): checks each version against the
plain version (largest error, within ``chip_smoke.py``'s TOL) and against
this tree's (bitwise); then times each shape in turns (this tree first, then
the others, then the reverse order, two rounds), each turn the median of 5 x
20 calls by CUDA events, beside the byte bound (x and g read once, dx written
once, at 3.35 TB/s) and the plain version's time.  Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import statistics
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SHAPES = {"norm1": (128, 55, 55, 96), "norm2": (128, 27, 27, 256)}
ARGS = (1e-4, 0.75, 2.0, 5)  # alpha, beta, k, n: AlexNet's LRN
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}  # chip_smoke.py's (rtol, atol)
HBM_BYTES_PER_S = 3.35e12
# SASS opcode classes counted (the opcode's first word, before any '.')
CLASSES = ("SHFL", "LDS", "STS", "BAR", "LDG", "STG", "MUFU", "FADD", "FMUL", "FFMA", "F2F",
           "PRMT", "BRA")
_ENTRY = re.compile(r"(halo|rows)_kernelILb([01])ELi(\d+)E(?:Li(\d)E)?")
BETAS = ("0.75", "0.5", "0.25", "1", "any")  # the source's BetaKind, in order


def _name(mangled: str) -> str:
    m = _ENTRY.search(mangled)
    if m is None:
        return mangled[:60]
    return (f"{m.group(1)}_kernel<{'bf16' if m.group(2) == '1' else 'f32'}, {m.group(3)}"
            + (f", beta {BETAS[int(m.group(4))]}>" if m.group(4) else ">"))


def _build(cuda_build, name: str, src: Path, out: Path):
    """nvcc of ``src`` into ``out/<name>.so``; returns (path, each kernel's
    registers and spill stores from ptxas)."""
    so = out / f"{name}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    rows, kname = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kname = _name(entry.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if regs:
            rows.append(f"{kname} {regs.group(1)} registers")
        elif spill and spill.group(1) != "0":
            rows.append(f"{kname} {spill.group(1)} bytes spilled")
    return so, rows


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.znicz_lrn_bwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, f32, f32, i32, f32, f32,
                                  i32, i32, i32, i32, i32, ptr]
    lib.znicz_lrn_bwd.restype = i32
    lib.znicz_lrn_error_string.argtypes = [i32]
    lib.znicz_lrn_error_string.restype = ctypes.c_char_p
    return lib


def sass_counts(cuobjdump: Path, binary: Path):
    """{function: Counter of SASS opcode classes, with 'all' the instruction
    count} from ``cuobjdump -sass`` of a cubin or a shared library."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(binary)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            out[cur] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)[.\s;]", line)
        if cur is not None and m:
            out[cur]["all"] += 1
            if m.group(1) in CLASSES:
                out[cur][m.group(1)] += 1
    return out


def _print_sass(label, counts, per_element):
    """One line a function: the counts, and per element where given."""
    for fn, cnt in sorted(counts.items()):
        per = per_element(fn)
        parts = [f"{k} {cnt[k]}" + (f" ({cnt[k] / per:.2f}/el)" if per else "")
                 for k in ("all",) + CLASSES if cnt[k]]
        print(f"sass {label} {_name(fn)}: " + ", ".join(parts)
              + ("" if per else " (static counts)"))


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


def _inputs(torch, shape, dtype, seed):
    """chip_smoke.py's: softplus-like positive x, as after conv_relu, and an
    O(1) output gradient."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).exp().log1p()
    g = torch.randn(shape, generator=gen, device="cuda") * 3
    return x.to(dtype), g.to(dtype)


def _triton_sass(torch, mod, cuobjdump, out):
    """Compile the old module's Triton backward at both shapes in bf16 and
    count its SASS per real element (BLOCK_R x C of a program's tile)."""
    tri, _, bwd = mod._kernels()
    alpha, beta, k, n = ARGS
    for tag, shape in SHAPES.items():
        x, g = _inputs(torch, shape, torch.bfloat16, 1)
        c = shape[-1]
        rows = x.numel() // c
        block_r, block_c = mod._blocks(c, mod._BWD_TILE)
        dx = torch.empty_like(x)
        compiled = bwd[(tri.cdiv(rows, block_r),)](
            x, g, dx, rows, c, alpha, k, 2.0 * alpha * beta,
            N=n, LO=n // 2, HI=n - 1 - n // 2, BETA=beta,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
        cubin = out / f"triton_bwd_{tag}.cubin"
        cubin.write_bytes(compiled.asm["cubin"])
        per_thread = block_r * c / (4 * 32)  # real elements a thread: 4 warps
        print(f"triton tile at {tag}: BLOCK_R {block_r} x BLOCK_C {block_c} for C {c}, "
              f"4 warps: {per_thread:g} real elements a thread")
        _print_sass(f"triton {tag}", sass_counts(cuobjdump, cubin), lambda fn: per_thread)


def main() -> int:
    sys.path.insert(0, ".")
    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="*", type=Path)
    ap.add_argument("--triton", type=Path, help="an earlier ops/kernels/lrn.py (Triton backward)")
    opts = ap.parse_args()
    import torch

    from znicz_tpu_torch.ops.kernels import cuda_build, lrn as lrn_kernel

    if not torch.cuda.is_available():
        print("ab_lrn_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = {"this": cuda_build.CSRC_DIR / "lrn.cu"}
    sources.update({p.stem + f"#{i}": p for i, p in enumerate(opts.others)})
    out = cuda_build.BUILD_DIR.parent / "ab_lrn"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda kv: _build(cuda_build, kv[0].replace("#", "_"),
                                                            kv[1], out), sources.items())))
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    libs = {}
    for name, (so, ptxas) in built.items():
        libs[name] = _load(so)
        print(f"ptxas {name} ({sources[name]}): " + " | ".join(ptxas))

        def per_element(fn):  # a halo thread owns one vector a tile: its VEC elements
            m = _ENTRY.search(fn)
            return int(m.group(3)) if m and m.group(1) == "halo" else 0

        _print_sass(name, sass_counts(cuobjdump, so), per_element)
    bwd = {}
    for name in libs:
        bwd[name] = lambda x, g, name=name: (setattr(lrn_kernel, "_lib", lambda: libs[name]),
                                             lrn_kernel.lrn_backward(x, g, *ARGS))[1]
    if opts.triton is not None:
        spec = importlib.util.spec_from_file_location("old_lrn", opts.triton)
        old = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old)
        _triton_sass(torch, old, cuobjdump, out)
        bwd["triton"] = lambda x, g: old.lrn_backward(x, g, *ARGS)
    names = list(bwd)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for tag, shape in SHAPES.items():
            x, g = _inputs(torch, shape, dtype, 0)
            ref = lrn_kernel.lrn_bwd_reference(x, g, *ARGS).float()
            first = None
            for name in names:
                got = bwd[name](x, g)
                torch.cuda.synchronize()
                diff = (got.float() - ref).abs()
                bad = int((diff > atol + rtol * ref.abs()).sum())
                same = first is None or torch.equal(got, first)
                first = got if first is None else first
                print(f"check {tag} {dname} {name}: max_abs_err {float(diff.max()):.3e} "
                      f"against the plain version, {bad} out of tolerance; bitwise this "
                      f"tree's: {same}")
    for rnd in range(2):
        order = names if rnd == 0 else names[::-1]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for tag, shape in SHAPES.items():
                x, g = _inputs(torch, shape, dtype, 3)
                row = [f"{name} {_ms(torch, lambda: bwd[name](x, g)):.4f}" for name in order]
                plain = _ms(torch, lambda: lrn_kernel.lrn_bwd_reference(x, g, *ARGS))
                bound = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
                print(f"time round {rnd} {tag} {dname} ms a call: " + ", ".join(row)
                      + f"; bound {bound:.4f} (bytes); plain {plain:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
