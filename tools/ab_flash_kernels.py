#!/usr/bin/env python3
"""Time the flash forward, dQ and dK/dV of other versions of the CUDA source beside this tree's, in turns, on one card.

    python3 tools/ab_flash_kernels.py OTHER.cu [OTHER.cu ...]

Run from the repository root on one CUDA card; each ``OTHER.cu`` is another
version of ``znicz_tpu_torch/csrc/flash_attention.cu`` (the parent commit's,
say, unpacked with ``git archive`` into a directory ``.gitignore`` lists),
with the same C interface.  Builds this tree's source and every other one
with the flags of ``ops/kernels/cuda_build.py`` into ``build/ab/``, in
parallel, and prints each version's registers and spills (ptxas) and SASS
instructions (all, and the tensor cores' ``HMMA``) of its f32 forward, dQ
and dK/dV at D 64.  For f32 and for bf16: checks each version's forward
(``out`` and ``lse``), dQ and dK/dV against the plain versions (within
``chip_smoke.py``'s ``FLASH_TOL`` of the reference's largest magnitude,
``lse`` within its f32 one) at the LM slice's shape ``[16, 2048, 8, 64]``
causal, at D 128 with a ragged T 1000, and without the causal mask, and in
f32 prints each version's out, lse, dq, dk and dv error against float64
beside the f32 plain version's; then
times the three kernels at the slice shape in turns (this tree first, then
the others, then the reverse order, three rounds), each turn the median of
3 x 10 launches by CUDA events.  Prints the card's name and power limit, and
each version's times sorted.
"""

from __future__ import annotations

import collections
import ctypes
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CASES = [  # (B, T, H, D, causal); the first is timed
    (16, 2048, 8, 64, True),
    (2, 1000, 8, 128, True),
    (2, 1024, 8, 64, False),
]


# the f32 forward, dQ and dK/dV at D 64, by mangled name: this tree's 3xTF32
# kernels or an older source's FMA ones
_F32_64 = re.compile(r"(fwd|dq|dkv)(?:_tf32)?_kernelI(?:f)?Li64E")


def _f32_summary(cuda_build, src: Path, out: Path, log: str) -> None:
    """ptxas' registers and spills, and SASS instruction counts, of the f32
    forward, dQ and dK/dV at D 64."""
    regs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _F32_64.search(m.group(1))
            cur = k.group(1) if k else None
        elif cur and "spill" in line:
            regs[cur] = line.strip()
        elif cur and "Used" in line:
            regs[cur] = regs.get(cur, "") + "; " + re.search(r"Used \d+ registers", line).group(0)
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(out)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops, cur = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        if "Function :" in line:
            k = _F32_64.search(line)
            cur = k.group(1) if k else None
        elif cur:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                ops[cur][m.group(1)] += 1
    for name in ("fwd", "dq", "dkv"):
        print(f"f32 {name} D=64 of {src}: {regs.get(name)}; SASS {sum(ops[name].values())} "
              f"instructions, {ops[name]['HMMA']} HMMA")


def _build(cuda_build, src: Path, out: Path) -> ctypes.CDLL:
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    _f32_summary(cuda_build, src, out, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.znicz_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
    lib.znicz_flash_dq.argtypes = [ptr] * 7 + [i32] * 6 + [f32, ptr]
    lib.znicz_flash_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [f32, ptr]
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__.splitlines()[2], file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    srcs = [cuda_build.CSRC_DIR / "flash_attention.cu", *map(Path, sys.argv[1:])]
    out_dir = cuda_build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(srcs)) as pool:
        # one library a version, named by its place in the list: two sources
        # of one name must not load the same file
        libs = dict(zip(map(str, srcs), pool.map(
            lambda i: _build(cuda_build, srcs[i], out_dir / f"{i}-{srcs[i].stem}.so"),
            range(len(srcs)))))

    def launch(lib, which, args, outs, shape, causal, scale):
        b, t, h, d = shape
        dtype = args[0].dtype
        fn = {"fwd": lib.znicz_flash_fwd, "dq": lib.znicz_flash_dq, "dkv": lib.znicz_flash_dkv}[which]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (*args, *outs)), b, t, h, d,
                fa.DTYPES[dtype], int(causal), float(scale), ctypes.c_void_p(stream))
        if rc:
            raise SystemExit(f"{which} launch failed with CUDA error {rc}")

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for b, t, h, d, causal in CASES:
            _check_and_time(torch, cs, fa, libs, launch, dtype, dname, b, t, h, d, causal)
    return 0


def _check_and_time(torch, cs, fa, libs, launch, dtype, dname, b, t, h, d, causal):
    """Every version checked at one case; timed in turns at the slice's."""
    tol = cs.FLASH_TOL[dname]
    q, k, v, dout, dlse = cs._flash_inputs(torch, b, t, h, d, dtype, 0)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, scale=scale)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    delta = ((dout.float() * out_r.float()).sum(-1) - dlse).contiguous()
    args = (q, k, v, dout, lse_r, delta)
    refs = (out_r, lse_r, fa.flash_dq_reference(*args, **kw),
            *fa.flash_dkv_reference(*args, **kw))
    out, lse = torch.empty_like(q), torch.empty_like(lse_r)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    shape = (b, t, h, d)
    label = f"[{b},{t},{h},{d}] {'causal' if causal else 'full'} {dname}"
    exact = ((*cs._flash_fwd_float64(torch, q, k, v, causal, scale),
              *cs._flash_bwd_float64(torch, *args, causal, scale))
             if dtype is torch.float32 else None)
    for src, lib in libs.items():
        launch(lib, "fwd", (q, k, v), (out, lse), shape, causal, scale)
        launch(lib, "dq", args, (dq,), shape, causal, scale)
        launch(lib, "dkv", args, (dk, dv), shape, causal, scale)
        torch.cuda.synchronize()
        for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dv), refs):
            cs._near(f"{name} {label} {src}", got, ref,
                     cs.FLASH_TOL["float32"] if name == "lse" else tol)
        if exact is not None:
            errs = [(float((g.double() - e).abs().max()), float((r.double() - e).abs().max()))
                    for g, r, e in zip((out, lse, dq, dk, dv), refs, exact)]
            print(f"float64 {label} {src}: "
                  + ", ".join(f"{n} kernel {ek:.3e} plain {ep:.3e} ratio {ek / ep:.2f}"
                              for n, (ek, ep) in zip(("out", "lse", "dq", "dk", "dv"), errs)))
    del exact
    if (b, t, h, d, causal) != CASES[0]:
        return
    calls = {"fwd": ((q, k, v), (out, lse)), "dq": (args, (dq,)), "dkv": (args, (dk, dv))}
    times = {src: {which: [] for which in calls} for src in libs}
    order = list(libs.items())
    for rnd in range(3):
        for src, lib in (order if rnd % 2 == 0 else order[::-1]):
            for which, (ins, outs) in calls.items():
                times[src][which].append(cs.cuda_ms(
                    lambda: launch(lib, which, ins, outs, shape, causal, scale),
                    iters=10, repeats=3))
    for src in libs:
        print(f"time {src} {label}: "
              + ", ".join(f"{which} ms {sorted(ms)}" for which, ms in times[src].items()))


if __name__ == "__main__":
    sys.exit(main())
