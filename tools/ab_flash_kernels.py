#!/usr/bin/env python3
"""Time the bf16 flash forward, dQ and dK/dV of other versions of the CUDA source beside this tree's, in turns, on one card.

    python3 tools/ab_flash_kernels.py OTHER.cu [OTHER.cu ...]

Run from the repository root on one CUDA card; each ``OTHER.cu`` is another
version of ``znicz_tpu_torch/csrc/flash_attention.cu`` (the parent commit's,
say, unpacked with ``git archive`` into a directory ``.gitignore`` lists),
with the same C interface.  Builds this tree's source and every other one
with the flags of ``ops/kernels/cuda_build.py`` into ``build/ab/``, in
parallel; checks each version's bf16 forward (``out`` and ``lse``), dQ and
dK/dV against the plain versions (within ``chip_smoke.py``'s ``FLASH_TOL`` of
the reference's largest magnitude, ``lse`` within its f32 one) at the LM
slice's shape ``[16, 2048, 8, 64]`` causal, at D 128 with a ragged T 1000,
and without the causal mask; then times the three kernels at the
slice shape in turns (this tree first, then the others, then the reverse
order, three rounds), each turn the median of 3 x 10 launches by CUDA
events.  Prints the card's name and power limit, and each version's times
sorted.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CASES = [  # (B, T, H, D, causal); the first is timed
    (16, 2048, 8, 64, True),
    (2, 1000, 8, 128, True),
    (2, 1024, 8, 64, False),
]


def _build(cuda_build, src: Path, out: Path) -> ctypes.CDLL:
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
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
        fn = {"fwd": lib.znicz_flash_fwd, "dq": lib.znicz_flash_dq, "dkv": lib.znicz_flash_dkv}[which]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (*args, *outs)), b, t, h, d,
                fa.DTYPES[torch.bfloat16], int(causal), float(scale), ctypes.c_void_p(stream))
        if rc:
            raise SystemExit(f"{which} launch failed with CUDA error {rc}")

    tol = cs.FLASH_TOL["bfloat16"]
    for b, t, h, d, causal in CASES:
        q, k, v, dout, dlse = cs._flash_inputs(torch, b, t, h, d, torch.bfloat16, 0)
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
        for src, lib in libs.items():
            launch(lib, "fwd", (q, k, v), (out, lse), shape, causal, scale)
            launch(lib, "dq", args, (dq,), shape, causal, scale)
            launch(lib, "dkv", args, (dk, dv), shape, causal, scale)
            torch.cuda.synchronize()
            for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"),
                                      (out, lse, dq, dk, dv), refs):
                cs._near(f"{name} [{b},{t},{h},{d}] {'causal' if causal else 'full'} {src}",
                         got, ref, cs.FLASH_TOL["float32"] if name == "lse" else tol)
        if (b, t, h, d, causal) != CASES[0]:
            continue
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
            print(f"time {src} [{b},{t},{h},{d}] causal bf16: "
                  + ", ".join(f"{which} ms {sorted(ms)}" for which, ms in times[src].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
