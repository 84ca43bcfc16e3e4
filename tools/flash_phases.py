#!/usr/bin/env python3
"""chip_smoke.py's flash-attention phases alone, as its main() runs them.

Run from the repository root on a machine with one CUDA card:
``PYTHONPATH=. python3 tools/flash_phases.py``.  It builds the port's CUDA
sources and runs ``chip_smoke.py``'s phase 5 (the flash build: registers,
spills, shared memory and ``HMMA`` counts of the 30 kernels), 6 and 6b (each
kernel against its plain version, bitwise repeats, float64, negative scale,
zero-padded head dims), 7 (times at ``[16, 2048, 8, 64]`` and ``[16, 2048,
2, 256]`` beside their bound), 8 (the mid LM at 8 heads) and 35 (the mid LM
at 2 heads of 256, on phase 8's data), with the same checks, each failing
as in the script.  Prints the card's name and power limit first and the
phases' seconds last; no number is printed without a card.
"""

from __future__ import annotations

import runpy
import subprocess
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    smoke = runpy.run_path("chip_smoke.py", run_name="chip_smoke_flash_phases")
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root as troot
    from znicz_tpu_torch.models import transformer_lm
    from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build
    from znicz_tpu_torch.workflow import model as model_lib, transformer

    t_start = time.perf_counter()
    bigrams = smoke["_memoize_bigrams"](prng, transformer_lm)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    built = smoke["build_all"](cuda_build)
    smoke["phase_flash_build"](built["flash_attention"], fa, cuda_build, torch)
    smoke["phase_flash_checks"](torch, fa)
    smoke["phase_flash_inputs"](torch, fa)
    cases = {case[0]: case for case in smoke["FLASH_CASES"]}
    for tag in smoke["FLASH_TIMED"]:
        smoke["phase_flash_times"](torch, fa, cases[tag])
    smoke["phase_lm"](torch, fa, transformer_lm, transformer, model_lib, troot, prng)
    smoke["phase_lm_d256"](torch, fa, transformer_lm, transformer, model_lib, troot, prng,
                           bigrams, smi)
    print(f"flash_phases: phases 5-8 and 35 passed in {time.perf_counter() - t_start:.1f} s "
          f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
