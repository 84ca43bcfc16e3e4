#!/usr/bin/env python3
"""What data parallelism costs AlexNet's train step on one card, by part.

Run from the repository root on a machine with one CUDA card:
``PYTHONPATH=. python3 tools/dp_step_cost.py``.  It makes a one-rank NCCL
group (``multihost.initialize`` at a free localhost port) and prints, beside
the card's name and power limit:

- the host time of ``DataParallel.all_reduce`` on 1 and on 61 M floats
  (AlexNet's gradients), with the card idle and with ~2.5 ms of matrix
  products queued before it (median of 10);
- AlexNet's train step (``chip_smoke.py`` phase 4's stand-in: batch 128,
  bf16, 227x227, 1000 classes) with and without the policy, in turns: the
  host's ms to issue a step and then its wait for the card (medians of 20
  synchronised steps after 3 warm-up);
- each ``all_reduce`` call's host ms inside the policy's step (the count of
  valid rows, then the flattened gradients).

The group is destroyed at the end.  No number is printed without a card.
"""

from __future__ import annotations

import socket
import statistics
import subprocess
import sys
import time

TURNS = ("plain", "dp", "dp", "plain", "plain", "dp")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dp_step_cost: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.parallel import DataParallel, make_mesh, multihost

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        dp = DataParallel(make_mesh())
        a = torch.randn(4096, 4096, device="cuda")
        for n in (1, 61_000_000):
            t = torch.zeros(n, device="cuda")
            dp.all_reduce([t])
            torch.cuda.synchronize()
            for busy in (False, True):
                host = []
                for _ in range(10):
                    if busy:
                        for _ in range(20):  # ~2.5 ms of queued work
                            a = a @ a * 1e-3
                    t0 = time.perf_counter()
                    dp.all_reduce([t])
                    host.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                print(f"all_reduce of {n} f32, card {'busy' if busy else 'idle'}: host ms "
                      f"median {statistics.median(host):.4f} of {[round(h, 4) for h in host]}")
        wfs = {}
        for key in ("plain", "dp"):
            prng.seed_all(1234)
            wfs[key] = alexnet.build_workflow(device="cuda",
                                              **({"parallel": dp} if key == "dp" else {}))
            wfs[key].initialize(seed=1234)
        mb = next(iter(wfs["plain"].loader.batches("train", shuffle=False)))
        x, y, m = (torch.as_tensor(v, device="cuda") for v in (mb.data, mb.labels, mb.mask))
        for key in TURNS:
            wf = wfs[key]
            for _ in range(3):
                wf.train_step(x, y, m)
            torch.cuda.synchronize()
            issue, wait = [], []
            for _ in range(20):
                t0 = time.perf_counter()
                wf.train_step(x, y, m)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                issue.append((t1 - t0) * 1e3)
                wait.append((time.perf_counter() - t1) * 1e3)
            print(f"alexnet {key}: host ms to issue a step median {statistics.median(issue):.3f}, "
                  f"then the wait for the card {statistics.median(wait):.3f}; wall median "
                  f"{statistics.median([i + w for i, w in zip(issue, wait)]):.3f}")
        calls = []
        reduce = dp.all_reduce

        def timed(tensors, op="sum"):
            t0 = time.perf_counter()
            out = reduce(tensors, op)
            calls.append((sum(t.numel() for t in tensors), (time.perf_counter() - t0) * 1e3))
            return out

        dp.all_reduce = timed
        for _ in range(10):
            wfs["dp"].train_step(x, y, m)
        torch.cuda.synchronize()
        print("all_reduce calls in the policy's last 3 steps (numel, host ms): "
              + str([(n, round(ms, 4)) for n, ms in calls[-6:]]))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
