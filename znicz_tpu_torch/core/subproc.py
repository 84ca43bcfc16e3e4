"""Process-level task parallelism for searches and ensembles (port of
``znicz_tpu/core/subproc.py``).

Each worker process loads the workflow module fresh (the ``run(load,
main)`` two-file convention), seeds the PRNG registry from its payload,
trains, and returns a small result: full isolation, so results are
deterministic given seeds and independent of worker count or completion
order.

The worker's device is explicit, as everywhere in the port: the caller
puts its device choice into every payload, and the worker passes the
payload's ``device`` to the launcher as ``--device`` does (``"cpu"``,
``"cuda"`` or ``"tpu"``, the JAX package's spelling of the accelerator;
None is the card).  Where the JAX package re-applies the parent's platform
config in the worker (its ``_call_with_parent_platforms`` trampoline),
nothing here is global, so the payload is the one channel.

On one card the worker processes share it: each makes its own CUDA
context, and their kernels contend for the card's time and memory (no
process is locked out, as one would be from a TPU).  For concurrent
evaluations on one card, pass ``device="cpu"`` (``--device cpu``); on the
CPU each worker is a true extra core-set.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence


def _run_workflow_module(
    workflow_path: str,
    config_path: Optional[str],
    *,
    seed: Optional[int],
    stop_after: Optional[int],
    device: Optional[str] = None,
    genome: Optional[Sequence[float]] = None,
    dry_run: bool = False,
    on_load: Optional[Callable[[], None]] = None,
):
    """Load + run a workflow module the way the launcher does; returns
    (launcher, decision).  ``genome`` (optional) is applied to the config
    tree's Tune leaves after the module loads, before it runs.
    ``on_load`` runs once the workflow is built (its device in use), before
    it trains."""
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.launcher import Launcher, _load_module, make_parser

    argv = [workflow_path] + ([config_path] if config_path else [])
    if device:
        argv += ["--device", device]
    args = make_parser().parse_args(argv)
    args.random_seed = seed
    args.stop_after = stop_after
    args.dry_run = dry_run
    launcher = Launcher(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(workflow_path)))
    module = _load_module(workflow_path, "__znicz_workflow__")
    if config_path:
        _load_module(config_path, "__znicz_config__")
    if genome is not None:
        from znicz_tpu_torch.genetics import find_tunables

        tunables = find_tunables(root)
        if len(tunables) != len(genome):
            raise ValueError(
                f"worker found {len(tunables)} Tune leaves but the genome "
                f"has {len(genome)} genes; the workflow module must "
                "register its tunables at import time"
            )
        for v, (node, key, _) in zip(genome, tunables):
            node[key] = v
    box: Dict[str, Any] = {}

    def load(cls, *a, **kw):
        wf = launcher.load(cls, *a, **kw)
        if on_load is not None:
            on_load()
        return wf

    def main(**kw):
        box["decision"] = launcher.main(**kw)

    module.run(load, main)
    return launcher, box.get("decision")


def _shared_card_message(n_workers: int, n_cards: int) -> str:
    return (
        f"{n_workers} worker processes will contend for {n_cards} CUDA "
        "card(s); pass device='cpu' (--device cpu) for concurrent "
        "evaluations on a shared card"
    )


def _cards_if_initialized() -> Optional[int]:
    """The visible card count, asked only of a process whose CUDA is
    already initialized (None otherwise): warning never initializes it."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.device_count()
    # best-effort probe: a torch without CUDA support must never break
    # the run; anything else propagates
    except (AttributeError, RuntimeError, AssertionError) as e:
        import logging

        logging.getLogger(__name__).debug("shared-card probe failed: %s", e)
        return None


def _worker_warn_shared_chip(payload: Dict[str, Any]) -> None:
    """In-worker twin of :func:`warn_if_shared_accelerator` for the case
    where the PARENT never initialized CUDA (the normal CLI path).  The
    caller tags exactly one payload with ``warn_n_workers``; this runs once
    the worker's workflow is built (its own CUDA initialized by the
    build), before it trains, so the query is free."""
    n = payload.get("warn_n_workers")
    if not n or payload.get("device") == "cpu":
        return
    n_cards = _cards_if_initialized()
    if n_cards is not None and n_cards < n:
        print(f"WARNING: {_shared_card_message(n, n_cards)}", file=sys.stderr, flush=True)


def eval_genome(payload: Dict[str, Any]) -> float:
    """Worker: one genetic-search evaluation; returns fitness (lower is
    better).  Payload keys: workflow, config, seed, stop_after, device,
    genome."""
    _, dec = _run_workflow_module(
        payload["workflow"],
        payload.get("config"),
        seed=payload.get("seed"),
        stop_after=payload.get("stop_after"),
        device=payload.get("device"),
        genome=payload["genome"],
        # BEFORE the (possibly contended) run
        on_load=lambda: _worker_warn_shared_chip(payload),
    )
    if dec is None or dec.best_value is None:
        return float("inf")
    return float(dec.best_value)


def train_member(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Worker: train one ensemble member; pickles the trained params (host
    tensors: a CUDA tensor would unpickle onto the card in the parent) to
    ``payload['params_path']`` and returns {'best_value', 'params_path'}."""
    launcher, dec = _run_workflow_module(
        payload["workflow"],
        payload.get("config"),
        seed=payload.get("seed"),
        stop_after=payload.get("stop_after"),
        device=payload.get("device"),
        on_load=lambda: _worker_warn_shared_chip(payload),
    )
    params = [
        {k: v.detach().cpu() for k, v in layer.items()}
        for layer in launcher.workflow.state.params
    ]
    with open(payload["params_path"], "wb") as f:
        pickle.dump(params, f)
    return {
        "best_value": None if dec is None else dec.best_value,
        "params_path": payload["params_path"],
    }


def warn_if_shared_accelerator(n_workers: int, device) -> bool:
    """Warn when N>1 spawned workers would share fewer cards than there
    are workers; the documented recipe is device='cpu' / --device cpu for
    concurrent evaluations.  Asks torch only when this process's CUDA is
    already initialized: the parent never initializes it just to warn.
    Returns True when the warning fired (callers then skip the in-worker
    twin)."""
    if n_workers <= 1 or device == "cpu":
        return False
    n_cards = _cards_if_initialized()
    if n_cards is None or n_cards >= n_workers:
        return False
    import warnings

    warnings.warn(_shared_card_message(n_workers, n_cards), stacklevel=3)
    return True


def run_pool(fn, payloads: List[Dict[str, Any]], n_workers: int) -> list:
    """Map ``fn`` over payloads with n_workers spawned processes (order
    preserved).  n_workers<=1 still uses ONE worker process so results are
    identical to the concurrent path (fresh interpreter per evaluation
    semantics differ from in-process evaluation).  Each payload names its
    worker's device."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # spawn: CUDA cannot be forked
    ctx = multiprocessing.get_context("spawn")
    # max_tasks_per_child=1: a FRESH interpreter per evaluation, so no
    # config-tree or PRNG state leaks between evaluations sharing a worker
    with ProcessPoolExecutor(
        max_workers=max(1, n_workers), mp_context=ctx, max_tasks_per_child=1
    ) as ex:
        return list(ex.map(fn, payloads))
