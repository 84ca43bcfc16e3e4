"""Ensemble training: N model instances, aggregated evaluation (port of
``znicz_tpu/ensemble``).

Two modes: :class:`Ensemble` trains in-process sequentially from a
``build_fn`` (each member gets its own derived seed), and
:func:`train_from_module` trains members CONCURRENTLY in spawned worker
processes from a workflow-module path, deterministic given seeds and
independent of worker count.  Predictions aggregate by mean probability or
majority vote; each member's forward is ``model.predict`` on the
workflow's device (on the card, through the hand kernels of its layers).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.logger import Logger


def _member_predict(wf, x) -> torch.Tensor:
    """One member's ``model.predict`` of the batch ``x`` (host array or
    tensor) on its workflow's device, after the loader's device
    preprocessing (the step's view of a batch)."""
    x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=wf.device)
    x = wf._prep(x, None)[0]
    with torch.no_grad():
        return wf.model.predict(wf.state.params, x)


class Ensemble(Logger):
    """Train ``n_models`` workflows built by ``build_fn()`` and aggregate.

    ``build_fn``: zero-arg callable returning a fresh (un-initialized)
    workflow with a ``model`` attribute (StandardWorkflow-style).
    """

    def __init__(
        self,
        build_fn: Callable[[], object],
        n_models: int = 5,
        *,
        base_seed: int = 1234,
    ):
        self.build_fn = build_fn
        self.n_models = n_models
        self.base_seed = base_seed
        self.workflows: List[object] = []
        self.decisions: List[object] = []

    def train(self, seeds: Optional[Sequence[int]] = None) -> List[object]:
        seeds = list(seeds) if seeds else [
            self.base_seed + 1000 * i for i in range(self.n_models)
        ]
        self.workflows, self.decisions = [], []
        # Members must differ by init/shuffle, NOT by task: pin the
        # "datasets" stream to one position for every build (a full
        # seed_all would hand each member a different synthetic dataset),
        # and reseed only the model-side streams per member.
        datasets_state = prng.get("datasets").state_dict()
        for i, seed in enumerate(seeds):
            # Reseed EVERY stream — including custom rand_name streams that
            # build_fn will only register DURING the build: seed_all sets the
            # global seed, so late-created generators derive member-specific
            # defaults too.  "datasets" is then re-pinned so all members
            # share one task (they must differ by init, not by data).
            prng.seed_all(seed)
            prng.get("datasets").load_state_dict(datasets_state)
            wf = self.build_fn()
            wf.initialize()
            dec = wf.run()
            self.info(
                "member %d/%d (seed %d): best=%s",
                i + 1, len(seeds), seed, dec.best_value,
            )
            self.workflows.append(wf)
            self.decisions.append(dec)
        return self.decisions

    # -- aggregation -------------------------------------------------------
    def predict_proba(self, x) -> torch.Tensor:
        """Mean class probability over members (softmax-headed models), on
        the first member's device."""
        if not self.workflows:
            raise RuntimeError("train() first")
        probs = [_member_predict(wf, x) for wf in self.workflows]
        return torch.mean(torch.stack(probs), dim=0)

    def predict(self, x, *, vote: str = "soft") -> np.ndarray:
        """``soft``: argmax of mean probs; ``hard``: majority vote."""
        if vote == "soft":
            return torch.argmax(self.predict_proba(x), dim=1).cpu().numpy()
        votes = np.stack(
            [
                torch.argmax(_member_predict(wf, x), dim=1).cpu().numpy()
                for wf in self.workflows
            ]
        )  # [n_models, batch]
        n_classes = int(votes.max()) + 1
        counts = np.apply_along_axis(
            lambda col: np.bincount(col, minlength=n_classes), 0, votes
        )
        return counts.argmax(axis=0)

    def evaluate(self, split: str = "test") -> dict:
        """Aggregate error rate of the ensemble vs. the mean member.

        Each member's forward runs ONCE per batch; the ensemble vote and
        the per-member errors both derive from those probabilities.
        """
        loader = self.workflows[0].loader
        n_err, n, member_errs = 0, 0, np.zeros(len(self.workflows))
        # shuffle=False: evaluation must not advance the shuffle PRNG stream
        for mb in loader.batches(split, shuffle=False):
            valid = mb.mask > 0
            labels = mb.labels[valid]
            probs = [_member_predict(wf, mb.data).to("cpu", torch.float32).numpy()
                     for wf in self.workflows]
            ens_pred = np.mean(probs, axis=0).argmax(axis=1)[valid]
            n_err += int((ens_pred != labels).sum())
            n += int(valid.sum())
            for i, p in enumerate(probs):
                member_errs[i] += (p.argmax(axis=1)[valid] != labels).sum()
        return {
            "n_samples": n,
            "ensemble_err_pct": 100.0 * n_err / max(n, 1),
            "mean_member_err_pct": float(
                100.0 * member_errs.mean() / max(n, 1)
            ),
        }


def train_from_module(
    workflow_path: str,
    *,
    config_path: Optional[str] = None,
    n_models: int = 5,
    base_seed: int = 1234,
    n_workers: int = 1,
    stop_after: Optional[int] = None,
    device: Optional[str] = None,
) -> Ensemble:
    """Train ``n_models`` members of a workflow module concurrently in
    ``n_workers`` spawned processes.  Member i trains with seed
    ``base_seed + 1000*i`` in a fresh interpreter, so the result is
    deterministic given seeds and identical for every ``n_workers``.
    Returns a fitted :class:`Ensemble` whose members share the parent's
    workflow (model/loader) but carry their own trained params —
    ``predict``/``evaluate`` work as usual.

    ``device`` is the workers' and the aggregation scaffold's (the
    launcher's ``--device``: ``"cpu"``, ``"cuda"``; None is the card).
    On one card the workers share it (contention): pass ``device="cpu"``
    for concurrent members there.
    """
    import pickle
    import tempfile

    from znicz_tpu_torch.core.subproc import (
        _run_workflow_module,
        run_pool,
        train_member,
        warn_if_shared_accelerator,
    )

    parent_warned = warn_if_shared_accelerator(n_workers, device)
    seeds = [base_seed + 1000 * i for i in range(n_models)]
    with tempfile.TemporaryDirectory(prefix="znicz_ens_") as tmp:
        payloads = [
            {
                "workflow": workflow_path,
                "config": config_path,
                "seed": seed,
                "stop_after": stop_after,
                "device": device,
                "params_path": f"{tmp}/member_{i}.params",
            }
            for i, seed in enumerate(seeds)
        ]
        if payloads and n_workers > 1 and not parent_warned:
            # first worker checks contention once ITS CUDA is up (the
            # parent may never initialize it)
            payloads[0]["warn_n_workers"] = n_workers
        results = run_pool(train_member, payloads, n_workers)
        member_params = []
        for r in results:
            with open(r["params_path"], "rb") as f:
                member_params.append(pickle.load(f))
    # build the aggregation scaffold in-process (dry run: model + loader,
    # no training) on the caller's device, and place each member's trained
    # params (host tensors) there
    launcher, _ = _run_workflow_module(
        workflow_path, config_path,
        seed=base_seed, stop_after=stop_after, device=device,
        dry_run=True,
    )
    wf = launcher.workflow

    def _no_rebuild():
        raise RuntimeError(
            "this Ensemble's members were trained out-of-process; "
            "re-train via ensemble.train_from_module(...), not .train()"
        )

    ens = Ensemble(_no_rebuild, n_models=n_models, base_seed=base_seed)
    ens.workflows = [
        SimpleNamespace(
            model=wf.model,
            loader=wf.loader,
            device=wf.device,
            _prep=wf._prep,
            state=SimpleNamespace(params=[
                {k: v.to(wf.device) for k, v in layer.items()} for layer in params
            ]),
        )
        for params in member_params
    ]
    ens.decisions = [
        SimpleNamespace(best_value=r["best_value"]) for r in results
    ]
    for i, (seed, r) in enumerate(zip(seeds, results)):
        ens.info(
            "member %d/%d (seed %d): best=%s", i + 1, n_models, seed,
            r["best_value"],
        )
    return ens
