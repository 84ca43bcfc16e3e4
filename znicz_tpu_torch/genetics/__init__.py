"""Genetic hyperparameter optimization (port of ``znicz_tpu/genetics``).

Mark tunables with :class:`Tune` in the config tree and run ``python -m
znicz_tpu_torch workflow.py config.py --optimize <gens>``.  Evaluations run
in-process sequentially (each builds a fresh workflow), or in spawned
worker processes (``n_workers``); the fitness is the Decision's best
validation value (lower is better).  The GA is pure Python over the named
numpy streams of :mod:`znicz_tpu_torch.core.prng`, which draw what the JAX
package's do: the same seed and the same fitness function give the JAX
package's history and best genome exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import Config, root
from znicz_tpu_torch.core.logger import Logger


class Tune:
    """A config leaf marked for optimization: value in [min, max].

    ``kind``: "float" or "int" (reference Range semantics).
    """

    def __init__(self, default, min_value, max_value, kind: str = "float"):
        self.default = default
        self.min = min_value
        self.max = max_value
        self.kind = kind

    def clip(self, v):
        v = max(self.min, min(self.max, v))
        return int(round(v)) if self.kind == "int" else float(v)

    def __repr__(self):
        return f"Tune({self.default}, [{self.min}, {self.max}])"


def find_tunables(node: Config, path: str = "") -> List[Tuple[Config, str, Tune]]:
    """Walk the config tree collecting Tune leaves (node, key, tune)."""
    out = []
    for key, value in node.items():
        here = f"{path}.{key}" if path else key
        if isinstance(value, Tune):
            out.append((node, key, value))
        elif isinstance(value, Config):
            out.extend(find_tunables(value, here))
        elif isinstance(value, list):
            for i, item in enumerate(value):
                if isinstance(item, dict):
                    out.extend(_find_in_dict(item, f"{here}[{i}]"))
    return out


def _find_in_dict(d: Dict[str, Any], path: str):
    out = []
    for key, value in d.items():
        here = f"{path}.{key}"
        if isinstance(value, Tune):
            out.append((d, key, value))
        elif isinstance(value, dict):
            out.extend(_find_in_dict(value, here))
        elif isinstance(value, list):
            for i, item in enumerate(value):
                if isinstance(item, dict):
                    out.extend(_find_in_dict(item, f"{here}[{i}]"))
    return out


class GeneticOptimizer(Logger):
    """Small real-valued GA: tournament selection, blend crossover, gaussian
    mutation, elitism — the reference's chromosome ops in spirit."""

    def __init__(
        self,
        evaluate,  # genome: List[float] -> fitness (lower better)
        tunables: List[Tuple[Any, str, Tune]],
        *,
        population_size: int = 8,
        mutation_rate: float = 0.3,
        elite: int = 2,
        rand_name: str = "genetics",
        evaluate_batch=None,  # genomes: List[List[float]] -> List[float]
    ):
        """``evaluate_batch``: optional concurrent evaluator for a whole
        uncached generation (the worker pool of :func:`optimize_workflow`);
        falls back to ``evaluate`` per genome when absent.  Results must not depend on
        completion order — the GA consumes them positionally."""
        if not tunables:
            raise ValueError(
                "no Tune leaves found in the config tree; mark hyperparams "
                "with znicz_tpu_torch.genetics.Tune to use --optimize"
            )
        if evaluate is None and evaluate_batch is None:
            raise ValueError("need evaluate or evaluate_batch")
        self.evaluate = evaluate
        self.evaluate_batch = evaluate_batch
        self.tunables = tunables
        self.population_size = population_size
        self.mutation_rate = mutation_rate
        self.elite = elite
        self.gen = prng.get(rand_name)
        self.history: List[Dict[str, Any]] = []

    # -- genome helpers ---------------------------------------------------
    def _random_genome(self) -> List[float]:
        return [
            t.clip(self.gen.uniform((), t.min, t.max).item())
            for _, _, t in self.tunables
        ]

    def _default_genome(self) -> List[float]:
        return [t.clip(t.default) for _, _, t in self.tunables]

    def _mutate(self, genome: List[float]) -> List[float]:
        out = []
        for v, (_, _, t) in zip(genome, self.tunables):
            if self.gen.uniform((), 0.0, 1.0).item() < self.mutation_rate:
                span = (t.max - t.min) * 0.2
                v = t.clip(v + self.gen.normal((), 0.0, span).item())
            out.append(v)
        return out

    def _crossover(self, a: List[float], b: List[float]) -> List[float]:
        alpha = self.gen.uniform((), 0.0, 1.0).item()
        return [
            t.clip(alpha * x + (1 - alpha) * y)
            for x, y, (_, _, t) in zip(a, b, self.tunables)
        ]

    def _tournament(self, scored) -> List[float]:
        i, j = (
            int(self.gen.integers(0, len(scored))),
            int(self.gen.integers(0, len(scored))),
        )
        return scored[min(i, j)][1]  # scored is sorted: lower idx = fitter

    # -- main loop --------------------------------------------------------
    def run(self, generations: int) -> Dict[str, Any]:
        population = [self._default_genome()] + [
            self._random_genome() for _ in range(self.population_size - 1)
        ]
        best = None
        fitness_cache: Dict[tuple, float] = {}

        def fitness(genome: List[float]) -> float:
            # an evaluation is a full training run: never re-train elites
            # or duplicate children
            key = tuple(genome)
            if key not in fitness_cache:
                fitness_cache[key] = self.evaluate(genome)
            return fitness_cache[key]

        for g in range(generations):
            if self.evaluate_batch is not None:
                # evaluate the whole uncached slice of this generation
                # concurrently (deduplicated, order-stable)
                pending = list(
                    dict.fromkeys(
                        tuple(genome)
                        for genome in population
                        if tuple(genome) not in fitness_cache
                    )
                )
                if pending:
                    results = self.evaluate_batch(
                        [list(key) for key in pending]
                    )
                    fitness_cache.update(zip(pending, results))
            scored = sorted(
                (fitness(genome), genome) for genome in population
            )
            if best is None or scored[0][0] < best[0]:
                best = scored[0]
            self.history.append(
                {"generation": g, "best_fitness": scored[0][0]}
            )
            self.info(
                "generation %d: best=%.6g worst=%.6g",
                g, scored[0][0], scored[-1][0],
            )
            nxt = [genome for _, genome in scored[: self.elite]]
            while len(nxt) < self.population_size:
                child = self._crossover(
                    self._tournament(scored), self._tournament(scored)
                )
                nxt.append(self._mutate(child))
            population = nxt
        return {"best_fitness": best[0], "best_genome": best[1]}

    def apply_genome(self, genome: List[float]) -> None:
        for v, (node, key, _) in zip(genome, self.tunables):
            node[key] = v


def optimize_workflow(
    module,
    launcher,
    *,
    generations: int,
    tunables=None,
    n_workers: int = 0,
    **ga_kwargs,
):
    """Drive ``--optimize``: evolve the Tune leaves of the config tree by
    repeatedly building + training the module's workflow.

    ``tunables``: pass a pre-collected ``find_tunables(root)`` result when
    the caller ran anything (e.g. an export probe) that may have
    materialized extra Tune copies into the tree since startup.

    ``n_workers`` >= 1 evaluates each generation in spawned worker
    processes — every evaluation gets a fresh interpreter seeded from
    ``--random-seed``, so results are deterministic given seeds and
    IDENTICAL for any worker count.  0 (default) keeps the in-process
    sequential path.  The workers run on the launcher's ``--device``; on
    one card they share it (contention), so run a concurrent search with
    ``--device cpu``.
    """
    if tunables is None:
        tunables = find_tunables(root)

    def evaluate(genome) -> float:
        for v, (node, key, _) in zip(genome, tunables):
            node[key] = v
        result_box = {}

        def load(cls, *a, **kw):
            return launcher.load(cls, *a, **kw)

        def main(**kw):
            result_box["decision"] = launcher.main(**kw)

        module.run(load, main)
        dec = result_box.get("decision")
        if dec is None or dec.best_value is None:
            return float("inf")
        return float(dec.best_value)

    evaluate_batch = None
    if n_workers >= 1:
        from znicz_tpu_torch.core.subproc import (
            eval_genome,
            run_pool,
            warn_if_shared_accelerator,
        )

        args = launcher.args
        # one contention warning per SEARCH: parent-side if its CUDA is
        # already initialized, else the first worker of the first generation
        parent_warned = warn_if_shared_accelerator(n_workers, args.device)
        pending_worker_warn = not parent_warned and n_workers > 1

        def evaluate_batch(genomes):
            payloads = [
                {
                    "workflow": args.workflow,
                    "config": args.config,
                    "seed": args.random_seed,
                    "stop_after": args.stop_after,
                    "device": args.device,
                    "genome": genome,
                }
                for genome in genomes
            ]
            nonlocal pending_worker_warn
            if payloads and pending_worker_warn:
                # first worker of the first generation checks contention
                # once ITS CUDA is up (the parent may never initialize it)
                pending_worker_warn = False
                payloads[0]["warn_n_workers"] = n_workers
            return run_pool(eval_genome, payloads, n_workers)

        evaluate = None  # all evaluations go through the worker pool

    optimizer = GeneticOptimizer(
        evaluate, tunables, evaluate_batch=evaluate_batch, **ga_kwargs
    )
    result = optimizer.run(generations)
    optimizer.apply_genome(result["best_genome"])  # leave best config applied
    optimizer.info(
        "optimize done: best fitness %.6g with %s",
        result["best_fitness"],
        {
            f"{getattr(n, '_config_path_', '?')}.{k}": v
            for v, (n, k, _) in zip(result["best_genome"], tunables)
        },
    )
    result["history"] = optimizer.history
    return result
