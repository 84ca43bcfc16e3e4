"""Launcher / CLI (port of ``znicz_tpu/launcher.py``).

``python -m znicz_tpu_torch <workflow.py> [config.py] --flags`` loads the
workflow module, applies the config module's ``root`` overrides, then
drives the module's ``run(load, main)`` convention: the JAX package's
two-file UX, with its flags and their defaults.

  --device        ``cuda`` (the card), ``cpu``, or ``tpu``: the JAX
                  package's spelling of "the accelerator", which means the
                  card here, so its command lines run unchanged.  Without
                  the flag the workflow gets no ``device=`` and runs on the
                  card, raising where there is none; nothing falls back to
                  the CPU.  ``--device cpu`` passes ``device="cpu"`` to the
                  workflow's builder and, with a coordinator, makes the
                  process group gloo.
  --random-seed   seeds the named PRNG registry
  --snapshot      resume from a snapshot file
  --snapshot-dir  where snapshots are written
  --data-parallel shard the batch over the job's processes (one device each)
  --optimize      genetic hyperparameter search: not ported yet (ROADMAP.md
                  A11); it and ``--optimize-workers`` raise

Self-healing: ``--resume auto`` resumes from the newest VALID snapshot in
``--snapshot-dir`` (corrupt files skipped) or starts fresh;
``--supervise`` runs the training command as a supervised child process
(``python -m znicz_tpu_torch ...``) and restarts it on crash with
exponential backoff under a ``--max-restarts`` budget, each restart
resuming via ``--resume auto``; SIGTERM/SIGINT drain the in-flight step,
write an emergency snapshot and exit with ``EXIT_PREEMPTED`` (75).

Exit codes: 0 done; 75 gracefully preempted (emergency snapshot
written — resume me); anything else: crash (the supervisor restarts
while its budget lasts, then exits with the child's last code).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger, setup_logging

# re-exported convenience: the documented graceful-preemption exit code
from znicz_tpu_torch.workflow.recovery import EXIT_PREEMPTED  # noqa: F401

# supervisor-only flags, stripped from the child's argv (flag -> has value)
_SUPERVISOR_FLAGS = {
    "--supervise": False,
    "--max-restarts": True,
    "--restart-backoff": True,
}

# --device -> the workflow's device= ("tpu" is the JAX package's spelling
# of the accelerator: the card here)
_DEVICES = {"cuda": "cuda", "tpu": "cuda", "cpu": "cpu"}


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load module from {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch",
        description="VELES/Znicz on PyTorch and CUDA: run a workflow module",
        # no prefix abbreviation: the supervisor strips its own flags
        # from the child argv by EXACT spelling — an abbreviated
        # --super reaching the child would recurse into a nested
        # supervisor chain
        allow_abbrev=False,
    )
    p.add_argument("workflow", help="path to the workflow module (.py)")
    p.add_argument(
        "config", nargs="?", default=None,
        help="optional config module mutating znicz_tpu_torch.root",
    )
    p.add_argument("--device", default=None, choices=["cuda", "cpu", "tpu"],
                   help="the workflow's device: cuda (or tpu, the JAX "
                        "package's spelling of the accelerator) for the "
                        "card, cpu for the CPU (default: the card, raising "
                        "without one)")
    p.add_argument("--random-seed", type=int, default=None)
    p.add_argument("--snapshot", default=None,
                   help="resume training from this snapshot file")
    p.add_argument("--resume", default=None, choices=["auto"],
                   metavar="MODE",
                   help="'auto': resume from the newest VALID snapshot "
                        "in --snapshot-dir (corrupt/truncated files are "
                        "skipped), or start fresh when none exists; "
                        "overrides --snapshot")
    p.add_argument("--supervise", action="store_true",
                   help="run training as a supervised child process: "
                        "restart it on crash with exponential backoff "
                        "(resuming via --resume auto), forward "
                        "SIGTERM/SIGINT, record restart history in "
                        "supervisor.json")
    p.add_argument("--max-restarts", type=int, default=3, metavar="N",
                   help="supervisor restart budget (default 3); past it "
                        "the supervisor exits with the child's last code")
    p.add_argument("--restart-backoff", type=float, default=1.0,
                   metavar="SECONDS",
                   help="initial restart backoff, doubled per restart "
                        "and capped at 60s (default 1.0; 0 disables)")
    p.add_argument("--snapshot-interval", type=int, default=None,
                   metavar="K",
                   help="also snapshot every K epochs (composes with "
                        "best-model snapshots in both epoch-sync modes)")
    p.add_argument("--snapshot-dir", default=None,
                   help="write snapshots under this directory")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard batches over the job's processes (one "
                        "device each)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="device mesh spec, e.g. data=4,model=2 — shards "
                        "batches over 'data' and weights over 'model' "
                        "(tensor parallel); implies --data-parallel")
    # multi-process bring-up: every process runs the SAME command with its
    # own --process-id; the coordinator address is the rendezvous, not a
    # data channel
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process rendezvous address "
                        "(torch.distributed); under torchrun omit all three "
                        "flags — its variables are read")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="dataset directory for the workflow's loader "
                        "(sets root.common.data_dir; model modules fall "
                        "back to it when their loader config has none)")
    p.add_argument("--stop-after", type=int, default=None, metavar="EPOCHS",
                   help="override the workflow's max_epochs")
    p.add_argument("--optimize", type=int, default=None, metavar="GENS",
                   help="genetic hyperparameter search for N generations "
                        "(not ported yet: ROADMAP.md A11)")
    p.add_argument("--optimize-workers", type=int, default=0, metavar="N",
                   help="evaluate each generation in N spawned worker "
                        "processes (reference: concurrent workflow "
                        "instances); deterministic given --random-seed and "
                        "independent of N. Combine with --device cpu on a "
                        "single shared accelerator (not ported yet: "
                        "ROADMAP.md A11)")
    p.add_argument("--export", default=None, metavar="MODEL.znicz",
                   help="after training, export the model for the native "
                        "inference engine (native/znicz_infer)")
    p.add_argument("--evaluate", nargs="?", const="test", default=None,
                   metavar="SPLIT",
                   help="evaluation-only mode (reference test runs): build "
                        "the workflow, restore --snapshot if given, run one "
                        "evaluation pass over SPLIT (default: test) with the "
                        "confusion matrix, print a JSON summary and exit "
                        "without training")
    p.add_argument("--epoch-sync", default=None,
                   choices=["sync", "deferred"],
                   help="deferred: overlap the per-epoch metric fetch with "
                        "the next epoch's dispatch (verdicts lag one epoch; "
                        "stop decisions stay exact; best-model snapshots "
                        "write from a retained one-epoch buffer)")
    p.add_argument("--dry-run", action="store_true",
                   help="build and initialize the workflow, run nothing")
    p.add_argument("--verbose", action="store_true")
    return p


class Launcher(Logger):
    """Owns CLI args; hands the workflow module its ``load``/``main`` pair."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.workflow = None
        self.result = None

    # -- the module-facing convention (reference run(load, main)) ---------
    def load(self, workflow_cls, *wf_args, **wf_kwargs):
        """Construct the workflow, applying CLI overrides (``--device``
        as ``device=``: ``"cuda"`` for ``cuda`` and ``tpu``)."""
        if self.args.device and "device" not in wf_kwargs:
            wf_kwargs["device"] = _DEVICES[self.args.device]
        if self.args.snapshot_dir and "snapshot_dir" not in wf_kwargs:
            wf_kwargs["snapshot_dir"] = self.args.snapshot_dir
        if getattr(self.args, "snapshot_interval", None):
            sc = dict(wf_kwargs.get("snapshot_config") or {})
            sc.setdefault("interval", self.args.snapshot_interval)
            wf_kwargs["snapshot_config"] = sc
        if (
            getattr(self.args, "epoch_sync", None)
            and "epoch_sync" not in wf_kwargs
        ):
            wf_kwargs["epoch_sync"] = self.args.epoch_sync
        if self.args.stop_after is not None:
            dc = dict(wf_kwargs.get("decision_config") or {})
            dc["max_epochs"] = self.args.stop_after
            wf_kwargs["decision_config"] = dc
        if (
            self.args.data_parallel or getattr(self.args, "mesh", None)
        ) and "parallel" not in wf_kwargs:
            import inspect

            from znicz_tpu_torch.parallel import (
                MODEL_AXIS,
                DataParallel,
                make_mesh,
                mesh_from_spec,
            )
            from znicz_tpu_torch.parallel.mesh import axis_size

            # the mesh places on the workflow's device: --device cpu keeps
            # it on the CPU where a card is visible too
            device = "cpu" if self.args.device == "cpu" else None
            if getattr(self.args, "mesh", None):
                mesh = mesh_from_spec(self.args.mesh, device=device)
                dp = DataParallel(mesh, tp=axis_size(mesh, MODEL_AXIS) > 1)
            else:
                dp = DataParallel(make_mesh(device=device))
            # Signature check (not try/except TypeError): an unrelated
            # TypeError raised inside the constructor must propagate, not
            # silently retry without DP.
            try:
                sig = inspect.signature(workflow_cls)
                accepts = "parallel" in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in sig.parameters.values()
                )
                # A module may already pass `parallel` positionally; its
                # explicit choice wins over the CLI default — injecting the
                # kwarg would raise "multiple values for 'parallel'".
                try:
                    bound = sig.bind(*wf_args, **wf_kwargs)
                    if "parallel" in bound.arguments:
                        self.workflow = workflow_cls(*wf_args, **wf_kwargs)
                        return self.workflow
                # bind failure: let the real constructor report it
                except TypeError:
                    pass
            except (TypeError, ValueError):  # C callables, odd metaclasses
                accepts = True
            if accepts:
                self.workflow = workflow_cls(
                    *wf_args, **{**wf_kwargs, "parallel": dp}
                )
            else:
                # user workflows predating the kwarg: attribute assignment
                # before initialize() has identical semantics
                self.workflow = workflow_cls(*wf_args, **wf_kwargs)
                self.workflow.parallel = dp
            return self.workflow
        self.workflow = workflow_cls(*wf_args, **wf_kwargs)
        return self.workflow

    def _resolve_auto_resume(self, exclude=()):
        """``--resume auto`` -> the newest valid snapshot path (or None
        for a fresh start).  Resolved HERE, once the workflow exists,
        so the search is scoped to the workflow's own snapshot prefix —
        a shared directory must never hand back another model's
        checkpoint (a shape-mismatch crash loop under --supervise)."""
        from znicz_tpu_torch.workflow.snapshotter import find_latest_valid

        snapshotter = getattr(self.workflow, "snapshotter", None)
        directory = self.args.snapshot_dir or getattr(
            snapshotter, "directory", None
        )
        if not directory:
            raise SystemExit(
                "--resume auto needs --snapshot-dir (or a workflow "
                "snapshotter) to know where to look"
            )
        found = find_latest_valid(
            directory,
            prefix=getattr(snapshotter, "prefix", None),
            exclude=exclude,
        )
        if found:
            self.info("--resume auto: resuming from %s", found)
        else:
            self.info(
                "--resume auto: no valid snapshot under %s; starting "
                "fresh", directory,
            )
        return found

    def _initialize_with_auto_resume(self, **kwargs) -> None:
        """Initialize, quarantining auto-resolved snapshots that pass
        verification (a digest check) but still fail to LOAD — e.g. a
        pickle referencing a since-renamed class.  Falling through to
        the next older snapshot keeps ``--supervise`` from burning its
        whole restart budget on one bad file."""
        from znicz_tpu_torch.workflow.snapshotter import SnapshotCorruptError

        tried: set = set()
        while True:
            self.args.snapshot = self._resolve_auto_resume(exclude=tried)
            try:
                self.workflow.initialize(
                    seed=self.args.random_seed,
                    snapshot=self.args.snapshot,
                    **kwargs,
                )
                return
            except (SnapshotCorruptError, ValueError):
                if not self.args.snapshot:
                    raise  # a fresh start failed: not a snapshot issue
                self.logger.exception(
                    "--resume auto: %s failed to load; trying an "
                    "older snapshot", self.args.snapshot,
                )
                tried.add(self.args.snapshot)

    def main(self, **kwargs):
        """Initialize and run the loaded workflow."""
        if self.workflow is None:
            raise RuntimeError("run(load, main): call load(...) before main()")
        if self.args.export:
            # fail BEFORE training, not after hours of it: class AND layer
            # types must be native-engine compatible
            from znicz_tpu_torch.export import validate_exportable

            if not hasattr(self.workflow.model, "_replace"):
                raise SystemExit(
                    "--export supports layer-list models (StandardWorkflow); "
                    f"{type(self.workflow).__name__} has no exportable model"
                )
            try:
                validate_exportable(self.workflow.model)
            except ValueError as e:
                raise SystemExit(f"--export: {e}") from None
        if self.args.resume == "auto":
            self._initialize_with_auto_resume(**kwargs)
        else:
            self.workflow.initialize(
                seed=self.args.random_seed, snapshot=self.args.snapshot,
                **kwargs,
            )
        if (
            getattr(self.workflow, "snapshotter", None) is not None
            and hasattr(self.workflow, "enable_emergency_snapshots")
            and not (self.args.dry_run or self.args.evaluate)
        ):
            # CLI runs own their process and have the SIGTERM/SIGINT
            # handlers installed: retain each epoch's start state so a
            # mid-epoch preemption snapshots consistently
            self.workflow.enable_emergency_snapshots()
        if self.args.dry_run:
            self.info("dry run: workflow initialized, skipping run()")
            return None
        if self.args.evaluate:
            import json

            import numpy as np

            split = self.args.evaluate
            try:
                # Workflow.evaluate rejects empty/misspelled splits (a
                # zero-sample evaluation would print a perfect score)
                result = self.workflow.evaluate(split, confusion=True)
            except ValueError as e:
                raise SystemExit(f"--evaluate: {e}") from None
            conf = result.pop("confusion", None)
            if conf is not None:
                result["confusion"] = np.asarray(conf).tolist()
            result["split"] = split
            print(json.dumps(result))
            self.result = result
            self._maybe_export()  # a restored model exports w/o training
            return self.result
        self.result = self.workflow.run()
        self._maybe_export()
        return self.result

    def _maybe_export(self) -> None:
        """Write the trained master params (whole tensors: model-sharded
        leaves are gathered, a collective every rank takes part in) for the
        native engine; the coordinator writes the file."""
        if not self.args.export:
            return
        from znicz_tpu_torch.export import export_model
        from znicz_tpu_torch.parallel import multihost

        params = self.workflow.snapshot_state()[0]
        if not multihost.is_coordinator():
            return
        export_model(self.workflow.model._replace(params=params), self.args.export)
        self.info("exported trained model to %s", self.args.export)


def _child_argv(argv) -> list:
    """The supervised child's argv: the supervisor's own flags stripped,
    everything else (including ``--resume auto``, so every restart
    re-resolves the newest valid snapshot) passed through."""
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        base = a.split("=", 1)[0]
        if base in _SUPERVISOR_FLAGS:
            i += 2 if _SUPERVISOR_FLAGS[base] and "=" not in a else 1
            continue
        out.append(a)
        i += 1
    return out


def _atomic_json(path: str, obj) -> None:
    from znicz_tpu_torch.services.web_status import _atomic_write

    _atomic_write(path, json.dumps(obj, indent=2))


def supervise(args: argparse.Namespace, argv) -> int:
    """The supervised auto-resume loop.

    Runs ``python -m znicz_tpu_torch <argv minus supervisor flags>`` as a
    child; exit 0 ends the run, a crash restarts it with exponential
    backoff while the ``--max-restarts`` budget lasts (each child gets
    ``ZNICZ_RESTARTS``/``ZNICZ_RESTART_BUDGET`` in its environment so
    its own ``/metrics`` carries ``znicz_train_restarts_total``), and a
    SIGTERM/SIGINT to the supervisor is forwarded to the child — whose
    graceful exit code (75) is then passed through instead of counting
    as a crash.  A child that exits 75 WITHOUT the supervisor being
    signalled (an externally-preempted child) is restarted like a
    crash: that is the auto-resume.  Restart history is written to
    ``supervisor.json`` next to the snapshots."""
    log = Logger()
    if args.resume != "auto" and not args.snapshot:
        log.warning(
            "--supervise without --resume auto: a restarted child "
            "starts FRESH instead of resuming from the newest snapshot"
        )
    child_cmd = [sys.executable, "-m", "znicz_tpu_torch"] + _child_argv(argv)
    history: list = []
    state = {"proc": None, "signalled": None}
    history_dir = args.snapshot_dir or "."
    os.makedirs(history_dir, exist_ok=True)
    history_path = os.path.join(history_dir, "supervisor.json")

    def _forward(signum, frame):
        state["signalled"] = signum
        proc = state["proc"]
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signum)
            # child already reaped: nothing to forward to
            except OSError:
                pass

    prev = {}
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[signum] = signal.signal(signum, _forward)
        # non-main thread (tests): forwarding off
        except ValueError:
            pass
    restarts = 0
    try:
        while True:
            env = dict(os.environ)
            env["ZNICZ_RESTARTS"] = str(restarts)
            env["ZNICZ_RESTART_BUDGET"] = str(args.max_restarts)
            log.info(
                "supervisor: starting child (restart %d/%d): %s",
                restarts, args.max_restarts, " ".join(child_cmd),
            )
            # own session: the terminal's Ctrl+C must not ALSO hit the
            # child directly — a doubled SIGINT would trip the child's
            # second-signal force-exit before the emergency snapshot.
            # The supervisor's forward is the one delivery.
            state["proc"] = subprocess.Popen(
                child_cmd, env=env, start_new_session=True
            )
            rc = state["proc"].wait()
            history.append(
                {
                    "restart": restarts,
                    "exit_code": rc,
                    "signalled": state["signalled"],
                    # timestamp, not a duration
                    "unix": time.time(),
                }
            )
            try:
                _atomic_json(
                    history_path,
                    {
                        "restarts": restarts,
                        "max_restarts": args.max_restarts,
                        "history": history,
                    },
                )
            except OSError:
                log.warning("supervisor.json write failed", exc_info=True)
            if rc == 0 or state["signalled"] is not None:
                # done, or the operator stopped US — pass the child's
                # code through (75 = graceful preemption with an
                # emergency snapshot on disk)
                return rc
            if restarts >= args.max_restarts:
                log.error(
                    "supervisor: restart budget (%d) spent; child exit "
                    "%d — giving up", args.max_restarts, rc,
                )
                return rc
            restarts += 1
            delay = (
                min(args.restart_backoff * 2 ** (restarts - 1), 60.0)
                if args.restart_backoff > 0
                else 0.0
            )
            log.warning(
                "supervisor: child exited %d; restart %d/%d in %.1fs",
                rc, restarts, args.max_restarts, delay,
            )
            if delay:
                time.sleep(delay)
            if state["signalled"] is not None:
                # a stop request landed while no child was alive (the
                # backoff window): honor it instead of spawning a
                # fresh child to train for hours after the operator
                # asked us to stop
                log.info(
                    "supervisor: stop requested during backoff; "
                    "not restarting"
                )
                return rc
    finally:
        for signum, handler in prev.items():
            try:
                signal.signal(signum, handler)
            # non-main thread: nothing was installed to restore
            except ValueError:
                pass


def _install_stop_handlers(launcher: Launcher) -> bool:
    """SIGTERM/SIGINT -> Workflow.request_stop(): drain the in-flight
    step, write the emergency snapshot, exit EXIT_PREEMPTED.  A second
    signal (or one before the workflow exists) exits immediately."""

    def _handler(signum, frame):
        wf = launcher.workflow
        if (
            wf is not None
            and hasattr(wf, "request_stop")
            and not getattr(wf, "_preempt_requested", False)
        ):
            wf.request_stop()
        else:
            raise SystemExit(EXIT_PREEMPTED)

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        return True
    except ValueError:  # not the main thread (embedded/test use)
        return False


def _export_restart_telemetry() -> None:
    """Surface the supervisor-provided restart count/budget in THIS
    process's registry, so metrics.prom / status.json / the aggregator
    (and znicz-doctor's restart-loop gate) see them."""
    restarts = os.environ.get("ZNICZ_RESTARTS")
    budget = os.environ.get("ZNICZ_RESTART_BUDGET")
    if not restarts and not budget:
        return
    from znicz_tpu_torch import observability
    from znicz_tpu_torch.observability import pipeline as _pipeline

    try:
        n = int(restarts or 0)
        if n:
            observability.counter(
                _pipeline.RESTARTS_METRIC,
                "supervised training restarts preceding this process",
            ).inc(n)
        if budget:
            observability.gauge(
                _pipeline.RESTART_BUDGET_METRIC,
                "supervisor restart budget (--max-restarts)",
            ).set(float(int(budget)))
    except ValueError:
        Logger().warning(
            "malformed ZNICZ_RESTARTS/ZNICZ_RESTART_BUDGET ignored"
        )


def run_args(argv=None) -> Launcher:
    args = make_parser().parse_args(argv)
    # the CLI owns its process: force-install so --verbose wins even if
    # an imported library already touched the root logger
    setup_logging(10 if args.verbose else 20, force=True)
    if args.supervise:
        # the supervisor never builds a workflow itself — it loops the
        # SAME command (minus supervisor flags) as a child process
        raise SystemExit(
            supervise(args, list(sys.argv[1:] if argv is None else argv))
        )
    _export_restart_telemetry()
    if args.coordinator or args.num_processes or args.process_id is not None:
        from znicz_tpu_torch.parallel import multihost

        info = multihost.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            # --device cpu keeps every rank on the CPU: a gloo group
            backend="gloo" if args.device == "cpu" else None,
        )
        Logger().info(
            "multi-host: process %d/%d, %d local / %d global devices",
            info["process_index"], info["process_count"],
            info["local_devices"], info["global_devices"],
        )
    if args.data_dir:
        root.common.update({"data_dir": args.data_dir})
    launcher = Launcher(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.workflow)))
    module = _load_module(args.workflow, "__znicz_workflow__")
    if args.config:
        _load_module(args.config, "__znicz_config__")
    if not hasattr(module, "run"):
        raise SystemExit(
            f"{args.workflow} does not define run(load, main) "
            "(reference workflow convention)"
        )
    if args.optimize and args.evaluate:
        raise SystemExit(
            "--optimize and --evaluate conflict: the genetic search "
            "needs training runs, evaluation mode skips them"
        )
    if args.optimize or args.optimize_workers:
        raise NotImplementedError(
            "--optimize and --optimize-workers: the genetic search "
            "(genetics/) is not ported yet (ROADMAP.md A11)"
        )
    from znicz_tpu_torch.workflow.recovery import TrainingPreempted

    _install_stop_handlers(launcher)
    try:
        module.run(launcher.load, launcher.main)
    except TrainingPreempted as exc:
        Logger().info(
            "preempted gracefully (snapshot: %s); exiting %d",
            exc.snapshot_path, EXIT_PREEMPTED,
        )
        raise SystemExit(EXIT_PREEMPTED) from None
    return launcher


def main(argv=None) -> int:
    launcher = run_args(argv)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        # the CLI owns its process: tear its process group down once what
        # holds it is collected, before the interpreter clears its modules
        # (a gloo group still alive then can abort the rank at exit)
        launcher.workflow = None
        del launcher
        gc.collect()
        dist.destroy_process_group()
    return 0
