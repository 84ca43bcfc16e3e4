"""Checkpoint / resume (port of ``znicz_tpu/workflow/snapshotter.py``).

A snapshot is the train state as plain tuples, lists, dicts and numpy arrays
(``(params, velocity, step, key)``, no port class pickled) and an explicit
host-state dict (decision, loader, prng registry), in the JAX package's
payload: ``{"format_version", "train_state", "host_state"}``.

Crash safety is the JAX package's: every snapshot is written atomically
(tmp + ``os.replace``) with a sha256 integrity sidecar (``<file>.sha256``)
committed only after the data file, so a crash at any byte leaves either the
previous snapshot intact or a digest-mismatched file that the loaders treat
as corrupt.  ``load_snapshot`` raises :class:`SnapshotCorruptError` on
truncation, a digest mismatch or an undecodable payload, and
:func:`find_latest_valid` walks a directory newest to oldest past corrupt
files.

Files are read with a restricted unpickler: numpy's array and dtype
reconstructors, and the two classes a JAX-written snapshot names
(``znicz_tpu.nn.train_state.TrainState`` and
``znicz_tpu.workflow.snapshotter._KeyLeaf``), mapped to the port-local
stand-ins :class:`JaxTrainState` and :class:`JaxKeyLeaf`, so a JAX snapshot
loads without importing the JAX package.  Any other class raises
:class:`SnapshotCorruptError` naming it.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib
import logging
import os
import pickle
import re
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability import pipeline as _pipeline
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1

SIDECAR_SUFFIX = ".sha256"

# snapshot files a Snapshotter (any prefix) may have written
_SNAPSHOT_RE = re.compile(r".+\.pickle(\.gz)?$")


class SnapshotCorruptError(RuntimeError):
    """The snapshot file exists but cannot be trusted: truncated,
    digest-mismatched against its sidecar, or undecodable."""


class SnapshotWriteError(RuntimeError):
    """Writing a snapshot failed (disk full, permissions, injected
    fault).  The previous snapshot is untouched: ``maybe_save`` swallows
    this (counted and logged), so a flaky disk costs a checkpoint, never
    the run."""


class JaxTrainState(NamedTuple):
    """Stand-in for the JAX package's ``TrainState`` in a JAX-written
    snapshot: its four leaves, as data."""

    params: Any
    velocity: Any
    step: Any
    key: Any


class JaxKeyLeaf(NamedTuple):
    """Stand-in for a JAX snapshot's typed PRNG key leaf: the threefry key
    data and its implementation's name, kept as data (it cannot seed a
    ``torch.Generator``)."""

    data: np.ndarray
    impl: str


# module -> names a snapshot may reference: numpy's reconstructors (both
# spellings of its core package) and the JAX package's two classes
_JAX_CLASSES = {
    ("znicz_tpu.nn.train_state", "TrainState"): JaxTrainState,
    ("znicz_tpu.workflow.snapshotter", "_KeyLeaf"): JaxKeyLeaf,
}
_NUMPY_NAMES = {
    "numpy": {"dtype", "ndarray"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
}


def _numpy_global(module: str, name: str):
    try:
        return getattr(importlib.import_module(module), name)
    except ImportError:
        # numpy 2 pickles name numpy._core, numpy 1 numpy.core
        other = module.replace("numpy._core", "numpy.core") if "_core" in module else (
            module.replace("numpy.core", "numpy._core"))
        return getattr(importlib.import_module(other), name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = _JAX_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if name in _NUMPY_NAMES.get(module, ()):
            return _numpy_global(module, name)
        raise SnapshotCorruptError(
            f"snapshot names the class {module}.{name}, which the port does "
            "not load (numpy arrays and the JAX package's TrainState and "
            "_KeyLeaf only)"
        )


def _leaf_to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "snapshot: a bfloat16 tensor in the train state; numpy has no "
                "bfloat16 and the port keeps float32 master params, so this "
                "state cannot be written"
            )
        return leaf.detach().cpu().numpy().copy()
    return leaf


def _to_host(tree):
    """The train state with every tensor as a numpy copy, containers as
    plain tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    return _leaf_to_host(tree)


def _sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def _digest_file(path: str) -> str:
    """Chunked sha256 of a file — snapshots can be multi-GB; neither
    the save nor the load/verify path may hold one in RAM to hash it."""
    hasher = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def _sidecar_fields(path: str) -> Optional[List[str]]:
    """The sidecar's whitespace fields (digest, basename, vN...), or
    None when no sidecar exists (a pre-sidecar snapshot)."""
    sidecar = _sidecar_path(path)
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        return f.read().strip().split()


def _check_sidecar(path: str) -> bool:
    """Digest-check ``path`` against its sidecar (chunked read).
    Returns True when a sidecar existed and matched, False when there
    is none; raises :class:`SnapshotCorruptError` on a mismatch."""
    fields = _sidecar_fields(path)
    if fields is None:
        return False
    want = fields[0] if fields else ""
    got = _digest_file(path)
    if want != got:
        raise SnapshotCorruptError(
            f"snapshot {path} fails its sha256 sidecar check "
            f"(want {want[:12]}..., got {got[:12]}...) — truncated "
            "or partially overwritten; resume from an older snapshot"
        )
    return True


def _decode_file(path: str) -> dict:
    """Streamed file -> payload dict (no full-file resident copy);
    every decode failure mode becomes the one typed
    :class:`SnapshotCorruptError`."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            payload = _Unpickler(f).load()
    except (
        pickle.UnpicklingError,
        EOFError,
        gzip.BadGzipFile,
        zlib.error,
        AttributeError,  # missing class on unpickle
        MemoryError,
        IndexError,
        KeyError,
        UnicodeDecodeError,
    ) as exc:
        raise SnapshotCorruptError(
            f"snapshot {path} is unreadable ({type(exc).__name__}: {exc})"
        ) from exc
    if not isinstance(payload, dict):
        raise SnapshotCorruptError(
            f"snapshot {path} decodes to {type(payload).__name__}, "
            "not a snapshot payload"
        )
    return payload


def load_snapshot(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Read a snapshot file -> (train_state, host_state).  Standalone so a
    resume never requires a snapshot-writing policy to be configured.

    Raises :class:`SnapshotCorruptError` on truncation, sidecar digest
    mismatch or an undecodable payload (never a bare pickle error), and
    ``ValueError`` on a format-version mismatch (a valid file this code
    doesn't speak — not corruption)."""
    try:
        faults.fire("snapshot.load")
    except faults.FaultInjected as exc:
        # the chaos point simulates an unreadable checkpoint: typed,
        # so find_latest_valid / rollback fall through to older ones
        raise SnapshotCorruptError(
            f"snapshot {path} unreadable (injected)"
        ) from exc
    _check_sidecar(path)
    payload = _decode_file(path)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"snapshot {path} has format {payload.get('format_version')}, "
            f"expected {FORMAT_VERSION}"
        )
    try:
        train_state, host_state = payload["train_state"], payload["host_state"]
    except KeyError as exc:
        raise SnapshotCorruptError(
            f"snapshot {path} payload is missing {exc}"
        ) from exc
    return train_state, host_state


def verify_snapshot(path: str) -> None:
    """Cheap usability check: sidecar digest (and the format version it
    records) when present, else a full decode attempt.  Raises
    :class:`SnapshotCorruptError` on untrustworthy bytes, ``ValueError``
    on a version-skewed (valid but unloadable) snapshot, OSError on an
    unreadable file; returns None when the snapshot is resumable."""
    if _check_sidecar(path):
        # version skew recorded in the sidecar: the file is intact but
        # load_snapshot would reject it — find_latest_valid must fall
        # through to an older COMPATIBLE snapshot instead of handing
        # the launcher a checkpoint that crash-loops the supervisor
        for field in (_sidecar_fields(path) or [])[2:]:
            if field.startswith("v") and field[1:].isdigit():
                if int(field[1:]) != FORMAT_VERSION:
                    raise ValueError(
                        f"snapshot {path} has format {field[1:]}, "
                        f"expected {FORMAT_VERSION}"
                    )
        return
    # pre-sidecar snapshot: the only way to verify is to decode it
    payload = _decode_file(path)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"snapshot {path} has format "
            f"{payload.get('format_version')}, expected {FORMAT_VERSION}"
        )


def is_valid_snapshot(path: str) -> bool:
    try:
        verify_snapshot(path)
        return True
    except Exception:
        logger.warning("snapshot %s failed verification", path, exc_info=True)
        return False


def find_latest_valid(
    directory: str,
    prefix: Optional[str] = None,
    *,
    exclude=(),
) -> Optional[str]:
    """Newest verifiable snapshot in ``directory`` (by mtime, newest
    first), or None.  Corrupt / truncated / unreadable files are logged
    and skipped — resume always lands on a checkpoint that passes
    :func:`verify_snapshot`, or starts fresh.  ``exclude``: paths the
    caller already tried and found unloadable (verification is a digest
    check, so a digest-valid file can still fail to unpickle — e.g. a
    since-renamed class; the launcher quarantines it and asks again)."""
    try:
        names = os.listdir(directory)
    # an absent/unreadable directory has no snapshots to offer
    except OSError:  # znicz-check: disable=ZNC008
        return None
    excluded = set(exclude)
    candidates: List[Tuple[float, str]] = []
    for name in names:
        if not _SNAPSHOT_RE.fullmatch(name):
            continue
        if prefix is not None and not name.startswith(prefix + "_"):
            continue
        path = os.path.join(directory, name)
        if path in excluded:
            continue
        try:
            candidates.append((os.path.getmtime(path), path))
        # deleted between listdir and stat: not a candidate
        except OSError:  # znicz-check: disable=ZNC008
            continue
    for _, path in sorted(candidates, reverse=True):
        if is_valid_snapshot(path):
            return path
    return None


class Snapshotter:
    """Write/read snapshots under ``directory`` with a filename ``prefix``.

    ``interval``: also snapshot every N epochs regardless of improvement
    (0 = only on improvement).  ``keep``: retain at most N non-best snapshots
    (best is always kept) — pruning counts VERIFIED snapshots, so the only
    remaining valid checkpoint is never deleted even when newer files are
    corrupt.
    """

    def __init__(
        self,
        directory: str,
        prefix: str = "workflow",
        *,
        compress: bool = True,
        interval: int = 0,
        keep: int = 3,
        save_best: bool = True,
    ):
        self.directory = directory
        self.prefix = prefix
        self.compress = compress
        self.interval = interval
        self.keep = keep
        self.save_best = save_best  # False: interval-only snapshots
        # multi-process: the Workflow sets writer=False on every process
        # but the coordinator; they still gather a save's state to the host
        # but never touch the filesystem
        self.writer = True
        self._m_failures = observability.counter(
            _pipeline.SNAPSHOT_FAILURES_METRIC,
            "snapshot writes that failed (previous snapshot left intact)",
        )
        # paths THIS process wrote successfully: prune() trusts them
        # without re-reading multi-GB files to re-hash a digest this
        # process computed moments earlier
        self._verified: set = set()
        os.makedirs(directory, exist_ok=True)
        # Recover periodic snapshots from a previous process so "keep at
        # most N" holds across restarts, oldest (lowest epoch tag) first.
        existing = []
        for fname in os.listdir(directory):
            m = re.fullmatch(
                re.escape(prefix) + r"_epoch(\d+)\.pickle(\.gz)?", fname
            )
            if m:
                existing.append((int(m.group(1)), os.path.join(directory, fname)))
        self._kept: list = [p for _, p in sorted(existing)]

    # -- paths ---------------------------------------------------------------
    def _path(self, tag: str) -> str:
        ext = ".pickle.gz" if self.compress else ".pickle"
        return os.path.join(self.directory, f"{self.prefix}_{tag}{ext}")

    @property
    def best_path(self) -> str:
        return self._path("best")

    # -- save/load -----------------------------------------------------------
    def save(
        self,
        train_state,
        host_state: Optional[Dict[str, Any]] = None,
        *,
        tag: str,
    ) -> str:
        # spans land the snapshot cost on the Perfetto timeline next to
        # the train phases it steals wall time from: gather is the
        # device->host readback, write the pickle and file cost
        with observability.span("snapshot/save", tag=tag):
            with observability.span("snapshot/gather"):
                payload = {
                    "format_version": FORMAT_VERSION,
                    "train_state": _to_host(train_state),
                    "host_state": host_state or {},
                }
            path = self._path(tag)
            if not self.writer:
                return path  # bookkeeping stays identical across processes
            opener = gzip.open if self.compress else open
            tmp = path + ".tmp"
            with observability.span("snapshot/write", path=path):
                replaced = False
                try:
                    faults.fire("snapshot.write")
                    with opener(tmp, "wb") as f:
                        pickle.dump(
                            payload, f, protocol=pickle.HIGHEST_PROTOCOL
                        )
                    # chunked hash: never hold a multi-GB serialized
                    # snapshot in host RAM beside the payload
                    digest = _digest_file(tmp)
                    # data file first, sidecar second: a crash in the
                    # window leaves a new file with the OLD sidecar —
                    # a digest MISMATCH the loaders skip, never a
                    # silently-trusted torn snapshot
                    os.replace(tmp, path)
                    replaced = True
                    side_tmp = _sidecar_path(path) + ".tmp"
                    with open(side_tmp, "w") as f:
                        f.write(
                            f"{digest}  {os.path.basename(path)}  "
                            f"v{FORMAT_VERSION}\n"
                        )
                    os.replace(side_tmp, _sidecar_path(path))
                except (OSError, faults.FaultInjected) as exc:
                    for leftover in (tmp, _sidecar_path(path) + ".tmp"):
                        try:
                            os.remove(leftover)
                        # best-effort cleanup on the failure path
                        except OSError:  # znicz-check: disable=ZNC008
                            pass
                    if replaced:
                        # the NEW data file already landed (the replace
                        # succeeded; only the sidecar write failed): a
                        # stale sidecar from the previous write would
                        # condemn the good new file forever — drop it
                        # so the file verifies by decode, and report
                        # SUCCESS (the checkpoint exists; callers must
                        # track it for retention/resume)
                        try:
                            os.remove(_sidecar_path(path))
                        except OSError:  # znicz-check: disable=ZNC008
                            pass
                        logger.warning(
                            "snapshot %s written but its sidecar "
                            "failed (%s); it will verify by decode",
                            path, exc,
                        )
                        return path
                    raise SnapshotWriteError(
                        f"snapshot write to {path} failed: {exc}"
                    ) from exc
            self._verified.add(path)
        return path

    def load(self, path: str) -> Tuple[Any, Dict[str, Any]]:
        return load_snapshot(path)

    def maybe_save(
        self,
        train_state,
        host_state: Optional[Dict[str, Any]] = None,
        *,
        epoch: int,
        improved: bool,
    ) -> Optional[str]:
        """Snapshot policy: on validation improvement -> overwrite 'best'
        (unless ``save_best=False``); every ``interval`` epochs -> tagged
        periodic snapshot.  A :class:`SnapshotWriteError` is swallowed
        (counted + logged): a failed checkpoint must not kill the run —
        the previous snapshot is intact and the next interval retries."""
        path = None
        if improved and self.save_best:
            try:
                path = self.save(train_state, host_state, tag="best")
            except SnapshotWriteError:
                self._m_failures.inc()
                logger.exception("best-snapshot write failed; continuing")
                path = None
        if self.interval and (epoch + 1) % self.interval == 0:
            try:
                path = self.save(train_state, host_state, tag=f"epoch{epoch}")
            except SnapshotWriteError:
                self._m_failures.inc()
                logger.exception(
                    "epoch%d snapshot write failed; continuing", epoch
                )
                return None
            self._kept.append(path)
            self.prune()
        return path

    def prune(self) -> None:
        """Apply the ``keep`` retention bound to periodic snapshots.

        Prunes by the VERIFIED set, not filename count: an old snapshot
        is only deleted while at least one newer kept snapshot passes
        :func:`verify_snapshot` — when every newer file is corrupt, the
        old valid one is retained past the bound (the bound is a disk
        budget; an unresumable run is a lost run)."""
        while len(self._kept) > self.keep:
            old = self._kept[0]
            if self.writer and os.path.exists(old):
                # newest first: the just-written (in-_verified) path
                # short-circuits the sweep, so a restart-recovered
                # ledger never re-hashes old multi-GB files per save
                newer_valid = any(
                    os.path.exists(p)
                    and (p in self._verified or is_valid_snapshot(p))
                    for p in reversed(self._kept[1:])
                )
                if not newer_valid:
                    logger.warning(
                        "retaining %s past keep=%d: no newer snapshot "
                        "verifies", old, self.keep,
                    )
                    return
            self._kept.pop(0)
            self._verified.discard(old)
            # only the writer touches the filesystem (processes share the
            # bookkeeping but must not race on removes)
            if self.writer:
                for victim in (old, _sidecar_path(old)):
                    if os.path.exists(victim):
                        os.remove(victim)
