"""Continuous micro-batching decode engine: the LM serving front end (port
of ``znicz_tpu/services/engine.py``).

Orca-style continuous batching over the bucketed decode path
(:mod:`znicz_tpu_torch.workflow.generate`): a request queue coalesces
pending prompts into a fixed B-slot batch over STATIC ``[B, T_max]`` KV
buffers; when a row retires (EOS or budget), its slot is re-used by
prefilling the next queued prompt into it while the other rows keep
decoding.  Two programs cover any request stream:

* **admit**: prefill ONE left-padded ``[1, bucket]`` prompt into a fresh
  zeroed cache row and copy it into the batch at the slot index; one
  program a prompt-length bucket (geometric ladder, so a handful).
* **decode chunk**: ``admit_every`` incremental steps for the whole batch,
  with PER-ROW positions (each row writes its K/V at its own position), so
  rows at different depths decode together and no prompt length or
  admission pattern ever makes another program.

**Paged backend** (:class:`PagedDecodeEngine`, vLLM / Sarathi /
RadixAttention lineage): K/V live in a shared block pool (``[n_blocks,
block_size, H, hd]`` a layer) and each slot owns a block table over
REFCOUNTED blocks.  Admission maps the longest prefix of the prompt
already in the content-hash PREFIX CACHE (chained block hashes; retiring
and preempted requests publish their completed full blocks) and
chunk-prefills only the uncached tail; shared blocks are read-only behind a
copy-on-write guard.  Blocks are otherwise allocated lazily as decode
advances, prompts prefill in block-sized CHUNKS interleaved with decode
chunks, and when the free list runs dry allocation first EVICTS cache-only
blocks (LRU) and only then PREEMPTS the youngest request (publish, release,
requeue for recompute).  With ``spec_k`` the paged engine drafts
continuations (:class:`~znicz_tpu_torch.workflow.generate
.PromptLookupDrafter` by default) and verifies them in one bucketed pass,
rolling rejected drafts back by truncating the block table.

**Programs.**  Each program key of the JAX package (``("admit", bucket,
structure)``, ``("chunk", admit_every, B, structure)``, ``("prefill",
block_size, structure)``, ``("cow", block_size)``, ``("paged_chunk",
admit_every, B, window, structure)``, ``("spec_verify", width, B, window,
structure)``) is one :class:`_Program` of the engine: static input buffers
the host fills before each call (one ``non_blocking`` copy of a packed
int64 vector), the engine's caches or pools updated in place, outputs
written into one static buffer the host reads with ONE copy a call.  On the
card a program's first call runs eagerly on a side stream and the program
is then captured into a ``torch.cuda.CUDAGraph``, which every later call
replays; on the CPU it runs eagerly every call.  A failed capture raises;
nothing falls back.  A chunk runs all ``admit_every`` steps (a graph cannot
branch on a device value): an iteration that starts with every row done
changes no row state (JAX's ``while_loop`` exits there), so emissions,
positions and the returned ``steps`` equal JAX's.

Sampling draws noise outside the programs into static buffers: from a
``torch.Generator`` on the engine's device, or from a callable ``rng(path,
shape, kind)`` handed the JAX package's fold-in path (``(n_admits,)`` for
an admit, ``(seq,)`` for a paged prefill, ``(1 << 20 | chunk_idx, i)`` for
chunk step ``i``, ``(1 << 20 | chunk_idx, 0)`` / ``(..., 1)`` for the
verify's uniforms / residual draw), the shape and the kind (``"gumbel"`` or
``"uniform"``), as the tests hand in JAX's draws.

Telemetry: the JAX package's metric (``znicz_serve_*``), span
(``serve/admit``, ``serve/prefill``, ``serve/decode``, ``serve/verify``)
and instant (``serve/queued``, ``serve/retired``, ``serve/preempt``) names,
byte for byte; the fault points ``engine.decode_step``, ``engine.prefill``,
``pool.alloc`` and ``pool.pressure`` fire where the JAX package fires them.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability import device as device_telemetry
from znicz_tpu_torch.ops.attention import masked_attention
from znicz_tpu_torch.ops.normalization import layer_norm
from znicz_tpu_torch.services.errors import (
    RequestTooLargeError,
    SpeculationUnsupportedError,
)
from znicz_tpu_torch.utils import faults, profiling
from znicz_tpu_torch.workflow.generate import (
    DEFAULT_PROMPT_BUCKETS,
    DEFAULT_SPEC_BUCKETS,
    NULL_BLOCK,
    PromptLookupDrafter,
    _check_sampling_args,
    _embed_rows,
    _filter_logits,
    _params_fingerprint,
    _proj,
    _sample,
    bucket_for,
    copy_paged_block,
    init_kv_cache,
    init_paged_kv,
    pack_prompts,
    paged_decode_step,
    paged_prefill_chunk,
    paged_verify_chunk,
    prefill,
)
from znicz_tpu_torch.workflow.transformer import _block_ffn

# process-wide first-make ledger backing znicz_serve_compiles_total and the
# device ledger, with the JAX package's semantics: a second engine with the
# same (params geometry, program key) adds nothing to either.  (Each engine
# still captures its own graphs: a graph is bound to its engine's buffers.)
_COMPILED_KEYS: set = set()

# seed of the prefix-cache hash chain (versioned: bump if block content
# semantics ever change, so stale-looking hashes can't alias)
_PREFIX_SEED = b"znicz-prefix-v1"

# the fold-in offset of a chunk's key (JAX: fold_in(rng, 1 << 20 | idx))
_CHUNK_KEY = 1 << 20


def _chain_digests(tokens: np.ndarray, block_size: int):
    """Chained sha256 over full ``block_size``-token blocks of
    ``tokens``: block j's key commits to ALL tokens before it, so equal
    keys mean equal K/V content, and walking the chain until the first
    miss is the longest-cached-prefix descent of an implicit radix
    structure.  Byte-identical to the JAX package's: the engine's prefix
    cache and the cluster router's affinity index hash through the same
    scheme, so a port replica and a JAX replica key blocks alike."""
    h = _PREFIX_SEED
    for j in range(tokens.size // block_size):
        h = hashlib.sha256(
            h
            + np.ascontiguousarray(
                tokens[j * block_size:(j + 1) * block_size]
            ).tobytes()
        ).digest()
        yield h


def prefix_block_keys(prompt, block_size: int) -> List[str]:
    """Public prefix-cache block keys for ``prompt`` (hex, full blocks
    only): the routing key a serving router indexes replicas by, and what
    :meth:`DecodeEngine.prefix_probe` returns.  Pure function of the token
    content (prompts are hashed as int32, matching the engine's internal
    chain), independent of any live engine state."""
    p = np.asarray(prompt, np.int32).reshape(-1)
    return [h.hex() for h in _chain_digests(p, int(block_size))]


@dataclasses.dataclass
class RequestTimings:
    """Per-request lifecycle breakdown, attached to every
    :class:`Completion`.  All host wall-clock (``time.perf_counter``
    deltas):

    * ``queue_s``: time spent WAITING (engine queue before first
      admission, plus every re-queue wait after a preemption).
    * ``prefill_s``: wall time of this request's own admit/prefill
      program calls (per chunk on the paged backend).
    * ``decode_s``: wall time of the decode chunks this request was
      RESIDENT in (chunks are batched, so concurrent residents each count
      the full chunk).
    * ``preemptions``: times this request was evicted and recomputed.
    * ``cached_tokens``: prompt tokens whose prefill was skipped via the
      prefix cache (accumulated across re-admissions).
    * ``spec_drafted`` / ``spec_accepted``: draft tokens proposed for (and
      accepted by) this request's speculative verify steps.
    """

    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    preemptions: int = 0
    cached_tokens: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    def as_dict(self) -> Dict:
        return {
            "queue_s": round(self.queue_s, 6),
            "prefill_s": round(self.prefill_s, 6),
            "decode_s": round(self.decode_s, 6),
            "preemptions": self.preemptions,
            "cached_tokens": self.cached_tokens,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
        }


@dataclasses.dataclass
class Request:
    """One queued generation request: a 1-D prompt with its own budget."""

    id: int
    prompt: np.ndarray  # 1-D int32
    max_new_tokens: int
    bucket: int  # prompt-length bucket it will be admitted at
    watch: profiling.Stopwatch  # started at submit; read at retirement
    ttft_s: Optional[float] = None  # set once at FIRST admission
    # memoized prefix-cache hash chain (pure function of the prompt)
    digests: Optional[List[bytes]] = None
    trace_id: Optional[str] = None
    timings: RequestTimings = dataclasses.field(default_factory=RequestTimings)
    # watch-relative instant this request last (re-)entered the queue
    last_queued_at: float = 0.0


@dataclasses.dataclass
class Completion:
    """A finished request: prompt + generated tokens plus its serving
    metrics.  ``latency_s`` is submit -> retirement (queue wait included);
    ``ttft_s`` is submit -> first sampled token.  ``finish_reason`` is
    ``"eos"`` / ``"budget"`` from the engine itself, or the typed reason an
    out-of-band :meth:`DecodeEngine.abort` retired it with."""

    id: int
    tokens: np.ndarray  # prompt + generated, EOS included when hit
    n_new: int
    finish_reason: str
    latency_s: float
    tokens_per_sec: float
    bucket: int
    ttft_s: Optional[float] = None
    error: Optional[str] = None  # set for finish_reason == "error"
    trace_id: Optional[str] = None
    timings: Optional[Dict] = None  # RequestTimings.as_dict()


# ---------------------------------------------------------------------------
# Noise, staging and the program wrapper.


def _draw(rng, path, shape, kind: str, device) -> torch.Tensor:
    """Noise for one fold-in ``path`` of the JAX package's key tree:
    Gumbel draws (``kind="gumbel"``, a categorical draw's) or uniforms in
    ``[0, 1)`` (``kind="uniform"``).  A ``torch.Generator`` draws them in
    call order; a callable returns ``rng(path, shape, kind)``."""
    if callable(rng):
        noise = rng(tuple(int(p) for p in path), tuple(shape), kind)
        if not torch.is_tensor(noise):
            noise = torch.from_numpy(np.array(noise, np.float32))
        return noise.to(device=device, dtype=torch.float32)
    u = torch.rand(shape, generator=rng, device=device)
    if kind == "uniform":
        return u
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))


def _stage(buf: torch.Tensor, *parts) -> None:
    """Pack host integer arrays into the static int64 buffer ``buf`` with
    one copy (``non_blocking`` from pageable memory: CUDA stages the source
    before returning, so the host neither waits nor may race it)."""
    host = np.concatenate([np.asarray(p, np.int64).reshape(-1) for p in parts])
    buf.copy_(torch.from_numpy(host), non_blocking=True)


class _Program:
    """One engine program: ``run`` reads only the static buffers in
    ``io`` (filled by the host before each call) and the engine's params,
    caches or pools, updates the caches or pools in place and writes its
    results into ``io["out"]``.  On the CPU each call runs it eagerly.  On
    the card the first call runs it eagerly on a side stream (this call's
    work; it also loads cuBLAS's algorithms and fills the allocator, which
    a capture may not do) and then captures it into :attr:`graph`; later
    calls replay the graph.  A failed capture raises.

    ``count=True`` counts the flops of the call's eager run (never of the
    capture) into :attr:`cost`: one call of the program, all its steps."""

    def __init__(self, run: Callable[[], None], io: Dict[str, torch.Tensor], device,
                 capture: bool = True):
        self.run = run
        self.io = io
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.graph = None
        self.cost = None

    def __call__(self, count: bool = False) -> None:
        with torch.no_grad():
            if self.graph is not None:
                self.graph.replay()
            elif self.capture:
                self._first_call(count)
            else:
                self._eager(count)

    def _eager(self, count: bool) -> None:
        if count:
            _, self.cost = device_telemetry.lowered_cost(self.run)
        else:
            self.run()

    def _first_call(self, count: bool) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._eager(count)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # an engine and its programs form a reference cycle: collect dead
        # engines now and keep the collector off while capturing, since a
        # graph destroyed mid-capture (its pool freed) invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self.run()
        except Exception as exc:
            raise RuntimeError(
                f"capturing an engine program into a CUDA graph failed "
                f"({type(exc).__name__}: {exc}); a program must launch work on its stream "
                "only, with no host read, host copy or data-sized allocation"
            ) from exc
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def read(self) -> np.ndarray:
        """The program's outputs on the host: ONE copy (and so one wait
        for the card)."""
        return self.io["out"].to("cpu", copy=True).numpy()


def _rows_decode_step(params, caches, tok, pos, start, *, n_heads, moe_top_k, moe_dispatch):
    """One decode step of every row at its own position (the JAX package
    ``vmap``s ``decode_step`` over the rows): row ``b`` writes its K/V at
    ``(b, pos[b])`` of the dense caches and attends over its own row up to
    ``pos[b]``.  Under capacity dispatch each row routes alone, with one
    token's expert capacity, as the ``vmap`` does.  Returns the
    next-position logits ``[B, vocab]``."""
    b = tok.shape[0]
    rows = torch.arange(b, device=tok.device)
    x = _embed_rows(params[0], tok, pos, start)  # [B, 1, D]
    q_pos = pos[:, None]
    for block, cache in zip(params[1:-1], caches):
        h = layer_norm(x, block["ln1_scale"], block["ln1_bias"])
        q, k_new, v_new = (_proj(h, block[w], n_heads) for w in ("wq", "wk", "wv"))
        cache["k"].index_put_((rows, pos), k_new[:, 0])
        cache["v"].index_put_((rows, pos), v_new[:, 0])
        o = masked_attention(q, cache["k"], cache["v"], q_pos, start=start)
        x = x + o.reshape(b, 1, -1) @ block["wo"]
        h = layer_norm(x, block["ln2_scale"], block["ln2_bias"])
        kw = dict(moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
        if moe_dispatch == "capacity" and "moe_router" in block:
            ffn = torch.cat([_block_ffn(block, h[i:i + 1], **kw) for i in range(b)])
        else:
            ffn = _block_ffn(block, h, **kw)
        x = x + ffn
    return x[:, 0] @ params[-1]["head"]


# ---------------------------------------------------------------------------
# The dense engine.


class DecodeEngine:
    """Continuous micro-batching front end over the KV-cache decoder.

    Usage::

        eng = DecodeEngine(params, n_heads=8, eos_id=0, batch_size=8)
        ids = [eng.submit(prompt, max_new_tokens=64) for prompt in reqs]
        completions = eng.run()          # drain the queue
        eng.stats()                      # latency / tokens/s / programs

    The engine runs on its params' device (the card, or the CPU for
    params there).  Greedy by default; ``temperature``/``top_k``/``top_p``
    select the same sampling structures as :func:`generate` (one program
    set per structure), drawing from ``rng`` (a ``torch.Generator`` on the
    params' device, or a callable: see the module docstring).
    ``admit_every`` is the admission granularity: the batch decodes in
    chunks of that many steps between retirement checks.
    ``cuda_graphs=False`` runs every program eagerly on the card too (for
    checks and timings against the replays)."""

    kv_backend = "dense"

    def __init__(
        self,
        params,
        *,
        n_heads: int,
        eos_id: int,
        batch_size: int = 8,
        max_seq: Optional[int] = None,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        admit_every: int = 8,
        pad_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng=None,
        moe_top_k: int = 1,
        moe_dispatch: str = "dense",
        prefix_cache: Optional[bool] = None,
        spec_k: int = 0,
        drafter=None,
        spec_buckets: Optional[Sequence[int]] = None,
        cuda_graphs: bool = True,
    ):
        if batch_size < 1 or admit_every < 1:
            raise ValueError(
                f"want batch_size >= 1 and admit_every >= 1; got "
                f"{batch_size}, {admit_every}"
            )
        if prefix_cache:
            raise ValueError(
                "prefix cache requires the paged backend "
                "(PagedDecodeEngine): the dense [B, T_max] KV layout has "
                "no shareable blocks to map across requests"
            )
        if spec_k or drafter is not None or spec_buckets is not None:
            raise SpeculationUnsupportedError(
                "speculative decoding requires the paged backend "
                "(PagedDecodeEngine): rejected draft tokens roll back "
                "by truncating the row's block table — the dense "
                "[B, T_max] KV layout has no block tables to truncate"
            )
        if not hasattr(self, "spec_k"):
            self.spec_k = 0  # the paged subclass sets its own first
        max_pos = params[0]["pos"].shape[0]
        self.t_max = int(max_seq or max_pos)
        if self.t_max > max_pos:
            raise ValueError(
                f"max_seq {self.t_max} exceeds the positional table "
                f"({max_pos})"
            )
        top_k, rng = _check_sampling_args(
            params, temperature, top_k, top_p, rng, eos_id
        )
        self.params = params
        self.device = params[0]["embed"].device
        self.cuda_graphs = bool(cuda_graphs)
        self._params_fp = _params_fingerprint(params)
        self.n_heads = n_heads
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id if pad_id is not None else eos_id)
        self.batch_size = int(batch_size)
        self.prompt_buckets = tuple(prompt_buckets)
        self.admit_every = int(admit_every)
        self.moe_top_k = moe_top_k
        self.moe_dispatch = moe_dispatch
        self.vocab = int(params[-1]["head"].shape[-1])
        # sampling scalars on the device: the programs read them there
        self._temperature = torch.tensor(
            float(temperature), dtype=torch.float32, device=self.device
        )
        self._top_p = torch.tensor(float(top_p), dtype=torch.float32, device=self.device)
        self._rng = rng
        # static sampling structure: one program set per value
        self._structure = (temperature == 0.0, top_k, top_p < 1.0)
        b = self.batch_size
        self._tok = np.zeros((b,), np.int32)
        self._pos = np.zeros((b,), np.int32)
        self._start = np.zeros((b,), np.int32)
        self._done = np.ones((b,), bool)  # empty slots idle as done
        self._remaining = np.zeros((b,), np.int32)
        self._slots: List[Optional[dict]] = [None] * b
        self._queue: Deque[Request] = deque()
        self._order: List[Completion] = []
        self.completions: Dict[int, Completion] = {}
        # process-wide registry series (shared across engines: get-or-create)
        self._m_submitted = observability.counter(
            "znicz_serve_requests_submitted_total",
            "requests accepted into the engine queue",
        )
        self._m_admitted = observability.counter(
            "znicz_serve_requests_admitted_total",
            "requests prefilled into a batch slot",
        )
        self._m_retired = observability.counter(
            "znicz_serve_requests_retired_total",
            "completed requests by finish reason",
            ("reason",),
        )
        self._m_tokens = observability.counter(
            "znicz_serve_tokens_generated_total",
            "generated tokens across all retired requests",
        )
        self._m_compiles = observability.counter(
            "znicz_serve_compiles_total",
            "distinct compiled engine programs by kind and bucket",
            ("kind", "bucket"),
        )
        self._m_program_hits = observability.counter(
            "znicz_serve_program_hits_total",
            "program invocations served from an already-compiled entry",
        )
        self._m_queue_depth = observability.gauge(
            "znicz_serve_queue_depth", "requests waiting for a slot"
        )
        self._m_active = observability.gauge(
            "znicz_serve_active_slots", "batch slots decoding right now"
        )
        self._m_latency = observability.histogram(
            "znicz_serve_request_latency_seconds",
            "submit -> retirement latency per request (queue wait included)",
        )
        self._m_ttft = observability.histogram(
            "znicz_serve_ttft_seconds",
            "submit -> first sampled token per request",
        )
        # per-tick occupancy: the fraction of each tick's wall spent by
        # admission/prefill, the decode chunk and a spec-verify chunk
        self._m_tick_occ = observability.histogram(
            "znicz_serve_tick_occupancy",
            "per-tick fraction of wall spent by phase "
            "(prefill / decode / spec_verify)",
            ("phase",),
            buckets=observability.DEFAULT_FRACTION_BUCKETS,
        )
        self._occ_seconds = {"prefill": 0.0, "decode": 0.0, "spec_verify": 0.0}
        self._occ_wall = 0.0
        self._occ_ticks = 0
        # which kind of chunk the last _run_chunk ran ("decode" or
        # "spec_verify"), written by the paged subclass's spec path
        self._last_chunk_kind = "decode"
        self.latency = profiling.LatencyStats(observe=self._m_latency.observe)
        self.timer = observability.PhaseTimer(
            "znicz_serve_phase_seconds",
            help="engine admit/decode host phase seconds",
            span_prefix="serve/",
        )
        # the serving instance this engine's spans belong to (rides every
        # span/instant as an ``instance`` arg)
        self.trace_instance: Optional[str] = None
        self._programs: Dict[tuple, int] = {}
        self._progs: Dict[tuple, _Program] = {}
        # wall seconds of this engine's first call of each key (on the card
        # its capture included), whether or not the ledger counted it
        self.capture_s: Dict[tuple, float] = {}
        self._program_hits = 0
        self._next_id = 0
        self._n_admits = 0
        self._chunk_idx = 0
        self._total_new = 0
        self._peak_active = 0
        self._init_kv_state()

    def _init_kv_state(self) -> None:
        """Allocate the dense ``[B, T_max]`` KV buffers and the admit
        programs' one zeroed ``[1, T_max]`` row (the paged subclass
        overrides this with a block pool + tables)."""
        self._caches = init_kv_cache(
            self.params, self.batch_size, self.t_max, n_heads=self.n_heads
        )
        self._admit_row_cache = init_kv_cache(self.params, 1, self.t_max, n_heads=self.n_heads)

    # -- request intake ---------------------------------------------------

    def _validate_request(self, p: np.ndarray, max_new_tokens: int) -> int:
        """Check the request against THIS backend's real KV capacity;
        returns the admission width (prompt bucket)."""
        bucket = bucket_for(p.size, self.prompt_buckets)
        if bucket + max_new_tokens > self.t_max:
            raise RequestTooLargeError(
                f"prompt bucket {bucket} (len {p.size}) + max_new_tokens "
                f"{max_new_tokens} exceeds the dense KV buffer "
                f"(t_max={self.t_max})"
            )
        return bucket

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        trace_id: Optional[str] = None,
    ) -> int:
        """Queue one prompt (1-D token ids); returns the request id.
        Validated against the active backend's real KV capacity, so
        admission can never fail later.  ``trace_id`` rides into the
        request's lifecycle spans and its completion."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"want max_new_tokens >= 1; got {max_new_tokens}")
        bucket = self._validate_request(p, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(
            Request(rid, p, int(max_new_tokens), bucket,
                    profiling.Stopwatch(), trace_id=trace_id)
        )
        self._m_submitted.inc()
        self._m_queue_depth.set(len(self._queue))
        observability.instant("serve/queued", id=rid, **self._trace_args(trace_id))
        return rid

    def _trace_args(self, trace_id: Optional[str]) -> Dict:
        """Span/instant args for a trace id (empty when none), plus the
        serving instance when one is named."""
        args: Dict = {}
        if trace_id:
            args["trace"] = trace_id
        if self.trace_instance:
            args["instance"] = self.trace_instance
        return args

    def _decode_trace_args(self, residents) -> Dict:
        """Decode chunks are batched: the span carries EVERY resident's
        trace id (comma-joined)."""
        args: Dict = {}
        traces = ",".join(r.trace_id for r in residents if r.trace_id)
        if traces:
            args["traces"] = traces
        if self.trace_instance:
            args["instance"] = self.trace_instance
        return args

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    # -- the serving loop -------------------------------------------------

    def run(self) -> List[Completion]:
        """Drain the queue: admit into free slots, decode in chunks,
        retire finished rows, re-admit, until every submitted request has
        completed.  Returns this call's completions in retirement order
        (also kept in :attr:`completions` by id)."""
        n0 = len(self._order)
        while self.tick():
            pass
        return self._order[n0:]

    def tick(self) -> bool:
        """ONE engine tick (admit + prefill, then a decode or spec-verify
        chunk), with the per-phase wall split observed into
        ``znicz_serve_tick_occupancy{phase}``.  Returns False when there is
        no work (nothing ran)."""
        if not self._has_work():
            return False
        t0 = time.perf_counter()
        self._admit_pending()
        self._prefill_tick()
        t1 = time.perf_counter()
        chunk_kind = None
        if self.active:
            self._last_chunk_kind = "decode"
            self._run_chunk()
            chunk_kind = self._last_chunk_kind
        t2 = time.perf_counter()
        self._observe_tick(t1 - t0, t2 - t1, chunk_kind)
        return True

    def _observe_tick(self, prefill_s: float, chunk_s: float, chunk_kind: Optional[str]) -> None:
        wall = prefill_s + chunk_s
        if wall <= 0:
            return
        frac = {"prefill": prefill_s / wall}
        if chunk_kind is not None:
            frac[chunk_kind] = chunk_s / wall
        for phase, f in frac.items():
            self._m_tick_occ.labels(phase=phase).observe(f)
        self._occ_seconds["prefill"] += prefill_s
        if chunk_kind is not None:
            self._occ_seconds[chunk_kind] += chunk_s
        self._occ_wall += wall
        self._occ_ticks += 1

    def tick_occupancy(self) -> Dict:
        """Lifetime tick-composition report (the ``stats()`` entry)."""
        wall = self._occ_wall
        return {
            "ticks": self._occ_ticks,
            "wall_s": round(wall, 6),
            "frac": {
                k: round(v / wall, 4) if wall > 0 else 0.0
                for k, v in self._occ_seconds.items()
            },
        }

    def _has_work(self) -> bool:
        return bool(self._queue) or self.active > 0

    def _prefill_tick(self) -> None:
        """Dense admission prefills whole prompts inside
        :meth:`_admit_pending`; the paged subclass interleaves prompt
        CHUNKS here, between decode chunks."""

    # -- programs ---------------------------------------------------------

    def _program(self, key: tuple) -> bool:
        """Ledger one program per key.  Registry mirror:
        ``znicz_serve_compiles_total{kind,bucket}`` counts first makes per
        (params geometry, key) across the whole process, as the JAX
        package counts first compiles (a second engine of the same geometry
        adds nothing, though it captures graphs of its own).  Returns True
        exactly on such a first make (the device ledger keys off it)."""
        if key in self._programs:
            self._program_hits += 1
            self._m_program_hits.inc()
            return False
        self._programs[key] = 1
        full_key = (self._params_fp, key)
        if full_key in _COMPILED_KEYS:
            return False
        _COMPILED_KEYS.add(full_key)
        self._m_compiles.labels(kind=key[0], bucket=key[1]).inc()
        return True

    def _call(self, key: tuple, make: Callable[[], _Program], *parts, noise=None) -> _Program:
        """Ledger + run one program: built by ``make()`` at this engine's
        first call of ``key`` (on the card: captured after that call),
        its int64 input packed from ``parts`` and its noise buffers filled
        from ``noise`` (name -> tensor) before the call.  A first make
        process-wide is wall-timed into the device ledger."""
        prog = self._progs.get(key)
        if prog is None:
            prog = self._progs[key] = make()
        _stage(prog.io["inp"], *parts)
        for name, value in (noise or {}).items():
            prog.io[name].copy_(value, non_blocking=True)
        first = self._program(key)
        if prog.graph is not None or key in self.capture_s:
            prog()
            return prog
        t0 = time.perf_counter()
        prog(count=first)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.capture_s[key] = seconds
        if first:
            device_telemetry.record_program(
                key, seconds, cost=prog.cost,
                memory=device_telemetry.compiled_memory(prog.graph),
                dedup=(self._params_fp, key),
            )
        return prog

    def _zeros(self, shape, dtype=torch.int64) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _sample(self, logits, noise):
        greedy, top_k, nucleus = self._structure
        if greedy:
            return torch.argmax(logits, dim=-1)
        return _sample(logits, noise, self._temperature, top_k, nucleus, self._top_p)

    def _noise_buf(self, shape) -> Optional[torch.Tensor]:
        """A static noise buffer, or None under greedy decoding."""
        return None if self._structure[0] else self._zeros(shape, torch.float32)

    def _moe(self) -> Dict:
        return dict(moe_top_k=self.moe_top_k, moe_dispatch=self.moe_dispatch)

    def _make_admit(self, bucket: int) -> _Program:
        """``("admit", bucket, structure)``: prefill ONE left-padded ``[1,
        bucket]`` prompt into a fresh zeroed row and copy it into row
        ``slot`` of the batch caches; sample its first token.  Input:
        ``prompt [bucket] | start | slot``."""
        io = {"inp": self._zeros(bucket + 2), "out": self._zeros(1),
              "noise": self._noise_buf((1, self.vocab))}
        row = self._admit_row_cache

        def run():
            inp = io["inp"]
            prompt, start, slot = inp[:bucket].view(1, bucket), inp[bucket:bucket + 1], inp[-1:]
            for r in row:
                r["k"].zero_()
                r["v"].zero_()
            _, logits = prefill(self.params, prompt, row, n_heads=self.n_heads, start=start,
                                **self._moe())
            for big, r in zip(self._caches, row):
                big["k"].index_copy_(0, slot, r["k"])
                big["v"].index_copy_(0, slot, r["v"])
            io["out"].copy_(self._sample(logits, io["noise"]))

        return _Program(run, io, self.device, self.cuda_graphs)

    def _chunk_loop(self, io, b: int, step, *, freeze_done: bool):
        """The body shared by the dense and paged decode chunks: up to
        ``admit_every`` steps of ``step(tok, pos, start, done) -> logits``.  An iteration that starts with every row done changes no
        row state (JAX's ``while_loop`` has exited there); ``steps`` counts
        the others.  Dense positions advance for every row (the dense
        chunk's clamp-and-ignore), paged ones freeze once a row is done.
        Writes ``out [B, chunk] | tok | pos | done | remaining | steps``."""
        chunk = self.admit_every
        t_cap = self.t_max - 1
        fill = self.eos_id
        state = io["inp"][-5 * b:].view(5, b)
        tok, pos, start, done, remaining = state.unbind(0)
        done = done.bool()
        out = torch.full((b, chunk), fill, dtype=torch.int64, device=self.device)
        steps = torch.zeros((), dtype=torch.int64, device=self.device)
        noise = io["noise"]
        for i in range(chunk):
            alive = ~done.all()
            logits = step(tok, pos, start, done)
            nxt = self._sample(logits, None if noise is None else noise[i])
            nxt = torch.where(done, fill, nxt)
            remaining = torch.where(done, remaining, remaining - 1)
            done = done | (nxt == self.eos_id) | (remaining <= 0)
            out[:, i] = nxt
            moved = done if freeze_done else ~alive
            pos = torch.where(moved, pos, (pos + 1).clamp(max=t_cap))
            tok = torch.where(alive, nxt, tok)
            steps = steps + alive.long()
        io["out"].copy_(torch.cat(
            [out.reshape(-1), tok, pos, done.long(), remaining, steps.reshape(1)]
        ))

    def _make_chunk(self) -> _Program:
        """``("chunk", admit_every, B, structure)``: ``admit_every`` decode
        steps for the whole batch at per-row positions.  Input: ``tok |
        pos | start | done | remaining``."""
        b, chunk = self.batch_size, self.admit_every
        io = {"inp": self._zeros(5 * b), "out": self._zeros(b * chunk + 4 * b + 1),
              "noise": self._noise_buf((chunk, b, self.vocab))}

        def step(tok, pos, start, done):
            return _rows_decode_step(self.params, self._caches, tok, pos, start,
                                     n_heads=self.n_heads, **self._moe())

        return _Program(lambda: self._chunk_loop(io, b, step, freeze_done=False), io,
                        self.device, self.cuda_graphs)

    def _chunk_noise(self) -> Optional[Dict]:
        """One chunk's draws: step ``i`` folds ``(1 << 20 | chunk_idx,
        i)``.  Call before bumping ``_chunk_idx``."""
        if self._structure[0]:
            return None
        c = _CHUNK_KEY | self._chunk_idx
        shape = (self.batch_size, self.vocab)
        return {"noise": torch.stack([
            _draw(self._rng, (c, i), shape, "gumbel", self.device)
            for i in range(self.admit_every)
        ])}

    def _unpack_chunk(self, flat: np.ndarray, b: int):
        """``(out [B, chunk], steps)`` and the host row state from a
        chunk's output."""
        chunk = self.admit_every
        out = flat[:b * chunk].reshape(b, chunk)
        tok, pos, done, remaining = flat[b * chunk:b * chunk + 4 * b].reshape(4, b)
        self._tok = tok.astype(np.int32)
        self._pos = pos.astype(np.int32)
        self._done = done.astype(bool)
        self._remaining = remaining.astype(np.int32)
        return out, int(flat[-1])

    def _admit_pending(self) -> None:
        for slot in range(self.batch_size):
            # keep pulling from the queue until the slot holds an ACTIVE
            # row: a request that retires at admission itself (first token
            # is EOS, or budget 1) must not idle the slot for a chunk
            while self._queue and self._slots[slot] is None:
                self._admit_into(slot, self._queue.popleft())
        self._m_queue_depth.set(len(self._queue))
        self._m_active.set(self.active)

    def _admit_into(self, slot: int, req: Request) -> None:
        req.timings.queue_s += req.watch.elapsed() - req.last_queued_at
        t0 = time.perf_counter()
        with self.timer.phase(
            "admit", request=req.id, bucket=req.bucket,
            **self._trace_args(req.trace_id),
        ):
            tokens, start = pack_prompts([req.prompt], req.bucket, self.pad_id)
            noise = None
            if not self._structure[0]:
                noise = {"noise": _draw(self._rng, (self._n_admits,), (1, self.vocab),
                                        "gumbel", self.device)}
            self._n_admits += 1
            prog = self._call(
                ("admit", req.bucket, self._structure),
                lambda: self._make_admit(req.bucket),
                tokens.numpy(), start.numpy(), [slot], noise=noise,
            )
            first = int(prog.read()[0])
        req.timings.prefill_s += time.perf_counter() - t0
        self._m_admitted.inc()
        req.ttft_s = req.watch.elapsed()
        self._m_ttft.observe(req.ttft_s)
        if first == self.eos_id:
            self._retire(req, [first], "eos")
        elif req.max_new_tokens == 1:
            self._retire(req, [first], "budget")
        else:
            self._slots[slot] = {"req": req, "emitted": [first]}
            self._tok[slot] = first
            self._pos[slot] = req.bucket
            self._start[slot] = req.bucket - req.prompt.size
            self._done[slot] = False
            self._remaining[slot] = req.max_new_tokens - 1

    def _run_chunk(self) -> None:
        faults.fire("engine.decode_step")
        self._peak_active = max(self._peak_active, self.active)
        residents = [st["req"] for st in self._slots if st is not None]
        b = self.batch_size
        t0 = time.perf_counter()
        with self.timer.phase(
            "decode", active=self.active, **self._decode_trace_args(residents),
        ):
            noise = self._chunk_noise()
            self._chunk_idx += 1
            prog = self._call(
                ("chunk", self.admit_every, b, self._structure), self._make_chunk,
                self._tok, self._pos, self._start, self._done, self._remaining,
                noise=noise,
            )
            # ONE host read per chunk: emissions and the [B] row state
            out, steps = self._unpack_chunk(prog.read(), b)
        dt = time.perf_counter() - t0
        for r in residents:
            r.timings.decode_s += dt
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            reason = self._collect(st, out[slot, :steps])
            if reason is not None:
                self._retire(st["req"], st["emitted"], reason)
                self._slots[slot] = None
                self._done[slot] = True
                self._remaining[slot] = 0
        self._m_active.set(self.active)

    def _collect(self, st: dict, tokens) -> Optional[str]:
        """Append a row's emitted tokens until EOS or its budget; returns
        the finish reason, or None while the row decodes on."""
        req, emitted = st["req"], st["emitted"]
        for t in tokens:
            emitted.append(int(t))
            if int(t) == self.eos_id:
                return "eos"
            if len(emitted) >= req.max_new_tokens:
                return "budget"
        return None

    def _retire(self, req: Request, emitted: List[int], reason: str):
        dt = req.watch.elapsed()
        comp = Completion(
            id=req.id,
            tokens=np.concatenate([req.prompt, np.asarray(emitted, np.int32)]),
            n_new=len(emitted),
            finish_reason=reason,
            latency_s=dt,
            tokens_per_sec=len(emitted) / max(dt, 1e-9),
            bucket=req.bucket,
            ttft_s=req.ttft_s,
            trace_id=req.trace_id,
            timings=req.timings.as_dict(),
        )
        self._order.append(comp)
        self.completions[req.id] = comp
        self.latency.record(dt)  # feeds the shared registry histogram
        self._total_new += len(emitted)
        self._m_retired.labels(reason=reason).inc()
        self._m_tokens.inc(len(emitted))
        observability.instant(
            "serve/retired", id=req.id, reason=reason, **self._trace_args(req.trace_id),
        )

    # -- out-of-band retirement (cancellation / deadlines) ----------------

    def abort(self, request_id: int, reason: str) -> Optional[Completion]:
        """Retire a request OUT OF BAND with a typed completion, wherever
        it lives: still queued (removed, zero tokens) or occupying a slot
        (tokens emitted so far are kept; the slot, and on the paged backend
        its blocks, is reclaimed at once).  Returns the typed
        :class:`Completion`, or None when the id is unknown or already
        completed.  Not thread-safe: call from the thread that drives the
        engine."""
        for i, req in enumerate(self._queue):
            if req.id == request_id:
                del self._queue[i]
                self._m_queue_depth.set(len(self._queue))
                req.timings.queue_s += req.watch.elapsed() - req.last_queued_at
                self._retire(req, [], reason)
                return self.completions[request_id]
        for slot, st in enumerate(self._slots):
            if st is not None and st["req"].id == request_id:
                self._abort_slot(slot, reason)
                return self.completions[request_id]
        return None

    def reap(self, request_id: int) -> None:
        """Forget a completed request's record (a long-lived service copies
        each completion out and reaps it, so the engine's ledgers stay
        bounded)."""
        if self.completions.pop(request_id, None) is not None:
            self._order = [c for c in self._order if c.id != request_id]

    def _abort_slot(self, slot: int, reason: str) -> None:
        """Dense out-of-band slot retirement: the slot just empties (its
        stale K/V is rebuilt from a zeroed row at re-admission)."""
        st = self._slots[slot]
        self._retire(st["req"], list(st.get("emitted") or []), reason)
        self._slots[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        self._m_active.set(self.active)

    # -- introspection ----------------------------------------------------

    def prefix_probe(self, prompt) -> Dict:
        """Public prefix-cache probe; the dense backend has no shareable
        blocks, so its answer is the empty probe."""
        np.asarray(prompt, np.int32).reshape(-1)  # same coercion contract
        return {
            "prefix_cache": False,
            "block_size": None,
            "block_keys": [],
            "cached_blocks": 0,
            "cached_tokens": 0,
        }

    def _graph_entries(self, kind: str) -> int:
        """CUDA graphs of one program kind this engine holds (0 on the
        CPU, where programs run eagerly)."""
        return sum(1 for k, p in self._progs.items() if k[0] == kind and p.graph is not None)

    def compile_stats(self) -> Dict:
        """Program-count hook: ``programs`` maps each key to 1 (one
        program per key over the engine's lifetime); ``program_hits``
        counts calls that reused one.  ``*_graph_entries`` are this
        engine's captured graphs of each kind (the JAX package reports its
        process-wide jit caches there instead)."""
        return {
            "programs": dict(self._programs),
            "n_programs": len(self._programs),
            "program_hits": self._program_hits,
            "admit_graph_entries": self._graph_entries("admit"),
            "chunk_graph_entries": self._graph_entries("chunk"),
        }

    def spec_stats(self) -> Dict:
        """The ``spec`` sub-dict of :meth:`stats`: disabled on the dense
        backend."""
        return {"enabled": False}

    def stats(self) -> Dict:
        """Serving report: completions, generated tokens, the per-request
        latency aggregate, per-phase host timings, program counts and the
        speculative sub-dict.  ``peak_active`` is the most rows decoding in
        one chunk."""
        return {
            "kv_backend": self.kv_backend,
            "completed": len(self.completions),
            "generated_tokens": self._total_new,
            "peak_active": self._peak_active,
            "latency": self.latency.summary(),
            "phases": self.timer.summary(),
            "tick_occupancy": self.tick_occupancy(),
            "spec": self.spec_stats(),
            **self.compile_stats(),
        }


# ---------------------------------------------------------------------------
# The paged engine.


class PagedDecodeEngine(DecodeEngine):
    """Paged-KV continuous batching: refcounted copy-on-write block pool,
    cross-request prefix cache, chunked prefill, preemption under pressure
    and speculative decoding.

    Same queue surface as :class:`DecodeEngine` (``submit``/``run``/
    ``stats``), different memory model: K/V live in a shared ``[n_blocks,
    block_size, H, hd]`` pool a layer; each slot owns an ordered block
    table and every pool block carries a REFCOUNT.

    * **memory-proportional concurrency**: a slot consumes blocks for the
      tokens it has decoded, not a ``T_max`` reservation.
    * **prefix reuse**: retiring (and preempted) requests publish their
      completed full blocks into a prefix cache keyed by CHAINED content
      hash; admission maps the longest cached chain prefix of the prompt
      with refcount bumps and chunk-prefills only the uncached tail.
      Shared blocks are READ-ONLY: a write into a block other tables or
      the cache reference COW-splits it first.  Prompts anchor at position
      0 and right-pad the final chunk so a shared prefix fills identical
      block contents whatever the prompt's length.
    * **chunked prefill**: prompts run in block-sized chunks under a
      per-tick TOKEN budget (``prefill_budget``), interleaved with decode
      chunks.
    * **eviction before preemption**: a dry free list first EVICTS the
      least-recently-used cache-only block; only when the cache too is
      empty is the YOUNGEST occupant preempted (publish, release, requeue
      at the queue head for recompute).

    ONE prefill program plus a short x2 ladder of decode-chunk variants
    (keyed by the active block-WINDOW rung) cover any stream.
    ``n_blocks`` defaults to the dense-equivalent footprint
    (``batch_size * ceil(T_max/block_size) + 1``).  ``prefix_cache=False``
    disables sharing (blocks then free directly at release, LIFO)."""

    kv_backend = "paged"

    def __init__(
        self,
        params,
        *,
        n_heads: int,
        eos_id: int,
        batch_size: int = 8,
        max_seq: Optional[int] = None,
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefill_budget: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        admit_every: int = 8,
        pad_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng=None,
        moe_top_k: int = 1,
        moe_dispatch: str = "dense",
        spec_k: int = 0,
        drafter=None,
        spec_buckets: Sequence[int] = DEFAULT_SPEC_BUCKETS,
        cuda_graphs: bool = True,
    ):
        if block_size < 1:
            raise ValueError(f"want block_size >= 1; got {block_size}")
        self.block_size = int(block_size)
        self._n_blocks_arg = n_blocks
        self.prefix_cache = True if prefix_cache is None else bool(prefix_cache)
        if spec_k < 0:
            raise ValueError(f"want spec_k >= 0; got {spec_k}")
        self.spec_k = int(spec_k)
        self.spec_buckets = tuple(int(w) for w in spec_buckets)
        if (
            not self.spec_buckets
            or min(self.spec_buckets) < 2
            or list(self.spec_buckets) != sorted(set(self.spec_buckets))
        ):
            raise ValueError(
                "spec_buckets must be strictly increasing verify "
                f"widths >= 2 (k+1 rungs); got {spec_buckets}"
            )
        if drafter is not None and not self.spec_k:
            raise ValueError(
                "a drafter was given but spec_k == 0 keeps speculation "
                "off; pass spec_k >= 1 to enable it"
            )
        self.drafter = (
            drafter if drafter is not None else PromptLookupDrafter()
        ) if self.spec_k else None
        # per-tick prefill token budget; the default matches one decode
        # chunk's per-row depth in tokens
        self.prefill_budget = int(
            prefill_budget if prefill_budget is not None
            else max(admit_every, 1) * self.block_size
        )
        if self.prefill_budget < 1:
            raise ValueError(f"want prefill_budget >= 1; got {self.prefill_budget}")
        super().__init__(
            params, n_heads=n_heads, eos_id=eos_id,
            batch_size=batch_size, max_seq=max_seq,
            admit_every=admit_every, pad_id=pad_id,
            temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
            moe_top_k=moe_top_k, moe_dispatch=moe_dispatch, cuda_graphs=cuda_graphs,
        )

    def _init_kv_state(self) -> None:
        m = -(-self.t_max // self.block_size)  # table width: ceil
        if self._n_blocks_arg is None:
            self.n_blocks = self.batch_size * m + 1
        else:
            self.n_blocks = int(self._n_blocks_arg)
        self.blocks_per_row = m
        self._pools = init_paged_kv(
            self.params, self.n_blocks, self.block_size, n_heads=self.n_heads,
        )
        # LIFO free list; block 0 stays reserved as null
        self._free: List[int] = list(range(1, self.n_blocks))
        # per-block refcount = how many tables reference it; the cache
        # reference is tracked separately by _block_hash membership
        self._ref = np.zeros(self.n_blocks, np.int64)
        # prefix cache: chained content hash -> block, its inverse, and an
        # LRU over CACHE-ONLY blocks (refcount 0: evictable)
        self._cache: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._lru: OrderedDict = OrderedDict()
        self._row_blocks: List[List[int]] = [[] for _ in range(self.batch_size)]
        self._tables = np.full((self.batch_size, m), NULL_BLOCK, np.int32)
        self._n_prefix_hits = 0
        self._n_prefix_misses = 0
        self._n_cached_tokens = 0
        self._n_evictions = 0
        self._n_cow = 0
        # one admission EVENT per request, ever (a preempted request's
        # readmission re-fires no serve/admit span, admitted count or TTFT)
        self._admitted_ids: set = set()
        self._n_preempted = 0
        # per-block K/V bytes across the whole tower
        self.block_bytes = sum(
            2 * p["k"][0].numel() * p["k"].element_size() for p in self._pools
        )
        self._prefill_start = self._zeros(1)  # prompts anchor at position 0
        self._m_pool = observability.gauge(
            "znicz_serve_kv_pool_blocks",
            "paged KV pool blocks by state (the null block is excluded)",
            ("state",),
        )
        self._m_pool_bytes = observability.gauge(
            "znicz_serve_kv_pool_bytes",
            "paged KV pool bytes by state (blocks x per-block K/V "
            "bytes across the tower; the null block is excluded)",
            ("state",),
        )
        self._m_preempted = observability.counter(
            "znicz_serve_preemptions_total",
            "requests preempted under pool pressure (freed + requeued)",
        )
        self._m_prefill_chunks = observability.counter(
            "znicz_serve_prefill_chunks_total",
            "prompt chunks run by the paged prefill program",
        )
        self._m_prefix_hits = observability.counter(
            "znicz_serve_prefix_hits_total",
            "prompt blocks mapped from the prefix cache at admission",
        )
        self._m_prefix_misses = observability.counter(
            "znicz_serve_prefix_misses_total",
            "full prompt blocks that missed the prefix cache at admission",
        )
        self._m_prefix_tokens = observability.counter(
            "znicz_serve_prefix_cached_tokens_total",
            "prompt tokens whose prefill was skipped via the prefix cache",
        )
        self._m_prefix_evictions = observability.counter(
            "znicz_serve_prefix_evictions_total",
            "cached blocks evicted to satisfy allocation pressure",
        )
        self._n_spec_drafted = 0
        self._n_spec_accepted = 0
        self._n_spec_rejected = 0
        self._n_verify_steps = 0
        self._m_spec_drafted = observability.counter(
            "znicz_serve_spec_drafted_total",
            "draft tokens proposed to the speculative verifier",
        )
        self._m_spec_accepted = observability.counter(
            "znicz_serve_spec_accepted_total",
            "draft tokens the speculative verifier accepted",
        )
        self._m_spec_rejected = observability.counter(
            "znicz_serve_spec_rejected_total",
            "draft tokens rejected and rolled back (table truncate)",
        )
        self._m_spec_accept_len = observability.histogram(
            "znicz_serve_spec_accept_length",
            "accepted draft tokens per row per verify step",
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0),
        )
        self._update_pool_gauges()

    # -- capacity & the block allocator -----------------------------------

    @property
    def usable_blocks(self) -> int:
        """Pool capacity available to requests (null block excluded)."""
        return self.n_blocks - 1

    def _validate_request(self, p: np.ndarray, max_new_tokens: int) -> int:
        padded = -(-p.size // self.block_size) * self.block_size
        total = padded + max_new_tokens
        need = -(-total // self.block_size)
        if total > self.t_max:
            raise RequestTooLargeError(
                f"prompt (len {p.size}, padded {padded}) + max_new_tokens "
                f"{max_new_tokens} exceeds the paged backend's positional "
                f"window (t_max={self.t_max})"
            )
        if need > self.usable_blocks:
            raise RequestTooLargeError(
                f"prompt (len {p.size}, padded {padded}) + max_new_tokens "
                f"{max_new_tokens} needs {need} KV blocks; exceeds the "
                f"paged KV pool ({self.usable_blocks} usable blocks x "
                f"{self.block_size} tokens)"
            )
        return padded  # admission width: the padded prompt length

    def _update_pool_gauges(self) -> None:
        free = len(self._free)
        cached = len(self._lru)
        used = self.usable_blocks - free - cached
        self._m_pool.labels(state="free").set(free)
        self._m_pool.labels(state="cached").set(cached)
        self._m_pool.labels(state="used").set(used)
        bb = self.block_bytes
        self._m_pool_bytes.labels(state="free").set(free * bb)
        self._m_pool_bytes.labels(state="cached").set(cached * bb)
        self._m_pool_bytes.labels(state="used").set(used * bb)

    def _slots_by_age(self) -> List[int]:
        """Occupied slot indices, oldest admission first."""
        occ = [
            (self._slots[i]["seq"], i)
            for i in range(self.batch_size)
            if self._slots[i] is not None
        ]
        return [i for _, i in sorted(occ)]

    def _youngest_slot(self) -> int:
        return max(
            (i for i in range(self.batch_size) if self._slots[i] is not None),
            key=lambda i: self._slots[i]["seq"],
        )

    def _incref(self, blk: int) -> None:
        self._ref[blk] += 1

    def _decref(self, blk: int) -> None:
        """Drop one table reference; at zero the block becomes EVICTABLE
        cache (if published) or returns to the free list."""
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            if blk in self._block_hash:
                self._lru[blk] = None  # MRU end
            else:
                self._free.append(blk)

    def _alloc_block(self) -> int:
        """One unreferenced, uncached block: free list first, then EVICT
        the least-recently-used cache-only block.  Returns -1 when both are
        dry (the caller preempts)."""
        faults.fire("pool.alloc")  # injected allocator failure (raises)
        if faults.fire("pool.pressure"):
            return -1  # injected exhaustion: free list AND cache "dry"
        if self._free:
            return self._free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)
            del self._cache[self._block_hash.pop(blk)]
            self._n_evictions += 1
            self._m_prefix_evictions.inc()
            return blk
        return -1

    def _alloc_for(self, slot: int) -> Optional[int]:
        """One referenced block for ``slot``, preempting the youngest
        occupant while the pool stays dry.  None when the starved slot was
        itself the youngest and got preempted."""
        while True:
            blk = self._alloc_block()
            if blk >= 0:
                self._incref(blk)
                return blk
            victim = self._youngest_slot()
            self._preempt(victim)
            if victim == slot:
                return None

    def _release_row(self, slot: int) -> None:
        """Drop every table reference of ``slot`` (reverse order keeps the
        free list LIFO)."""
        row = self._row_blocks[slot]
        for blk in reversed(row):
            self._decref(blk)
        row.clear()
        self._tables[slot, :] = NULL_BLOCK
        self._update_pool_gauges()

    def _clear_row_state(self, slot: int) -> None:
        """An empty slot idles as done at position 0 (it writes to the null
        block and can never index past a narrowed decode window)."""
        self._slots[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._start[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``: publish its completed full blocks into the
        prefix cache, release its table references and requeue its
        request at the queue HEAD, to be recomputed on readmission."""
        req = self._slots[slot]["req"]
        self._publish_row(slot)
        self._release_row(slot)
        self._clear_row_state(slot)
        self._queue.appendleft(req)
        req.timings.preemptions += 1
        req.last_queued_at = req.watch.elapsed()
        self._n_preempted += 1
        self._m_preempted.inc()
        self._m_queue_depth.set(len(self._queue))
        observability.instant("serve/preempt", id=req.id, **self._trace_args(req.trace_id))

    def _ensure_blocks(self, slot: int, need: int) -> bool:
        """Grow ``slot``'s table to >= ``need`` blocks, preempting the
        youngest occupant whenever the pool is dry.  False when the starved
        slot was itself the youngest and got preempted."""
        row = self._row_blocks[slot]
        while len(row) < need:
            blk = self._alloc_for(slot)
            if blk is None:
                return False
            self._tables[slot, len(row)] = blk
            row.append(blk)
        self._update_pool_gauges()
        return True

    def _shared(self, blk: int) -> bool:
        """A block this row must NOT write into: other tables reference it,
        or the prefix cache does."""
        return self._ref[blk] > 1 or blk in self._block_hash

    def _make_cow(self) -> _Program:
        """``("cow", block_size)``: copy pool block ``src`` into ``dst`` in
        every layer.  Input: ``src | dst``."""
        io = {"inp": self._zeros(2), "out": self._zeros(1)}

        def run():
            copy_paged_block(self._pools, io["inp"][0], io["inp"][1])

        return _Program(run, io, self.device, self.cuda_graphs)

    def _cow_split(self, slot: int, j: int, *, copy: bool) -> bool:
        """Copy-on-write: retarget table entry ``j`` of ``slot`` to a fresh
        private block before a write into a shared/cached block.
        ``copy=False`` when the write rewrites the whole block.  No-op for
        private blocks.  False when allocation had to preempt ``slot``."""
        blk = int(self._row_blocks[slot][j])
        if not self._shared(blk):
            return True
        new = self._alloc_for(slot)
        if new is None:
            return False
        if copy:
            self._call(("cow", self.block_size), self._make_cow, [blk, new])
        self._decref(blk)
        self._row_blocks[slot][j] = new
        self._tables[slot, j] = new
        self._n_cow += 1
        self._update_pool_gauges()
        return True

    # -- the prefix cache -------------------------------------------------

    def _chain_hashes(self, tokens: np.ndarray):
        yield from _chain_digests(tokens, self.block_size)

    def prefix_probe(self, prompt) -> Dict:
        """Paged probe: the prompt's chained block keys plus how many lead
        blocks are CURRENTLY resident in this engine's prefix cache (a
        snapshot, not a reservation)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        keys: List[str] = []
        cached = 0
        walking = self.prefix_cache
        for h in _chain_digests(p, self.block_size):
            keys.append(h.hex())
            if walking and h in self._cache:
                cached += 1
            else:
                walking = False
        return {
            "prefix_cache": self.prefix_cache,
            "block_size": self.block_size,
            "block_keys": keys,
            "cached_blocks": cached,
            "cached_tokens": cached * self.block_size,
        }

    def _lookup_prefix(self, req: Request) -> List[int]:
        """Longest cached block-chain prefix of the request's prompt (full
        blocks only).  Claim-free: the caller bumps refcounts when it
        binds."""
        hits: List[int] = []
        if not self.prefix_cache:
            return hits
        if req.digests is None:
            req.digests = list(self._chain_hashes(req.prompt))
        for h in req.digests:
            blk = self._cache.get(h)
            if blk is None:
                break
            hits.append(blk)
        return hits

    def _publish_row(self, slot: int) -> None:
        """Retire/preempt hook: publish this row's COMPLETED full blocks
        into the prefix cache.  First writer wins when two physical blocks
        hold the same content."""
        if not self.prefix_cache:
            return
        st = self._slots[slot]
        req = st["req"]
        emitted = st.get("emitted") or []
        if st["mode"] == "prefill":
            covered = min(st["chunks_done"] * self.block_size, req.prompt.size)
        else:
            # the whole prompt plus every emitted token EXCEPT the last
            # (sampled, never fed back, so its K/V was never written)
            covered = req.prompt.size + max(len(emitted) - 1, 0)
        row = self._row_blocks[slot]
        n_full = min(covered // self.block_size, len(row))
        if not n_full:
            return
        toks = np.concatenate(
            [req.prompt, np.asarray(emitted, np.int32)]
        )[: n_full * self.block_size]
        for j, h in enumerate(self._chain_hashes(toks)):
            blk = int(row[j])
            if h in self._cache or blk in self._block_hash:
                continue  # already published (a mapped prefix), or dup
            self._cache[h] = blk
            self._block_hash[blk] = h

    def flush_prefix_cache(self) -> int:
        """Drop every cache entry; cache-only blocks return to the free
        list.  Returns entries dropped."""
        n = len(self._cache)
        self._cache.clear()
        self._block_hash.clear()
        self._free.extend(self._lru)
        self._lru.clear()
        self._update_pool_gauges()
        return n

    # -- admission: chunked prefill ---------------------------------------

    def _admit_pending(self) -> None:
        # bind a queued request only when the pool can already hold the
        # UNCACHED part of its prompt beyond what in-flight prefills are
        # still owed (owed 0 in prefill mode is the fully-cached case: its
        # final chunk will COW-split one block)
        reserved = sum(
            max(s["req"].bucket // self.block_size - len(self._row_blocks[i]), 1)
            for i, s in enumerate(self._slots)
            if s is not None and s["mode"] == "prefill"
        )
        for slot in range(self.batch_size):
            if self._slots[slot] is None and self._queue:
                req = self._queue[0]
                hits = self._lookup_prefix(req)
                need = max(req.bucket // self.block_size - len(hits), 1)
                pool = (
                    len(self._free)
                    + len(self._lru)
                    - sum(1 for b in hits if b in self._lru)
                )
                if pool - reserved < need:
                    break
                reserved += need
                self._start_prefill(slot, self._queue.popleft(), hits)
        self._m_queue_depth.set(len(self._queue))
        self._m_active.set(self.active)

    def _start_prefill(self, slot: int, req: Request, hits: Optional[List[int]] = None) -> None:
        """Bind a queued request to a slot: claim the longest cached
        block-chain prefix of its prompt and queue only the UNCACHED tail
        for chunked prefill (run lazily by :meth:`_prefill_tick`).  Prompts
        anchor at position 0 and RIGHT-pad the final chunk."""
        req.timings.queue_s += req.watch.elapsed() - req.last_queued_at
        size = req.prompt.size
        tokens = np.full((1, req.bucket), self.pad_id, np.int32)
        tokens[0, :size] = req.prompt
        row = self._row_blocks[slot]
        if hits is None:
            hits = self._lookup_prefix(req)
        for j, blk in enumerate(hits):
            self._incref(blk)
            if blk in self._lru:
                del self._lru[blk]
            self._tables[slot, j] = blk
            row.append(blk)
        # a fully-cached prompt still needs its first-token LOGITS: the
        # final block's chunk re-runs (COW-split off the shared block)
        skip = len(hits) - 1 if hits and len(hits) * self.block_size == size else len(hits)
        req.timings.cached_tokens += skip * self.block_size
        if self.prefix_cache:
            n_lookup = size // self.block_size
            self._n_prefix_hits += len(hits)
            self._n_prefix_misses += n_lookup - len(hits)
            self._n_cached_tokens += skip * self.block_size
            self._m_prefix_hits.inc(len(hits))
            self._m_prefix_misses.inc(n_lookup - len(hits))
            self._m_prefix_tokens.inc(skip * self.block_size)
        self._slots[slot] = {
            "req": req, "emitted": [], "mode": "prefill",
            "seq": self._n_admits, "tokens": tokens,
            "chunks_done": skip,
        }
        self._n_admits += 1
        self._done[slot] = True
        self._remaining[slot] = 0
        self._update_pool_gauges()

    def _prefill_tick(self) -> None:
        """Prompt chunks for prefilling slots, oldest first, under a
        per-tick TOKEN budget; while NOTHING is decoding the budget is
        waived and chunks run back to back."""
        budget = self.prefill_budget
        for slot in self._slots_by_age():
            while budget > 0 or self.active == 0:
                if not self._prefill_chunk_for(slot):
                    break
                budget -= self.block_size
        self._m_active.set(self.active)

    def _make_prefill(self) -> _Program:
        """``("prefill", block_size, structure)``: one aligned prompt chunk
        into the row's block, and the first-token sample at ``last``.
        Input: ``table [M] | tokens [block_size] | offset | last``."""
        m, bs = self.blocks_per_row, self.block_size
        io = {"inp": self._zeros(m + bs + 2), "out": self._zeros(1),
              "noise": self._noise_buf((1, self.vocab))}

        def run():
            inp = io["inp"]
            _, logits = paged_prefill_chunk(
                self.params, self._pools, inp[:m], inp[m:m + bs].view(1, bs), inp[m + bs],
                n_heads=self.n_heads, block_size=bs, start=self._prefill_start,
                last=inp[m + bs + 1], **self._moe(),
            )
            io["out"].copy_(self._sample(logits, io["noise"]))

        return _Program(run, io, self.device, self.cuda_graphs)

    def _prefill_chunk_for(self, slot: int) -> bool:
        """Run one prefill chunk for ``slot``; True while the slot remains
        in prefill mode."""
        st = self._slots[slot]
        if st is None or st["mode"] != "prefill":
            return False  # preempted mid-tick, or already decoding
        faults.fire("engine.prefill")
        req = st["req"]
        size = req.prompt.size
        c = st["chunks_done"]
        if not self._ensure_blocks(slot, c + 1):
            return False  # starved AND youngest: requeued itself
        if not self._cow_split(slot, c, copy=False):
            return False
        last = c == req.bucket // self.block_size - 1
        first_time = req.id not in self._admitted_ids
        t0 = time.perf_counter()
        bs = self.block_size
        with self.timer.phase(
            "admit" if last and first_time else "prefill",
            request=req.id, bucket=req.bucket, chunk=c,
            **self._trace_args(req.trace_id),
        ):
            noise = None
            if last and not self._structure[0]:
                # only the final chunk's sample is read
                noise = {"noise": _draw(self._rng, (st["seq"],), (1, self.vocab), "gumbel",
                                        self.device)}
            prog = self._call(
                ("prefill", bs, self._structure), self._make_prefill,
                self._tables[slot], st["tokens"][:, c * bs:(c + 1) * bs], [c * bs],
                [(size - 1) % bs if last else bs - 1], noise=noise,
            )
            st["chunks_done"] = c + 1
            if last:
                first = int(prog.read()[0])  # host read only at admission
        req.timings.prefill_s += time.perf_counter() - t0
        self._m_prefill_chunks.inc()
        if not last:
            return True
        if first_time:
            self._admitted_ids.add(req.id)
            req.ttft_s = req.watch.elapsed()
            self._m_admitted.inc()
            self._m_ttft.observe(req.ttft_s)
        if first == self.eos_id:
            self._retire_slot(slot, [first], "eos")
        elif req.max_new_tokens == 1:
            self._retire_slot(slot, [first], "budget")
        else:
            st["mode"] = "decode"
            st["emitted"] = [first]
            self._tok[slot] = first
            self._pos[slot] = size
            self._start[slot] = 0
            self._done[slot] = False
            self._remaining[slot] = req.max_new_tokens - 1
        return False

    def _retire_slot(self, slot: int, emitted: List[int], reason: str):
        self._slots[slot]["emitted"] = emitted
        self._publish_row(slot)
        self._retire(self._slots[slot]["req"], emitted, reason)
        self._release_row(slot)
        self._clear_row_state(slot)

    def _abort_slot(self, slot: int, reason: str) -> None:
        """Paged out-of-band retirement rides the normal retire hook:
        completed full blocks publish to the prefix cache and every table
        reference is released."""
        st = self._slots[slot]
        self._retire_slot(slot, list(st.get("emitted") or []), reason)
        self._m_active.set(self.active)

    # -- the serving loop -------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None and s["mode"] == "decode")

    @property
    def prefilling(self) -> int:
        return sum(1 for s in self._slots if s is not None and s["mode"] == "prefill")

    def _has_work(self) -> bool:
        return bool(self._queue) or self.active > 0 or self.prefilling > 0

    def _grow_for_chunk(self, steps_for) -> bool:
        """Pre-chunk allocation + write guard, oldest first: each decoding
        row gets blocks covering the ``steps_for(slot)`` positions the
        coming chunk may write; exhaustion preempts the youngest occupant;
        a write-range block still shared is COW-split (with copy).  False
        when pressure preempted every decoder."""
        for slot in self._slots_by_age():
            st = self._slots[slot]
            if st is None or st["mode"] != "decode":
                continue
            p0 = int(self._pos[slot])
            last_pos = p0 + max(int(steps_for(slot)) - 1, 0)
            if not self._ensure_blocks(slot, last_pos // self.block_size + 1):
                continue  # starved AND youngest: requeued itself
            for j in range(p0 // self.block_size, last_pos // self.block_size + 1):
                if self._slots[slot] is None:
                    break  # a COW allocation preempted this very row
                if not self._cow_split(slot, j, copy=True):
                    break
        return self.active > 0

    def _decode_window(self) -> int:
        """The decode/verify gather WINDOW: the x2 rung covering the blocks
        active rows hold."""
        need = max(
            (len(self._row_blocks[i]) for i, s in enumerate(self._slots)
             if s is not None and s["mode"] == "decode"),
            default=1,
        )
        window = 1
        while window < need:
            window *= 2
        return min(window, self.blocks_per_row)

    def _residents(self) -> List[Request]:
        return [s["req"] for s in self._slots if s is not None and s["mode"] == "decode"]

    # -- speculative decoding: draft -> verify -> accept -> rollback ------

    def _draft_pending(self) -> Dict[int, np.ndarray]:
        """One drafting pass over the decoding rows (context: the row's
        own prompt plus everything it emitted; clamped so accepted drafts
        never outrun the budget).  {} when NO row drafted."""
        drafts: Dict[int, np.ndarray] = {}
        any_draft = False
        for slot, st in enumerate(self._slots):
            if st is None or st["mode"] != "decode":
                continue
            req = st["req"]
            rem = req.max_new_tokens - len(st["emitted"])
            k = min(self.spec_k, rem - 1)
            d = np.zeros((0,), np.int32)
            if k > 0:
                ctx = np.concatenate([req.prompt, np.asarray(st["emitted"], np.int32)])
                d = np.asarray(self.drafter.propose(ctx, k), np.int32).reshape(-1)[:k]
            drafts[slot] = d
            any_draft = any_draft or d.size > 0
        return drafts if any_draft else {}

    def _make_verify(self, w: int, window: int) -> _Program:
        """``("spec_verify", width, B, window, structure)``: score ``w``
        input tokens a row in one pass and keep each row's longest agreeing
        prefix.  Input: ``tables [B, window] | tokens [B, w] | pos | start
        | done | n_write | draft_len``; output ``out [B, w] | n_accept``."""
        b = self.batch_size
        sampled = not self._structure[0]
        io = {"inp": self._zeros(b * window + b * w + 5 * b), "out": self._zeros(b * w + b),
              "uniform": self._zeros((b, w), torch.float32) if sampled else None,
              "gumbel": self._zeros((b, w, self.vocab), torch.float32) if sampled else None}
        greedy, top_k, nucleus = self._structure

        def run():
            inp = io["inp"]
            tables = inp[:b * window].view(b, window)
            tokens = inp[b * window:b * (window + w)].view(b, w)
            pos, start, done, n_write, draft_len = inp[b * (window + w):].view(5, b).unbind(0)
            idx = torch.arange(w, device=self.device)[None, :]
            wmask = (done == 0)[:, None] & (idx < n_write[:, None])
            _, logits = paged_verify_chunk(
                self.params, self._pools, tables, tokens, pos, n_heads=self.n_heads,
                block_size=self.block_size, start=start, write_mask=wmask, **self._moe(),
            )
            # position i predicts the token AFTER input token i; the draft
            # for it is tokens[:, i+1], which exists iff i < draft_len
            has_draft = idx < draft_len[:, None]
            d_next = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
            if greedy:
                out = torch.argmax(logits, dim=-1)
                acc = (out == d_next) & has_draft
            else:
                flt = _filter_logits(logits, self._temperature, top_k, nucleus, self._top_p)
                probs = torch.softmax(flt, dim=-1)
                p_draft = probs.gather(-1, d_next[..., None])[..., 0]
                acc = (io["uniform"] <= p_draft) & has_draft
                # a rejected draft resamples the RESIDUAL (the draft masked
                # out); an undrafted position samples the filtered
                # distribution directly
                vocab = flt.shape[-1]
                is_d = (torch.arange(vocab, device=self.device)[None, None, :]
                        == d_next[..., None]) & has_draft[..., None]
                corr = torch.argmax(io["gumbel"] + torch.where(is_d, -torch.inf, flt), dim=-1)
                out = torch.where(acc, d_next, corr)
            n_accept = torch.cumprod(acc.long(), dim=1).sum(dim=1)
            io["out"].copy_(torch.cat([out.reshape(-1), n_accept]))

        return _Program(run, io, self.device, self.cuda_graphs)

    def _verify_chunk(self, drafts: Dict[int, np.ndarray]) -> None:
        """One speculative tick: pack every decoding row's last token +
        drafted continuation into a ``[B, W]`` verify batch (W the drafted
        max snapped UP the ``spec_buckets`` ladder), run ONE verify
        program, emit each row's longest agreeing prefix plus the bonus
        token, and ROLL BACK the rest by truncating the block table."""
        w = bucket_for(max(d.size for d in drafts.values()) + 1, self.spec_buckets)
        b = self.batch_size
        tokens = np.full((b, w), self.pad_id, np.int32)
        n_write = np.zeros((b,), np.int32)
        draft_len = np.zeros((b,), np.int32)
        for slot, d in drafts.items():
            st = self._slots[slot]
            req = st["req"]
            rem = req.max_new_tokens - len(st["emitted"])
            dl = min(d.size, w - 1, max(rem - 1, 0))
            tokens[slot, 0] = self._tok[slot]
            tokens[slot, 1:1 + dl] = d[:dl]
            draft_len[slot] = dl
            # only positions 0..dl are ever READ back; masking the bucket
            # pad avoids garbage writes and needless allocation
            n_write[slot] = dl + 1
        if not self._grow_for_chunk(lambda slot: int(n_write[slot])):
            return  # allocation pressure preempted every decoder
        self._peak_active = max(self._peak_active, self.active)
        window = self._decode_window()
        residents = self._residents()
        t0 = time.perf_counter()
        with self.timer.phase(
            "verify", active=self.active, width=w, **self._decode_trace_args(residents),
        ):
            noise = None
            if not self._structure[0]:
                c = _CHUNK_KEY | self._chunk_idx
                noise = {"uniform": _draw(self._rng, (c, 0), (b, w), "uniform", self.device),
                         "gumbel": _draw(self._rng, (c, 1), (b, w, self.vocab), "gumbel",
                                         self.device)}
            self._chunk_idx += 1
            prog = self._call(
                ("spec_verify", w, b, window, self._structure),
                lambda: self._make_verify(w, window),
                self._tables[:, :window], tokens, self._pos, self._start, self._done,
                n_write, draft_len, noise=noise,
            )
            flat = prog.read()
            out, n_acc = flat[:b * w].reshape(b, w), flat[b * w:]
        dt = time.perf_counter() - t0
        self._n_verify_steps += 1
        for r in residents:
            r.timings.decode_s += dt
        for slot, st in enumerate(self._slots):
            # rows preempted during allocation never reached the program
            if st is None or st["mode"] != "decode":
                continue
            req, emitted = st["req"], st["emitted"]
            dl = int(draft_len[slot])
            na = min(int(n_acc[slot]), dl)
            n0 = len(emitted)
            reason = self._collect(st, out[slot, :na + 1])
            appended = len(emitted) - n0
            self._n_spec_drafted += dl
            self._n_spec_accepted += na
            self._n_spec_rejected += dl - na
            req.timings.spec_drafted += dl
            req.timings.spec_accepted += na
            if dl:
                self._m_spec_drafted.inc(dl)
                self._m_spec_accepted.inc(na)
                self._m_spec_rejected.inc(dl - na)
                self._m_spec_accept_len.observe(float(na))
            if reason is not None:
                self._retire_slot(slot, emitted, reason)
            else:
                self._tok[slot] = emitted[-1]
                self._pos[slot] = int(self._pos[slot]) + appended
                self._remaining[slot] = req.max_new_tokens - len(emitted)
                self._truncate_row(slot)
        self._m_active.set(self.active)

    def _truncate_row(self, slot: int) -> None:
        """Speculative ROLLBACK: drop the table entries past the last
        position holding accepted K/V (bookkeeping only: no device copies,
        no recompute)."""
        row = self._row_blocks[slot]
        keep = (int(self._pos[slot]) - 1) // self.block_size + 1
        if len(row) <= keep:
            return
        for blk in reversed(row[keep:]):
            self._decref(blk)
        del row[keep:]
        self._tables[slot, keep:] = NULL_BLOCK
        self._update_pool_gauges()

    def _make_paged_chunk(self, window: int) -> _Program:
        """``("paged_chunk", admit_every, B, window, structure)``:
        ``admit_every`` paged decode steps for the whole batch through the
        ``[B, window]`` tables; done and idle rows write to the null block
        and their positions freeze.  Input: ``tables [B, window] | tok |
        pos | start | done | remaining``."""
        b, chunk = self.batch_size, self.admit_every
        io = {"inp": self._zeros(b * window + 5 * b),
              "out": self._zeros(b * chunk + 4 * b + 1),
              "noise": self._noise_buf((chunk, b, self.vocab))}
        tables = io["inp"][:b * window].view(b, window)

        def step(tok, pos, start, done):
            _, logits = paged_decode_step(
                self.params, self._pools, tables, tok, pos, n_heads=self.n_heads,
                block_size=self.block_size, start=start, write_mask=~done, **self._moe(),
            )
            return logits

        return _Program(
            lambda: self._chunk_loop(io, b, step, freeze_done=True), io,
            self.device, self.cuda_graphs,
        )

    def _run_chunk(self) -> None:
        faults.fire("engine.decode_step")
        if self.spec_k:
            drafts = self._draft_pending()
            if drafts:
                self._last_chunk_kind = "spec_verify"
                self._verify_chunk(drafts)
                return
            # no row drafted this tick: the plain decode chunk runs
        if not self._grow_for_chunk(
            lambda slot: min(self.admit_every, int(self._remaining[slot]))
        ):
            return  # allocation pressure preempted every decoder
        self._peak_active = max(self._peak_active, self.active)
        window = self._decode_window()
        residents = self._residents()
        b = self.batch_size
        t0 = time.perf_counter()
        with self.timer.phase(
            "decode", active=self.active, **self._decode_trace_args(residents),
        ):
            noise = self._chunk_noise()
            self._chunk_idx += 1
            prog = self._call(
                ("paged_chunk", self.admit_every, b, window, self._structure),
                lambda: self._make_paged_chunk(window),
                self._tables[:, :window], self._tok, self._pos, self._start, self._done,
                self._remaining, noise=noise,
            )
            out, steps = self._unpack_chunk(prog.read(), b)
        dt = time.perf_counter() - t0
        for r in residents:
            r.timings.decode_s += dt
        for slot, st in enumerate(self._slots):
            if st is None or st["mode"] != "decode":
                continue
            reason = self._collect(st, out[slot, :steps])
            if reason is not None:
                self._retire_slot(slot, st["emitted"], reason)
        self._m_active.set(self.active)

    # -- introspection ----------------------------------------------------

    def compile_stats(self) -> Dict:
        """Paged ledger: one ``("prefill", block_size, structure)`` entry
        plus one ``("paged_chunk", chunk, B, window, structure)`` entry per
        x2 window rung the stream reached (and the COW and verify programs
        it used); ``*_graph_entries`` count this engine's captured
        graphs."""
        return {
            "programs": dict(self._programs),
            "n_programs": len(self._programs),
            "program_hits": self._program_hits,
            "prefill_graph_entries": self._graph_entries("prefill"),
            "paged_chunk_graph_entries": self._graph_entries("paged_chunk"),
            "cow_graph_entries": self._graph_entries("cow"),
            "spec_verify_graph_entries": self._graph_entries("spec_verify"),
        }

    @property
    def pool_free_frac(self) -> float:
        """Fraction of the pool still ALLOCATABLE (free list plus evictable
        cache-only blocks)."""
        return (len(self._free) + len(self._lru)) / max(self.usable_blocks, 1)

    def spec_stats(self) -> Dict:
        """The live speculative-decoding report (``stats()["spec"]``)."""
        return {
            "enabled": bool(self.spec_k),
            "k": self.spec_k,
            "buckets": list(self.spec_buckets),
            "drafted": self._n_spec_drafted,
            "accepted": self._n_spec_accepted,
            "rejected": self._n_spec_rejected,
            "verify_steps": self._n_verify_steps,
            "acceptance_rate": round(
                self._n_spec_accepted / max(self._n_spec_drafted, 1), 4
            ),
        }

    def stats(self) -> Dict:
        """Adds the block-pool + prefix-cache view to the base report.
        ``pool_blocks_free`` counts ALLOCATABLE blocks (free list plus
        evictable cache-only blocks)."""
        return {
            **super().stats(),
            "pool_blocks": self.usable_blocks,
            "pool_blocks_free": len(self._free) + len(self._lru),
            "pool_blocks_cached": len(self._lru),
            "block_size": self.block_size,
            "block_bytes": self.block_bytes,
            "pool_bytes": self.usable_blocks * self.block_bytes,
            "preemptions": self._n_preempted,
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "entries": len(self._cache),
                "hits": self._n_prefix_hits,
                "misses": self._n_prefix_misses,
                "cached_tokens": self._n_cached_tokens,
                "evictions": self._n_evictions,
                "cow_splits": self._n_cow,
            },
        }
