"""KV-cache autoregressive decoding for the transformer LM (port of
``znicz_tpu/workflow/generate.py``).

The KV cache is a static ``[B, T_max, H, hd]`` buffer a block; validity is
an index mask, not a dynamic length.  A decode step is one position through
the block tower: its K/V are written into the cache in place
(``index_copy_``) at a position that may be a tensor on the device, and
attention runs over the whole buffer masked to ``<= pos``.  So one decode
step has one shape for every position: on the card it is captured once into
a ``torch.cuda.CUDAGraph`` and replayed for each position (the JAX
package's one ``lax.while_loop`` program); on the CPU the same step runs
eagerly.  A failed capture raises; nothing falls back.  The loop stops at
the budget or, with ``eos_id``, once every row has emitted EOS: on the card
that flag is read two steps late from pinned memory (no sync a token), and
done rows emit ``eos_id``, so the tokens are those of the full-budget run
up to EOS either way.

Sampling is Gumbel-max over the truncated logits (:func:`_filter_logits`),
as ``jax.random.categorical`` is.  ``rng`` is a ``torch.Generator`` on the
decode device (or a callable ``(step, shape) -> noise`` handing each step's
Gumbel noise in, as the tests hand in the JAX package's draws); the noise
of a step is drawn outside the captured graph into a static buffer.

Serving fast path: prompts are left-padded to a geometric ladder of length
buckets and budgets round up a rung, so a request stream makes a handful of
programs (:func:`generate_serve`, :func:`serve_cache_stats`; each program
recorded in :mod:`observability.device`).  Per-row ``start`` offsets make
the padding inert in attention and in the positional embeddings.

Paged KV (vLLM lineage): K/V live in shared ``[n_blocks, block_size, H,
hd]`` pools and each row owns a block table (:func:`paged_prefill_chunk`,
:func:`paged_decode_step`, :func:`paged_verify_chunk`,
:func:`copy_paged_block`).  The pools are updated in place; each function
still returns them, as the JAX package returns new ones.

Numerics match :func:`workflow.transformer.lm_apply` (same projections,
f32 score accumulation, stable softmax), which the tests assert position by
position against it and against the JAX package.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability import device as device_telemetry
from znicz_tpu_torch.ops.attention import masked_attention, paged_attention
from znicz_tpu_torch.ops.normalization import layer_norm
from znicz_tpu_torch.workflow.transformer import _block_ffn, _token_rows
from znicz_tpu_torch.workflow.workflow import _fetch_async

# steps between issuing the all-rows-done flag's copy and reading it
EOS_READ_LAG = 2


def init_kv_cache(params, batch: int, max_seq: int, *, n_heads: int):
    """Zeroed ``[B, T_max, H, hd]`` K/V buffers, one pair a block, on the
    params' device."""
    caches = []
    for block in params[1:-1]:
        wq = block["wq"]
        shape = (batch, max_seq, n_heads, wq.shape[1] // n_heads)
        caches.append({
            "k": torch.zeros(shape, dtype=wq.dtype, device=wq.device),
            "v": torch.zeros(shape, dtype=wq.dtype, device=wq.device),
        })
    return caches


def _clamp(v, lo: int, hi: int):
    """``v`` (an int or an integer tensor) clamped to ``[lo, hi]``."""
    return v.clamp(lo, hi) if torch.is_tensor(v) else min(max(v, lo), hi)


def _positions(offset, n: int, device) -> torch.Tensor:
    """``offset .. offset+n-1`` on ``device``; ``offset`` an int or a 0-d
    integer tensor there (no host read)."""
    return offset + torch.arange(n, device=device)


def _proj(h, w, n_heads):
    b, t, _ = h.shape
    return (h @ w).reshape(b, t, n_heads, -1)


def _block_step(
    block, x, cache, offset, *, n_heads, start=None, moe_top_k=1, moe_dispatch="dense",
):
    """One pre-LN block over ``x`` [B, Tq, D] at absolute positions
    ``offset .. offset+Tq-1``, writing their K/V into the cache in place
    and attending over it.  Tq is the prompt length in the prefill and 1 in
    a decode step.  ``start`` [B] marks each row's first real position
    under left-padding; keys before it are masked out (a pad-region query
    keeps its own position, so its softmax stays finite)."""
    b, tq, _ = x.shape
    h = layer_norm(x, block["ln1_scale"], block["ln1_bias"])
    q, k_new, v_new = (_proj(h, block[w], n_heads) for w in ("wq", "wk", "wv"))
    k_cache, v_cache = cache["k"], cache["v"]
    t_max = k_cache.shape[1]
    # the write start clamped into the buffer, as dynamic_update_slice does
    write = _positions(_clamp(offset, 0, t_max - tq), tq, x.device)
    k_cache.index_copy_(1, write, k_new)
    v_cache.index_copy_(1, write, v_new)
    # causal validity by absolute index (unwritten slots lie past
    # offset+Tq-1, so they mask out too)
    q_pos = _positions(offset, tq, x.device)[None, :]
    o = masked_attention(q, k_cache, v_cache, q_pos, start=start)
    x = x + o.reshape(b, tq, -1) @ block["wo"]
    h = layer_norm(x, block["ln2_scale"], block["ln2_bias"])
    x = x + _block_ffn(block, h, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
    return x, cache


def _embed_at(embed, tokens, offset, start=None):
    """Token + positional embedding for tokens [B, Tq] at ``offset``.  With
    ``start`` [B] (left-padding) a row's positional index is relative to its
    first real token, so a padded row sees the position ids of the unpadded
    prompt."""
    tq = tokens.shape[1]
    n_pos = embed["pos"].shape[0]
    tokens = tokens.long()
    if start is None:
        first = _clamp(offset, 0, n_pos - tq)  # as dynamic_slice_in_dim
        pos = embed["pos"].index_select(0, _positions(first, tq, tokens.device))
        return _token_rows(embed, tokens) + pos[None, :, :]
    rel = _positions(offset, tq, tokens.device)[None, :] - start[:, None]
    return _token_rows(embed, tokens) + embed["pos"][rel.clamp(0, n_pos - 1)]


def prefill(params, tokens, caches, *, n_heads, start=None, moe_top_k=1, moe_dispatch="dense"):
    """Run the prompt [B, Tp] through the tower, filling positions
    ``0..Tp-1`` of the caches; returns (caches, last-position logits).
    ``start`` [B]: the first real position of each row of a left-padded
    prompt (the last position is always real)."""
    x = _embed_at(params[0], tokens, 0, start)
    for block, cache in zip(params[1:-1], caches):
        x, _ = _block_step(block, x, cache, 0, n_heads=n_heads, start=start,
                           moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
    return caches, x[:, -1] @ params[-1]["head"]


def decode_step(params, caches, token, pos, *, n_heads, start=None, moe_top_k=1,
                moe_dispatch="dense"):
    """One incremental step: ``token`` [B] at position ``pos`` (an int or a
    0-d integer tensor on the device) -> (caches, next-position logits [B,
    vocab])."""
    x = _embed_at(params[0], token[:, None], pos, start)
    for block, cache in zip(params[1:-1], caches):
        x, _ = _block_step(block, x, cache, pos, n_heads=n_heads, start=start,
                           moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
    return caches, x[:, 0] @ params[-1]["head"]


# ---------------------------------------------------------------------------
# Paged KV cache: K/V in a shared [n_blocks, block_size, H, hd] pool per
# layer, an ordered block table per row.

NULL_BLOCK = 0  # reserved pool block: the write target of idle and done rows


def init_paged_kv(params, n_blocks: int, block_size: int, *, n_heads: int):
    """Zeroed ``[n_blocks, block_size, H, hd]`` K/V pools, one pair a block
    of the tower.  Pool block ``NULL_BLOCK`` is reserved as the write
    target of rows with nothing to write; allocators hand out
    ``1..n_blocks-1``."""
    if n_blocks < 2 or block_size < 1:
        raise ValueError(
            f"want n_blocks >= 2 (one is the reserved null block) and "
            f"block_size >= 1; got {n_blocks}, {block_size}"
        )
    return init_kv_cache(params, n_blocks, block_size, n_heads=n_heads)


def _index1(i, device) -> torch.Tensor:
    """``i`` (an int or a 0-d integer tensor) as a ``[1]`` long index on
    ``device``, with no host read."""
    if torch.is_tensor(i):
        return i.reshape(1).long()
    return torch.full((1,), int(i), dtype=torch.long, device=device)


def _take(t: torch.Tensor, i) -> torch.Tensor:
    """Row ``i`` of ``t`` kept as ``[1, ...]``."""
    return t.index_select(0, _index1(i, t.device))


def _paged_block_step(
    block, x, pool, write, tables, q_pos, *, n_heads, block_size, start=None, moe_top_k=1,
    moe_dispatch="dense",
):
    """One pre-LN block over ``x`` [B, Tq, D] with paged KV: ``write(pool,
    new)`` puts this layer's new K/V into the pool in place, then
    attention gathers through the block tables (:func:`paged_attention`)."""
    b, tq, _ = x.shape
    h = layer_norm(x, block["ln1_scale"], block["ln1_bias"])
    q, k_new, v_new = (_proj(h, block[w], n_heads) for w in ("wq", "wk", "wv"))
    write(pool["k"], k_new)
    write(pool["v"], v_new)
    o = paged_attention(q, pool["k"], pool["v"], tables, q_pos, block_size=block_size,
                        start=start)
    x = x + o.reshape(b, tq, -1) @ block["wo"]
    h = layer_norm(x, block["ln2_scale"], block["ln2_bias"])
    x = x + _block_ffn(block, h, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch)
    return x, pool


def paged_prefill_chunk(
    params, pools, table, tokens, offset, *, n_heads, block_size, start=None, last=None,
    moe_top_k=1, moe_dispatch="dense",
):
    """One aligned chunk of a single prompt through the tower, its K/V
    written into the row's block; returns ``(pools, logits)`` at the
    chunk's ``last`` position (its final one by default).

    ``tokens`` is ``[1, C]`` with ``C == block_size`` and ``offset`` a
    multiple of ``block_size``, so the chunk fills exactly one block and
    the step has one shape whatever the prompt's length.  ``table`` is the
    row's ``[M]`` block table.  A final chunk is right-padded; its pad
    positions write K/V past the prompt, which validity by absolute index
    never reads before a decode step overwrites them.  ``last`` (an int or
    a 0-d tensor) is the in-chunk index of the prompt's last real token."""
    c = tokens.shape[1]
    if c != block_size:
        raise ValueError(
            f"chunk length {c} must equal block_size {block_size} "
            "(one chunk == one block)"
        )
    blk = _take(table, offset // block_size).long()  # [1]
    x = _embed_at(params[0], tokens, offset, start)
    q_pos = _positions(offset, c, x.device)[None, :]

    def write(pool, new):
        pool.index_copy_(0, blk, new)

    for block, pool in zip(params[1:-1], pools):
        x, _ = _paged_block_step(
            block, x, pool, write, table[None], q_pos, n_heads=n_heads, block_size=block_size,
            start=start, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
        )
    xl = x[:, -1] if last is None else _take(x[0], _clamp(last, 0, c - 1))
    return pools, xl @ params[-1]["head"]


def copy_paged_block(pools, src, dst):
    """Copy pool block ``src`` into ``dst`` in every layer's K/V pool (the
    copy-on-write split of paged prefix sharing); ``src`` and ``dst`` are
    ints or 0-d tensors, so one step serves every split."""
    for pool in pools:
        for name in ("k", "v"):
            t = pool[name]
            t.index_copy_(0, _index1(dst, t.device), _take(t, src))
    return pools


def _table_col(pos, block_size: int, tables) -> torch.Tensor:
    """The table column of each position, clamped to the table's last
    column as the JAX package's gather clamps: a verify's bucket pad can lie
    past a row's window; its write is masked to ``NULL_BLOCK`` and its
    logits are never read."""
    return (pos // block_size).clamp(max=tables.shape[1] - 1)


def _last_writer(blk: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """For each of the ``[N]`` writes ``(blk, slot)``, the index of the last
    write to the same place.  Masked writes all land in ``NULL_BLOCK``; each
    takes the last one's value, so the block ends as a serial scatter leaves
    it (the JAX package's and the CPU's last write wins) whatever order the
    card's scatter stores in.  Idle rows read that block, and under capacity
    routing their states share the experts' slots with live rows."""
    n = blk.shape[0]
    same = (blk[:, None] == blk[None, :]) & (slot[:, None] == slot[None, :])
    order = torch.arange(1, n + 1, device=blk.device)
    return (same * order[None, :]).argmax(dim=1)


def paged_decode_step(
    params, pools, tables, token, pos, *, n_heads, block_size, start=None, write_mask=None,
    moe_top_k=1, moe_dispatch="dense",
):
    """One incremental paged step: ``token`` [B] at per-row positions
    ``pos`` [B] -> ``(pools, next logits [B, vocab])``.  Each row writes
    its K/V at ``(tables[b, pos_b // bs], pos_b % bs)`` and attends through
    its own table; rows with ``write_mask`` False write to ``NULL_BLOCK``."""
    b = token.shape[0]
    rows = torch.arange(b, device=token.device)
    pos = pos.long()
    blk = tables[rows, _table_col(pos, block_size, tables)].long()
    if write_mask is not None:
        blk = torch.where(write_mask, blk, NULL_BLOCK)
    slot = pos % block_size
    last = _last_writer(blk, slot)
    x = _embed_rows(params[0], token, pos, start)

    def write(pool, new):
        pool.index_put_((blk, slot), new[:, 0][last])

    for block, pool in zip(params[1:-1], pools):
        x, _ = _paged_block_step(
            block, x, pool, write, tables, pos[:, None], n_heads=n_heads,
            block_size=block_size, start=start, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
        )
    return pools, x[:, 0] @ params[-1]["head"]


def _embed_rows(embed, token, pos, start=None):
    """Token + positional embedding at per-row absolute positions (the
    paged twin of :func:`_embed_at`).  ``token``/``pos`` are ``[B]`` (a
    decode step) or ``[B, W]`` (a verify chunk); with ``start`` the
    position index is row-relative."""
    if token.ndim == 1:
        token = token[:, None]
        pos = pos[:, None]
    rel = pos if start is None else pos - start[:, None]
    rel = rel.long().clamp(0, embed["pos"].shape[0] - 1)
    return _token_rows(embed, token) + embed["pos"][rel]


def paged_verify_chunk(
    params, pools, tables, tokens, pos, *, n_heads, block_size, start=None, write_mask=None,
    moe_top_k=1, moe_dispatch="dense",
):
    """Score W tokens a row at per-row positions ``pos .. pos+W-1`` in one
    pass (the speculative-decoding verify step); returns ``(pools, logits
    [B, W, vocab])``, ``logits[:, i]`` the next-token distribution after
    input token ``i``.  Each position writes its K/V before attention
    gathers, so a query sees what ``i`` sequential decode steps would;
    ``write_mask`` ``[B, W]`` routes masked positions to ``NULL_BLOCK``."""
    b, w = tokens.shape
    rows = torch.arange(b, device=tokens.device)[:, None]
    pos_w = pos.long()[:, None] + torch.arange(w, device=tokens.device)[None, :]  # [B, W]
    blk = tables[rows, _table_col(pos_w, block_size, tables)].long()
    if write_mask is not None:
        blk = torch.where(write_mask, blk, NULL_BLOCK)
    slot = pos_w % block_size
    last = _last_writer(blk.reshape(-1), slot.reshape(-1)).reshape(b, w)
    x = _embed_rows(params[0], tokens, pos_w, start)

    def write(pool, new):
        pool.index_put_((blk, slot), new.reshape(b * w, *new.shape[2:])[last])

    for block, pool in zip(params[1:-1], pools):
        x, _ = _paged_block_step(
            block, x, pool, write, tables, pos_w, n_heads=n_heads, block_size=block_size,
            start=start, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
        )
    return pools, x @ params[-1]["head"]


# ---------------------------------------------------------------------------
# Speculative drafting: a host-side ``propose(context, k)`` interface.

# verify-width (k+1) bucket ladder: drafted lengths snap up a rung
DEFAULT_SPEC_BUCKETS = (2, 4, 8)


class PromptLookupDrafter:
    """Prompt-lookup / n-gram drafting: propose the continuation of the most
    recent earlier occurrence of the context's final n-gram, longest n
    first.  ``propose(context, k)`` takes the 1-D token context and returns
    up to ``k`` proposed next tokens (empty when it has no guess).
    ``ngram_min=2`` by default: a 1-gram match is noise on most streams."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 2):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"want 1 <= ngram_min <= ngram_max; got {ngram_min}, {ngram_max}"
            )
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def propose(self, context, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).reshape(-1)
        if k <= 0:
            return np.zeros((0,), np.int32)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if ctx.size <= n:
                continue
            pattern = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.nonzero((win == pattern).all(axis=1))[0]
            # at least one continuation token (drops the terminal self-match)
            hits = hits[hits + n < ctx.size]
            if hits.size:
                # the latest occurrence with k continuation tokens: inside a
                # repeated run an earlier one carries the whole period
                full = hits[hits + n + int(k) <= ctx.size]
                i = int(full[-1] if full.size else hits[-1])
                return ctx[i + n: i + n + int(k)].copy()
        return np.zeros((0,), np.int32)


# ---------------------------------------------------------------------------
# Sampling.


def _filter_logits(logits, temperature, top_k, nucleus, top_p):
    """Temperature scaling, an optional ``top_k`` cut and an optional
    ``top_p`` nucleus (the smallest prefix of the sorted distribution with
    cumulative probability >= top_p; the argmax token is always kept), on
    the last axis.  ``temperature`` and ``top_p`` may be 0-d tensors on the
    device (a captured step reads them from there)."""
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if nucleus:
        sl = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # the mass before the token; [..., 0] True
        thr = torch.where(keep, sl, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thr, logits, -torch.inf)
    return logits


def _sample(logits, noise, temperature, top_k, nucleus, top_p):
    """Gumbel-max over the truncated distribution: ``argmax(filtered +
    noise)`` with ``noise`` the step's Gumbel draws (``jax.random.
    categorical``'s recipe)."""
    filtered = _filter_logits(logits, temperature, top_k, nucleus, top_p)
    return torch.argmax(noise + filtered, dim=-1)


def _gumbel(rng, step: int, shape, device) -> torch.Tensor:
    """Decode step ``step``'s Gumbel noise: ``-log(-log(u))`` of uniforms in
    ``[tiny, 1)`` drawn from ``rng`` (a ``torch.Generator`` on ``device``),
    or what a callable ``rng(step, shape)`` returns."""
    if callable(rng):
        noise = rng(step, tuple(shape))
        if not torch.is_tensor(noise):
            noise = torch.from_numpy(np.array(noise, np.float32))
        return noise.to(device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=rng, device=device) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def _check_sampling_args(params, temperature, top_k, top_p, rng, eos_id):
    """Argument validation shared by generate() and generate_serve();
    returns (top_k, rng) with the full-support clamp applied.  A negative
    temperature passes, as in the JAX package."""
    if temperature != 0.0 and rng is None:
        raise ValueError("temperature > 0 needs an rng (a torch.Generator)")
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"want top_k >= 0 and 0 < top_p <= 1; got {top_k}, {top_p}")
    vocab = params[-1]["head"].shape[-1]
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} outside vocab {vocab}")
    if top_k >= vocab:
        top_k = 0  # full support: no truncation
    return top_k, rng


def _check_budget(tp: int, max_new_tokens: int, max_pos: int) -> None:
    if max_new_tokens < 1:
        raise ValueError(f"want max_new_tokens >= 1; got {max_new_tokens}")
    if tp + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt {tp} + max_new_tokens {max_new_tokens} exceeds the "
            f"positional table ({max_pos}); re-init the LM with a larger max_seq"
        )


def _as_prompt(prompt, device) -> torch.Tensor:
    if not torch.is_tensor(prompt):
        prompt = torch.as_tensor(np.asarray(prompt))
    return prompt.to(device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# The decode program.


class _DecodeProgram:
    """One decode geometry's static buffers and step: ``[B, tp]`` prompts,
    ``max_new_tokens`` out slots, one sampling structure.

    It holds its own copy of the params (each request copies the caller's
    values in, so in-place training and other tensors of the same geometry
    both decode right), the KV caches, the current token, the step counter
    (on the device), the done mask, the out buffer, the sampling operands
    and the noise buffer.  :meth:`_step` reads and writes only these, with
    no host read, so on the card it is captured once (``graph=True``:
    after one eager warm-up step on a side stream) and replayed a
    position.

    ``count=True`` counts the program's flops as it runs, never running
    anything extra: the first step run eagerly (the warm-up before the
    capture; on the CPU, the first request's first step) and the first
    request's prefill; :meth:`cost` scales the step by the program's
    ``max_new_tokens - 1`` steps, one call of the program."""

    def __init__(self, params, batch, tp, max_new_tokens, *, n_heads, greedy, top_k, nucleus,
                 eos_id, moe_top_k, moe_dispatch, padded, graph, count=False):
        with torch.no_grad():
            self.params = [{k: w.detach().clone() for k, w in layer.items()} for layer in params]
        dev = params[0]["embed"].device
        self.device = dev
        self.tp, self.max_new_tokens = tp, max_new_tokens
        self.n_heads, self.greedy, self.top_k, self.nucleus = n_heads, greedy, top_k, nucleus
        self.eos_id, self.moe_top_k, self.moe_dispatch = eos_id, moe_top_k, moe_dispatch
        self.fill = eos_id if eos_id is not None else 0
        vocab = params[-1]["head"].shape[-1]
        self.caches = init_kv_cache(self.params, batch, tp + max_new_tokens, n_heads=n_heads)
        self.prompt = torch.zeros((batch, tp), dtype=torch.long, device=dev)
        self.start = torch.zeros((batch,), dtype=torch.long, device=dev) if padded else None
        self.token = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.i = torch.ones((), dtype=torch.long, device=dev)
        self.done = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self.out = torch.full((batch, max_new_tokens), self.fill, dtype=torch.long, device=dev)
        self.temperature = torch.ones((), device=dev)
        self.top_p = torch.ones((), device=dev)
        self.noise = None if greedy else torch.zeros((batch, vocab), device=dev)
        self.graph = None
        self.count = count
        self.step_cost = self.prefill_cost = None
        if graph:
            self._capture()

    def _sample(self, logits):
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        return _sample(logits, self.noise, self.temperature, self.top_k, self.nucleus, self.top_p)

    def _step(self) -> None:
        """Decode step ``i`` (a tensor): the current token at position ``tp
        + i - 1``, the next one sampled into ``out[:, i]``."""
        _, logits = decode_step(
            self.params, self.caches, self.token, self.tp + self.i - 1, n_heads=self.n_heads,
            start=self.start, moe_top_k=self.moe_top_k, moe_dispatch=self.moe_dispatch,
        )
        nxt = self._sample(logits)
        if self.eos_id is not None:
            nxt = torch.where(self.done, self.fill, nxt)
            self.done |= nxt == self.eos_id
        self.out.index_copy_(1, self.i.reshape(1), nxt[:, None])
        self.token.copy_(nxt)
        self.i += 1

    def _capture(self) -> None:
        """One eager step on a side stream (it picks cuBLAS's algorithms
        and fills the allocator, which a capture may not do), then the step
        captured into ``self.graph``.  The warm-up's writes are reset by
        each request.  A failed capture raises."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad():
            with torch.cuda.stream(side):
                self._counted_step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    self._step()
            except Exception as exc:
                raise RuntimeError(
                    f"capturing the decode step into a CUDA graph failed "
                    f"({type(exc).__name__}: {exc}); the step must launch work on its stream "
                    "only, with no host read, host copy or data-sized allocation"
                ) from exc
        self.graph = graph

    def run(self, params, prompt, start, budget, temperature, top_p, rng) -> torch.Tensor:
        """One request: ``[B, tp + max_new_tokens]`` long tokens, the prompt
        included.  ``budget`` (<= max_new_tokens) bounds the loop."""
        budget = min(int(budget), self.max_new_tokens)
        with torch.no_grad():
            torch._foreach_copy_(
                [w for layer in self.params for w in layer.values()],
                [w.detach() for layer in params for w in layer.values()],
            )
            for cache in self.caches:
                cache["k"].zero_()
                cache["v"].zero_()
            self.prompt.copy_(prompt)
            if self.start is not None:
                self.start.copy_(start)
            self.temperature.fill_(float(temperature))
            self.top_p.fill_(float(top_p))
            self.out.fill_(self.fill)
            self.i.fill_(1)
            prefill_kw = dict(n_heads=self.n_heads, start=self.start,
                              moe_top_k=self.moe_top_k, moe_dispatch=self.moe_dispatch)
            if self.count and self.prefill_cost is None:
                (_, logits), self.prefill_cost = device_telemetry.lowered_cost(
                    prefill, (self.params, self.prompt, self.caches), prefill_kw)
            else:
                _, logits = prefill(self.params, self.prompt, self.caches, **prefill_kw)
            if not self.greedy:
                self.noise.copy_(_gumbel(rng, 0, self.noise.shape, self.device))
            first = self._sample(logits)
            self.out[:, 0] = first
            self.token.copy_(first)
            if self.eos_id is None:
                self.done.zero_()
            else:
                self.done.copy_(first == self.eos_id)
            flags = deque()
            for i in range(1, budget):
                if self.eos_id is not None and self._all_done(flags):
                    break
                if not self.greedy:
                    self.noise.copy_(_gumbel(rng, i, self.noise.shape, self.device))
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self._counted_step()
            return torch.cat([self.prompt, self.out], dim=1)

    def _counted_step(self) -> None:
        """:meth:`_step`, counted where it is the program's first eager
        step and ``count`` asks for it."""
        if self.count and self.step_cost is None:
            _, self.step_cost = device_telemetry.lowered_cost(self._step)
        else:
            self._step()

    def cost(self) -> Optional[dict]:
        """One call's cost: the prefill plus ``max_new_tokens - 1`` steps
        (what the bucketed program covers); None until both were seen."""
        step = self.step_cost if self.max_new_tokens > 1 else {"flops": 0.0}
        if not self.prefill_cost or not step:
            return None
        return {
            "flops": self.prefill_cost["flops"] + (self.max_new_tokens - 1) * step["flops"],
            "bytes_accessed": None,
        }

    def _all_done(self, flags: deque) -> bool:
        """Whether every row had emitted EOS: on the CPU now; on the card
        as of ``EOS_READ_LAG`` steps ago (each step's flag goes to pinned
        memory by a ``non_blocking`` copy and an event), so the loop never
        waits on the step it has just issued."""
        if self.device.type != "cuda":
            return bool(self.done.all())
        flags.append(_fetch_async([self.done.all()]))
        if len(flags) <= EOS_READ_LAG:
            return False
        (host,), event = flags.popleft()
        event.synchronize()
        return bool(host)


def generate(
    params,
    prompt,  # [B, Tp] integer
    *,
    n_heads: int,
    max_new_tokens: int,
    eos_id: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rng=None,
    moe_top_k: int = 1,
    moe_dispatch: str = "dense",
):
    """Autoregressive generation; returns ``[B, Tp + max_new_tokens]`` int32
    tokens (prompt included) on the params' device.  ``temperature=0`` is
    greedy argmax; otherwise sampling at that temperature (``rng``
    required), optionally truncated to the ``top_k`` highest logits and/or
    the ``top_p`` nucleus.  With ``eos_id`` the loop exits once every row
    has emitted EOS; rows that finish early emit ``eos_id`` for the rest of
    the budget."""
    device = params[0]["embed"].device
    prompt = _as_prompt(prompt, device)
    _check_budget(prompt.shape[1], max_new_tokens, params[0]["pos"].shape[0])
    top_k, rng = _check_sampling_args(params, temperature, top_k, top_p, rng, eos_id)
    return _generate_impl(
        params, prompt, None, max_new_tokens, temperature, top_p, rng,
        n_heads=n_heads, max_new_tokens=max_new_tokens, greedy=temperature == 0.0,
        top_k=top_k, nucleus=top_p < 1.0, eos_id=eos_id, moe_top_k=moe_top_k,
        moe_dispatch=moe_dispatch,
    )


def _generate_impl(
    params, prompt, start, budget, temperature, top_p, rng, *, n_heads, max_new_tokens, greedy,
    top_k, nucleus, eos_id, moe_top_k, moe_dispatch, graph=None,
):
    """One decode program made and run once: the prefill, then the decode
    steps (replays of the captured step on the card; ``graph=False`` runs
    the eager step loop there, for checks and timings)."""
    if graph is None:
        graph = prompt.is_cuda
    b, tp = prompt.shape
    program = _DecodeProgram(
        params, b, tp, max_new_tokens, n_heads=n_heads, greedy=greedy, top_k=top_k,
        nucleus=nucleus, eos_id=eos_id, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
        padded=start is not None, graph=graph,
    )
    out = program.run(params, prompt, start, budget, temperature, top_p, rng)
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# Serving fast path: shape buckets and an explicit program cache.

# geometric x2 ladders: a stream of arbitrary prompt lengths and budgets
# makes at most len(ladder) programs a sampling structure
DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
DEFAULT_BUDGET_LADDER = (16, 32, 64, 128, 256, 512, 1024)


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest rung >= ``n``; past the top rung keep doubling it."""
    if n <= 0:
        raise ValueError(f"want a positive length; got {n}")
    for rung in ladder:
        if n <= rung:
            return int(rung)
    rung = int(ladder[-1])
    while rung < n:
        rung *= 2
    return rung


def pack_prompts(prompts, bucket: int, pad_id: int):
    """Left-pad ragged prompts into one ``[B, bucket]`` int32 batch; returns
    ``(tokens, start)``, ``start[b]`` the index of row b's first real token
    (CPU tensors)."""
    tokens = np.full((len(prompts), bucket), pad_id, np.int32)
    start = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32).reshape(-1)
        if p.size == 0:
            raise ValueError(f"prompt {i} is empty")
        if p.size > bucket:
            raise ValueError(f"prompt {i} length {p.size} exceeds bucket {bucket}")
        tokens[i, bucket - p.size:] = p
        start[i] = bucket - p.size
    return torch.from_numpy(tokens), torch.from_numpy(start)


def _params_fingerprint(params):
    """Hashable geometry of the params (names, shapes, dtypes, device): one
    program serves one geometry; the values may change."""
    return tuple(
        tuple((k, tuple(w.shape), str(w.dtype), str(w.device)) for k, w in layer.items())
        for layer in params
    )


class _ServeCache:
    """The serving path's program cache: each distinct key is one program
    (on the card a captured decode graph), so ``programs`` is an exact
    count.  The request, hit and compile tallies live in the process-wide
    metrics registry (``znicz_serve_cache_*_total``); the attributes here
    read through to it."""

    def __init__(self):
        self.programs = {}  # key -> _DecodeProgram
        self._requests = observability.counter(
            "znicz_serve_cache_requests_total", "generate_serve() invocations",
        )
        self._hits = observability.counter(
            "znicz_serve_cache_hits_total", "generate_serve() calls served without compiling",
        )
        self._compiles = observability.counter(
            "znicz_serve_cache_compiles_total",
            "generate_serve() AOT compiles (distinct executable keys)",
        )

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def requests(self) -> int:
        return int(self._requests.value)

    @property
    def compiles(self) -> int:
        return int(self._compiles.value)

    def record_request(self) -> None:
        self._requests.inc()

    def record_hit(self) -> None:
        self._hits.inc()

    def record_compile(self) -> None:
        self._compiles.inc()

    def reset(self):
        self.programs.clear()
        self._requests.reset()
        self._hits.reset()
        self._compiles.reset()


_serve_cache = _ServeCache()


def serve_cache_stats() -> dict:
    """One entry in ``programs`` per (bucket_tp, bucket_new, B,
    sampling-structure) ever made; ``hits`` counts requests served without
    making one."""
    return {
        "programs": len(_serve_cache.programs),
        "hits": _serve_cache.hits,
        "requests": _serve_cache.requests,
        "compiles": _serve_cache.compiles,
        "keys": sorted(str(k[:-1]) for k in _serve_cache.programs),
    }


def reset_serve_cache() -> None:
    """Drop every cached program and zero the counters."""
    _serve_cache.reset()


def generate_serve(
    params,
    prompt,  # [B, Tp] integer (rectangular)
    *,
    n_heads: int,
    max_new_tokens: int,
    eos_id: Optional[int] = None,
    pad_id: Optional[int] = None,
    prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
    budget_ladder: Sequence[int] = DEFAULT_BUDGET_LADDER,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rng=None,
    moe_top_k: int = 1,
    moe_dispatch: str = "dense",
):
    """Shape-bucketed serving twin of :func:`generate`.

    Left-pads the prompt to the next prompt bucket and rounds the budget up
    a ladder rung, then runs the program cached under ``(bucket_tp,
    bucket_new, B, n_heads, sampling structure, MoE routing, params
    geometry)``, making (on the card: capturing) it at the key's first
    request.  Returns ``[B, Tp + max_new_tokens]`` int32 tokens like
    ``generate()``, the padding stripped and the budget trimmed back, equal
    to it token for token up to EOS."""
    device = params[0]["embed"].device
    prompt = _as_prompt(prompt, device)
    b, tp = prompt.shape
    max_pos = params[0]["pos"].shape[0]
    _check_budget(tp, max_new_tokens, max_pos)
    bucket_tp = bucket_for(tp, prompt_buckets)
    bucket_new = bucket_for(max_new_tokens, budget_ladder)
    if bucket_tp + bucket_new > max_pos:
        # rounding up never rejects a feasible request: shrink the budget
        # rung into the table, then fall back to exact shapes
        bucket_new = max_pos - bucket_tp
        if bucket_new < max_new_tokens:
            bucket_tp, bucket_new = tp, max_new_tokens
    top_k, rng = _check_sampling_args(params, temperature, top_k, top_p, rng, eos_id)
    if pad_id is None:
        pad_id = eos_id if eos_id is not None else 0
    pad = bucket_tp - tp
    padded = torch.cat([torch.full((b, pad), pad_id, dtype=torch.long, device=device), prompt], 1)
    # start always (all zeros at an exact bucket), so one program a bucket
    # serves every prompt length inside it
    start = torch.full((b,), pad, dtype=torch.long, device=device)
    greedy = temperature == 0.0
    nucleus = top_p < 1.0
    key = (
        bucket_tp, bucket_new, b, n_heads, greedy, top_k, nucleus,
        eos_id, moe_top_k, moe_dispatch, _params_fingerprint(params),
    )
    _serve_cache.record_request()
    program = _serve_cache.programs.get(key)
    made = program is None
    if made:
        t0 = time.perf_counter()
        program = _DecodeProgram(
            params, b, bucket_tp, bucket_new, n_heads=n_heads, greedy=greedy, top_k=top_k,
            nucleus=nucleus, eos_id=eos_id, moe_top_k=moe_top_k, moe_dispatch=moe_dispatch,
            padded=True, graph=device.type == "cuda", count=True,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        compile_s = time.perf_counter() - t0
        _serve_cache.programs[key] = program
        _serve_cache.record_compile()
    else:
        _serve_cache.record_hit()
    out = program.run(params, padded, start, max_new_tokens, temperature, top_p, rng)
    if made:
        # the first request counted the program's flops as it ran: ledger it
        program.count = False
        device_telemetry.record_program(
            ("serve", bucket_tp, bucket_new, b, greedy, top_k, nucleus),
            compile_s, source="serve_cache", cost=program.cost(),
            memory=device_telemetry.compiled_memory(program.graph), dedup=key,
        )
    return out[:, pad: pad + tp + max_new_tokens].to(torch.int32)
