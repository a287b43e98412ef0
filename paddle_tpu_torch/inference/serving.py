"""Serving scheduler: continuous batching over the paged KV cache
(counterpart: ``paddle_tpu/inference/serving.py``).

The model math of a serving pass (``_embed``, ``_mm``, ``_block_math``,
``_qkv``, ``_head_logits``) and the ``ServingEngine`` on its two paths:

* **Block pool + admit/free**: sequences own block tables into one shared
  ``[L, H_kv, num_blocks, bs, D]`` pool; finishing frees pages for queued
  requests; block 0 is the scratch block padding tokens and idle slots
  write into, never allocated and so never read as live data.
* **Two-program path** (``ragged=False``, the ``FLAGS_serving_ragged``
  default): each step runs at most two programs, one batched prefill chunk
  over every prefilling slot (``_prefill_chunk``: the GEMMs, in-place KV
  writes, each slot's sequence gathered from the pool and attended through
  ``scaled_dot_product_attention`` with a causal keep-mask, which the card
  runs on the flash forward kernel with an additive bias) and one decode
  burst of K micro-steps (``_decode_burst``: the hand-written paged decode
  kernel in every layer). Each program samples on the device; the host
  fetches once per program.
* **Single-dispatch ragged path** (``ragged=True``): every step packs decode
  rows (q_len 1) and prefill chunks (q_len <= chunk, sharing a fixed token
  budget) into ONE ragged token batch and runs ONE unified step
  (``inference/ragged_step.py``): the GEMMs over the packed tokens, the
  hand-written ragged paged-attention kernel in every layer, in-step KV
  append and sampling, then a K-1 micro-step decode burst. Its pool may be
  int8 or fp8 e4m3 (``kv_cache_dtype``) with per-page scales
  (``quantization/kv_cache.py``), which halves the bytes a decode step reads
  and doubles the blocks a fixed budget (``kv_pool_bytes``) admits.
* **Streaming**: each sampled token fires the request's ``on_token``.
* **Adaptive mix and bursts**: the ragged burst shortens under admission
  pressure read from the engine's own Prometheus registry; the two-program
  burst ends when the earliest request can finish while others queue
  (``adaptive_burst``).

The JAX engine compiles each program; the port runs them as eager PyTorch,
so ``dispatches`` counts programs (one per step on the ragged path, at most
two on the two-program path, the same contract) while the CUDA launches
inside one program number in the thousands. Capturing them in CUDA graphs
is later work.

Not in this slice, each raising ``NotImplementedError`` naming its ROADMAP
item: W8A8 weights (``int8``), tensor parallelism (``mesh``), prefix
sharing, speculative decoding and the resilience options (``queue_max``,
``shed``, ``preempt``, deadlines).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..enforce import UnimplementedError, enforce
from ..flags import flag
from ..kernels.paged_attention import paged_decode_attention
from ..models import gpt as G
from ..nn.functional.flash_attention import scaled_dot_product_attention
from ..observability.prom import PromRegistry
from ..profiler.utils import RecordEvent
from ..quantization.kv_cache import kv_cache_dtype as _kv_dtype
from ..quantization.kv_cache import kv_pool_blocks_for_budget

__all__ = ["Request", "ServingEngine", "RunResult", "NonFiniteSampleError"]


class NonFiniteSampleError(RuntimeError):
    """The step handed back a token outside [0, vocab): the signature of a
    poisoned sampling path (nonfinite logits, corrupted state)."""

    def __init__(self, rid: int, token: int):
        super().__init__(
            f"request {rid} sampled out-of-range token {token} — "
            "nonfinite/poisoned sampling state")
        self.rid = rid
        self.token = token


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    on_token: Optional[Callable] = None  # (rid, token_id) -> None (stream)
    # scheduler state
    slot: int = -1
    prefill_done: int = 0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # ok | failed (rejected: can never fit, or its on_token raised)
    status: str = "ok"
    error: Optional[str] = None
    submit_time: float = 0.0
    ttft_s: Optional[float] = None


class RunResult(dict):
    """``ServingEngine.run`` return value: ``{rid: output}`` plus
    ``statuses`` ({rid: Request.status}) and ``leftover`` (rids still
    queued/in flight when the step budget ran out)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.statuses: Dict[int, str] = {}
        self.leftover: List[int] = []


def _embed(params, tokens, pos, cfg):
    return (params["wte"][tokens.long()]
            + params["wpe"][pos.long()]).to(cfg.dtype)


def _mm(x, p, name, cfg):
    """x @ p[name] in the compute dtype (float weights only; the W8A8
    branch is not ported yet)."""
    return x @ p[name].to(cfg.dtype)


def _block_math(p, x, attn, cfg):
    """Post-attention half of the GPT block."""
    B, S, _ = x.shape
    out = _mm(attn.reshape(B, S, -1), p, "proj_w", cfg)
    x = x + out + p["proj_b"].to(cfg.dtype)
    h = G._ln(x, p["ln2_g"], p["ln2_b"])
    m = _mm(h.to(cfg.dtype), p, "fc1_w", cfg) + p["fc1_b"].to(cfg.dtype)
    m = F.gelu(m.float(), approximate="tanh").to(cfg.dtype)
    m = _mm(m, p, "fc2_w", cfg)
    return x + m + p["fc2_b"].to(cfg.dtype)


def _qkv(p, x, cfg):
    """LayerNorm + the fused QKV GEMM. The channel layout is head-major
    ``[heads, 3, D]`` (q/k/v innermost), the reference's serving layout."""
    B, S, _ = x.shape
    h = G._ln(x, p["ln1_g"], p["ln1_b"])
    qkv = _mm(h.to(cfg.dtype), p, "qkv_w", cfg) + p["qkv_b"].to(cfg.dtype)
    heads = qkv.shape[-1] // (3 * cfg.head_dim)
    qkv = qkv.reshape(B, S, heads, 3, cfg.head_dim)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def _head_logits(params, x_last, cfg):
    """LM head in fp32."""
    return x_last.float() @ params["head_w"].float()


def sample_tokens(logits, temps, gen):
    """Greedy where temps == 0, else a draw from softmax(logits / temp) by
    the Gumbel-max trick (what ``jax.random.categorical`` does), with the
    noise from the engine's ``torch.Generator``. The draws cannot match
    JAX's bits; greedy rows match exactly."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# the two-program path's model functions
# ---------------------------------------------------------------------------
def _layer_params(params, layer):
    return {name: leaf[layer] for name, leaf in params["blocks"].items()}


def _token_slots(tables, lens, bs):
    """(block, offset) of each sequence's current position: the targets of
    ``_write_token``. Idle slots point at scratch block 0; the table index
    clamps to the table's width, as JAX's gather does. A decode micro-step
    computes them once for every layer's K and V writes (JAX forms them in
    each write, and its compiled program shares them)."""
    B = lens.shape[0]
    slot = torch.clamp(lens // bs, max=tables.shape[1] - 1).long()
    blks = tables[torch.arange(B, device=lens.device), slot].long()
    return blks, (lens % bs).long()


def _write_token(pool, val, slots):
    """Scatter one token's k or v ([B, H, D]) into one layer's pool
    [H, NB, bs, D] at each sequence's ``_token_slots``, in place."""
    blks, offs = slots
    pool[:, blks, offs] = val.transpose(0, 1).to(pool.dtype)
    return pool


@torch.no_grad()
def _decode_burst(params, tokens, k_pools, v_pools, tables, lens, remaining,
                  eos_ids, temps, gen, *, cfg, bs, K):
    """K decode micro-steps with on-device sampling and one host fetch per
    burst (the caller's). tokens: [B] last sampled token per slot;
    remaining: [B] tokens each slot may still emit; eos_ids: [B] (-1 =
    none); temps: [B] (0 = greedy). The loop keeps tokens, lens, remaining
    and alive on the device and reads nothing back. Every micro-step runs
    for every row, as JAX's scan does; a row that is not active writes its
    token at its unchanged position (past its live length, never read) and
    samples a discarded token. The pools [L, H_kv, NB, bs, D] are updated IN
    PLACE through each layer's view (``index_put_``), where JAX donates them
    and gets new ones back. Returns (toks [K, B], k_pools, v_pools, lens)."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    alive = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    out = []
    for _ in range(K):
        active = alive & (remaining > 0)
        pos = torch.clamp(lens, max=cfg.max_seq_len - 1)
        x = _embed(params, tokens[:, None], pos[:, None], cfg)
        slots = _token_slots(tables, lens, bs)
        kv_lens = lens + 1
        for layer in range(cfg.num_layers):
            p = _layer_params(params, layer)
            q, k, v = _qkv(p, x, cfg)
            kp, vp = k_pools[layer], v_pools[layer]
            _write_token(kp, k[:, 0], slots)
            _write_token(vp, v[:, 0], slots)
            attn = paged_decode_attention(q[:, 0], kp, vp, tables, kv_lens,
                                          scale)
            x = _block_math(p, x, attn[:, None], cfg)
        x = G._ln(x, params["lnf_g"], params["lnf_b"])
        tok = sample_tokens(_head_logits(params, x[:, 0], cfg), temps, gen)
        tok = torch.where(active, tok, torch.zeros_like(tok))
        step = active.to(lens.dtype)
        lens = lens + step
        remaining = remaining - step
        alive = alive & ~(active & (tok == eos_ids))
        tokens = tok
        out.append(tok)
    return torch.stack(out), k_pools, v_pools, lens


def _gather_seqs(pool, tables, bs):
    """Every slot's K or V from one layer's pool, position-contiguous:
    [P, capacity, H, D] (tables: [P, max_blocks]). The gather is a copy;
    the result is a strided view of it with a unit stride over D."""
    g = pool[:, tables.long()]                        # [H, P, mb, bs, D]
    H, P, mb, _, D = g.shape
    return g.reshape(H, P, mb * bs, D).movedim(0, 2)


@torch.no_grad()
def _prefill_chunk(params, chunk_tokens, pos0, tables, last_idx, temps, gen,
                   k_pools, v_pools, *, cfg, bs):
    """One ``chunk``-token slice of every prefilling slot's prompt in one
    program. chunk_tokens: [P, C] (pad tail columns attend but are
    discarded; non-prefilling slots ride all-zero tables, so their writes
    land in scratch block 0); pos0 / last_idx / temps: [P]. Writes the
    chunk's K/V into the pools in place, attends over [0, pos] of each
    slot's gathered sequence, and samples each slot's next token from its
    last valid row. Returns (tok [P], k_pools, v_pools)."""
    P, C = chunk_tokens.shape
    nb = tables.shape[1]
    pos = pos0[:, None] + torch.arange(C, device=pos0.device,
                                       dtype=pos0.dtype)[None, :]  # [P, C]
    x = _embed(params, chunk_tokens,
               torch.clamp(pos, max=cfg.max_seq_len - 1), cfg)     # [P, C, H]
    slot = (pos // bs).long()
    # a pad column past the table's end: JAX's take_along_axis gives an
    # out-of-range block there and its scatter drops the write; the port
    # sends it to the scratch block 0, which is never read
    blks = torch.where(slot < nb,
                       torch.gather(tables.long(), 1,
                                    torch.clamp(slot, max=nb - 1)),
                       torch.zeros_like(slot)).reshape(-1)
    offs = (pos % bs).long().reshape(-1)
    cap = nb * bs
    allowed = (torch.arange(cap, device=pos.device)[None, None, :]
               <= pos[:, :, None])                                # [P, C, cap]
    for layer in range(cfg.num_layers):
        p = _layer_params(params, layer)
        q, k, v = _qkv(p, x, cfg)                         # [P, C, h, D]
        kp, vp = k_pools[layer], v_pools[layer]
        h, D = k.shape[2], k.shape[3]
        kp[:, blks, offs] = k.reshape(P * C, h, D).transpose(0, 1).to(
            kp.dtype)
        vp[:, blks, offs] = v.reshape(P * C, h, D).transpose(0, 1).to(
            vp.dtype)
        ck = _gather_seqs(kp, tables, bs)                 # [P, cap, h, D]
        cv = _gather_seqs(vp, tables, bs)
        attn = scaled_dot_product_attention(q, ck, cv,
                                            attn_mask=allowed[:, None])
        x = _block_math(p, x, attn, cfg)
    x = G._ln(x, params["lnf_g"], params["lnf_b"])
    x_last = x[torch.arange(P, device=x.device), last_idx.long()]   # [P, H]
    tok = sample_tokens(_head_logits(params, x_last, cfg), temps, gen)
    return tok, k_pools, v_pools


def _dispatch_rtt_ms(device) -> float:
    """One small op and a scalar fetch on ``device``, after a warm-up: the
    round trip that decides whether adaptive bursts pay for themselves."""
    x = torch.zeros((), device=device)
    float(x + 1)
    t0 = time.perf_counter()
    float(x + 2)
    return (time.perf_counter() - t0) * 1e3


def _later_slice(what: str, item: str):
    raise UnimplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1: {item})",
        op="ServingEngine")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Continuous-batching engine over a paged KV pool (see module doc).
    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.

    ``ragged`` (None: ``FLAGS_serving_ragged``, off) picks the
    single-dispatch ragged path over the two-program path.
    ``kv_cache_dtype`` (None: ``FLAGS_serving_kv_cache_dtype``, "auto" = the
    compute dtype) may be "int8" or "fp8_e4m3" on the ragged path;
    ``kv_pool_bytes`` sizes the pool from a byte budget in place of
    ``num_blocks``. ``adaptive_burst`` ("auto" or a bool): on the
    two-program path, end a decode burst when the earliest request can
    finish while others queue. "auto" enables it when one small op and its
    fetch on the engine's device take under 5 ms, as the JAX package
    decides from its dispatch round trip; on a local card that is tens of
    microseconds."""

    def __init__(self, params, cfg: G.GPTConfig, *, max_batch: int = 4,
                 block_size: int = None, num_blocks: int = 256,
                 max_blocks_per_seq: int = 32, chunk: int = None,
                 decode_burst: int = None, seed: int = 0, device=None,
                 adaptive_burst="auto", ragged=None, kv_cache_dtype=None,
                 kv_pool_bytes: Optional[int] = None,
                 token_budget: Optional[int] = None, adaptive_mix=None,
                 ttft_slo_s: Optional[float] = None, int8: bool = False,
                 mesh=None, queue_max=None, shed=None, preempt=None,
                 prefix_share=None, spec_decode_k=None):
        if ragged is None or ragged == "auto":
            ragged = bool(flag("serving_ragged"))
        if kv_cache_dtype is None:
            kv_cache_dtype = str(flag("serving_kv_cache_dtype"))
        if int8:
            _later_slice("W8A8 weights (int8=True)", "W8A8 int8=True")
        if mesh is not None:
            _later_slice("tensor-parallel serving (mesh=)", "TP mesh=")
        if prefix_share:
            _later_slice("prefix page sharing", "prefix sharing and "
                         "speculative decoding")
        if spec_decode_k:
            _later_slice("speculative decoding", "prefix sharing and "
                         "speculative decoding")
        for name, v in (("queue_max", queue_max), ("shed", shed),
                        ("preempt", preempt)):
            if v and v != "auto":
                _later_slice(f"{name}=", "resilience (deadlines, shed, "
                             "preempt)")
        if kv_cache_dtype == "auto":
            pool_dtype, kv_quantized = cfg.dtype, False
        else:
            pool_dtype, kv_quantized = _kv_dtype(kv_cache_dtype)
        enforce(not kv_quantized or ragged,
                "quantized KV pools (kv_cache_dtype="
                f"{kv_cache_dtype!r}) need the single-dispatch ragged path "
                "(ragged=True / FLAGS_serving_ragged): the two-program "
                "path's kernels read float pools", op="ServingEngine")
        block_size = (int(flag("paged_block_size")) if block_size is None
                      else block_size)
        chunk = (int(flag("serving_prefill_chunk")) if chunk is None
                 else chunk)
        decode_burst = (int(flag("serving_decode_burst"))
                        if decode_burst is None else decode_burst)
        if adaptive_mix is None or adaptive_mix == "auto":
            adaptive_mix = bool(flag("serving_adaptive_mix"))
        self.device = resolve_device(device)
        dev = self.device
        L, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
        if kv_pool_bytes is not None:
            # capacity from a fixed byte budget: a one-byte pool admits ~2x
            # the blocks of bf16 at the same budget
            num_blocks = max(2, kv_pool_blocks_for_budget(
                kv_pool_bytes, L, Hkv, block_size, D, pool_dtype))
        self.params, self.cfg = _to_device(params, dev), cfg
        self.bs, self.chunk = block_size, chunk
        self.max_batch = max_batch
        self.ragged = bool(ragged)
        self.kv_quantized = kv_quantized
        self.k_pools = torch.zeros((L, Hkv, num_blocks, block_size, D),
                                   dtype=pool_dtype, device=dev)
        self.v_pools = torch.zeros_like(self.k_pools)
        self.k_scales = self.v_scales = None
        if kv_quantized:
            self.k_scales = torch.zeros((L, Hkv, num_blocks),
                                        dtype=torch.float32, device=dev)
            self.v_scales = torch.zeros_like(self.k_scales)
        self.tables = np.zeros((max_batch, max_blocks_per_seq), np.int32)
        self.lens = np.zeros((max_batch,), np.int32)
        # block 0 is the scratch block padding tokens write into
        self.free_blocks = list(range(num_blocks - 1, 0, -1))
        self.refcount = np.zeros((num_blocks,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._next_rid = 0
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        self.decode_burst = decode_burst
        # fixed per-step token budget shared by decode rows (1 each,
        # always granted) and prefill chunks (the leftover)
        self.token_budget = (int(token_budget) if token_budget
                             else max_batch + chunk)
        enforce(self.token_budget >= max_batch,
                f"token_budget {self.token_budget} must cover one decode "
                f"token per slot (max_batch {max_batch})",
                op="ServingEngine")
        self._c_att = max(1, min(chunk, self.token_budget))
        self.adaptive_mix = adaptive_mix
        self.ttft_slo_s = ttft_slo_s
        # recent-window p95 over 16 TTFT samples drives the adaptive mix
        self._ttft_window = 16
        self._notify: List[Request] = []
        # dispatch accounting: one program per step on the ragged path,
        # at most two (prefill chunk + decode burst) on the two-program path
        self.dispatches = 0
        self.engine_steps = 0
        self._dispatches_reported = 0
        if adaptive_burst == "auto":
            adaptive_burst = _dispatch_rtt_ms(dev) < 5.0
        self.adaptive_burst = bool(adaptive_burst)
        self.decode_microsteps = 0  # forward passes issued (telemetry)
        self._pending_tok = np.zeros((max_batch,), np.int32)
        self._num_blocks = num_blocks
        self._prom = PromRegistry(namespace="paddle_tpu_serving")
        self._t_first_step: Optional[float] = None
        self._tokens_total = 0
        if not self.ragged:
            # the two-program path's programs: one decode burst per burst
            # length (powers of two up to decode_burst) and the prefill
            # chunk, plain callables where the JAX package jits them
            self._decode_k = {
                k: functools.partial(_decode_burst, cfg=cfg, bs=block_size,
                                     K=k)
                for k in self._burst_sizes(decode_burst)}
            self._prefill = functools.partial(_prefill_chunk, cfg=cfg,
                                              bs=block_size)

    @staticmethod
    def _burst_sizes(k_max):
        ks = [1]
        while ks[-1] < k_max:
            ks.append(min(ks[-1] * 2, k_max))
        return ks

    def _pick_burst(self, n_prefilling: int) -> int:
        """Adaptive prefill/decode mix from the registry's queue depth and
        TTFT p95: admission pressure shortens the burst so prefill slices
        come around sooner; no pressure runs the full burst."""
        if not self.adaptive_mix:
            return self.decode_burst
        q_depth = int(self._prom.get("queue_depth") or 0)
        pressure = q_depth + n_prefilling
        ttft = self._prom.quantile("ttft_seconds", 0.95)
        if (self.ttft_slo_s is not None and ttft is not None
                and ttft > self.ttft_slo_s):
            pressure = max(pressure * 2, 1)
        if pressure <= 0:
            return self.decode_burst
        k = max(1, self.decode_burst // (pressure + 1))
        return max(s for s in self._burst_sizes(self.decode_burst)
                   if s <= k)

    # -- public --------------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int, temperature=0.0,
                    eos_id=None, on_token=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        r = Request(rid, np.asarray(prompt, np.int32),
                    int(max_new_tokens), temperature, eos_id, on_token)
        r.submit_time = time.perf_counter()
        self._prom.counter_inc("requests_total",
                               help="requests ever submitted")
        self.queue.append(r)
        self._prom.gauge_set("queue_depth", len(self.queue),
                             help="requests waiting for a slot")
        return rid

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self, max_steps: int = 100000) -> "RunResult":
        """Drive to completion; returns {rid: output token ids}."""
        results = RunResult()

        def take(reqs):
            for r in reqs:
                results[r.rid] = r.output
                results.statuses[r.rid] = r.status
        take(self._take_notifications())
        for _ in range(max_steps):
            if not self.has_work():
                break
            take(self.step())
        if self.has_work():
            results.leftover = sorted(
                [r.rid for r in self.queue]
                + [s.rid for s in self.slots if s is not None])
            self._prom.counter_inc(
                "run_steps_exhausted_total",
                help="run() budgets that ran out with work left")
        return results

    def step(self) -> List[Request]:
        """One engine iteration. Ragged path: admit, then ONE unified step
        over the packed ragged batch. Two-program path: admit, then one
        batched prefill chunk and one decode burst. Returns every request
        that reached a terminal state this step (finished or rejected;
        check ``Request.status``)."""
        self.engine_steps += 1
        with RecordEvent("serving_step"):
            terminal = self._take_notifications()
            out = (self._step_ragged() if self.ragged
                   else self._step_two_program())
            return terminal + out + self._take_notifications()

    def _take_notifications(self) -> List[Request]:
        out, self._notify = self._notify, []
        return out

    # -- scheduler -----------------------------------------------------------
    def _blocks_needed(self, r: Request) -> int:
        return -(-(len(r.prompt) + r.max_new_tokens) // self.bs)

    def free_pages(self) -> int:
        return len(self.free_blocks)

    def _alloc_blocks(self, n: int) -> List[int]:
        """Allocate n private pages (refcount 1). Caller checked capacity."""
        out = []
        for _ in range(n):
            b = self.free_blocks.pop()
            self.refcount[b] = 1
            out.append(b)
        return out

    def _decref(self, b: int) -> None:
        """Drop one holder of page b; at refcount 0 it returns to the free
        list."""
        self.refcount[b] -= 1
        if self.refcount[b] > 0:
            return
        self.refcount[b] = 0
        self.free_blocks.append(b)

    def _admit(self) -> List[int]:
        """Admit queued requests into free slots while the pool has pages;
        returns the freshly admitted slot ids (the ragged path resets those
        slots' page scales). When pages run out the head of the queue
        WAITS (no starvation); a request that could never fit even in an
        empty pool is rejected on its own (status='failed') while its
        siblings keep admitting."""
        fresh: List[int] = []
        usable = self._num_blocks - 1  # block 0 is reserved scratch
        while self.queue:
            try:
                i = self.slots.index(None)
            except ValueError:
                break  # no free slot
            r = self.queue[0]
            need = self._blocks_needed(r)
            if need > self.tables.shape[1] or need > usable:
                self.queue.pop(0)
                cap = (f"max_blocks_per_seq {self.tables.shape[1]}"
                       if need > self.tables.shape[1]
                       else f"pool capacity {usable}")
                r.done = True
                r.status = "failed"
                r.error = (f"needs {need} blocks > {cap} — can never be "
                           "admitted")
                self._prom.counter_inc(
                    "requests_rejected_total",
                    help="requests that could never fit (failed at "
                         "admission)")
                self._notify.append(r)
                continue
            if need > self.free_pages():
                break  # head-of-line waits for finishes
            self.queue.pop(0)
            blocks = self._alloc_blocks(need)
            self.tables[i, :] = 0
            self.tables[i, :need] = blocks
            self.lens[i] = 0
            r.slot = i
            r.prefill_done = 0
            self.slots[i] = r
            fresh.append(i)
        return fresh

    def _release_slot(self, r: Request):
        """Return a running request's pages + slot to the pool."""
        i = r.slot
        for b in sorted({int(b) for b in self.tables[i] if b != 0}):
            self._decref(b)
        self.tables[i, :] = 0
        self.lens[i] = 0
        self.slots[i] = None
        self._pending_tok[i] = 0
        r.slot = -1

    def _finish(self, r: Request):
        self._release_slot(r)
        r.done = True

    def _emit(self, r: Request, tok: int) -> bool:
        """Record a sampled token; True if the request just finished. A
        raising ``on_token`` fails ONLY this request (status='failed')."""
        r.output.append(tok)
        self._tokens_total += 1
        if len(r.output) == 1:
            r.ttft_s = time.perf_counter() - r.submit_time
            self._prom.summary_observe(
                "ttft_seconds", r.ttft_s,
                help="submit-to-first-token latency",
                window=self._ttft_window)
            self._prom.histogram_observe(
                "ttft_seconds_hist", r.ttft_s,
                help="submit-to-first-token latency distribution")
        if r.on_token is not None:
            try:
                r.on_token(r.rid, tok)
            except Exception as e:
                r.status = "failed"
                r.error = f"on_token callback raised: {e!r}"
                r.on_token = None
                self._prom.counter_inc(
                    "callback_errors_total",
                    help="requests failed by a raising on_token callback")
                return True  # finish (and free) the poisoned request
        return (len(r.output) >= r.max_new_tokens
                or (r.eos_id is not None and tok == r.eos_id))

    def _check_tok(self, r: Request, tok: int) -> int:
        if tok < 0 or tok >= self.cfg.vocab_size:
            raise NonFiniteSampleError(r.rid, tok)
        return tok

    def _step_ragged(self) -> List[Request]:
        """Admit, pack ONE ragged token batch (decode rows first, one token
        each and always granted, then prefill chunks sharing the leftover
        budget), run the unified step, walk the [K, R] token matrix on the
        host. Two host-to-device copies in, one device-to-host fetch out."""
        t_step0 = time.perf_counter()
        if self._t_first_step is None:
            self._t_first_step = t_step0
        tokens_before = self._tokens_total
        finished: List[Request] = []
        fresh = np.zeros((self.max_batch,), np.int32)
        fresh[self._admit()] = 1
        self._note_pool_peak()

        R, T = self.max_batch, self.token_budget
        dec = [r for r in self.slots
               if r is not None and r.prefill_done >= len(r.prompt)]
        pre = [r for r in self.slots
               if r is not None and r.prefill_done < len(r.prompt)]
        if not dec and not pre:
            self._step_metrics(t_step0, tokens_before, 0, 0, finished)
            return finished

        tokens = np.zeros((T,), np.int32)
        row_of = np.zeros((T,), np.int32)
        off_of = np.full((T,), T, np.int32)  # > any q_len -> padding
        starts = np.zeros((R,), np.int32)
        pos0 = np.zeros((R,), np.int32)
        q_lens = np.zeros((R,), np.int32)
        sample0 = np.zeros((R,), np.int32)
        remaining = np.zeros((R,), np.int32)
        eos_ids = np.full((R,), -1, np.int32)
        temps = np.zeros((R,), np.float32)
        cursor = 0
        for r in dec:  # decode rows: always granted
            i = r.slot
            q_lens[i] = 1
            pos0[i] = self.lens[i]
            sample0[i] = 1
            remaining[i] = r.max_new_tokens - len(r.output)
            if r.eos_id is not None:
                eos_ids[i] = r.eos_id
            temps[i] = r.temperature
            tokens[cursor] = self._pending_tok[i]
            row_of[cursor] = i
            off_of[cursor] = 0
            starts[i] = cursor
            cursor += 1
        grants: Dict[int, int] = {}
        for r in pre:  # prefill chunks share the leftover budget
            i = r.slot
            lo = r.prefill_done
            pos0[i] = lo  # keeps device lens honest even at zero grant
            grant = min(self.chunk, len(r.prompt) - lo, T - cursor)
            if grant <= 0:
                continue
            grants[i] = grant
            q_lens[i] = grant
            completing = lo + grant >= len(r.prompt)
            sample0[i] = completing
            remaining[i] = (r.max_new_tokens - len(r.output)
                            if completing else 0)
            if r.eos_id is not None:
                eos_ids[i] = r.eos_id
            temps[i] = r.temperature
            tokens[cursor:cursor + grant] = r.prompt[lo:lo + grant]
            row_of[cursor:cursor + grant] = i
            off_of[cursor:cursor + grant] = np.arange(grant)
            starts[i] = cursor
            cursor += grant

        K = self._pick_burst(len(pre))
        if not sample0.any():
            # every slot is mid-prefill: no row can sample this step, so
            # the K-1 micro-steps would run full passes over zero q_lens
            K = 1
        self.decode_microsteps += K
        self.dispatches += 1
        with RecordEvent("serving_unified_dispatch"):
            # every int32 descriptor rides ONE host-to-device copy
            parts = (tokens, row_of, off_of, starts, pos0, q_lens,
                     self.tables.reshape(-1), sample0, remaining, eos_ids,
                     fresh)
            flat = torch.from_numpy(np.concatenate(parts)).to(self.device)
            views = torch.split(flat, [p.size for p in parts])
            (tokens_d, row_d, off_d, starts_d, pos0_d, qlens_d, tables_d,
             sample0_d, rem_d, eos_d, fresh_d) = views
            from . import ragged_step as RS
            toks, self.k_pools, self.v_pools, lens = RS.unified_step(
                self.params, tokens_d, row_d, off_d, starts_d, pos0_d,
                qlens_d, tables_d.view(self.tables.shape), sample0_d != 0,
                rem_d, eos_d, torch.from_numpy(temps).to(self.device),
                self._gen, self.k_pools, self.v_pools, cfg=self.cfg,
                bs=self.bs, c_att=self._c_att, K=K, ks=self.k_scales,
                vs=self.v_scales, fresh=fresh_d != 0)
            # ONE device-to-host fetch: [K, R] tokens + [R] lengths
            host = torch.cat([toks.reshape(-1), lens]).cpu().numpy()
        toks = host[:K * R].reshape(K, R)
        self.lens = host[K * R:].astype(np.int32)
        for r in pre:
            r.prefill_done += grants.get(r.slot, 0)
        for r in dec + [r for r in pre if r.prefill_done >= len(r.prompt)]:
            for t in range(K):
                if r.done:
                    break
                tok = self._check_tok(r, int(toks[t, r.slot]))
                self._pending_tok[r.slot] = tok
                if self._emit(r, tok):
                    finished.append(r)
                    self._finish(r)
                    break
        self._step_metrics(t_step0, tokens_before, len(pre), len(dec),
                           finished)
        return finished

    def _step_two_program(self) -> List[Request]:
        """Admit, then one batched prefill-chunk program over every
        prefilling slot and one decode-burst program over every decoding
        slot: at most two dispatches per step, each with one host fetch."""
        t_step0 = time.perf_counter()
        if self._t_first_step is None:
            self._t_first_step = t_step0
        tokens_before = self._tokens_total
        finished: List[Request] = []
        self._admit()
        self._note_pool_peak()
        dev = self.device

        # ---- one chunked-prefill slice for every prefilling slot
        pre = [r for r in self.slots
               if r is not None and r.prefill_done < len(r.prompt)]
        if pre:
            P = self.max_batch
            buf = np.zeros((P, self.chunk), np.int32)
            pos0 = np.zeros((P,), np.int32)
            tables_pre = np.zeros_like(self.tables)  # zeros -> scratch
            last_idx = np.zeros((P,), np.int32)
            temps = np.zeros((P,), np.float32)
            his = {}
            for r in pre:
                i = r.slot
                lo = r.prefill_done
                hi = min(lo + self.chunk, len(r.prompt))
                buf[i, :hi - lo] = r.prompt[lo:hi]
                pos0[i] = lo
                tables_pre[i] = self.tables[i]
                last_idx[i] = hi - lo - 1  # last VALID prompt row
                temps[i] = r.temperature
                his[i] = hi
            completing = [r for r in pre if his[r.slot] >= len(r.prompt)]
            self.dispatches += 1
            with RecordEvent("serving_prefill_dispatch"):
                # every int32 descriptor rides one host-to-device copy
                parts = (buf, pos0, tables_pre, last_idx)
                flat = torch.from_numpy(np.concatenate(
                    [a.reshape(-1) for a in parts])).to(dev)
                buf_d, pos0_d, tables_d, last_d = torch.split(
                    flat, [a.size for a in parts])
                tok_dev, self.k_pools, self.v_pools = self._prefill(
                    self.params, buf_d.view(buf.shape), pos0_d,
                    tables_d.view(tables_pre.shape), last_d,
                    torch.from_numpy(temps).to(dev), self._gen,
                    self.k_pools, self.v_pools)
                # the fetch stays inside the span: the device work ends here
                tok_np = tok_dev.cpu().numpy() if completing else None
            for r in pre:
                r.prefill_done = his[r.slot]
                self.lens[r.slot] = his[r.slot]
            for r in completing:
                tok = self._check_tok(r, int(tok_np[r.slot]))
                self._pending_tok[r.slot] = tok
                if self._emit(r, tok):
                    finished.append(r)
                    self._finish(r)

        # ---- one decode burst for every slot in the decode phase
        dec = [r for r in self.slots
               if r is not None and r.prefill_done >= len(r.prompt)]
        if dec:
            B = self.max_batch
            remaining = np.zeros((B,), np.int32)
            eos_ids = np.full((B,), -1, np.int32)
            temps = np.zeros((B,), np.float32)
            for r in dec:
                remaining[r.slot] = r.max_new_tokens - len(r.output)
                if r.eos_id is not None:
                    eos_ids[r.slot] = r.eos_id
                temps[r.slot] = r.temperature
            K = self.decode_burst
            if self.adaptive_burst and self.queue:
                # end exactly when the earliest active request can finish,
                # so its slot and pages free for the queue before the next
                # burst (the smallest burst length that covers it)
                min_rem = min(r.max_new_tokens - len(r.output) for r in dec)
                K = min((k for k in self._decode_k if k >= min_rem),
                        default=K)
            self.decode_microsteps += K
            self.dispatches += 1
            with RecordEvent("serving_decode_dispatch"):
                parts = (self._pending_tok, self.tables.reshape(-1),
                         self.lens, remaining, eos_ids)
                flat = torch.from_numpy(np.concatenate(parts)).to(dev)
                tok_d, tables_d, lens_d, rem_d, eos_d = torch.split(
                    flat, [a.size for a in parts])
                toks, self.k_pools, self.v_pools, lens = self._decode_k[K](
                    self.params, tok_d, self.k_pools, self.v_pools,
                    tables_d.view(self.tables.shape), lens_d, rem_d, eos_d,
                    torch.from_numpy(temps).to(dev), self._gen)
                # ONE device-to-host fetch: [K, B] tokens + [B] lengths
                host = torch.cat([toks.reshape(-1), lens]).cpu().numpy()
            toks = host[:K * B].reshape(K, B)
            self.lens = host[K * B:].astype(np.int32)
            for r in dec:
                for t in range(K):
                    if r.done:
                        break
                    tok = self._check_tok(r, int(toks[t, r.slot]))
                    self._pending_tok[r.slot] = tok
                    if self._emit(r, tok):
                        finished.append(r)
                        self._finish(r)
                        break

        self._step_metrics(t_step0, tokens_before, len(pre), len(dec),
                           finished)
        return finished

    # -- observability -------------------------------------------------------
    def _note_pool_peak(self):
        """Sample pool pressure while this step's admissions hold their
        pages (block 0 is reserved scratch, never allocatable)."""
        total_blocks = self._num_blocks - 1
        if total_blocks:
            self._prom.gauge_max(
                "kv_pool_utilization_peak",
                1.0 - self.free_pages() / total_blocks,
                help="high-water allocated fraction of the KV pool")

    def _step_metrics(self, t_step0, tokens_before, n_pre, n_dec, finished):
        prom = self._prom
        dt = max(time.perf_counter() - t_step0, 1e-9)
        emitted = self._tokens_total - tokens_before
        total = self._num_blocks - 1
        util = 1.0 - self.free_pages() / total if total else 0.0
        prom.gauge_set("kv_pool_utilization", util,
                       help="allocated fraction of the paged KV pool")
        prom.gauge_max("kv_pool_utilization_peak", util)
        prom.gauge_set("queue_depth", len(self.queue))
        prom.gauge_set("running_requests",
                       sum(s is not None for s in self.slots),
                       help="slots occupied this step")
        prom.counter_inc("engine_steps_total", help="engine iterations")
        prom.counter_inc("dispatches_total",
                         self.dispatches - self._dispatches_reported,
                         help="programs dispatched (one per step on the "
                              "ragged path, at most two on the two-program "
                              "path)")
        self._dispatches_reported = self.dispatches
        prom.gauge_set("dispatches_per_step",
                       self.dispatches / max(self.engine_steps, 1),
                       help="mean dispatches per engine step")
        prom.counter_inc("tokens_total", emitted,
                         help="sampled tokens emitted")
        prom.counter_inc("prefill_slots_total", n_pre,
                         help="slot-steps spent prefilling")
        prom.counter_inc("decode_slots_total", n_dec,
                         help="slot-steps spent decoding")
        prom.gauge_set("prefill_decode_mix",
                       n_pre / (n_pre + n_dec) if (n_pre + n_dec) else 0.0,
                       help="prefill share of this step's active slots")
        prom.gauge_set("step_tokens_per_sec", emitted / dt,
                       help="tokens emitted by the last engine step / its "
                            "wall time")
        elapsed = max(time.perf_counter() - self._t_first_step, 1e-9)
        prom.gauge_set("tokens_per_sec", self._tokens_total / elapsed,
                       help="tokens emitted since the first engine step / "
                            "elapsed wall time")
        ok = [r for r in finished if r.status == "ok"]
        prom.counter_inc("requests_completed_total", len(ok),
                         help="requests finished successfully")
        for r in ok:
            prom.summary_observe(
                "request_seconds", time.perf_counter() - r.submit_time,
                help="submit-to-completion latency")

    def metrics_text(self) -> str:
        """Prometheus text-format exposition of the engine's telemetry."""
        return self._prom.render()
