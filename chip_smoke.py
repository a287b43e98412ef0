#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: require CUDA, print the card's name and power limit, turn TF32 off;
2. build every CUDA kernel from ``paddle_tpu_torch/csrc`` and print each
   wgmma instance's registers and spill bytes (the flash forward, dQ and
   dK/dV, the 16-bit ragged kernel on both page rings and the TF32 one)
   and the bulk-ring paged decode instances'; the dK/dV split instances
   (D_pad 192 / 256), every ragged wgmma instance (16-bit on the TMA and
   the gathered ring, TF32 on its gathered ring), the fp32
   decode instances, the TF32 flash instances (forward, dQ and dK/dV) and
   the LayerNorm forward's held-row instances must not spill;
3. hold the ragged kernel against its plain PyTorch version on the card, at
   the serving shapes (bf16, 16 heads of 128, block 32), print each case's
   route and split count (``kernel_plan``), and time kernel, plain version,
   a library yardstick and the card's bound, the decode time over kv
   lengths 64-1024, one or two decode rows of 8192 keys split over
   blocks against one split, and the decode (a) and mixed (b) batches with
   fp32 queries (the TF32 route, held at 1e-5); D 256 bf16 decode and mixed
   timed and D 160 bf16 / fp16 and D 256 fp16 held on the wgmma route (D_pad
   192 / 256); fp32 on the TF32 route there (16-key tiles): D 256 decode
   and mixed and D 160 decode timed, D 160 GQA held; D 250 fp32 decode
   timed and D 99 fp32 and D 100 bf16 held on the CUDA-core route (its wide
   and narrow instances); every case's launch counted under its
   planned route; pages of 12 keys on the gathered rings,
   decode (a) timed in bf16 ("wgmma+gather"), fp32 ("wgmma-3xtf32", which
   gathers every page size) and bf16 q over int8 pools;
4. serve a tiny fp32 GPT on the card and on the CPU: greedy tokens identical;
5. serve the GPT-1.3B shape (vocab 32768, hidden 2048, 24 layers, 16 heads,
   random weights from seed 0) through the ragged engine: 8 requests, one warm
   wave and one timed wave, every layer of every pass through the kernel,
   the ragged kernel's share of a profiled wave's device time, checked
   against a dense teacher-forced forward in bf16 and in fp32 (5b: every
   fp32 ragged launch on the TF32 kernel, counted);
6. hold the flash attention kernels (forward, dQ, dK/dV) against their plain
   versions at the training shape (B 8, S 1024, H 16, D 128, causal, q, k, v
   strided views of a head-major qkv) in bf16 and fp32, timed against their
   bound and F.scaled_dot_product_attention; check GQA 16/4, a rectangular
   causal case and S = 1000 untimed;
7. hold the fused Adam kernel against its plain version on the GPT-1.3B
   flagship's 9 eligible leaves (bf16 p, g and moments), check its stochastic
   rounding, time it against its bound and torch.optim.AdamW(fused=True);
8. train a tiny fp32 GPT 10 AdamW steps on the card and on the CPU: the
   losses agree and the training kernels launched;
9. train the GPT-1.3B flagship (bench.py's FLAGSHIP step: bf16 params, AdamW
   lr 1e-4 with bf16 moments and stochastic rounding, default remat, a fixed
   batch from RandomState(0)): 1 warm step and 5 timed steps, every launch
   count required, then a profiled step;
9b. exactness at full width: the fp32 loss and gradients of a 2-layer model,
   and the bf16 loss and gradients of the flagship's first step and the
   losses of its first 4 AdamW steps, on the kernel path against the plain
   path (composed attention, plain Adam) on the card;
9c. the flagship through the data-parallel engine at world size 1 over
   NCCL (``init_parallel_env``: a TCPStore on 127.0.0.1): (a)
   ``hybrid_engine.build_train_step`` over ``dense_loss``, ZeRO stage 1, a
   bucketed CommOverlapConfig over two comm microbatches; (b)
   ``gpt.build_hybrid_train_step`` at ZeRO stage 3 with the overlapped
   gather; 1 warm and 5 timed steps each on phase 9's batch: every loss
   within 1e-2 of phase 9's, the flash launches phase 9's times the
   microbatches, fused Adam's phase 9's; ms/step, tokens/s, peak memory
   and the collectives per step;
9d. ``distributed.sharding.build_sharded_train_step`` at world size 1 over
   NCCL: (a) level "os" with ``offload=True`` at ``offload_bench.py``'s
   2.85b shape (GPT 2.76B: H 2560, L 34, 20 heads, vocab 32768; batch 4 x
   1024, bf16, full remat, AdamW with bf16 moments): every slot leaf pinned
   on the host; (b) level "p_g_os" at phase 9's flagship and batch, the
   losses within 1e-2 of phase 9's; one warm and two timed steps each, the
   launch counts, s/step, peak memory, the copies a step;
9e. the main path of ``distributed/sharding``: GPT-6.7B (H 4096, L 32, 32
   heads, vocab 50304) trained by ``build_param_streamed_train_step`` at
   batch 4 x 2048 in bf16 with bf16 moments, its parameters and moments in
   pinned host memory (``init_streamed_params(park=)``): one warm and two
   timed steps; the loss falls, the peak device memory stays below the
   bf16 parameter bytes, the flash and fused Adam launches are 2 L, L, L
   and 4 L + 3 a step; s/step, tokens/s, the host bytes pinned, the GB
   moved each way and the share of the copy time under compute; then the
   same width at 4 layers with ClipGradByGlobalNorm(1.0) and Llama-2 7B's
   width at 4 layers, each within 1e-2 of the on-device dense step's losses
   from the same tree;
10. hold the paged decode kernel's routes against their plain version at
   the serving decode shape (timed at bf16, fp16 and fp32, all on the bulk
   ring, beside the ragged kernel on the same batch; its split counts
   swept) and on GQA, MQA 32/1, D 256, small-page, empty-row, wide-table,
   fp32 pages carried in parts (every split count) and off-the-ring cases,
   and time one and two rows of 8192 keys under GQA 16/4 split against
   unsplit;
11. hold the flash forward with an additive bias against its plain version
   at the two-program prefill's shape (timed: q a view of the head-major
   qkv, k and v the gathered pool views, a [8, 1, 128, 640] mask) and on
   the broadcast shapes, a float bias, a bool mask through
   scaled_dot_product_attention, a dead row and GQA, bf16 and fp32;
12. fill int8 and fp8 pools with the port's append on the card (bit for bit
   the CPU append's) and hold the ragged kernel over them against its plain
   version, decode (timed) and mixed, the decode batch at D 256 (the wgmma
   route) and with fp32 queries at D 128 and 256 (the TF32 kernel, held at
   1e-5 of max-abs), all timed, and with fp32 queries at D 200 (rows not
   whole 16-byte words: the CUDA-core kernel, held at 1e-5, untimed);
13. serve the GPT-1.3B shape through the two-program engine (the default
   path: batched prefill chunks on the flash bias kernel, decode bursts on
   the paged decode kernel): the same wave as phase 5, launch counts, bf16
   and fp32 checks, and fp32 tokens identical to the fp32 ragged engine's,
   every fp32 decode launch on the bulk ring, the fp32 prefill's flash
   launches (the TF32 forward) counted;
14. serve the same wave through the ragged engine with int8 and fp8 KV
   pools: tokens/s, capacity at phase 5's pool budget, determinism across
   fresh engines, teacher-forced top-5 containment; then through a bf16
   ragged engine paging by 12 keys (534 blocks, 54 a sequence: every
   ragged launch on "wgmma+gather", top-5 >= 99 %) and an fp32 one over
   int8 pools (every launch on "wgmma-3xtf32", top-5 >= 95 % against the
   dense fp32 forward);
15. hold the LayerNorm forward and backward kernels against their plain
   versions (y, dx, dw, db; the backward forms dx, dw and db in one launch,
   bit for bit across two calls, and reports its route) at the BERT-base
   step's rows (5120 x 768), at 37 rows and at 1, bf16 and fp32, eps 1e-12
   and 1e-5, with and without a bias, at the 128-sequence cell's rows with
   and without a bias, at 13 and 37 x 100 (no 16-byte words) and above the
   primitives' 28672-column limit, and at the forward's held-row edges
   (bf16 H 2048 / 2056, fp32 H 1024 / 1028); record the forward's route
   (the held row's persistent grid or the walk) and grid; time them (at
   5120 and the 128-sequence rows) against their bound, torch's layer_norm
   and its autograd backward, the backward also through the autograd
   Function, and the forward alone at [5120, 768] and [8192, 2048] in bf16,
   fp16 and fp32;
16. hold the flash kernels' segment-id and dropout variants against their
   plain versions at the packed BERT call ([10, 512, 12, 64] with the
   corpus' segment ids, p 0 and 0.1, bf16 timed, fp32), a dead row, GQA and
   causal with segments; check the CUDA and torch Philox masks bit for bit;
17. train a tiny fp32 BERT 3 AdamW steps on the card and on the CPU: losses
   and parameters agree, the BERT kernels launched;
18. train BERT-base packed (``bench_bert_packed``: vocab 30522, hidden 768,
   12 layers, 12 heads, dropout 0.1, bf16 >= 2-D parameters, AdamW bf16
   moments) on ``_bert_job``'s corpus of 16 sequences, then 128: 1 warm and
   5 timed steps each, real tokens/s, MFU, memory, every launch count (the
   LayerNorm backwards all with dw and db inside their launch), a profiled
   step;
18b. with dropout 0, the BERT kernel path against the plain path: fp32 at 2
   layers (loss, every gradient), bf16 at full depth over 4 AdamW steps;
19. hold the RMSNorm forward and backward kernels against their plain
   versions (y, dx, dw, rstd; the forward's route, the held row's
   persistent grid or the walk; the backward forms dx and dw in one launch,
   dw bit for bit across two calls) at the Llama step's rows (8192 x 2048
   bf16, fp32 weight, eps 1e-5; timed against their bound, torch's
   rms_norm and its autograd backward, and the dense form's composed
   _rms), at 4096 x 4096 (the row re-read), at 37, 1 and 13 rows x 100
   and 4095 and at 37 rows x 30000 (above the primitives' 28672-column
   limit), bf16 and fp32;
20. hold the RoPE kernel against its plain version through
   incubate's fused_rotary_position_embedding at q [8, 1024, 16, 128] and
   k [8, 1024, 4, 128] bf16, forward and backward (4 launches), timed with
   -sin too; odd D/2, fp32, a strided view and v given untimed;
21. train a tiny fp32 eager Llama 3 AdamW steps on the card and on the CPU:
   losses and parameters agree, the RMSNorm kernels launched; incubate's
   fused ops agree between card and CPU;
22. train the eager Llama at bench_llama's width (vocab 32000, hidden 2048,
   intermediate 5632, 22 layers, 16 query and 4 KV heads of 128, batch 8 x
   1024; >= 2-D parameters bf16, RMSNorm weights fp32, AdamW lr 1e-4 with
   bf16 moments and SR) through nn.functional_train_graph,
   nn.functional_call, cross_entropy on the fp32 logits,
   torch.autograd.grad and AdamW.apply: 1 warm and 5 timed steps, tokens/s,
   MFU, memory, every launch count, a profiled step and the fp32 head
   GEMMs' time;
22b. the eager Llama's kernel path (RMSNorm, flash and Adam kernels)
   against the plain path: fp32 at 2 layers (loss, every gradient), bf16 at
   full depth over 4 AdamW steps;
23. bench_llama's own dense_loss step at the same width and batch (composed
   RMSNorm and RoPE, flash GQA, per-block remat, all parameters bf16): 1
   warm and 5 timed steps, launch counts, a profiled step;
24. hold the flash kernels with an additive bias against their plain
   versions at the padded BERT call (B 16, S 512, H 12, D 64, the
   [16, 1, 512, 512] bool mask of bench_bert_base as a bias in q's dtype),
   bf16 and fp32: the bias alone and with dropout 0.1 (bf16 timed against
   their bound, the plain version and SDPA on the same mask), the bias with
   segment ids, an fp32 ALiBi-like bias beside bf16 q, the d-bias at three
   bias shapes; the dropout mask with a bias bit for bit;
25. hold them at D 32, 40, 80, 96, 160, 256 in fp32, bf16 and fp16, causal
   and not, GQA 8/2 with Sq != Sk; time D 32, 96, 160, 256 (bf16), 256 and
   128 (fp16) and 256 and 160 (fp32: the forward, dQ and dK/dV on the TF32
   kernels beside their TF32 bounds) at B 8, S 1024, H 16 causal, fp32 at
   D 160 / 256 with dropout (one mask in every kernel),
   and the Llama GQA 16/4 call,
   each against its bound and SDPA; the 16-bit dK/dV on "wgmma+tma" at
   every D 1-256; D 160 and 256 through scaled_dot_product_attention
   forward and backward with each kernel launched once; D 320 there takes
   the counted composed route;
26. a tiny fp32 BERT with a 4-D bool mask over ragged lengths: logits, loss
   and every gradient on the card against the CPU;
27. train BERT-base padded (bench_bert_base: _bert_job's corpus of 16
   sequences padded to 512, the 4-D bool mask, dropout 0.1, bf16 >= 2-D
   parameters, AdamW lr 1e-4 bf16 moments): 1 warm and 5 timed steps,
   padded and real tokens/s, MFU on the useful FLOPs, memory, every launch
   count, a profiled step;
27b. with dropout 0, the padded BERT's kernel path against the plain path:
   fp32 at 2 layers, bf16 at full depth over 4 AdamW steps, its query / key
   gradients against an fp32 witness;
28. hold the flash kernels with the flashmask rows and the sliding window
   against their plain versions at B 2, S 256, GQA 4 / 2 (and Sq 128 /
   Sk 256), D 64, 128, 256 in fp32, bf16 and fp16: causal C = 1 rows (a
   document mask), C = 2 rows with H_mask 1 and H, the window alone (causal
   and not), (left, right), the window with rows, rows with a bias, with
   segment ids, with dropout, dead rows; the d-bias with rows; the Philox
   mask with rows and a window bit for bit; the share of the causal tiles
   each mask runs (the kernels' bounds and skip rule, counted on the host);
29. time them at bench_llama's attention width (16 query and 4 kv heads of
   128, bf16): (a) a causal document mask at [8, 1024] and (b) a causal
   window of 1024 at [2, 4096], each kernel against its bound, the plain
   version, SDPA on the same dense mask, the port's kernels on that mask as
   a bias, and the causal call at the same shape;
30. drive nn.functional.flashmask_attention forward and backward on (a) and
   (b) with exact launch counts, against the plain path at full width; a
   tiny fp32 case card vs CPU, the bidirectional forms through the counted
   dense-mask route into the bias kernels; re-time the flash kernels without
   rows or window at the GPT flagship and packed BERT calls;
31. the tile primitives (kernels/primitives.py) at the models' widths: build
   each generated kernel alone (cold nvcc seconds), drive elementwise (a tanh
   GELU written by hand over the GPT flagship's FFN activation [8192, 8192]
   and a * b + 1 over [8192, 2048]), row_reduce (add and maximum over the
   Llama logits [8192, 32000]) and layer_norm forward and backward (rows
   [8192, 768] and [8192, 2048], bf16, fp32 g and b) once each with exact
   launch counts, hold each to its plain version, dg / db bit for bit across
   two calls, time each against its bound, the plain version and one
   library call (a * b + 1: torch.addcmul of a 0-d one), and a warm call's
   host work; the LayerNorm runs the ported LayerNorm's kernels
   (csrc/layer_norm.cu), their routes recorded;
32. fp16 through the LayerNorm, RMSNorm, RoPE, Adam (with a gradient in
   another dtype than p) and paged attention kernels, each against its plain
   version and timed at its main shape, and through nn.functional's
   layer_norm and rms_norm, incubate's fused RoPE and AdamW.apply with exact
   launch counts;
33. train tests/test_moe_hybrid.py's tiny fp32 GPT-MoE (vocab 64, H 32, 4
   layers, E 4, capacity factor 8) 3 AdamW steps on the card and on the
   CPU, dense and index dispatch: the losses within 1e-4, the flash kernels
   launched;
34. GPT-MoE at bench.py _run_moe_config's width (SECONDARY: vocab 32768, H
   1024, 16 layers, 16 heads, 16 x 1024 tokens; E 8 in every second layer,
   capacity factor 2.0; bf16, AdamW with bf16 moments) through
   gpt.build_hybrid_train_step at world size 1 over NCCL, mesh {dp 1, ep 1,
   pp 1, mp 1}, dense and index dispatch: 1 warm and 3 timed steps each (a
   garbage collection before, none inside), ms/step, tokens/s, peak memory,
   a profiled step's busy share, the drop fraction and tokens per expert,
   every launch count; the index form's first loss within 1e-3 of the
   dense form's;
34b. GPT-MoE's kernel path against the plain path: fp32 at 2 layers (loss,
   every gradient), bf16 at full depth (loss; gate_w, w1, qkv_w, head_w);
35. configs_bench.py bench_moe's layer (MoELayer(2048, 8192, 8, "switch",
   capacity factor 1.25), T 16384 bf16, mean(y^2), SGD) in index and
   einsum dispatch and the expert bank alone: ms/step and the expert GEMMs'
   share of the bf16 peak; fused_moe (top-2) against a MoELayer with a
   naive top-2 gate that drops nothing, within 2e-2.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.inference.serving import (ServingEngine, _block_math,
                                                _embed, _gather_seqs,
                                                _head_logits, _qkv)
from paddle_tpu_torch import device_guard
from paddle_tpu_torch import nn as TNN
from paddle_tpu_torch import random as TR
from paddle_tpu_torch.incubate.nn import functional as TI
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.kernels import layer_norm as LN
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.kernels import rms_norm as RN
from paddle_tpu_torch.kernels import rope as RP
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import gpt as G
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import norm as TFN
from paddle_tpu_torch.nn.functional.flash_attention import (
    _sdpa_reference, scaled_dot_product_attention)
from paddle_tpu_torch.quantization import kv_cache as KV
from paddle_tpu_torch.observability import flops as FL
from paddle_tpu_torch.optimizer import optimizer as O
from paddle_tpu_torch.optimizer.optimizer import AdamW

# published H100 SXM peaks at its 700 W power limit (the bound_ms basis)
HBM_BYTES_PER_S = 3.35e12      # device memory
BF16_FLOPS = 989e12            # dense bf16 tensor cores
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
TF32_FLOPS = 495e12            # dense TF32 tensor cores
KERNEL_TOL = 1e-2              # max-abs err / max-abs ref (test_ragged_serving)
TIMING_RUNS = 30
# device-side sleep before each timed call, in clock cycles (milliseconds at
# the card's clock): the host has enqueued the call before the device gets
# to it
SLEEP_CYCLES = 10_000_000
FULL = dict(vocab_size=32768, hidden_size=2048, num_layers=24, num_heads=16,
            max_seq_len=1024)
FULL_ENGINE = dict(max_batch=8, block_size=32, num_blocks=200,
                   max_blocks_per_seq=20, chunk=128, decode_burst=32,
                   ragged=True)
TRAIN = dict(FULL, batch=8, seq=1024)   # bench.py FLAGSHIP
TRAIN_TIMED_STEPS = 5
TRAJECTORY_STEPS = 4          # phase 9b: kernel path vs plain path
# flash kernel vs plain tolerances (out, grads) on the worst tile's
# ||got - ref|| / ||ref|| (tile_rel_err): fp32 summation order, bf16
# rounding of the outputs and of the tensor-core operands
FLASH_TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-2, 2e-2)}
# the operands the flash forward takes beside q, k and v
FWD_KEYS = ("bias", "q_seg", "kv_seg", "dropout_p", "seed", "fm", "window")
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """A check of the run: raises (never stripped, unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    log(f"\n=== {name} ===")
    return time.perf_counter()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def cuda_ms(fn, runs=TIMING_RUNS, warmup=3, sleep=SLEEP_CYCLES):
    """Median of ``runs`` CUDA-event timings of fn() on the device, after a
    warm-up. Before each run a 256 MB write evicts the 50 MB L2 (the
    serving pass streams gigabytes of weights between two attention calls,
    so the pages arrive cold), then a device-side sleep of ``sleep`` cycles
    holds the stream while the host enqueues fn(): the events then bracket
    device work only, not the wrapper's host time."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(sleep)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------
def make_case(rng, q_lens, kv_lens, C, hq, hkv, D=128, bs=32, NB=200, nb=20,
              dtype=torch.bfloat16):
    R = len(q_lens)
    dev = torch.device(DEV)
    tables = np.zeros((R, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(R):
        for j in range(-(-kv_lens[r] // bs)):
            tables[r, j] = free.pop()

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    return dict(
        q=t(rng.randn(R, C, hq, D).astype(np.float32)),
        k_pool=t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
        v_pool=t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
        block_tables=t(tables, torch.int32),
        q_lens=t(np.asarray(q_lens, np.int32), torch.int32),
        kv_lens=t(np.asarray(kv_lens, np.int32), torch.int32),
        scale=1.0 / math.sqrt(D))


def case_bound(case):
    """Least time the card needs: each input byte it needs read once (the
    live query columns; the K / V rows of the keys a row sees, kv_len of
    them and not the whole pages they sit in; the table entries of the
    pages those keys use, with two fp32 scales per (kv head, page) of a
    quantized pool; the lengths), each output byte written once (all C
    columns), against the FLOPs the visible (query head, key) pairs
    need."""
    q, kp = case["q"], case["k_pool"]
    R, C, hq, D = q.shape
    hkv, _, bs, _ = kp.shape
    nb = case["block_tables"].shape[1]
    it = q.element_size()
    ql = case["q_lens"].cpu().numpy()
    kl = case["kv_lens"].cpu().numpy()
    keys = [min(int(k), nb * bs) for k, l in zip(kl, ql) if l > 0]
    pages = sum(-(-k // bs) for k in keys)
    scale_bytes = 4 * pages if "k_scales" in case else 0
    nbytes = (int(ql.sum()) * hq * D * it + q.numel() * it
              + 2 * hkv * (sum(keys) * D * kp.element_size() + scale_bytes)
              + 4 * (pages + 2 * R))
    flops = 0
    for l, k in zip(ql, kl):
        for c in range(int(l)):
            flops += (int(k) - int(l) + c + 1) * hq * 4 * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def sdpa_yardstick(case):
    """F.scaled_dot_product_attention over the pre-gathered pages with the
    same mask: a timing yardstick only, never used by the port."""
    q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
    R, C, hq, D = q.shape
    hkv, _, bs, _ = kp.shape
    tables = case["block_tables"].long()
    nb = tables.shape[1]
    k = kp[:, tables].reshape(hkv, R, nb * bs, D).transpose(0, 1)
    v = vp[:, tables].reshape(hkv, R, nb * bs, D).transpose(0, 1)
    qt = q.transpose(1, 2).contiguous()                       # [R, hq, C, D]
    c = torch.arange(C, device=q.device)
    col = torch.arange(nb * bs, device=q.device)
    qpos = (case["kv_lens"] - case["q_lens"]).long()[:, None] + c[None]
    mask = ((c[None] < case["q_lens"].long()[:, None])[:, :, None]
            & (col[None, None] <= qpos[:, :, None]))[:, None]  # [R,1,C,K]
    k, v = k.contiguous(), v.contiguous()
    gqa = hq != hkv

    def run():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask, scale=case["scale"], enable_gqa=gqa)
    return run


def ragged_plan_line(case):
    """The route, tiles and split count the library gives a case
    (RPA.kernel_plan)."""
    plan = RPA.kernel_plan(case["q"], case["k_pool"], case["block_tables"])
    return plan, (f"route {plan['design']}, {plan['query_rows']} folded rows "
                  f"a block, {plan['keys']} keys a tile, splits "
                  f"{plan['splits']}")


def counted_ragged(name, plan, args):
    """One launch of the ragged kernel, counted under the route its plan
    names and no other (``RPA.ragged_paged_attention.ROUTES``)."""
    routes = dict(RPA.ragged_paged_attention.ROUTES)
    out = RPA.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    now = RPA.ragged_paged_attention.ROUTES
    require(all(now[r] == routes[r] + (r == plan["design"]) for r in now),
            f"{name}: launches by route {routes} -> {now}, planned "
            f"{plan['design']}")
    return out


def check_kernel_case(name, case, card, tol=None):
    """The ragged kernel against its plain version on one case (max-abs
    error within ``tol`` of the reference's max-abs: KERNEL_TOL in 16 bits,
    1e-5 in fp32 by default); with ``card``, timed against the plain
    version, SDPA over pre-gathered pages and the bound (and, on the TF32
    route, the bound of three TF32 products a pair)."""
    if tol is None:
        tol = 1e-5 if case["q"].dtype == torch.float32 else KERNEL_TOL
    args = (case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
            case["q_lens"], case["kv_lens"], case["scale"])
    plan, line = ragged_plan_line(case)
    log(f"{name}: {line}")
    out_k = counted_ragged(name, plan, args)
    out_p = RPA.ragged_paged_attention_plain(*args)
    require(out_k.dtype == out_p.dtype == case["q"].dtype, f"{name}: dtype")
    require(torch.isfinite(out_k.float()).all(), f"{name}: non-finite output")
    err = (out_k.float() - out_p.float()).abs().max().item()
    ref = out_p.float().abs().max().item()
    rel = err / max(ref, 1e-9)
    # masked columns and empty rows must be exact zeros
    ql = case["q_lens"].cpu().numpy()
    for r, l in enumerate(ql):
        dead = out_k[r, int(l):]
        require((dead == 0).all(), f"{name}: row {r} columns >= {l} not zero")
    log(f"{name}: max_abs_err {err:.3e} max_abs_ref {ref:.3e} rel {rel:.3e} "
        f"(tol {tol})")
    require(rel <= tol, f"{name}: rel err {rel} > {tol}")
    rec = dict(max_abs_err=err, rel_err=rel, design=plan["design"],
               splits=plan["splits"])
    if card is None:
        return rec
    kern = cuda_ms(lambda: RPA.ragged_paged_attention(*args))
    plain = cuda_ms(lambda: RPA.ragged_paged_attention_plain(*args))
    lib = cuda_ms(sdpa_yardstick(case))
    bound, bound_by, nbytes, flops = case_bound(case)
    tf32 = (tf32_bound_ms(case_bound(case))
            if plan["design"].startswith("wgmma-3xtf32") else None)
    note = "" if tf32 is None else f" tf32x3_bound_ms {tf32:.4f}"
    log(f"{name}: kernel_ms {kern:.4f} plain_ms {plain:.4f} "
        f"library_ms {lib:.4f} (SDPA over pre-gathered pages) bound_ms "
        f"{bound:.4f} ({bound_by}: {nbytes} B, {flops} FLOP){note} "
        f"kernel/bound {kern / bound:.1f}x  [{card}]")
    rec.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
               bound_by=bound_by, bytes=nbytes, flops=flops)
    if tf32 is not None:
        rec["tf32x3_bound_ms"] = tf32
    return rec


def decode_sweep(rng, card):
    """(d) How the decode time grows with kv_len (8 rows, all at one
    length): a row's key tiles are split over blocks (the split count from
    the table width), so the time should follow the bytes, not one block's
    walk over the longest row; the library call runs on pre-gathered dense
    K/V."""
    recs = {}
    for kv in (64, 128, 256, 512, 1024):
        case = make_case(rng, [1] * 8, [kv] * 8, C=1, hq=16, hkv=16, NB=300,
                         nb=33)
        args = (case["q"], case["k_pool"], case["v_pool"],
                case["block_tables"], case["q_lens"], case["kv_lens"],
                case["scale"])
        plan, line = ragged_plan_line(case)
        kern = cuda_ms(lambda: RPA.ragged_paged_attention(*args))
        lib = cuda_ms(sdpa_yardstick(case))
        bound = case_bound(case)[0]
        log(f"(d) decode R=8 kv_len {kv}: kernel_ms {kern:.4f} library_ms "
            f"{lib:.4f} bound_ms {bound:.4f} ({line})  [{card}]")
        recs[kv] = dict(ms=kern, library_ms=lib, bound_ms=bound,
                        splits=plan["splits"])
    return recs


def long_row_decode(rng, card):
    """(e) A few long decode rows (R 1 and 2 at kv_len 8192, 16 kv heads: 16
    and 32 blocks on the card's SMs): the plan splits each row's key tiles
    over blocks and a second kernel merges them; held to the plain version
    and timed against the same call at one split, SDPA and the bound."""
    recs = {}
    for R in (1, 2):
        case = make_case(rng, [1] * R, [8192] * R, C=1, hq=16, hkv=16,
                         NB=256 * R + 8, nb=256)
        args = (case["q"], case["k_pool"], case["v_pool"],
                case["block_tables"], case["q_lens"], case["kv_lens"],
                case["scale"])
        plan, line = ragged_plan_line(case)
        require(plan["splits"] > 1, f"(e) R={R}: the plan does not split")
        rec = check_kernel_case(f"(e) long decode R={R} kv_len 8192", case,
                                None)
        one = cuda_ms(lambda: RPA.ragged_paged_attention(*args, splits=1))
        kern = cuda_ms(lambda: RPA.ragged_paged_attention(*args))
        lib = cuda_ms(sdpa_yardstick(case))
        bound = case_bound(case)[0]
        log(f"(e) long decode R={R} kv_len 8192: kernel_ms {kern:.4f} "
            f"({plan['splits']} splits) one_split_ms {one:.4f} library_ms "
            f"{lib:.4f} bound_ms {bound:.4f}  [{card}]")
        recs[R] = dict(ms=kern, one_split_ms=one, library_ms=lib,
                       bound_ms=bound, splits=plan["splits"],
                       max_abs_err=rec["max_abs_err"])
    return recs


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------
def serve(engine, prompts, news, eos=None):
    """Submit every request, run to completion; returns (outputs in order,
    TTFT seconds per request, wall seconds)."""
    first = {}
    submit = {}

    def on_token(rid, tok):
        first.setdefault(rid, time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = []
    for i, (p, n) in enumerate(zip(prompts, news)):
        rid = engine.add_request(p, n, eos_id=(eos or {}).get(i),
                                 on_token=on_token)
        submit[rid] = time.perf_counter()
        rids.append(rid)
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(not res.leftover and all(res.statuses[r] == "ok" for r in rids),
            f"requests left over or failed: {res.statuses}")
    return ([res[r] for r in rids], [first[r] - submit[r] for r in rids],
            wall)


@torch.no_grad()
def dense_logits(params, cfg, seq):
    """Teacher-forced dense forward over one sequence: the port's block
    math with plain causal attention (matmul, mask, fp32 softmax), no pool.
    Returns fp32 logits [S, V]."""
    dev = params["wte"].device
    S = len(seq)
    toks = torch.as_tensor(np.asarray(seq), device=dev)[None]
    pos = torch.arange(S, device=dev)[None]
    x = _embed(params, toks, pos, cfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for layer in range(cfg.num_layers):
        p = {name: leaf[layer] for name, leaf in params["blocks"].items()}
        q, k, v = _qkv(p, x, cfg)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        s = s / math.sqrt(cfg.head_dim)
        s = s.masked_fill(~causal, float("-inf"))
        a = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float()).to(cfg.dtype)
        x = _block_math(p, x, attn, cfg)
    x = G._ln(x, params["lnf_g"], params["lnf_b"])
    return _head_logits(params, x[0], cfg)


def teacher_forced(params, cfg, prompts, outs, topk):
    """For every generated token: is it the reference's top-1, and is it in
    the reference's top-k? Returns (top1 hits, topk hits, first-token top-1
    hits, positions, margins where top-1 differs)."""
    top1 = topk_hits = first_hits = n = 0
    margins = []
    for p, out in zip(prompts, outs):
        seq = list(p) + list(out)
        logits = dense_logits(params, cfg, seq)
        P = len(p)
        for i, tok in enumerate(out):
            row = logits[P + i - 1]
            best = int(torch.argmax(row))
            kset = torch.topk(row, topk).indices.tolist()
            n += 1
            topk_hits += tok in kset
            if best == tok:
                top1 += 1
                first_hits += i == 0
            else:
                margins.append(float(row[best] - row[tok]))
    return top1, topk_hits, first_hits, n, margins


def small_engine_phase():
    cfg = G.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                      num_heads=4, max_seq_len=128, dtype=torch.float32)
    kw = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False, ragged=True)
    params = G.init_hybrid_params(cfg, 0, DEV)
    params_cpu = {k: ({n: t.cpu() for n, t in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in (5, 13, 9, 16)]
    news = [6, 3, 9, 5]

    def run(dev, prm, eos):
        eng = ServingEngine(prm, cfg, device=dev, **kw)
        rids = [eng.add_request(p, n, eos_id=eos.get(i))
                for i, (p, n) in enumerate(zip(prompts, news))]
        res = eng.run()
        return [res[r] for r in rids]

    # request 2 stops at EOS: its third token from an EOS-free CPU run
    free_run = run("cpu", params_cpu, {})[2]
    eos = {2: free_run[2]}
    RPA.ragged_paged_attention.LAUNCHES = 0
    out_gpu = run(DEV, params, eos)
    launches = RPA.ragged_paged_attention.LAUNCHES
    out_cpu = run("cpu", params_cpu, eos)
    log(f"cuda: {out_gpu}\ncpu:  {out_cpu}\nkernel launches (cuda run): "
        f"{launches}")
    require(len(out_gpu[2]) == free_run.index(eos[2]) + 1 < news[2],
            "EOS did not stop request 2")
    require(out_gpu == out_cpu, "card and CPU engines disagree")
    require(launches > 0, "the tiny engine launched no kernel")


def full_width_workload():
    rng = np.random.RandomState(0)
    plens = rng.choice([128, 256, 512], size=8)
    news = rng.randint(16, 65, size=8)
    prompts = [rng.randint(0, FULL["vocab_size"], (int(n),)) for n in plens]
    return prompts, [int(n) for n in news]


def _kernel_class(name, gather=False):
    """Device time classes of a serving profile; ``gather`` splits the
    indexing kernels (the pool gathers and scatters) out of "other"."""
    if any(w in name for w in ("ragged_paged_attention", "paged_decode",
                               "flash_fwd")):
        return "attention"
    if gather and any(w in name.lower() for w in ("index", "gather",
                                                  "scatter")):
        return "gather/scatter"
    if any(w in name.lower() for w in ("nvjet", "gemm", "cutlass", "xmma")):
        return "gemm"
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "other"


def profile_wave(engine, prompts, card, gather=False, n=4, tokens=16):
    """Where the time goes: one wave (n requests x ``tokens`` tokens) under
    torch.profiler. Device busy = the sum of kernel and copy times (one
    stream, so they do not overlap); launches = their count. The device
    events are summed from the profiler's raw records: its per-name tables
    (``key_averages``) take a minute per 100k events to build."""
    from torch.profiler import ProfilerActivity, profile
    steps0, micro0 = engine.engine_steps, engine.decode_microsteps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(engine, prompts[:n], [tokens] * n)
    steps = engine.engine_steps - steps0
    passes = engine.decode_microsteps - micro0
    by_name = {}                                   # name -> [ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            agg = by_name.setdefault(e.name(), [0, 0])
            agg[0] += e.duration_ns()
            agg[1] += 1
    busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
    ops = sum(c for _, c in by_name.values())
    require(ops > 0, "the profiled wave shows no device operation")
    by_class = {}
    for name, (ns, _) in by_name.items():
        c = _kernel_class(name, gather)
        by_class[c] = by_class.get(c, 0) + ns / 1e3
    share = busy_us / 1e3 / (wall * 1e3)
    log(f"profiled wave ({n} requests x {tokens} tokens): wall "
        f"{wall * 1e3:.1f} ms, "
        f"{steps} engine steps, {passes} forward passes; device busy "
        f"{busy_us / 1e3:.1f} ms = {share:.1%} of wall (idle {1 - share:.1%}); "
        f"{ops} device operations = {ops / steps:.0f} per engine step, "
        f"{ops / passes:.0f} per pass  [{card}]")
    log("device time by class: " + ", ".join(
        f"{c} {t / 1e3:.1f} ms ({t / busy_us:.1%})"
        for c, t in sorted(by_class.items(), key=lambda kv: -kv[1])))
    ragged_us = sum(ns for name, (ns, _) in by_name.items()
                    if "ragged" in name) / 1e3
    log(f"ragged paged attention (kernel and split merge): "
        f"{ragged_us / 1e3:.2f} ms = {ragged_us / busy_us:.1%} of the wave's "
        f"device time")
    for name, (ns, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ns / 1e6:9.3f} ms {count:7d} x  {name[:100]}")
    return dict(profile_wall_ms=wall * 1e3, device_busy_share=share,
                ragged_ms=ragged_us / 1e3, ragged_share=ragged_us / busy_us,
                device_ops_per_step=ops / steps,
                device_ops_per_pass=ops / passes,
                device_ms_by_class={c: t / 1e3 for c, t in by_class.items()})


def full_width_bf16_phase(card):
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    params = G.init_hybrid_params(cfg, 0, DEV)
    engine = ServingEngine(params, cfg, seed=0, device=DEV, **FULL_ENGINE)
    prompts, news = full_width_workload()
    log(f"prompt lengths {[len(p) for p in prompts]}, max_new_tokens {news}")
    serve(engine, prompts, news)                       # warm wave
    steps0, disp0 = engine.engine_steps, engine.dispatches
    micro0 = engine.decode_microsteps
    torch.cuda.reset_peak_memory_stats()
    # main path: the counts go to 0 just before and are read just after
    RPA.ragged_paged_attention.LAUNCHES = 0
    outs, ttft, wall = serve(engine, prompts, news)    # timed wave
    launches = RPA.ragged_paged_attention.LAUNCHES
    steps = engine.engine_steps - steps0
    disp = engine.dispatches - disp0
    micro = engine.decode_microsteps - micro0
    gen = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated()
    ttft_ms = sorted(t * 1e3 for t in ttft)
    p50 = ttft_ms[math.ceil(0.5 * len(ttft_ms)) - 1]
    p95 = ttft_ms[math.ceil(0.95 * len(ttft_ms)) - 1]
    log(f"timed wave: {gen} tokens in {wall:.3f} s = {gen / wall:.1f} "
        f"generated tokens/s; TTFT p50 {p50:.1f} ms p95 {p95:.1f} ms; "
        f"engine steps {steps}; dispatches/step {disp / steps:.3f}; "
        f"forward passes {micro}; ms/pass {wall * 1e3 / micro:.2f}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    log(f"ragged_paged_attention LAUNCHES {launches} == {cfg.num_layers} x "
        f"decode_microsteps {micro}")
    require(launches == cfg.num_layers * micro and launches > 0,
            "a layer of a pass did not go through the kernel")
    require(disp == steps, f"{disp} dispatches in {steps} engine steps")
    for o, n in zip(outs, news):
        require(0 < len(o) <= n and all(0 <= t < cfg.vocab_size for t in o),
                "an output is empty, too long or out of the vocabulary")

    profile = profile_wave(engine, prompts, card)

    top1, top5, first, n, margins = teacher_forced(params, cfg, prompts, outs,
                                                   5)
    log(f"bf16 teacher-forced: top-5 containment {top5}/{n} = {top5 / n:.2%}, "
        f"top-1 agreement {top1}/{n} = {top1 / n:.2%}; logit margins where "
        f"top-1 differs: {[round(m, 3) for m in margins]}")
    require(top5 >= 0.99 * n, "bf16 top-5 containment below 99 %")
    record = dict(tokens_per_s=gen / wall, ttft_p50_ms=p50, ttft_p95_ms=p95,
                  engine_steps=steps, dispatches_per_step=disp / steps,
                  passes=micro, launches=launches, peak_bytes=peak,
                  top5=top5 / n, top1=top1 / n, **profile)
    del engine, params
    torch.cuda.empty_cache()
    return record


def full_width_fp32_phase(stats=None, **engine_kw):
    """The fp32 copy's exactness checks; returns its greedy outputs (phase
    13 holds the two-program engine's to them). ``stats``, where given, gets
    the wave's generated tokens/s."""
    cfg = G.GPTConfig(**FULL, dtype=torch.float32, param_dtype=torch.float32)
    params = G.init_hybrid_params(cfg, 0, DEV)
    engine = ServingEngine(params, cfg, seed=0, device=DEV,
                           **{**FULL_ENGINE, **engine_kw})
    prompts, _ = full_width_workload()
    prompts = prompts[:4]
    outs, _, wall = serve(engine, prompts, [16] * 4)
    if stats is not None:
        stats["tokens_per_s"] = sum(len(o) for o in outs) / wall
    top1, top5, first, n, margins = teacher_forced(params, cfg, prompts, outs,
                                                   5)
    log(f"fp32 teacher-forced ({wall:.2f} s serving): top-1 {top1}/{n} = "
        f"{top1 / n:.2%}, first tokens {first}/{len(outs)}, margins where "
        f"top-1 differs: {margins}")
    require(first == len(outs), "fp32: a first token differs from reference")
    require(top1 >= 0.99 * n, "fp32 top-1 agreement below 99 %")
    del engine, params
    torch.cuda.empty_cache()
    return outs


# ---------------------------------------------------------------------------
# phase 6: flash attention kernels vs plain
# ---------------------------------------------------------------------------
def visible_pairs(sq, sk, causal):
    """(query, key) pairs the causal rule leaves visible (all if not)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(max(i + off + 1, 0), sk) for i in range(sq))


def flash_case(B, sq, sk, H, Hkv, D, dtype, seed):
    """q, k, v as the model gives them (strided views of one head-major
    qkv [B, S, H, 3, D] when the shapes allow), and dO."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    if sq == sk and H == Hkv:
        qkv = rnd(B, sq, H, 3, D)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    else:
        q, k, v = rnd(B, sq, H, D), rnd(B, sk, Hkv, D), rnd(B, sk, Hkv, D)
    return q, k, v, rnd(B, sq, H, D)


def _rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1.0)


def tile_rel_err(got, ref, rows=64):
    """The worst ||got - ref|| / ||ref|| over the (batch, 64-row tile,
    head) slabs of [B, S, H, D] tensors: every tile of every head is held
    to its own size, so a kernel that drops or corrupts one tile fails
    however small that tile's values are beside the largest (0 where both
    slabs are zero, inf where only ref's is)."""
    r = ref.float()
    d = got.float() - r
    pad = -d.shape[1] % rows
    d, r = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (d, r))
    B, S, H, D = d.shape
    dd, rr = (t.reshape(B, S // rows, rows, H, D).square().sum((2, 4))
              for t in (d, r))
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, math.inf, 0.0))
    return ratio.max().item()


def flash_bounds(q, k, pairs, bias=None, dbias=False, seg=False, fm=None):
    """{kernel: (bound_ms, bound_by, bytes, flops)}: each input read once,
    each output written once (the bias once by each kernel, so twice by the
    backward; the segment ids and the flashmask rows ``fm`` once; with
    ``dbias`` the fp32 [B, H, Sq, Sk] d-bias written by dQ), against 4 D
    (forward), 6 D (dQ: s, dp, dq; its
    kernel's delta pass repeats s and dp, which the bound does not count)
    and 8 D (dK/dV: s, dp, dk, dv) FLOPs per visible (query, key) pair over
    all heads (``pairs``: what this run's causal rule and mask leave), at
    the dtype's peak (the 16-bit tensor cores, or fp32 outside them)."""
    B, sq, H, D = q.shape
    sk, Hkv = k.shape[1], k.shape[2]
    it = q.element_size()
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    qn, kn, rows = B * sq * H * D, B * sk * Hkv * D, B * H * sq
    extra = (0 if bias is None else bias.numel() * bias.element_size()) + (
        4 * B * (sq + sk) if seg else 0) + (
        0 if fm is None else 4 * (fm[0].numel() + fm[1].numel()))
    work = {"flash_fwd": ((2 * qn + 2 * kn) * it + 4 * rows, 4 * D * pairs),
            "flash_bwd_dq": ((3 * qn + 2 * kn) * it + 8 * rows
                             + (4 * B * H * sq * sk if dbias else 0),
                             6 * D * pairs),
            "flash_bwd_dkv": ((2 * qn + 4 * kn) * it + 8 * rows,
                              8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        nbytes += extra
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations",
                     nbytes, flops)
    return out


def tf32_bound_ms(bound):
    """The fp32 bound of the TF32 tensor-core design (each operand split in
    two halves: three products for each) from a ``flash_bounds`` or
    ``case_bound`` entry: its bytes against 3x its FLOPs at the dense TF32
    peak."""
    _, _, nbytes, flops = bound
    return max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3


def check_attn(name, q, k, v, do, causal, var, bias_grad=False, card=None,
               pairs=None):
    """The three kernels against their plain versions on the same inputs:
    lse, dead rows, out, dq, dk, dv (and the d-bias) on the worst 64-row
    tile at the dtype's tier; with ``card``, each kernel timed (CUDA
    events, median, cold L2) against its bound, the plain version and
    F.scaled_dot_product_attention on the same float mask and dropout."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    out, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    dq, delta, *dbf = FA.flash_bwd_dq(q, k, v, lse, do, causal, scale,
                                      bias_grad=bias_grad, **var)
    dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale, **var)
    torch.cuda.synchronize()
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale, **fwd)
    ref = FA.flash_bwd_plain(q, k, v, lse, do, causal, scale,
                             bias_grad=bias_grad, **var)
    tol_o, tol_g = FLASH_TOL[torch.float32 if q.dtype == torch.float32
                             else torch.bfloat16]
    live = lse_p > -1e29
    require(torch.equal(live, lse > -1e29), f"{name}: dead rows differ")
    dead_q = ~live.transpose(1, 2)
    require(bool((out[dead_q] == 0).all()) and bool((dq[dead_q] == 0).all()),
            f"{name}: a dead row's output or dq is not zero")
    err, rel = _rel_err(lse[live], lse_p[live]) if live.any() else (0.0, 0.0)
    require(rel <= 1e-5, f"{name}: lse rel err {rel} > 1e-5")
    require(bool((lse[~live] == -1e30).all()), f"{name}: a dead row's lse "
            f"is not -1e30")
    rec = {"lse": err, "dead_rows": int((~live).sum())}
    for what, got, want, tol in (("out", out, out_p, tol_o),
                                 ("dq", dq, ref[0], tol_g),
                                 ("dk", dk, ref[1], tol_g),
                                 ("dv", dv, ref[2], tol_g)):
        require(torch.isfinite(got.float()).all(), f"{name}: {what} not finite")
        tile = tile_rel_err(got, want)
        require(tile <= tol, f"{name}: {what} tile L2 rel err {tile} > {tol}")
        rec[what], rec[what + "_tile"] = _rel_err(got, want)[0], tile
    msg = ""
    if bias_grad:
        db = FA._reduce_dbias(dbf[0], var["bias"])
        want = ref[3]
        l2 = ((db.float() - want.float()).norm()
              / want.float().norm().clamp_min(1e-30)).item()
        tol = tol_g if q.dtype != torch.float32 else 5e-6
        require(db.shape == var["bias"].shape and l2 <= tol,
                f"{name}: d-bias {tuple(db.shape)} l2 rel err {l2} > {tol}")
        rec["dbias_l2"] = l2
        msg = f" d-bias {tuple(db.shape)} l2 rel {l2:.3e}"
    log(f"{name}: worst tile L2 rel err out {rec['out_tile']:.3e} dq "
        f"{rec['dq_tile']:.3e} dk {rec['dk_tile']:.3e} dv "
        f"{rec['dv_tile']:.3e} (tol {tol_o}, {tol_g});{msg} lse max_abs_err "
        f"{rec['lse']:.3e}; dead rows {rec['dead_rows']}")
    del out_p, lse_p, ref
    if card is None:
        return rec
    bounds = flash_bounds(q, k, pairs, var.get("bias"), bias_grad,
                          "q_seg" in var, var.get("fm"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    p = var.get("dropout_p", 0.0)
    mask = var.get("bias")
    if mask is not None and mask.dtype != q.dtype:
        mask = mask.to(q.dtype)
    if "q_seg" in var:
        seg = var["q_seg"]
        same = (seg[:, None, :, None] == seg[:, None, None, :])
        mask = same if mask is None else torch.where(same, mask, -1e30).to(
            q.dtype)
    if "fm" in var or "window" in var:
        # the library takes the rows and the window as a dense bool mask
        # that carries the causal rule too
        vis = FA._visible(q.shape[1], k.shape[1], causal, q.device,
                          fm=var.get("fm"), window=var.get("window"))
        mask = vis if mask is None else torch.where(vis, mask, -1e30).to(
            q.dtype)
    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    do_t = do.transpose(1, 2).contiguous()

    def lib():
        return sdpa(qt, kt, vt, attn_mask=mask, dropout_p=p,
                    is_causal=causal and mask is None, enable_gqa=gqa)
    o_lib = lib()
    times = {
        "flash_fwd": (cuda_ms(lambda: FA.flash_fwd(q, k, v, causal, scale,
                                                   **fwd)),
                      cuda_ms(lambda: FA.flash_fwd_plain(q, k, v, causal,
                                                         scale, **fwd),
                              runs=10),
                      cuda_ms(lib)),
        "flash_bwd_dq": (cuda_ms(lambda: FA.flash_bwd_dq(
            q, k, v, lse, do, causal, scale, bias_grad=bias_grad, **var)),
            None, None),
        "flash_bwd_dkv": (cuda_ms(lambda: FA.flash_bwd_dkv(
            q, k, v, lse, delta, do, causal, scale, **var)), None, None)}
    plain_bwd = cuda_ms(lambda: FA.flash_bwd_plain(
        q, k, v, lse, do, causal, scale, bias_grad=bias_grad, **var), runs=10)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[kname] = (times[kname][0], plain_bwd, lib_bwd)
    errs = {"flash_fwd": rec["out"], "flash_bwd_dq": rec["dq"],
            "flash_bwd_dkv": max(rec["dk"], rec["dv"])}
    recs = {}
    for kname, (kern, plain, libt) in times.items():
        bound, by, nbytes, flops = bounds[kname]
        design = FA.kernel_plan(kname, q.shape[-1], q.dtype,
                                "bias" in var)["design"]
        tf32 = (tf32_bound_ms(bounds[kname]) if design == "wgmma-3xtf32"
                else None)
        note = ("" if tf32 is None else
                f" tf32x3_bound_ms {tf32:.4f} (3x the FLOPs at "
                f"{TF32_FLOPS / 1e12:.0f} TFLOP/s) kernel/tf32x3 bound "
                f"{kern / tf32:.1f}x")
        log(f"{name} {kname} [{design}]: kernel_ms {kern:.4f} plain_ms "
            f"{plain:.4f} library_ms {libt:.4f} bound_ms {bound:.4f} ({by}: "
            f"{nbytes} B, {flops} FLOP over {pairs} visible pairs) "
            f"kernel/bound {kern / bound:.1f}x{note}  [{card}]")
        recs[kname] = dict(max_abs_err=errs[kname], ms=kern, plain_ms=plain,
                           library_ms=libt, bound_ms=bound, bound_by=by,
                           bytes=nbytes, flops=flops, visible_pairs=pairs,
                           design=design)
        if tf32 is not None:
            recs[kname]["tf32x3_bound_ms"] = tf32
    lib_on = ", ".join(w for w, on in (("the same mask",
                                         mask is not None),
                                        ("dropout", p), ("GQA", gqa)) if on)
    log(f"{name}: plain and library backward times cover dq, dk and dv "
        f"together (the library: SDPA{' with ' + lib_on if lib_on else ''})")
    del qt, kt, vt, o_lib
    return recs


def flash_designs(name):
    """How each instance of a flash kernel computes, by D_pad and dtype, as
    the built library reports it (FA.kernel_plan): "wgmma+tma" (the 16-bit
    forward and dQ, csrc/flash_fwd_hopper.cu and flash_dq_hopper.cu: wgmma
    with the scores and accumulators in registers, K / V through a TMA
    ring; the 16-bit dK/dV, csrc/flash_dkv_hopper.cu: transposed scores in
    registers, Q / dO through a TMA ring, at D_pad 192 and 256 one
    warpgroup holding dv and another dk over 64 keys), "wgmma-3xtf32" (the
    fp32 forward, dQ and dK/dV at every width,
    csrc/flash_fwd_tf32_hopper.cu, flash_dq_tf32_hopper.cu and
    flash_dkv_tf32_hopper.cu: each operand split into two TF32 halves,
    three products for each); and the bf16 and fp32 tiles (query rows x
    keys)."""
    from paddle_tpu_torch.kernels import _build
    out = {}
    for d in _build.FLASH_D_PADS:
        out[f"D_pad {d}"] = {tag: FA.kernel_plan(name, d, dt)["design"]
                             for tag, dt in (("bf16", torch.bfloat16),
                                             ("fp16", torch.float16),
                                             ("fp32", torch.float32))}
        plan = FA.kernel_plan(name, d, torch.bfloat16)
        out[f"D_pad {d}"]["tiles"] = [plan["query_rows"], plan["keys"]]
        plan = FA.kernel_plan(name, d, torch.float32)
        out[f"D_pad {d}"]["fp32_tiles"] = [plan["query_rows"], plan["keys"]]
    return out


def tf32_ptxas(output):
    """[(kernel, D_pad, bias, ints, dropout, registers, spill store bytes)]
    of the fp32 flash instances on the TF32 tensor cores (the forward at
    every width, flash_fwd_tf32_wide_kernel at D_pad 192 / 256; dQ and
    dK/dV), from ptxas's -v lines."""
    recs, cur, spill = [], None, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.search(r"(flash_(?:fwd|dq|dkv)_tf32(?:_wide)?_kernel)ILi"
                            r"(\d+)ELb([01])ELb([01])ELb([01])E", m.group(1))
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name, *rest = cur.groups()
            recs.append((name, *(int(r) if r else -1 for r in rest),
                         int(m.group(1)), spill))
            cur = None
    return recs


def wgmma_ptxas(output):
    """[(kernel, dtype, D_pad, bias, ints, dropout, registers, spill store
    bytes)] of the 16-bit flash wgmma instances (the forward, dQ and
    dK/dV), from ptxas's -v lines."""
    recs, cur = [], None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.search(r"(flash_(?:fwd|dq|dkv)_wgmma_kernel)I(\w+?)Li"
                            r"(\d+)ELb([01])ELb([01])ELb([01])E", m.group(1))
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name, ty, d, *flags = cur.groups()
            recs.append((name, "bf16" if "bfloat16" in ty else "fp16", int(d),
                         *(int(f) for f in flags), int(m.group(1)), spill))
            cur = None
    return recs


def ragged_ptxas(output):
    """[(kernel, q dtype, pool, D_pad, ring, registers, spill store bytes)]
    of the ragged wgmma instances (the 16-bit kernel
    ragged_wgmma_kernel<T, P, D_pad, G>, ring "tma" or "gather", and the
    TF32 kernel ragged_tf32_kernel<D_pad, P>, always "gather"), from
    ptxas's -v lines."""
    recs, cur = [], None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            cur = None
            w = re.search(r"ragged_wgmma_kernelI(\w+?)Li(\d+)ELb([01])E",
                          name)
            t = re.search(r"ragged_tf32_kernelILi(\d+)E(\w+?)EEv", name)
            if w:
                q = "bf16" if w.group(1).startswith("13__nv_bfloat16") \
                    else "fp16"
                # the pool type: q's (a substitution S.._), int8 (a) or
                # fp8 e4m3
                pool = w.group(1)[len("13__nv_bfloat16" if q == "bf16"
                                      else "6__half"):]
                cur = ("ragged_wgmma_kernel", q,
                       "fp8" if "fp8" in pool else "int8" if pool == "a"
                       else q, int(w.group(2)),
                       "gather" if w.group(3) == "1" else "tma")
            elif t:
                pool = t.group(2)
                cur = ("ragged_tf32_kernel", "fp32",
                       "fp8" if "fp8" in pool else "int8" if pool == "a"
                       else "fp32", int(t.group(1)), "gather")
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            recs.append((*cur, int(m.group(1)), spill))
            cur = None
    return recs


def ln_fwd_ptxas(output):
    """[(dtype, words a lane, registers, spill store bytes)] of the
    LayerNorm forward's held-row instances (csrc/layer_norm.cu
    ln_fwd_held), from ptxas's -v lines."""
    recs, cur, spill = [], None, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.search(r"ln_fwd_heldI(\w+?)Li(\d+)E", m.group(1))
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ty, nw = cur.groups()
            recs.append(({"f": "fp32", "13__nv_bfloat16": "bf16"}.get(
                ty, "fp16"), int(nw), int(m.group(1)), spill))
            cur = None
    return recs


def decode_ptxas(output):
    """[(dtype, query rows a block, D_pad, registers, spill store bytes)]
    of the bulk-ring paged decode instances (paged_decode_hopper.cu), from
    ptxas's -v lines."""
    recs, cur, spill = [], None, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.search(
                r"paged_decode_hopper_kernelI(\w+?)Li(\d+)ELi(\d+)E", m.group(1))
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ty, rb, dp = cur.groups()
            recs.append(({"f": "fp32", "13__nv_bfloat16": "bf16"}.get(
                ty, "fp16"), int(rb), int(dp), int(m.group(1)), spill))
            cur = None
    return recs


def flash_phase(card):
    B, S, H, D = TRAIN["batch"], TRAIN["seq"], FULL["num_heads"], \
        FULL["hidden_size"] // FULL["num_heads"]
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        recs[tag] = check_attn(
            f"(a) {tag} B={B} S={S} H={H} D={D} causal",
            *flash_case(B, S, S, H, H, D, dtype, seed=2 * S + H), True, {},
            card=card, pairs=visible_pairs(S, S, True) * B * H)
        torch.cuda.empty_cache()
    for name, shape, causal, dtype in (
            ("(b) GQA 16/4 bf16", (2, S, S, H, 4, D), True, torch.bfloat16),
            ("(b) GQA 16/4 fp32", (2, S, S, H, 4, D), True, torch.float32),
            ("(c) rectangular causal sq 256 sk 1024 bf16",
             (2, 256, S, H, H, D), True, torch.bfloat16),
            ("(d) S=1000 bf16", (2, 1000, 1000, H, H, D), True,
             torch.bfloat16),
            ("(e) S=1000 fp32 non-causal", (2, 1000, 1000, H, H, D), False,
             torch.float32)):
        check_attn(name, *flash_case(*shape, dtype, seed=sum(shape[1:4])),
                   causal, {})
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 7: fused Adam vs plain
# ---------------------------------------------------------------------------
def flat_leaves(tree, prefix=""):
    out = []
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out += flat_leaves(v, name) if isinstance(v, dict) else [(name, v)]
    return out


def unflatten(names, values):
    tree = {}
    for name, v in zip(names, values):
        node = tree
        *head, last = name.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def flagship_shapes():
    """The flagship's leaf shapes (meta tensors: nothing allocated)."""
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    return [(n, tuple(t.shape))
            for n, t in flat_leaves(G.init_hybrid_params(cfg, 0, "meta"))]


ADAM = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=0.01)
ADAM_FLOPS_PER_ELEMENT = 17   # m1 3, m2 4, update 5, step 2, decay 3


def adam_phase(card):
    dev = torch.device(DEV)
    shapes = [(n, s) for n, s in flagship_shapes()
              if FAD.supported(torch.empty(s, device="meta"),
                               torch.empty(s, device="meta"),
                               {"moment1": torch.empty(s, device="meta"),
                                "moment2": torch.empty(s, device="meta")})]
    log(f"eligible leaves ({len(shapes)}): {shapes}")
    require(len(shapes) == 9, "the flagship has 9 leaves for the fused kernel")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)
    leaves = []
    for _, s in shapes:
        g = rnd(s, 1e-3)
        leaves.append((rnd(s, 0.02), g, {"moment1": rnd(s, 1e-3),
                                         "moment2": rnd(s, 1e-3).square()}))
    n = sum(p.numel() for p, _, _ in leaves)

    # SR off: kernel == plain to one bf16 ulp, leaf by leaf
    worst = 0.0
    for (name, _), (p, g, slot) in zip(shapes, leaves):
        kp, ks = p.clone(), {k: v.clone() for k, v in slot.items()}
        pp, ps = p.clone(), {k: v.clone() for k, v in slot.items()}
        FAD.adam_update(kp, g, ks, 1e-4, 1, None, **ADAM)
        FAD.adam_update_plain(pp, g, ps, 1e-4, 1, None, **ADAM)
        for got, ref in [(kp, pp)] + [(ks[k], ps[k]) for k in ks]:
            d = (got.float() - ref.float()).abs()
            ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs()
            require(bool((d <= ulp).all()), f"adam {name}: beyond 1 bf16 ulp")
            worst = max(worst, d.max().item())
        del kp, ks, pp, ps
    log(f"SR off: all {len(shapes)} leaves within 1 bf16 ulp of the plain "
        f"version (max_abs_err {worst:.3e})")

    # SR on: every m2 one of the two bf16 neighbours; unbiased over repeats
    p, g, slot = leaves[1]                                # wpe [1024, 2048]
    exact = {k: v.float() for k, v in slot.items()}
    FAD.adam_update_plain(p.clone(), g, exact, 1e-4, 1, None, **ADAM)
    x = exact["moment2"]
    lo = (x.view(torch.int32) & -65536).view(torch.float32)
    hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    mean = torch.zeros_like(x)
    repeats = 8
    for r in range(repeats):
        ks = {k: v.clone() for k, v in slot.items()}
        FAD.adam_update(p.clone(), g, ks, 1e-4, 1, (r, 1), **ADAM)
        m2 = ks["moment2"].float()
        require(bool(((m2 == lo) | (m2 == hi)).all()),
                "SR: a moment2 is not a bf16 neighbour of its fp32 value")
        mean += m2 / repeats
    bias = ((mean - x).mean() / (hi - lo).mean()).item()
    log(f"SR on: {x.numel()} elements x {repeats} seeds, every m2 a bf16 "
        f"neighbour; mean bias {bias:+.2e} ulp (bound 5e-3)")
    require(abs(bias) < 5e-3, f"SR biased: {bias} ulp")

    def step_kernel():
        for i, (p, g, slot) in enumerate(leaves):
            FAD.adam_update(p, g, slot, 1e-4, 1, (1, i), **ADAM)

    def step_plain():
        for p, g, slot in leaves:
            FAD.adam_update_plain(p, g, slot, 1e-4, 1, None, **ADAM)

    kern = cuda_ms(step_kernel, runs=10)
    kern_nosr = cuda_ms(lambda: [FAD.adam_update(p, g, s, 1e-4, 1, None,
                                                 **ADAM)
                                 for p, g, s in leaves], runs=10)
    plain = cuda_ms(step_plain, runs=5, warmup=1)
    params = [p for p, _, _ in leaves]
    for p, g, _ in leaves:
        p.grad = g
    lib_opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01,
                                fused=True)
    lib = cuda_ms(lib_opt.step, runs=10)
    nbytes = n * 14            # read p, g, m1, m2; write p, m1, m2 (bf16)
    flops = n * ADAM_FLOPS_PER_ELEMENT
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    bound, by = max(tb, to), "bytes" if tb >= to else "operations"
    log(f"fused adam over {len(leaves)} leaves ({n} elements, bf16): "
        f"kernel_ms {kern:.4f} (SR on; {kern_nosr:.4f} SR off) plain_ms "
        f"{plain:.4f} (SR off) library_ms {lib:.4f} "
        f"(torch.optim.AdamW(fused=True)) bound_ms {bound:.4f} ({by}: "
        f"{nbytes} B, {flops} FLOP) kernel/bound {kern / bound:.2f}x  [{card}]")
    del leaves, params, lib_opt
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=kern, ms_sr_off=kern_nosr,
                plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops, elements=n)


# ---------------------------------------------------------------------------
# phases 8-9b: training
# ---------------------------------------------------------------------------
def loss_and_grads(params, tokens, labels, cfg, **kw):
    names, leaves = zip(*flat_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = G.dense_loss(params, tokens, labels, cfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), unflatten(names, grads)


def train_step(opt, params, state, tokens, labels, cfg):
    loss, grads = loss_and_grads(params, tokens, labels, cfg)
    opt.apply(params, grads, state)
    return loss


@contextlib.contextmanager
def plain_path():
    """The plain path on the card: the composed attention (_sdpa_reference)
    in place of the flash kernels, and the fused leaves' plain Adam
    (adam_update_plain, noise drawn from the same per-leaf seed) in place
    of the Adam kernel."""
    def attention(qkv):
        return _sdpa_reference(qkv[:, :, :, 0], qkv[:, :, :, 1],
                               qkv[:, :, :, 2], is_causal=True)

    def adam(p, g, slot, lr, step, seed, **kw):
        sr = seed is not None and slot["moment2"].dtype == torch.bfloat16
        noise = FAD.sr_noise(p.shape, seed, p.device) if sr else None
        return FAD.adam_update_plain(p, g, slot, lr, step, noise, **kw)
    orig = G._attention, O.adam_update
    G._attention, O.adam_update = attention, adam
    try:
        yield
    finally:
        G._attention, O.adam_update = orig


def plain_loss_and_grads(params, tokens, labels, cfg, **kw):
    with plain_path():
        return loss_and_grads(params, tokens, labels, cfg, **kw)


def reset_training_counts():
    for fn in (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv,
               FAD.adam_update):
        fn.LAUNCHES = 0


def training_counts():
    return dict(flash_fwd=FA.flash_fwd.LAUNCHES,
                flash_bwd_dq=FA.flash_bwd_dq.LAUNCHES,
                flash_bwd_dkv=FA.flash_bwd_dkv.LAUNCHES,
                fused_adam=FAD.adam_update.LAUNCHES)


def tiny_trainer_phase():
    cfg = G.GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=64, dtype=torch.float32)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 128, (4, 64)))
    labels = torch.from_numpy(rng.randint(0, 128, (4, 64)))

    def run(dev):
        params = G.init_hybrid_params(cfg, 0, "cpu")
        params = unflatten(*zip(*[(n, t.to(dev))
                                  for n, t in flat_leaves(params)]))
        opt = AdamW(3e-3)
        state = opt.init_state(params)
        return [train_step(opt, params, state, tokens.to(dev),
                           labels.to(dev), cfg).item() for _ in range(10)]

    reset_training_counts()
    card_losses = run(DEV)
    counts = training_counts()
    cpu_losses = run("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    log(f"card: {[round(x, 6) for x in card_losses]}\ncpu:  "
        f"{[round(x, 6) for x in cpu_losses]}\nmax rel diff {rel:.2e} "
        f"(tol 1e-4: fp32 sums in another order); card launches {counts}")
    require(rel <= 1e-4, f"tiny trainer: card and CPU losses differ by {rel}")
    require(card_losses[-1] < card_losses[0], "tiny trainer: loss not falling")
    require(all(v > 0 for v in counts.values()),
            f"a training kernel did not launch: {counts}")


def _kernel_class_train(name):
    if "flash_" in name:
        return "flash"
    if "nccl" in name.lower():
        return "nccl"
    if "fused_adam" in name:
        return "adam"
    if any(w in name.lower() for w in ("nvjet", "gemm", "cutlass", "xmma")):
        return "gemm"
    return "other"


def profile_train_step(step, card, classify=None):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in device)
    ops = sum(e.count for e in device)
    by_class = {}
    for e in device:
        c = (classify or _kernel_class_train)(e.key)
        by_class[c] = by_class.get(c, 0) + e.self_device_time_total
    share = busy_us / 1e3 / (wall * 1e3)
    log(f"profiled step: wall {wall * 1e3:.1f} ms (under the profiler), "
        f"device busy {busy_us / 1e3:.1f} ms = {share:.1%} (idle "
        f"{1 - share:.1%}); {ops} device operations  [{card}]")
    log("device time by class: " + ", ".join(
        f"{c} {t / 1e3:.1f} ms ({t / busy_us:.1%})"
        for c, t in sorted(by_class.items(), key=lambda kv: -kv[1])))
    log(events.table(sort_by="self_device_time_total", row_limit=15,
                     max_name_column_width=60))
    return dict(profile_wall_ms=wall * 1e3, device_busy_share=share,
                device_ops_per_step=ops,
                device_ms_by_class={c: t / 1e3 for c, t in by_class.items()})


def flagship_batch(cfg):
    rng = np.random.RandomState(0)                      # bench.py:70-72
    shape = (TRAIN["batch"], TRAIN["seq"])
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).to(DEV)
    return tokens, labels


def compare_grads(tag, got, ref, tol_rel, stat):
    """Per-leaf gradient agreement: stat "max" is max-abs err / max-abs ref,
    "l2" is ||got - ref|| / ||ref||."""
    worst = (0.0, "")
    for (name, g), (_, r) in zip(flat_leaves(got), flat_leaves(ref)):
        g, r = g.float(), r.float()
        require(torch.isfinite(g).all(), f"{tag}: {name} grad not finite")
        if stat == "max":
            rel = ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        else:
            rel = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        worst = max(worst, (rel, name))
    log(f"{tag}: worst per-leaf grad {stat} rel err {worst[0]:.3e} "
        f"({worst[1]}; tol {tol_rel})")
    require(worst[0] <= tol_rel, f"{tag}: {worst[1]} grad rel err "
            f"{worst[0]} > {tol_rel}")
    return worst[0]


def flagship_train_phase(card):
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    params = G.init_hybrid_params(cfg, 0, DEV)
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_state(params)
    tokens, labels = flagship_batch(cfg)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [train_step(opt, params, state, tokens, labels, cfg)]   # warm
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # main path: the counts go to 0 just before and are read just after
    reset_training_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        losses.append(train_step(opt, params, state, tokens, labels, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = training_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    ms = wall * 1e3 / TRAIN_TIMED_STEPS
    tok_s = TRAIN["batch"] * TRAIN["seq"] * TRAIN_TIMED_STEPS / wall
    fpt = FL.gpt_flops_per_token(cfg, TRAIN["seq"], params=params)["model"]
    mfu = FL.mfu(tok_s, fpt, FL.peak_flops(torch.cuda.get_device_name(0)))
    log(f"warm step {warm:.2f} s; {TRAIN_TIMED_STEPS} timed steps: "
        f"{ms:.1f} ms/step, {tok_s:.1f} tokens/s, MFU {mfu:.2%} "
        f"({fpt:.4g} FLOP/token model, 989 TFLOP/s bf16 peak); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    log(f"losses (warm, then timed): {losses}")
    log(f"launches in the timed steps: {counts}; per step expected "
        f"flash_fwd {L} (default remat keeps out and lse), flash_bwd_dq {L}, "
        f"flash_bwd_dkv {L}, fused_adam 9")
    # not "every loss below the one before": Adam's first steps move every
    # weight by about lr, and at this depth and width the loss rises once
    # (third step) before it falls, on the plain path as on the kernel path;
    # phase 9b holds the trajectory to the plain path's step by step, and
    # tests/test_torch_gpt_training.py holds this step's bf16 optimizer at
    # this width (one layer) to the JAX package's
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    require(losses[-1] < losses[0] - 0.5,
            "the loss is not falling on the repeated batch")
    want = dict(flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L, fused_adam=9)
    for k, per_step in want.items():
        require(counts[k] == per_step * TRAIN_TIMED_STEPS,
                f"{k}: {counts[k]} launches in {TRAIN_TIMED_STEPS} steps, "
                f"expected {per_step} per step")
    profile = profile_train_step(
        lambda: train_step(opt, params, state, tokens, labels, cfg), card)
    del params, state, opt
    torch.cuda.empty_cache()
    return dict(tokens_per_s=tok_s, ms_per_step=ms, mfu=mfu, peak_bytes=peak,
                losses=losses, launches=counts, warm_s=warm, **profile)


def exactness_phase():
    # fp32, full width, 2 layers: kernel path vs plain path on the card
    cfg = G.GPTConfig(**dict(FULL, num_layers=2), dtype=torch.float32,
                      param_dtype=torch.float32)
    params = G.init_hybrid_params(cfg, 0, DEV)
    tokens, labels = flagship_batch(cfg)
    loss_k, g_k = loss_and_grads(params, tokens, labels, cfg)
    loss_p, g_p = plain_loss_and_grads(params, tokens, labels, cfg)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"fp32 2-layer: loss kernel {loss_k.item():.7f} plain "
        f"{loss_p.item():.7f} rel {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, f"fp32 2-layer loss rel err {rel}")
    fp32_worst = compare_grads("fp32 2-layer", g_k, g_p, 1e-3, "max")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    # bf16, full depth: the flagship's first TRAJECTORY_STEPS steps from one
    # init on the kernel path (default remat) and on the plain path (full
    # remat keeps its S^2 scores per block), each with its own AdamW: the
    # first step's loss and gradients, then every step's loss
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    pk = G.init_hybrid_params(cfg, 0, DEV)
    pp = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
              else v.clone()) for k, v in pk.items()}
    ok, op = (AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
              for _ in range(2))
    sk, sp = ok.init_state(pk), op.init_state(pp)
    traj_k, traj_p, bf16_worst = [], [], None
    for step in range(TRAJECTORY_STEPS):
        loss_k, g_k = loss_and_grads(pk, tokens, labels, cfg)
        loss_p, g_p = plain_loss_and_grads(pp, tokens, labels, cfg,
                                           remat_save=())
        if step == 0:
            rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            log(f"bf16 full depth, first step: loss kernel "
                f"{loss_k.item():.5f} plain {loss_p.item():.5f} rel "
                f"{rel:.2e} (tol 1e-3)")
            require(rel <= 1e-3, f"bf16 loss rel err {rel}")
            bf16_worst = compare_grads("bf16 full depth", g_k, g_p, 5e-2,
                                       "l2")
        ok.apply(pk, g_k, sk)
        with plain_path():
            op.apply(pp, g_p, sp)
        traj_k.append(loss_k.item())
        traj_p.append(loss_p.item())
        del g_k, g_p
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(traj_k, traj_p))
    log(f"bf16 full depth, {TRAJECTORY_STEPS} AdamW steps: kernel path "
        f"{traj_k}\n  plain path {traj_p}\n  max rel diff {traj_rel:.2e} "
        f"(tol 1e-2: bf16 rounding of two attention paths, SR noise "
        f"from two generators)")
    require(traj_rel <= 1e-2, f"bf16 trajectories differ by {traj_rel}")
    del pk, pp, sk, sp
    torch.cuda.empty_cache()
    return dict(fp32_grad_max_rel=fp32_worst, bf16_grad_l2_rel=bf16_worst,
                bf16_trajectory_kernel=traj_k, bf16_trajectory_plain=traj_p)


# ---------------------------------------------------------------------------
# phase 9c: the flagship through the dp / ZeRO engine over NCCL
# ---------------------------------------------------------------------------
DP_TIMED_STEPS = TRAIN_TIMED_STEPS
DP_LOSS_TOL = 1e-2     # relative to phase 9's dense path, step by step


def dp_zero_phase(card, train):
    """GPT-1.3B (phase 9's bf16 flagship, init, batch and AdamW with bf16
    moments and SR) through the data-parallel engine at world size 1 over
    NCCL, every collective issued: (a) ``hybrid_engine.build_train_step``
    over ``dense_loss`` at {"dp": 1}, ZeRO stage 1, a bucketed
    CommOverlapConfig over two comm microbatches; (b)
    ``gpt.build_hybrid_train_step`` at ZeRO stage 3, block i+1's gathers
    issued before block i runs. One warm and five timed steps each; the
    losses against phase 9's, the launches against phase 9's per step."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as DC
    from paddle_tpu_torch.distributed.comm_overlap import (CommOverlapConfig,
                                                           Zero3Config)
    from paddle_tpu_torch.distributed.comm_overlap import zero3 as Z3
    from paddle_tpu_torch.models import hybrid_engine as HE
    D.init_parallel_env(rank=0, world_size=1)
    require(tdist.get_backend() == "nccl",
            f"the process group runs {tdist.get_backend()}, not NCCL")
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    tokens, labels = flagship_batch(cfg)
    L = cfg.num_layers
    ref = train["losses"]
    per_step = {k: v // TRAIN_TIMED_STEPS
                for k, v in train["launches"].items()}
    out = {}
    for tag, name, micro in (("a", "stage1_bucketed", 2),
                             ("b", "stage3_gather", 1)):
        params = G.init_hybrid_params(cfg, 0, DEV)
        opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
        if name == "stage1_bucketed":
            mesh = D.build_mesh({"dp": 1})
            specs = {k: ({n: () for n in v} if isinstance(v, dict) else ())
                     for k, v in params.items()}
            step, shard, init = HE.build_train_step(
                lambda p, t, l: G.dense_loss(p, t, l, cfg), specs, mesh,
                opt, example_params=params, zero_stage=1,
                comm_overlap=CommOverlapConfig(bucket_mb=4.0,
                                               microbatches=micro),
                donate=True)
        else:
            mesh = D.build_mesh({"dp": 1, "pp": 1, "mp": 1})
            step, shard, init = G.build_hybrid_train_step(
                cfg, mesh, opt, num_microbatches=1, zero_stage=3,
                zero3=Zero3Config(overlap=True), comm_overlap=None,
                donate=True)
        p = shard(params)
        del params
        s = init(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, s, loss = step(p, s, tokens, labels, 1e-4)             # warm
        losses = [loss]
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        # main path: the counts go to 0 just before and are read just after
        reset_training_counts()
        DC.CALLS.clear()
        Z3.GATHERS.update(all_gather=0, reduce_scatter=0)
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            p, s, loss = step(p, s, tokens, labels, 1e-4)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = training_counts()
        colls = dict(DC.CALLS)
        gathers = dict(Z3.GATHERS)
        peak = torch.cuda.max_memory_allocated()
        losses = [x.item() for x in losses]
        ms = wall * 1e3 / DP_TIMED_STEPS
        tok_s = TRAIN["batch"] * TRAIN["seq"] * DP_TIMED_STEPS / wall
        n_coll = sum(colls.values()) / DP_TIMED_STEPS
        log(f"({tag}) {name}: warm step {warm:.2f} s; "
            f"{DP_TIMED_STEPS} timed steps: {ms:.1f} ms/step, "
            f"{tok_s:.1f} tokens/s; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB; NCCL collectives per step {n_coll:g} "
            f"{ {k: v / DP_TIMED_STEPS for k, v in colls.items()} }  [{card}]")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        log(f"losses {losses}\n  phase 9     {ref}\n  max rel diff "
            f"{rel:.2e} (tol {DP_LOSS_TOL}: {micro} microbatch(es) of the "
            f"batch, bf16 sums in another order)")
        log(f"launches in the timed steps: {counts}; zero3 gathers "
            f"{gathers}")
        require(all(math.isfinite(x) for x in losses),
                f"{name}: a loss is not finite")
        require(rel <= DP_LOSS_TOL,
                f"{name}: losses differ from phase 9's by {rel}")
        require(tdist.get_backend() == "nccl" and n_coll > 0,
                f"{name}: no collective went through NCCL")
        want = {k: (v * micro if k.startswith("flash") else v)
                for k, v in per_step.items()}
        for k, v in want.items():
            require(counts[k] == v * DP_TIMED_STEPS,
                    f"{name}: {k} {counts[k]} launches in "
                    f"{DP_TIMED_STEPS} steps, expected {v} per step")
        if name == "stage3_gather":
            # one group of the once-per-step leaves, and per block two
            # groups (ln1 / qkv gathered where used, the rest of block
            # i+1 ahead of block i), gathered again by the replay
            require(gathers == {"all_gather": (1 + 4 * L) * DP_TIMED_STEPS,
                                "reduce_scatter": (1 + 2 * L)
                                * DP_TIMED_STEPS},
                    f"stage 3 gathers {gathers}")
        profile = profile_train_step(
            lambda: step(p, s, tokens, labels, 1e-4), card)
        out[name] = dict(ms_per_step=ms, tokens_per_s=tok_s,
                         peak_bytes=peak, losses=losses, loss_rel_diff=rel,
                         launches=counts, launches_per_step={
                             k: v // DP_TIMED_STEPS
                             for k, v in counts.items()},
                         collectives_per_step=n_coll,
                         collectives={k: v / DP_TIMED_STEPS
                                      for k, v in colls.items()},
                         zero3_gathers=gathers, warm_s=warm,
                         microbatches=micro, card=card, **profile)
        del p, s, opt, step, shard, init
        gc.collect()
        torch.cuda.empty_cache()
    tdist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phases 9d / 9e: the offload tiers (distributed/sharding)
# ---------------------------------------------------------------------------
# offload_bench.py --size 2.85b (run_moments_offload): GPT 2.76B
OFFLOAD_2P85B = dict(vocab_size=32768, hidden_size=2560, num_layers=34,
                     num_heads=20, max_seq_len=1024)
OFFLOAD_BATCH = (4, 1024)
OFFLOAD_TIMED_STEPS = 2
STREAM_BATCH = (4, 2048)            # offload_bench.py --size 6.7b
STREAM_TIMED_STEPS = 2
STREAM_CHECK_LAYERS = 4             # 9e (b) / (c): the dense step beside it
STREAM_LOSS_TOL = 1e-2


def _fused_eligible(tree):
    """How many leaves the fused Adam's gate admits (>= 65536 elements,
    ndim >= 2): one launch each per update."""
    return sum(1 for _, t in flat_leaves(tree)
               if t.dim() >= 2 and t.numel() >= (1 << 16))


def _batch(vocab, shape, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, vocab, shape)).to(DEV)
                 for _ in range(2))


def _timed_steps(run, steps):
    """(wall seconds of ``steps`` calls, losses); the launch counts go to
    0 just before and are read just after."""
    reset_training_counts()
    t0 = time.perf_counter()
    losses = [run() for _ in range(steps)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, losses, training_counts()


def sharded_offload_phase(card, train):
    """(a) ``build_sharded_train_step(level="os", offload=True)`` at
    offload_bench's 2.85b shape (bf16, full remat, AdamW with bf16 moments):
    every slot leaf of ndim >= 1 pinned on the host; (b) level "p_g_os"
    without offload at phase 9's flagship and batch, the losses against
    phase 9's. World size 1 over NCCL; one warm and two timed steps each."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import _tree as DT
    from paddle_tpu_torch.distributed import collective as DC
    from paddle_tpu_torch.distributed import sharding as S
    D.init_parallel_env(rank=0, world_size=1)
    require(tdist.get_backend() == "nccl",
            f"the process group runs {tdist.get_backend()}, not NCCL")
    mesh = D.build_mesh({"sharding": 1})
    out = {}
    for tag, level, offload in (("a", "os", True), ("b", "p_g_os", False)):
        if offload:
            cfg = G.GPTConfig(**OFFLOAD_2P85B, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
            shape, remat = OFFLOAD_BATCH, dict(remat_save=())
            tokens, labels = _batch(cfg.vocab_size, shape)
        else:
            cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
            shape, remat = (TRAIN["batch"], TRAIN["seq"]), {}
            tokens, labels = flagship_batch(cfg)
        params = G.init_hybrid_params(cfg, 0, DEV)
        n_params = sum(t.numel() for _, t in flat_leaves(params))
        adam_per_step = _fused_eligible(params)
        opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
        _, place, compile_for = S.build_sharded_train_step(
            lambda p, t, l, cfg=cfg, remat=remat: G.dense_loss(
                p, t, l, cfg, **remat),
            opt, mesh, level=level, offload=offload)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, s = place(params)
        del params
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        step, spec = compile_for(p)
        box = {"p": p, "s": s}

        def run():
            box["p"], box["s"], loss = step(box["p"], box["s"], tokens,
                                            labels, 1e-4)
            return loss
        t0 = time.perf_counter()
        losses = [run()]                                       # warm
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        DC.CALLS.clear()
        wall, timed, counts = _timed_steps(run, OFFLOAD_TIMED_STEPS)
        losses = [x.item() for x in losses + timed]
        peak = torch.cuda.max_memory_allocated()
        s_step = wall / OFFLOAD_TIMED_STEPS
        tok_s = shape[0] * shape[1] / s_step
        L = cfg.num_layers
        slots = [t for _, t in DT.flatten(box["s"]["slots"])]
        host = [t for t in slots if t.dim() >= 1]
        pinned_bytes = sum(t.numel() * t.element_size() for t in host
                           if t.device.type == "cpu" and t.is_pinned())
        rec = dict(level=level, offload=offload, n_params=n_params,
                   batch=list(shape), s_per_step=s_step, tokens_per_s=tok_s,
                   peak_bytes=peak, place_s=place_s, warm_s=warm,
                   losses=losses, launches=counts,
                   collectives_per_step={k: v / OFFLOAD_TIMED_STEPS
                                         for k, v in DC.CALLS.items()},
                   host_pinned_bytes=pinned_bytes, card=card)
        log(f"({tag}) level {level}{' + offload' if offload else ''}, GPT "
            f"{n_params / 1e9:.3f}B bf16 (H {cfg.hidden_size}, L {L}), batch "
            f"{shape[0]} x {shape[1]}: place {place_s:.2f} s, warm "
            f"{warm:.2f} s, {s_step:.3f} s/step, {tok_s:.1f} tokens/s; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; slots pinned on "
            f"the host {pinned_bytes / 1e9:.2f} GB  [{card}]")
        log(f"losses {losses}; launches {counts}; collectives per step "
            f"{rec['collectives_per_step']}")
        require(all(math.isfinite(x) for x in losses),
                f"9d ({tag}): a loss is not finite")
        if offload:
            require(host and all(t.device.type == "cpu" and t.is_pinned()
                                 for t in host),
                    "9d (a): a slot leaf is not pinned on the host")
            rec["copies_per_step_gb"] = {
                k: v / 1e9 for k, v in step.copier.stats.items()}
            log(f"last step's copies: {rec['copies_per_step_gb']} GB")
        else:
            ref = train["losses"][:len(losses)]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            rec["loss_rel_diff"] = rel
            log(f"phase 9: {ref}; max rel diff {rel:.2e} (tol "
                f"{DP_LOSS_TOL})")
            require(rel <= DP_LOSS_TOL,
                    f"9d (b): losses differ from phase 9's by {rel}")
        want = dict(flash_fwd=(2 * L if offload else L), flash_bwd_dq=L,
                    flash_bwd_dkv=L, fused_adam=adam_per_step)
        for k, v in want.items():
            require(counts[k] == v * OFFLOAD_TIMED_STEPS,
                    f"9d ({tag}): {k} {counts[k]} launches in "
                    f"{OFFLOAD_TIMED_STEPS} steps, expected {v} per step")
        rec["launches_per_step"] = want
        out[f"{level}{'_offload' if offload else ''}"] = rec
        del p, s, box, step, opt, place, compile_for
        gc.collect()
        torch.cuda.empty_cache()
    tdist.destroy_process_group()
    return out


def _stack_segments(hp, device):
    """The stacked dense tree of a segmented host tree (9e's dense
    check)."""
    seg = {k: ({n: t.to(device) for n, t in v.items()}
               if isinstance(v, dict) else v)
           for k, v in hp.items() if k != "blocks"}
    blocks = {k: torch.stack([b[k].to(device) for b in hp["blocks"]])
              for k in hp["blocks"][0]}
    out = {**seg["embed"], **seg["head"], "blocks": blocks}
    return out


def streamed_leg(card, model, cfg, shape, steps, clip=None, dense=False,
                 trace=False):
    """One streamed run: the parameters made one segment at a time and
    parked in pinned host memory, the slots likewise, then a warm step and
    ``steps`` timed ones; with ``dense`` the same tree's on-device dense
    step (full remat, AdamW.apply) beside it."""
    from paddle_tpu_torch.distributed import _tree as DT
    from paddle_tpu_torch.distributed import sharding as S
    from paddle_tpu_torch.distributed.sharding import _host as SH
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hp = model.init_streamed_params(cfg, 0, park=S.park)
    init_s = time.perf_counter() - t0
    leaves = [t for seg in [hp["embed"], hp["head"], *hp["blocks"]]
              for _, t in DT.flatten(seg)]
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16,
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    place, init_state, step = S.build_param_streamed_train_step(
        *model.streamed_fns(cfg), opt)
    t0 = time.perf_counter()
    hs = init_state(hp)
    state_s = time.perf_counter() - t0
    segs = [hp["embed"], hp["head"], *hp["blocks"], hs["slots"]["embed"],
            hs["slots"]["head"], *hs["slots"]["blocks"]]
    pinned_bytes = sum(s.buffer.numel() for s in segs)
    tokens, labels = _batch(cfg.vocab_size, shape)
    ref = None
    if dense:
        params = _stack_segments(hp, DEV)
        dopt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16,
                     grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
        dstate = dopt.init_state(params)
        ref = []
        for _ in range(steps + 1):
            names, ls = zip(*flat_leaves(params))
            for t in ls:
                t.requires_grad_(True)
            loss = model.dense_loss(params, tokens, labels, cfg,
                                    **({"remat_save": ()} if model is G
                                       else {}))
            grads = torch.autograd.grad(loss, ls)
            for t in ls:
                t.requires_grad_(False)
            dopt.apply(params, unflatten(names, grads), dstate)
            ref.append(loss.item())
            del grads, loss
        del params, dstate, dopt
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box = {"hp": hp, "hs": hs}

    def run():
        box["hp"], box["hs"], loss = step(box["hp"], box["hs"], tokens,
                                          labels, 1e-4)
        return loss
    t0 = time.perf_counter()
    losses = [run()]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    step.copier.trace = trace
    reset_llama_counts()
    t0 = time.perf_counter()
    timed = [run() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = llama_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses + timed]
    overlap = (SH.overlap_summary(step.copier.timeline, step.copier.origin)
               if trace else {})
    stats = dict(step.copier.stats)
    host_ok = all(t.device.type == "cpu" and t.is_pinned()
                  for seg in [box["hp"]["embed"], box["hp"]["head"],
                              *box["hp"]["blocks"],
                              box["hs"]["slots"]["embed"],
                              box["hs"]["slots"]["head"],
                              *box["hs"]["slots"]["blocks"]]
                  for _, t in DT.flatten(seg))
    s_step = wall / steps
    rec = dict(n_params=sum(t.numel() for t in leaves), layers=cfg.num_layers,
               hidden=cfg.hidden_size, batch=list(shape), s_per_step=s_step,
               tokens_per_s=shape[0] * shape[1] / s_step, peak_bytes=peak,
               param_bytes=param_bytes, host_pinned_bytes=pinned_bytes,
               init_params_s=init_s, init_state_s=state_s, warm_s=warm,
               losses=losses, dense_losses=ref, launches=counts,
               h2d_gb_per_step=stats["h2d_bytes"] / 1e9,
               d2h_gb_per_step=stats["d2h_bytes"] / 1e9, overlap=overlap,
               host_pinned=host_ok, clip=clip, card=card)
    del box, hp, hs, segs, leaves, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def param_stream_phase(card):
    """(a) GPT-6.7B at full width and depth, streamed from pinned host
    memory at offload_bench's batch (4 x 2048, bf16, bf16 moments): one
    warm and two timed steps, the copies timed; the peak device memory
    below the model's bf16 parameter bytes; (b) the same width at 4 layers
    with ClipGradByGlobalNorm(1.0) and (c) Llama-2 7B's width at 4 layers,
    each against the on-device dense step from the same tree."""
    host_gb = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("MemTotal", "MemAvailable")):
                    log("  " + line.strip())
                    if line.startswith("MemAvailable"):
                        host_gb = int(line.split()[1]) / 2**20
    except OSError:
        pass
    out = {}
    cfg = G.gpt_6p7b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    a = streamed_leg(card, G, cfg, STREAM_BATCH, STREAM_TIMED_STEPS,
                     trace=True)
    L = cfg.num_layers
    log(f"(a) GPT-6.7B streamed, {a['n_params'] / 1e9:.3f}B bf16 (H 4096, L "
        f"{L}), batch {STREAM_BATCH[0]} x {STREAM_BATCH[1]}: "
        f"{a['s_per_step']:.3f} s/step, {a['tokens_per_s']:.1f} tokens/s; "
        f"max_memory_allocated {a['peak_bytes'] / 2**30:.2f} GiB against "
        f"{a['param_bytes'] / 2**30:.2f} GiB of bf16 parameters; "
        f"{a['host_pinned_bytes'] / 1e9:.2f} GB pinned on the host "
        f"(available before: {host_gb} GiB); init params {a['init_params_s']:.1f} s, "
        f"slots {a['init_state_s']:.1f} s, warm step {a['warm_s']:.1f} s  "
        f"[{card}]")
    log(f"  per step: {a['h2d_gb_per_step']:.2f} GB host->device, "
        f"{a['d2h_gb_per_step']:.2f} GB device->host; last step's spans "
        f"{a['overlap']}")
    log(f"  losses {a['losses']}; launches {a['launches']}")
    adam = 4 * L + 3
    want = dict(flash_fwd=2 * L, flash_bwd_dq=L, flash_bwd_dkv=L,
                fused_adam=adam)
    _check_stream("9e (a)", a, want, STREAM_TIMED_STEPS)
    require(a["losses"][-1] < a["losses"][0],
            f"9e (a): the loss is not falling: {a['losses']}")
    require(a["peak_bytes"] < a["param_bytes"],
            f"9e (a): peak device memory {a['peak_bytes']} is not below the "
            f"bf16 parameter bytes {a['param_bytes']}")
    out["gpt_6p7b"] = a
    cl = STREAM_CHECK_LAYERS
    b = streamed_leg(card, G, dataclasses.replace(cfg, num_layers=cl),
                     STREAM_BATCH, 2, clip=1.0, dense=True)
    _check_stream("9e (b)", b, dict(flash_fwd=3 * cl, flash_bwd_dq=2 * cl,
                                    flash_bwd_dkv=2 * cl,
                                    fused_adam=4 * cl + 3), 2)
    _check_dense("9e (b) GPT-6.7B width, 4 layers, global-norm clip 1.0", b)
    out["gpt_6p7b_4l_clip"] = b
    lcfg = dataclasses.replace(TL.llama2_7b(dtype=torch.bfloat16,
                                            param_dtype=torch.bfloat16),
                               num_layers=cl)
    c = streamed_leg(card, TL, lcfg, STREAM_BATCH, 2, dense=True)
    _check_stream("9e (c)", c, dict(flash_fwd=2 * cl, flash_bwd_dq=cl,
                                    flash_bwd_dkv=cl, fused_adam=7 * cl + 2),
                  2)
    _check_dense("9e (c) Llama-2 7B width, 4 layers", c)
    log(f"  (c) RoPE kernel launches {c['launches']['rope']} (the dense "
        f"block rotates with the composed rotate)")
    out["llama2_7b_4l"] = c
    return out


def _check_stream(tag, rec, want, steps):
    require(all(math.isfinite(x) for x in rec["losses"]),
            f"{tag}: a loss is not finite")
    require(rec["host_pinned"], f"{tag}: a host leaf is not pinned")
    for k, v in want.items():
        require(rec["launches"][k] == v * steps,
                f"{tag}: {k} {rec['launches'][k]} launches in {steps} steps, "
                f"expected {v} per step")
    rec["launches_per_step"] = want


def _check_dense(tag, rec):
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(rec["losses"], rec["dense_losses"]))
    rec["loss_rel_diff"] = rel
    log(f"{tag}: streamed {rec['losses']}\n  dense    {rec['dense_losses']}"
        f"\n  max rel diff {rel:.2e} (tol {STREAM_LOSS_TOL}); "
        f"{rec['s_per_step']:.3f} s/step, peak "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB; launches {rec['launches']}")
    require(rel <= STREAM_LOSS_TOL,
            f"{tag}: streamed and dense losses differ by {rel}")


# ---------------------------------------------------------------------------
# phase 10: paged decode kernel vs plain
# ---------------------------------------------------------------------------
# paged kernels vs plain on the worst (row, head) slab's ||got - ref|| /
# ||ref|| (slab_rel_err): phase 3's bf16 limit; fp32 summation order
PAGED_TOL = {torch.bfloat16: KERNEL_TOL, torch.float16: KERNEL_TOL,
             torch.float32: 1e-5}


def slab_rel_err(got, ref, dims):
    """The worst ||got - ref|| / ||ref|| over the slabs of the leading
    ``dims`` dimensions (0 where both slabs are zero, inf where only ref's
    is): an empty row must be exact zeros, and every live slab is held to
    its own size."""
    r = ref.float().flatten(dims)
    d = got.float().flatten(dims) - r
    dd, rr = d.square().sum(-1), r.square().sum(-1)
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, math.inf, 0.0))
    return ratio.max().item()


def decode_case(rng, lens, hq, hkv, D=128, bs=32, NB=200, nb=20,
                dtype=torch.bfloat16):
    """q [B, H_q, D] as the decode burst gives it (a strided view of the
    head-major qkv), pools, tables filling every slot (so a read past a
    row's length would pick up real pages), lengths."""
    B = len(lens)
    free = list(rng.permutation(np.arange(1, NB)))
    tables = np.array([[free.pop() for _ in range(nb)] for _ in range(B)],
                      np.int32)

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(DEV, dt)
    qkv = t(rng.randn(B, hq, 3, D).astype(np.float32))
    return dict(q=qkv[:, :, 0],
                k_pool=t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
                v_pool=t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
                block_tables=t(tables, torch.int32),
                seq_lens=t(np.asarray(lens, np.int32), torch.int32),
                scale=1.0 / math.sqrt(D))


def decode_bound(case):
    """Each byte the call needs read once (q, the K / V rows of the keys a
    row sees, seq_len of them and not the whole pages they sit in, the
    table entries of their pages, the lengths) and written once (out),
    against 4 D FLOPs per (query head, visible key) at the dtype's peak."""
    q, kp = case["q"], case["k_pool"]
    B, hq, D = q.shape
    hkv, _, bs, _ = kp.shape
    it = q.element_size()
    lens = case["seq_lens"].cpu().numpy()
    nb = case["block_tables"].shape[1]
    keys = [min(int(n), nb * bs) for n in lens]
    pages = sum(-(-k // bs) for k in keys)
    nbytes = (2 * q.numel() * it + 2 * hkv * sum(keys) * D * it
              + 4 * (pages + B))
    flops = 4 * D * hq * sum(keys)
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", nbytes, flops


def decode_yardstick(case):
    """F.scaled_dot_product_attention over the pre-gathered pages with the
    length mask: a timing yardstick only, never used by the port."""
    q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
    B, hq, D = q.shape
    hkv, _, bs, _ = kp.shape
    tables = case["block_tables"].long()
    nb = tables.shape[1]
    k = kp[:, tables].reshape(hkv, B, nb * bs, D).transpose(0, 1).contiguous()
    v = vp[:, tables].reshape(hkv, B, nb * bs, D).transpose(0, 1).contiguous()
    qt = q.contiguous()[:, :, None]                            # [B, hq, 1, D]
    col = torch.arange(nb * bs, device=q.device)
    mask = (col[None] < case["seq_lens"].long()[:, None])[:, None, None]

    def run():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask, scale=case["scale"],
            enable_gqa=hq != hkv)
    return run


def decode_plan_line(case):
    """The route that serves the case, its stages, the keys a stage carries
    and its split count (PA.kernel_plan)."""
    plan = PA.kernel_plan(case["q"], case["k_pool"], case["block_tables"],
                          case["v_pool"])
    return plan, (f"route {plan['design']}, {plan['rows']} query rows a "
                  f"block, {plan['stages']} stages of {plan['stage_keys']} "
                  f"keys, splits {plan['splits']}")


def decode_args(case):
    return (case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
            case["seq_lens"], case["scale"])


def check_decode_case(name, case, card, route=None):
    """The kernel (every route through one wrapper) against the plain
    version; ``route``, where given, the design the plan must report."""
    args = decode_args(case)
    plan, line = decode_plan_line(case)
    if route is not None:
        require(plan["design"] == route, f"{name}: route {plan['design']}, "
                f"expected {route}")
    n = PA.paged_decode_attention.ROUTES[plan["design"]]
    out_k = PA.paged_decode_attention(*args)
    torch.cuda.synchronize()
    require(PA.paged_decode_attention.ROUTES[plan["design"]] == n + 1,
            f"{name}: the {plan['design']} route did not launch")
    out_p = PA.paged_decode_attention_plain(*args)
    tol = PAGED_TOL[case["q"].dtype]
    require(out_k.dtype == out_p.dtype == case["q"].dtype, f"{name}: dtype")
    require(torch.isfinite(out_k.float()).all(), f"{name}: non-finite output")
    empty = case["seq_lens"] == 0
    require((out_k[empty] == 0).all(), f"{name}: a len-0 row is not zero")
    err = (out_k.float() - out_p.float()).abs().max().item()
    rel = slab_rel_err(out_k, out_p, 2)
    log(f"{name}: {line}; worst (row, head) L2 rel err {rel:.3e} (tol "
        f"{tol}); max_abs_err {err:.3e}")
    require(rel <= tol, f"{name}: rel err {rel} > {tol}")
    rec = dict(max_abs_err=err, rel_err=rel, design=plan["design"],
               splits=plan["splits"], stages=plan["stages"],
               stage_keys=plan["stage_keys"])
    if card is None:
        return rec
    kern = cuda_ms(lambda: PA.paged_decode_attention(*args))
    plain = cuda_ms(lambda: PA.paged_decode_attention_plain(*args))
    lib = cuda_ms(decode_yardstick(case))
    bound, bound_by, nbytes, flops = decode_bound(case)
    log(f"{name}: kernel_ms {kern:.4f} plain_ms {plain:.4f} library_ms "
        f"{lib:.4f} (SDPA over pre-gathered pages) bound_ms {bound:.4f} "
        f"({bound_by}: {nbytes} B, {flops} FLOP) kernel/bound "
        f"{kern / bound:.1f}x  [{card}]")
    rec.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
               bound_by=bound_by, bytes=nbytes, flops=flops)
    return rec


def ragged_same_batch_ms(case):
    """The ragged kernel on the same decode batch (one query a row), the
    yardstick of the paged decode kernel's redesign."""
    q = case["q"].contiguous()[:, None]
    ones = torch.ones_like(case["seq_lens"])
    args = (q, case["k_pool"], case["v_pool"], case["block_tables"], ones,
            case["seq_lens"], case["scale"])
    out = RPA.ragged_paged_attention(*args)
    ref = PA.paged_decode_attention(*decode_args(case))
    torch.cuda.synchronize()
    require(slab_rel_err(out[:, 0], ref, 2) <= PAGED_TOL[q.dtype],
            "ragged vs paged decode on the same batch")
    return cuda_ms(lambda: RPA.ragged_paged_attention(*args))


def long_rows_decode(rng, card):
    """One and two rows of 8192 keys under GQA 16/4 (4 and 8 (row, kv head)
    pairs: most SMs idle without splits), split against unsplit."""
    recs = {}
    for B in (1, 2):
        case = decode_case(rng, [8192] * B, 16, 4, nb=256, NB=B * 256 + 1)
        name = f"(e) {B} row(s) of 8192 keys, GQA 16/4 bf16"
        rec = check_decode_case(name, case, card, route="bulk-ring")
        bound = decode_bound(case)[0]
        one = cuda_ms(lambda: PA.paged_decode_attention(
            *decode_args(case), splits=1))
        log(f"{name}: unsplit {one:.4f} ms, the plan's {rec['splits']} "
            f"splits {rec['ms']:.4f} ms, bound {bound:.4f}  [{card}]")
        rec["unsplit_ms"] = one
        recs[f"rows_{B}"] = rec
    return recs


def paged_decode_phase(card):
    rng = np.random.RandomState(10)
    lens = [100, 173, 256, 311, 400, 467, 555, 640]   # phase 3's case (a)
    case_a = decode_case(rng, lens, 16, 16)
    rec = check_decode_case("(a) decode B=8 H=16 D=128 bs=32 bf16", case_a,
                            card, route="bulk-ring")
    rec["ragged_same_batch_ms"] = ragged_same_batch_ms(case_a)
    log(f"(a) bf16: {rec['ms']:.4f} ms, beside the first design's 0.1169 "
        f"and the ragged kernel's 0.0237 (PERF.md), SDPA "
        f"{rec['library_ms']:.4f}, the ragged kernel on the same batch "
        f"{rec['ragged_same_batch_ms']:.4f} and the bound "
        f"{rec['bound_ms']:.4f}  [{card}]")
    rec["fp16"] = check_decode_case("(a) fp16", decode_case(
        rng, lens, 16, 16, dtype=torch.float16), card, route="bulk-ring")
    rec["fp32"] = check_decode_case("(a) fp32", decode_case(
        rng, lens, 16, 16, dtype=torch.float32), card, route="bulk-ring")
    log(f"(a) fp32 on the ring: {rec['fp32']['ms']:.4f} ms beside bf16 "
        f"{rec['ms']:.4f} and fp16 {rec['fp16']['ms']:.4f}, the fp32-tiles "
        f"kernel's 0.2490 (PERF.md), SDPA {rec['fp32']['library_ms']:.4f}, "
        f"the bound {rec['fp32']['bound_ms']:.4f}  [{card}]")
    rec["long_rows"] = long_rows_decode(rng, card)
    odd = [0, 45, 64, 1, 300, 129]     # empty, mid-page, page-aligned, 1
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        check_decode_case(f"(b) GQA 16/4 {tag}", decode_case(
            rng, odd, 16, 4, dtype=dtype), None)
        check_decode_case(f"(c) bs 16 D 64, table of 24 slots {tag}",
                          decode_case(rng, odd, 8, 8, D=64, bs=16, nb=24,
                                      dtype=dtype), None)
        check_decode_case(f"(d) MQA 16/1 {tag}", decode_case(
            rng, odd, 16, 1, dtype=dtype), None)
        check_decode_case(f"(f) MQA 32/1 {tag}", decode_case(
            rng, odd, 32, 1, dtype=dtype), None)
        check_decode_case(f"(g) D 256, GQA 8/2, bs 16 {tag}", decode_case(
            rng, odd, 8, 2, D=256, bs=16, dtype=dtype), None)
    # fp32 pages the ring carries in parts: 16 of a page's 32 keys at D
    # 256, 32 of 64 at D 128 under g 16; every split count of one case
    for name, kw in (("(i) fp32 D 256 bs 32, GQA 8/2, parts of 16 keys",
                      dict(hq=8, hkv=2, D=256, bs=32)),
                     ("(j) fp32 D 128 bs 64, GQA 16/1, parts of 32 keys",
                      dict(hq=16, hkv=1, D=128, bs=64, nb=12))):
        case = decode_case(rng, odd, dtype=torch.float32, **kw)
        part = check_decode_case(name, case, None, route="bulk-ring")
        require(part["stage_keys"] < kw["bs"], f"{name}: whole pages")
        ref = PA.paged_decode_attention_plain(*decode_args(case))
        worst = max(slab_rel_err(PA.paged_decode_attention(
            *decode_args(case), splits=n), ref, 2) for n in range(1, 17))
        log(f"{name}: splits 1-16 forced, worst (row, head) L2 rel err "
            f"{worst:.3e}")
        require(worst <= PAGED_TOL[torch.float32], f"{name}: a forced split "
                f"count is off by {worst}")
    # off the ring: a head dim that is not whole 16-byte words
    check_decode_case("(h) D 100 bf16", decode_case(rng, odd, 8, 4, D=100),
                      None, route="fp32-tiles")
    check_decode_case("(h) D 102 fp32", decode_case(
        rng, odd, 8, 4, D=102, dtype=torch.float32), None, route="fp32-tiles")
    return rec


# ---------------------------------------------------------------------------
# phase 11: flash forward with a bias vs plain
# ---------------------------------------------------------------------------
PREFILL = dict(P=8, C=128, H=16, D=128, bs=32, nb=20)   # cap 640


def prefill_case(dtype, seed, hkv=None):
    """The two-program prefill's attention call: q a strided view of the
    head-major qkv [P, C, H, 3, D], k and v the _gather_seqs views of one
    layer's pools through each slot's table, and the causal keep-mask over
    each slot's positions (chunks at different depths of their prompts)."""
    P, C, H, D, bs, nb = (PREFILL[k] for k in ("P", "C", "H", "D", "bs",
                                               "nb"))
    hkv = hkv or H
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    qkv = rnd(P, C, H, 3, D)
    pools = [rnd(hkv, P * nb + 1, bs, D) for _ in range(2)]
    tables = torch.arange(1, P * nb + 1, dtype=torch.int32,
                          device=DEV).reshape(P, nb)
    k, v = (_gather_seqs(pl, tables, bs) for pl in pools)
    pos0 = torch.tensor([0, 128, 256, 384, 0, 128, 384, 512], device=DEV)
    pos = pos0[:P, None] + torch.arange(C, device=DEV)
    mask = torch.arange(nb * bs, device=DEV)[None, None] <= pos[:, :, None]
    return qkv[:, :, :, 0], k, v, mask[:, None]              # [P, 1, C, cap]


def flash_bias_bound(q, k, bias, mask):
    """Each input read once (q, k, v, the bias as stored), out and lse
    written once, against 4 D FLOPs per visible (query, key) pair, the
    pairs this mask leaves (the kernel computes every pair: the mask is
    arbitrary)."""
    B, Sq, H, D = q.shape
    it = q.element_size()
    nbytes = ((2 * q.numel() + 2 * k.numel()) * it
              + bias.untyped_storage().nbytes() + 4 * B * H * Sq)
    flops = 4 * D * int(mask.expand(B, H, -1, -1).sum().item())
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", nbytes, flops


def check_bias_case(name, q, k, v, bias, card, mask=None, dead=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = FA.flash_fwd(q, k, v, False, scale, bias)
    torch.cuda.synchronize()
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, False, scale, bias)
    tol = FLASH_TOL[q.dtype][0]
    live = lse_p > -1e29
    require(torch.equal(live, lse > -1e29), f"{name}: dead rows differ")
    if dead is not None:
        require(bool((out[:, dead] == 0).all()) and not live[:, :, dead].any(),
                f"{name}: the masked row is not dead")
    require(torch.isfinite(out.float()).all(), f"{name}: out not finite")
    tile = tile_rel_err(out, out_p)
    err, lrel = _rel_err(lse[live], lse_p[live])
    log(f"{name}: worst tile L2 rel err {tile:.3e} (tol {tol}); max_abs_err "
        f"{(out.float() - out_p.float()).abs().max().item():.3e}; lse rel "
        f"{lrel:.2e} (tol 1e-5)")
    require(tile <= tol, f"{name}: tile L2 rel err {tile} > {tol}")
    require(lrel <= 1e-5, f"{name}: lse rel err {lrel} > 1e-5")
    rec = dict(max_abs_err=(out.float() - out_p.float()).abs().max().item(),
               tile_rel_err=tile)
    if card is None:
        return rec
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = cuda_ms(lambda: FA.flash_fwd(q, k, v, False, scale, bias))
    plain = cuda_ms(lambda: FA.flash_fwd_plain(q, k, v, False, scale, bias),
                    runs=10)
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                               enable_gqa=q.shape[2] != k.shape[2]))
    bound, by, nbytes, flops = flash_bias_bound(q, k, bias, mask)
    log(f"{name}: kernel_ms {kern:.4f} plain_ms {plain:.4f} library_ms "
        f"{lib:.4f} (SDPA, bool attn_mask) bound_ms {bound:.4f} ({by}: "
        f"{nbytes} B, {flops} FLOP) kernel/bound {kern / bound:.1f}x  "
        f"[{card}]")
    rec.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
               bound_by=by, bytes=nbytes, flops=flops)
    return rec


def flash_bias_phase(card):
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, mask = prefill_case(dtype, seed=11)
        bias = torch.where(mask, 0.0, -1e30).to(dtype)
        recs[tag] = check_bias_case(
            f"(a) prefill P=8 C=128 cap=640 H=16 D=128 {tag}", q, k, v, bias,
            card if dtype == torch.bfloat16 else None, mask=mask)
        # the registry op with the bool mask: the same kernel, one launch
        n = FA.flash_fwd.LAUNCHES
        out = scaled_dot_product_attention(q, k, v, attn_mask=mask)
        require(FA.flash_fwd.LAUNCHES == n + 1, "sdpa did not launch once")
        out_p, _ = FA.flash_fwd_plain(q, k, v, False, q.shape[-1] ** -0.5,
                                      bias)
        tile = tile_rel_err(out, out_p)
        log(f"(b) scaled_dot_product_attention(bool mask) {tag}: worst tile "
            f"L2 rel err {tile:.3e}")
        require(tile <= FLASH_TOL[dtype][0], f"sdpa bool mask {tag}: {tile}")
        # broadcast shapes of a float bias with a dead row, and GQA 16/4
        gen = torch.Generator(device=DEV)
        gen.manual_seed(12)
        P, C, H = q.shape[:3]
        cap = k.shape[1]
        for mb, mh in ((1, 1), (P, 1), (1, H), (P, H)):
            fb = torch.randn(mb, mh, C, cap, generator=gen, device=DEV) * 2
            fb[..., 7, :] = -1e30
            fb[..., ::5] = -1e30
            check_bias_case(f"(c) float bias [{mb},{mh},{C},{cap}] {tag}", q,
                            k, v, fb.to(dtype), None, dead=7)
        q4, k4, v4, mask4 = prefill_case(dtype, seed=13, hkv=4)
        check_bias_case(f"(d) GQA 16/4 {tag}", q4, k4, v4,
                        torch.where(mask4, 0.0, -1e30).to(dtype), None)
        torch.cuda.empty_cache()
    return recs["bf16"]


# ---------------------------------------------------------------------------
# phase 12: the ragged kernel over quantized pools vs plain
# ---------------------------------------------------------------------------
def fill_quantized(case, pool_dtype, rng):
    """Replace a ragged case's float pools by pools of ``pool_dtype`` that
    the port's append fills on the card, as the engine would: each row's
    history, then its chunk (whose pages are requantized). The same appends
    on the CPU must write the same bits."""
    hkv, NB, bs, D = case["k_pool"].shape
    R = case["q"].shape[0]
    ql = case["q_lens"].cpu().numpy()
    kl = case["kv_lens"].cpu().numpy()
    hist = np.maximum(kl - ql, 0).astype(np.int32)
    C = max(int(kl.max()), 1)
    # two appends: the history (columns 0 .. hist) then the chunk (columns
    # hist .. kv_len, moved to the front)
    chunk_cols = np.minimum(hist[:, None] + np.arange(C)[None], C - 1)
    appends = [(np.zeros(R, np.int32), hist, np.arange(C)[None].repeat(R, 0)),
               (hist, (kl - hist).astype(np.int32), chunk_cols)]
    vals = [rng.randn(R, C, hkv, D).astype(np.float32) for _ in range(2)]
    filled = {}
    for dev in (DEV, "cpu"):
        tables = case["block_tables"].to(dev)
        for name, val in zip("kv", vals):
            pool = torch.zeros((hkv, NB, bs, D), dtype=pool_dtype, device=dev)
            scales = torch.zeros((hkv, NB), device=dev)
            for pos0, n, cols in appends:
                chunk = torch.from_numpy(val[np.arange(R)[:, None], cols])
                KV.append_tokens_quantized(
                    pool, scales, chunk.to(dev),
                    torch.from_numpy(pos0).to(dev),
                    torch.from_numpy(n).to(dev), tables, bs)
            filled[dev, name] = (pool, scales)
    for name in "kv":
        for got, want, what in zip(filled[DEV, name], filled["cpu", name],
                                   ("pool", "scales")):
            got = got.cpu()
            same = (torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                    if got.element_size() == 1 else torch.equal(got, want))
            require(same, f"{pool_dtype} append: the card's {name} {what} "
                    "differ from the CPU's")
    case.update(k_pool=filled[DEV, "k"][0], k_scales=filled[DEV, "k"][1],
                v_pool=filled[DEV, "v"][0], v_scales=filled[DEV, "v"][1])


def check_quantized_case(name, case, card):
    """The ragged kernel over a case's int8 / fp8 pools against its plain
    version (16-bit q: the worst slab's L2 within KERNEL_TOL, the
    dequantized tile being rounded to 16 bits for the tensor cores; fp32 q:
    max-abs within 1e-5 of the reference's max-abs, the fp32 gate); with
    ``card``, timed against the plain version, SDPA over pages dequantized
    to q's dtype and the bound."""
    args = (case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
            case["q_lens"], case["kv_lens"], case["scale"], case["k_scales"],
            case["v_scales"])
    plan, line = ragged_plan_line(case)
    log(f"{name}: {line}")
    out_k = counted_ragged(name, plan, args)
    out_p = RPA.ragged_paged_attention_plain(*args)
    require(torch.isfinite(out_k.float()).all(), f"{name}: non-finite output")
    for r, l in enumerate(case["q_lens"].cpu().numpy()):
        require((out_k[r, int(l):] == 0).all(),
                f"{name}: row {r} columns >= {l} not zero")
    err = (out_k.float() - out_p.float()).abs().max().item()
    if case["q"].dtype == torch.float32:
        tol = 1e-5
        rel = err / max(out_p.float().abs().max().item(), 1e-9)
        log(f"{name}: max_abs_err {err:.3e}, rel to max-abs ref {rel:.3e} "
            f"(tol {tol})")
    else:
        tol = KERNEL_TOL
        rel = slab_rel_err(out_k, out_p, 3)
        log(f"{name}: worst (row, column, head) L2 rel err {rel:.3e} (tol "
            f"{tol}); max_abs_err {err:.3e}")
    require(rel <= tol, f"{name}: rel err {rel} > {tol}")
    rec = dict(max_abs_err=err, rel_err=rel, design=plan["design"],
               splits=plan["splits"])
    if card is None:
        return rec
    kern = cuda_ms(lambda: RPA.ragged_paged_attention(*args))
    plain = cuda_ms(lambda: RPA.ragged_paged_attention_plain(*args))
    # the library call gets the pages dequantized to q's dtype (bf16, or
    # fp32 for fp32 queries) ahead of time
    deq = dict(case)
    for p, sc in (("k_pool", "k_scales"), ("v_pool", "v_scales")):
        deq[p] = (case[p].float() * (case[sc] / KV._qmax(case[p].dtype))[
            :, :, None, None]).to(case["q"].dtype)
    lib = cuda_ms(sdpa_yardstick(deq))
    bound, bound_by, nbytes, flops = case_bound(case)
    log(f"{name}: kernel_ms {kern:.4f} plain_ms {plain:.4f} library_ms "
        f"{lib:.4f} (SDPA over pre-gathered pages dequantized to "
        f"{str(case['q'].dtype)[6:]}) "
        f"bound_ms {bound:.4f} ({bound_by}: {nbytes} B, {flops} FLOP) "
        f"kernel/bound {kern / bound:.1f}x  [{card}]")
    rec.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
               bound_by=bound_by, bytes=nbytes, flops=flops)
    return rec


def quantized_phase(card):
    recs = {}
    for pool_dtype, tag in ((torch.int8, "int8"),
                            (torch.float8_e4m3fn, "fp8")):
        rng = np.random.RandomState(12)
        dec = make_case(rng, [1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                       640], C=1, hq=16, hkv=16)
        mixed = make_case(rng, [128, 100, 1, 0], [384, 100, 517, 0], C=128,
                          hq=16, hkv=16)
        fill_quantized(dec, pool_dtype, rng)
        fill_quantized(mixed, pool_dtype, rng)
        log(f"{tag}: the card's append wrote the CPU append's pools and "
            f"scales, bit for bit (decode and mixed cases)")
        recs[tag] = check_quantized_case(f"(a) {tag} decode R=8", dec, card)
        recs[tag + "_mixed"] = check_quantized_case(
            f"(b) {tag} mixed R=4 C=128", mixed, card)
        # the decode batch at D 256 (the wgmma kernel at D_pad 256), with
        # fp32 queries (the TF32 kernel, held at 1e-5), with fp32 queries at
        # D 256 (the TF32 kernel's 16-key tiles, held at 1e-5), and with
        # fp32 queries at D 200 (rows not whole 16-byte words: the CUDA-core
        # kernel's wide 1-byte instance, held at 1e-5, untimed)
        lens = [100, 173, 256, 311, 400, 467, 555, 640]
        d256 = make_case(rng, [1] * 8, lens, C=1, hq=16, hkv=16, D=256)
        q32 = make_case(rng, [1] * 8, lens, C=1, hq=16, hkv=16,
                        dtype=torch.float32)
        q32_d256 = make_case(rng, [1] * 8, lens, C=1, hq=16, hkv=16, D=256,
                             dtype=torch.float32)
        q32_d200 = make_case(rng, [1] * 8, lens, C=1, hq=16, hkv=16, D=200,
                             dtype=torch.float32)
        for c in (d256, q32, q32_d256, q32_d200):
            fill_quantized(c, pool_dtype, rng)
        recs[tag + "_d256"] = check_quantized_case(
            f"(a) {tag} decode R=8 D=256", d256, card)
        recs[tag + "_fp32_q"] = check_quantized_case(
            f"(a) {tag} decode R=8 fp32 q", q32, card)
        recs[tag + "_fp32_q_d256"] = check_quantized_case(
            f"(a) {tag} decode R=8 fp32 q D=256", q32_d256, card)
        recs[tag + "_fp32_q_d200"] = check_quantized_case(
            f"(a) {tag} decode R=8 fp32 q D=200", q32_d200, None)
        require(recs[tag + "_d256"]["design"] == "wgmma+tma"
                and recs[tag + "_fp32_q"]["design"] == "wgmma-3xtf32"
                and recs[tag + "_fp32_q_d256"]["design"] == "wgmma-3xtf32"
                and recs[tag + "_fp32_q_d200"]["design"] == "fp32",
                f"{tag}: D 256 on {recs[tag + '_d256']['design']}, fp32 q "
                f"on {recs[tag + '_fp32_q']['design']}, fp32 q at D 256 on "
                f"{recs[tag + '_fp32_q_d256']['design']}, fp32 q at D 200 on "
                f"{recs[tag + '_fp32_q_d200']['design']}")
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 13-14: the two-program engine and the quantized pools at full width
# ---------------------------------------------------------------------------
def reset_serving_counts():
    for fn in (RPA.ragged_paged_attention, PA.paged_decode_attention,
               FA.flash_fwd):
        fn.LAUNCHES = 0
    for route in RPA.ragged_paged_attention.ROUTES:
        RPA.ragged_paged_attention.ROUTES[route] = 0


def serving_counts():
    return dict(ragged_paged_attention=RPA.ragged_paged_attention.LAUNCHES,
                paged_decode_attention=PA.paged_decode_attention.LAUNCHES,
                flash_fwd=FA.flash_fwd.LAUNCHES,
                ragged_routes={r: n for r, n in
                               RPA.ragged_paged_attention.ROUTES.items() if n})


def count_prefills(engine):
    """Wrap the engine's prefill program to count its dispatches."""
    calls = [0]
    inner = engine._prefill

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)
    engine._prefill = counted
    return calls


def timed_wave(engine, prompts, news, card, tag):
    """A timed wave with the launch counts set to 0 just before and read
    just after; returns (outputs, record)."""
    steps0, disp0 = engine.engine_steps, engine.dispatches
    micro0 = engine.decode_microsteps
    torch.cuda.reset_peak_memory_stats()
    reset_serving_counts()
    outs, ttft, wall = serve(engine, prompts, news)
    counts = serving_counts()
    steps = engine.engine_steps - steps0
    disp = engine.dispatches - disp0
    micro = engine.decode_microsteps - micro0
    gen = sum(len(o) for o in outs)
    ttft_ms = sorted(t * 1e3 for t in ttft)
    p50 = ttft_ms[math.ceil(0.5 * len(ttft_ms)) - 1]
    p95 = ttft_ms[math.ceil(0.95 * len(ttft_ms)) - 1]
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} timed wave: {gen} tokens in {wall:.3f} s = {gen / wall:.1f} "
        f"generated tokens/s; TTFT p50 {p50:.1f} ms p95 {p95:.1f} ms; engine "
        f"steps {steps}; dispatches/step {disp / steps:.3f}; forward passes "
        f"{micro}; max_memory_allocated {peak / 2**30:.2f} GiB; launches "
        f"{counts}  [{card}]")
    for o, n in zip(outs, news):
        require(0 < len(o) <= n and all(0 <= t < FULL["vocab_size"]
                                        for t in o),
                f"{tag}: an output is empty, too long or out of the "
                "vocabulary")
    return outs, dict(tokens_per_s=gen / wall, ttft_p50_ms=p50,
                      ttft_p95_ms=p95, engine_steps=steps,
                      dispatches_per_step=disp / steps, passes=micro,
                      peak_bytes=peak, launches=counts)


def two_program_phase(card, ragged_fp32_outs):
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    params = G.init_hybrid_params(cfg, 0, DEV)
    engine = ServingEngine(params, cfg, seed=0, device=DEV,
                           **{**FULL_ENGINE, "ragged": False})
    require(engine.adaptive_burst, "adaptive_burst 'auto' did not resolve "
            "to True on the card")
    prefills = count_prefills(engine)
    prompts, news = full_width_workload()
    log(f"warm wave {serve(engine, prompts, news)[2]:.2f} s")
    # main path: the counts go to 0 just before and are read just after
    n0 = prefills[0]
    outs, rec = timed_wave(engine, prompts, news, card, "two-program bf16")
    pre = prefills[0] - n0
    L = cfg.num_layers
    launches = rec["launches"]
    log(f"paged_decode_attention LAUNCHES {launches['paged_decode_attention']}"
        f" == {L} x decode_microsteps {rec['passes']}; flash_fwd (bias) "
        f"LAUNCHES {launches['flash_fwd']} == {L} x prefill dispatches {pre}")
    require(launches["paged_decode_attention"] == L * rec["passes"] > 0,
            "a layer of a decode micro-step did not go through the kernel")
    require(launches["flash_fwd"] == L * pre > 0,
            "a layer of a prefill dispatch did not go through the kernel")
    require(launches["ragged_paged_attention"] == 0,
            "the two-program engine launched the ragged kernel")
    require(rec["dispatches_per_step"] <= 2.0, "more than 2 dispatches/step")
    n1 = prefills[0]
    rec.update(prefill_dispatches=pre,
               profile=profile_wave(engine, prompts, card, gather=True))
    # the device share of the per-layer _gather_seqs copies (K and V of
    # every slot, 2 L per prefill dispatch): one copy timed at the engine's
    # shape, cold L2, against the profiled wave's device busy time
    mb, bs = FULL_ENGINE["max_batch"], FULL_ENGINE["block_size"]
    nb = FULL_ENGINE["max_blocks_per_seq"]
    tables = torch.arange(1, 1 + mb * nb, dtype=torch.int32,
                          device=DEV).reshape(mb, nb)
    t_gather = cuda_ms(lambda: _gather_seqs(engine.k_pools[0], tables, bs))
    gathers = 2 * L * (prefills[0] - n1)
    busy = sum(rec["profile"]["device_ms_by_class"].values())
    moved = 2 * engine.k_pools[0][:, :mb * nb].nbytes
    log(f"_gather_seqs: {t_gather:.4f} ms per copy ({moved / 1e6:.1f} MB "
        f"read and written) x {gathers} copies in the profiled wave = "
        f"{gathers * t_gather:.1f} ms = {gathers * t_gather / busy:.1%} of "
        f"its device busy time  [{card}]")
    rec.update(gather_seqs_ms=t_gather,
               gather_seqs_share=gathers * t_gather / busy)
    t0 = time.perf_counter()
    top1, top5, first, n, margins = teacher_forced(params, cfg, prompts, outs,
                                                   5)
    log(f"({time.perf_counter() - t0:.1f} s) two-program bf16 teacher-forced: top-5 containment {top5}/{n} = "
        f"{top5 / n:.2%}, top-1 agreement {top1}/{n} = {top1 / n:.2%}; logit "
        f"margins where top-1 differs: {[round(m, 3) for m in margins]}")
    require(top5 >= 0.99 * n, "two-program bf16 top-5 containment below 99 %")
    rec.update(top5=top5 / n, top1=top1 / n)
    del engine, params
    torch.cuda.empty_cache()
    # the fp32 copy: phase 5b's checks, then the ragged engine's tokens;
    # every decode launch of its wave on the bulk ring (the counts go to 0
    # just before and are read just after)
    PA.paged_decode_attention.LAUNCHES = 0
    for route in PA.paged_decode_attention.ROUTES:
        PA.paged_decode_attention.ROUTES[route] = 0
    FA.flash_fwd.LAUNCHES = 0
    fp32 = {}
    outs32 = full_width_fp32_phase(stats=fp32, ragged=False)
    fp32.update(launches=PA.paged_decode_attention.LAUNCHES,
                routes=dict(PA.paged_decode_attention.ROUTES),
                flash_fwd_launches=FA.flash_fwd.LAUNCHES,
                flash_fwd_design=FA.kernel_plan(
                    "flash_fwd", cfg.hidden_size // cfg.num_heads,
                    torch.float32, bias=True)["design"])
    log(f"fp32 two-program {outs32}\nfp32 ragged      {ragged_fp32_outs}")
    log(f"fp32 two-program wave: {fp32['tokens_per_s']:.1f} generated "
        f"tokens/s (4 requests of 16 tokens, the engine's first wave), "
        f"paged_decode_attention LAUNCHES {fp32['launches']}, by route "
        f"{fp32['routes']}; flash_fwd (bias, prefill) LAUNCHES "
        f"{fp32['flash_fwd_launches']} [{fp32['flash_fwd_design']}]  "
        f"[{card}]")
    require(fp32["flash_fwd_launches"] > 0
            and fp32["flash_fwd_design"] == "wgmma-3xtf32",
            f"fp32 prefill off the TF32 forward: {fp32['flash_fwd_launches']}"
            f" launches, design {fp32['flash_fwd_design']}")
    require(outs32 == ragged_fp32_outs, "fp32: the two-program engine's "
            "greedy tokens differ from the ragged engine's")
    require(fp32["launches"] > 0 and
            fp32["routes"]["bulk-ring"] == fp32["launches"],
            f"fp32 two-program decode launches off the bulk ring: "
            f"{fp32['routes']}")
    rec["fp32"] = fp32
    return rec


def quantized_engine_phase(card):
    cfg = G.GPTConfig(**FULL, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    params = G.init_hybrid_params(cfg, 0, DEV)
    prompts, news = full_width_workload()
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
    bs, nblocks = FULL_ENGINE["block_size"], FULL_ENGINE["num_blocks"]
    budget = 2 * L * H * nblocks * bs * D * 2           # phase 5's bf16 pools
    recs = {}
    for kind, gate in (("int8", 0.95), ("fp8_e4m3", 0.90)):
        dtype, _ = KV.kv_cache_dtype(kind)
        blocks = KV.kv_pool_blocks_for_budget(budget, L, H, bs, D, dtype)
        log(f"{kind}: {blocks} blocks in phase 5's bf16 pool budget of "
            f"{budget} B ({nblocks} bf16 blocks): {blocks / nblocks:.3f}x")
        # no warm wave: phases 5 and 13 ran every kernel and GEMM shape of
        # this engine, and phase 12 the quantized append's operations
        engine = ServingEngine(params, cfg, seed=0, device=DEV,
                               kv_cache_dtype=kind, **FULL_ENGINE)
        outs, rec = timed_wave(engine, prompts, news, card, kind)
        require(rec["launches"]["ragged_paged_attention"]
                == L * rec["passes"] > 0,
                f"{kind}: a layer of a pass did not go through the kernel")
        if kind == "int8":
            rec["profile"] = profile_wave(engine, prompts, card, gather=True,
                                          n=2, tokens=8)
        del engine
        fresh = ServingEngine(params, cfg, seed=0, device=DEV,
                              kv_cache_dtype=kind, **FULL_ENGINE)
        again, _, wall = serve(fresh, prompts, news)
        del fresh
        log(f"{kind}: a fresh engine's wave {wall:.2f} s")
        require(outs == again, f"{kind}: a fresh engine's outputs differ")
        t0 = time.perf_counter()
        top1, top5, first, n, margins = teacher_forced(params, cfg, prompts,
                                                       outs, 5)
        log(f"({time.perf_counter() - t0:.1f} s) {kind} teacher-forced vs the dense bf16 forward: top-5 "
            f"containment {top5}/{n} = {top5 / n:.2%} (gate {gate:.0%}), "
            f"top-1 {top1}/{n} = {top1 / n:.2%}, first tokens top-1 "
            f"{first}/{len(outs)}")
        require(top5 >= gate * n, f"{kind}: top-5 containment below the gate")
        rec.update(top5=top5 / n, top1=top1 / n, blocks_for_budget=blocks,
                   budget_bytes=budget)
        recs[kind] = rec
        torch.cuda.empty_cache()
    # the gathered ring on the serving path: pages of 12 keys, phase 5's
    # pool bytes (534 x 12 = 6408 keys a head) and sequence reach (54 x 12
    # = 648 keys), every ragged launch on "wgmma+gather"
    kw = {**FULL_ENGINE, "block_size": 12, "num_blocks": 534,
          "max_blocks_per_seq": 54}
    recs["bf16_bs12"] = route_wave(params, cfg, prompts, news, card,
                                   "bf16 pages of 12", "wgmma+gather", 0.99,
                                   **kw)
    del params
    torch.cuda.empty_cache()
    # fp32 queries over int8 pools on the TF32 kernel: an fp32 model with
    # kv_cache_dtype="int8", held against the dense fp32 forward
    cfg32 = G.GPTConfig(**FULL, dtype=torch.float32,
                        param_dtype=torch.float32)
    params = G.init_hybrid_params(cfg32, 0, DEV)
    recs["fp32_int8"] = route_wave(params, cfg32, prompts, news, card,
                                   "fp32 over int8 pools", "wgmma-3xtf32",
                                   0.95, kv_cache_dtype="int8", **FULL_ENGINE)
    del params
    torch.cuda.empty_cache()
    return recs


def route_wave(params, cfg, prompts, news, card, tag, design, gate, **kw):
    """One warm and one timed wave of a ragged engine built with ``kw``:
    every ragged launch of the timed wave (the counts set to 0 just before
    and read just after) on ``design``, L per forward pass; tokens held by
    teacher-forced top-5 containment >= ``gate`` against the dense forward
    of the model's dtype."""
    engine = ServingEngine(params, cfg, seed=0, device=DEV, **kw)
    serve(engine, prompts, news)                       # warm wave
    outs, rec = timed_wave(engine, prompts, news, card, tag)
    del engine
    L, launches = cfg.num_layers, rec["launches"]
    log(f"{tag}: ragged_paged_attention LAUNCHES "
        f"{launches['ragged_paged_attention']} == {L} x passes "
        f"{rec['passes']}, by route {launches['ragged_routes']}")
    require(launches["ragged_paged_attention"] == L * rec["passes"] > 0
            and launches["ragged_routes"] == {
                design: launches["ragged_paged_attention"]},
            f"{tag}: a ragged launch of a pass off {design}: "
            f"{launches['ragged_routes']}")
    t0 = time.perf_counter()
    top1, top5, first, n, margins = teacher_forced(params, cfg, prompts,
                                                   outs, 5)
    log(f"({time.perf_counter() - t0:.1f} s) {tag} teacher-forced vs the "
        f"dense {str(cfg.dtype)[6:]} forward: top-5 containment {top5}/{n} "
        f"= {top5 / n:.2%} (gate {gate:.0%}), top-1 {top1}/{n} = "
        f"{top1 / n:.2%}, first tokens top-1 {first}/{len(outs)}")
    require(top5 >= gate * n, f"{tag}: top-5 containment below the gate")
    rec.update(top5=top5 / n, top1=top1 / n, design=design)
    return rec


# ---------------------------------------------------------------------------
# phases 15-18b: BERT-base packed pretraining
# ---------------------------------------------------------------------------
BERT_SEQ = 512
BERT_SEQS = (16, 128)         # _bert_job's corpus, then 8x its sequences
BERT_TIMED_STEPS = 5
BERT_TRAJECTORY_STEPS = 4     # phase 18b: kernel path vs plain path
# LayerNorm kernel vs plain: max-abs err / max-abs ref; fp32 sums in another
# order, bf16 one rounding of the output (an fp32 difference flips one ulp)
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# per element; the backward's dx ~10, its dw and db sums 3
LN_FLOPS = {"layer_norm_fwd": 8, "layer_norm_bwd": 13}
# the key projection's bias has an exactly-zero gradient (one constant added
# to every score of a softmax row): both paths return rounding noise there
ZERO_GRAD = "self_attn.k_proj.bias"


def bert_batch(n_seqs, vocab):
    """``benchmarks/configs_bench.py`` ``_bert_job`` / ``bench_bert_packed``:
    RandomState(0) lengths in U[S/8, S], random tokens, first-fit packing,
    15 % MLM labels on real tokens, NSP labels. Returns numpy arrays and the
    lengths."""
    S = BERT_SEQ
    rng = np.random.RandomState(0)
    lens = rng.randint(S // 8, S + 1, (n_seqs,))
    seqs = [rng.randint(0, vocab, (n,)) for n in lens]
    ids, seg, pos, _, _ = TB.pack_sequences(seqs, S)
    rows = ids.shape[0]
    mlm = np.where((rng.rand(rows, S) < 0.15) & (seg >= 0),
                   rng.randint(0, vocab, (rows, S)), -100)
    nsp = rng.randint(0, 2, (rows,))
    return dict(ids=ids, seg=seg, pos=pos, mlm=mlm, nsp=nsp, lens=lens)


def seg_pairs(seg):
    """Visible (same-segment) query-key pairs of packed rows, pads with
    pads included, per head."""
    return int(sum((np.unique(r, return_counts=True)[1].astype(np.int64)
                    ** 2).sum() for r in seg))


# -- phase 15 ---------------------------------------------------------------
def ln_bounds(rows, H, dtype, bias):
    """The forward reads x, w (and b) and writes y, mean and rstd; the
    backward reads x, dy, w, mean and rstd and writes dx, dw (and db)."""
    it = torch.tensor([], dtype=dtype).element_size()
    n_affine = 2 if bias else 1
    work = {"layer_norm_fwd": (2 * rows * H * it + n_affine * H * 4
                               + 8 * rows),
            "layer_norm_bwd": (3 * rows * H * it + (1 + n_affine) * H * 4
                               + 8 * rows)}
    out = {}
    for name, nbytes in work.items():
        flops = LN_FLOPS[name] * rows * H
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations",
                     nbytes, flops)
    return out


def ln_held(H, dtype):
    """The LayerNorm forward's held row (csrc/layer_norm.cu fwd_plan): whole
    16-byte words, at most 8 a lane."""
    n = 16 // torch.tensor([], dtype=dtype).element_size()
    return H % n == 0 and H // n <= 32 * 8


def ln_fwd_sweep(card, rows_bert):
    """The LayerNorm forward at BERT's rows [rows_bert, 768] and at [8192,
    2048] (the primitives' flagship call) in bf16, fp16 and fp32, with a
    bias: its route and grid, held to the plain version, timed against its
    bound, the plain version and F.layer_norm (weight and bias in x's
    dtype)."""
    F_ = torch.nn.functional
    recs = {}
    for rows, H in ((rows_bert, 768), (8192, 2048)):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            tag = f"{rows}x{H}_{str(dtype)[6:]}"
            gen = torch.Generator(device=DEV)
            gen.manual_seed(rows + H)
            x = (torch.randn(rows, H, generator=gen, device=DEV) * 3
                 + 1).to(dtype)
            w = torch.randn(H, generator=gen, device=DEV)
            b = torch.randn(H, generator=gen, device=DEV)
            plan = LN.fwd_plan(x, w, b)
            require(plan["path"] == ("held" if ln_held(H, dtype) else "walk"),
                    f"LayerNorm forward {tag} on {plan['path']}")
            y, _, _ = LN.layer_norm_fwd(x, w, b, 1e-12)
            y_p, _, _ = LN.layer_norm_fwd_plain(x, w, b, 1e-12)
            err, rel = _rel_err(y, y_p)
            require(rel <= LN_TOL[dtype], f"LayerNorm forward {tag}: rel err "
                    f"{rel}")
            wl, bl = w.to(dtype), b.to(dtype)
            kern = cuda_ms(lambda: LN.layer_norm_fwd(x, w, b, 1e-12))
            plain = cuda_ms(lambda: LN.layer_norm_fwd_plain(x, w, b, 1e-12))
            lib = cuda_ms(lambda: F_.layer_norm(x, (H,), wl, bl, 1e-12))
            bound, by, nbytes, flops = ln_bounds(rows, H, dtype,
                                                 True)["layer_norm_fwd"]
            log(f"LayerNorm forward {tag}: route {plan['path']}, "
                f"{plan['blocks']} blocks; max_abs_err {err:.3e} rel "
                f"{rel:.3e}; kernel_ms {kern:.4f} plain_ms {plain:.4f} "
                f"library_ms {lib:.4f} (F.layer_norm) bound_ms {bound:.4f} "
                f"({by}) kernel/bound {kern / bound:.2f}x  [{card}]")
            recs[tag] = dict(max_abs_err=err, ms=kern, plain_ms=plain,
                             library_ms=lib, bound_ms=bound, bound_by=by,
                             path=plan["path"], blocks=plan["blocks"])
            del x, y, y_p
    torch.cuda.empty_cache()
    return recs


def check_ln_case(name, rows, H, dtype, eps, bias, card=None):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(rows + H)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=DEV) * scale + shift
    x = rnd(rows, H, scale=3.0, shift=1.0).to(dtype)
    w = rnd(H)
    b = rnd(H) if bias else None
    dy = rnd(rows, H).to(dtype)
    y, mean, rstd = LN.layer_norm_fwd(x, w, b, eps)
    dx, dw, db = LN.layer_norm_bwd(x, w, mean, rstd, dy, need_db=bias)
    again = LN.layer_norm_bwd(x, w, mean, rstd, dy, need_db=bias)
    # the dx-only kernel a frozen weight with no trainable bias takes
    dx_o, dw_o, db_o = LN.layer_norm_bwd(x, w, mean, rstd, dy, need_dw=False,
                                         need_db=False)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    br = b.clone().requires_grad_(True) if bias else None
    yk = LN.layer_norm(xr, wr, br, eps)
    gk = torch.autograd.grad(yk, [t for t in (xr, wr, br) if t is not None],
                             dy, retain_graph=True)
    torch.cuda.synchronize()
    require(all((u is None and v is None) or torch.equal(u, v)
                for u, v in zip((dx, dw, db), again)),
            f"{name}: two backward calls differ in their bits")
    plan = LN.bwd_plan(x, w, dy, need_db=bias)
    fplan = LN.fwd_plan(x, w, b)
    require(fplan["path"] == ("held" if ln_held(H, dtype) else "walk"),
            f"{name}: the forward on {fplan['path']}")
    y_p, mean_p, rstd_p = LN.layer_norm_fwd_plain(x, w, b, eps)
    dx_p, _, _ = LN.layer_norm_bwd_plain(x, w, mean_p, rstd_p, dy, bias)
    # dw and db are fp32 sums of the same products on both sides (the
    # kernel's statistics given to both): only the order of the sums differs
    _, dw_p, db_p = LN.layer_norm_bwd_plain(x, w, mean, rstd, dy, bias,
                                            need_dx=False)
    tol, sum_tol = LN_TOL[dtype], LN_TOL[torch.float32]
    rec = {}
    pairs = [("y", y, y_p, tol), ("dx", dx, dx_p, tol),
             ("dw", dw, dw_p, sum_tol), ("dx_only", dx_o, dx_p, tol),
             ("dx_autograd", gk[0], dx_p, tol),
             ("dw_autograd", gk[1], dw_p, sum_tol)] + (
        [("db", db, db_p, sum_tol), ("db_autograd", gk[2], db_p, sum_tol)]
        if bias else [])
    require(bias or db is None, f"{name}: a bias-less call returned db")
    require(dw_o is None and db_o is None,
            f"{name}: the dx-only call returned a sum")
    for what, got, ref, t in pairs:
        require(got.dtype == ref.dtype and got.shape == ref.shape,
                f"{name} {what}: {got.dtype} {tuple(got.shape)} vs "
                f"{ref.dtype} {tuple(ref.shape)}")
        require(torch.isfinite(got.float()).all(), f"{name} {what} not finite")
        err, rel = _rel_err(got, ref)
        require(rel <= t, f"{name} {what}: rel err {rel} > {t}")
        rec[what] = err
    srel = max(((mean - mean_p).abs().max() / mean_p.abs().max().clamp_min(
        1.0)).item(), ((rstd - rstd_p).abs() / rstd_p).max().item())
    require(srel <= 1e-5, f"{name} mean / rstd rel err {srel}")
    log(f"{name}: max_abs_err y {rec['y']:.3e} dx {rec['dx']:.3e} dw "
        f"{rec['dw']:.3e}" + (f" db {rec['db']:.3e}" if bias else "")
        + f", dx-only kernel dx {rec['dx_only']:.3e}, stats rel {srel:.2e} "
        f"(tol {tol}, dw / db {sum_tol}); forward route {fplan['path']}, "
        f"{fplan['blocks']} blocks; backward route {plan['path']}, "
        f"{plan['blocks']} blocks; dx, dw, db bit for bit across two calls")
    if card is None:
        return None
    bounds = ln_bounds(rows, H, dtype, bias)
    F_ = torch.nn.functional
    wl = w.to(dtype)
    bl = b.to(dtype) if bias else None
    xl = x.clone().requires_grad_(True)
    wlr = wl.clone().requires_grad_(True)
    blr = bl.clone().requires_grad_(True) if bias else None
    yl = F_.layer_norm(xl, (H,), wlr, blr, eps)
    lib_in = [t for t in (xl, wlr, blr) if t is not None]
    k_in = [t for t in (xr, wr, br) if t is not None]
    times = {
        "layer_norm_fwd": (
            cuda_ms(lambda: LN.layer_norm_fwd(x, w, b, eps)),
            cuda_ms(lambda: LN.layer_norm_fwd_plain(x, w, b, eps)),
            cuda_ms(lambda: F_.layer_norm(x, (H,), wl, bl, eps))),
        "layer_norm_bwd": (
            cuda_ms(lambda: LN.layer_norm_bwd(x, w, mean, rstd, dy,
                                              need_db=bias)),
            cuda_ms(lambda: LN.layer_norm_bwd_plain(x, w, mean, rstd, dy,
                                                    bias)),
            cuda_ms(lambda: torch.autograd.grad(yl, lib_in, dy,
                                                retain_graph=True))),
    }
    # the backward as the model runs it (the autograd Function: the one
    # launch and the casts), and the dx-only kernel a frozen weight takes
    full_bwd = cuda_ms(lambda: torch.autograd.grad(yk, k_in, dy,
                                                   retain_graph=True))
    dx_only = cuda_ms(lambda: LN.layer_norm_bwd(x, w, mean, rstd, dy,
                                                need_dw=False, need_db=False))
    # a warm call's host time (the wrapper's checks, the cached plan and the
    # launch), beside the library call's
    torch.cuda.synchronize()
    host = host_overhead_ms(lambda: LN.layer_norm_bwd(x, w, mean, rstd, dy,
                                                      need_db=bias))
    host_lib = host_overhead_ms(lambda: torch.autograd.grad(
        yl, lib_in, dy, retain_graph=True))
    torch.cuda.synchronize()
    errs = {"layer_norm_fwd": rec["y"],
            "layer_norm_bwd": max(rec["dx"], rec["dw"], rec.get("db", 0.0))}
    recs = {}
    for kname, (kern, plain, lib) in times.items():
        bound, by, nbytes, flops = bounds[kname]
        log(f"{name} {kname}: kernel_ms {kern:.4f} plain_ms {plain:.4f} "
            f"library_ms {lib:.4f} bound_ms {bound:.4f} ({by}: {nbytes} B, "
            f"{flops} FLOP) kernel/bound {kern / bound:.1f}x  [{card}]")
        recs[kname] = dict(max_abs_err=errs[kname], ms=kern, plain_ms=plain,
                           library_ms=lib, bound_ms=bound, bound_by=by,
                           bytes=nbytes, flops=flops)
    recs["layer_norm_fwd"].update(path=fplan["path"], blocks=fplan["blocks"])
    recs["layer_norm_bwd"].update(
        ms_autograd=full_bwd, dx_only_ms=dx_only, path=plan["path"],
        blocks=plan["blocks"], host_ms=host, library_host_ms=host_lib,
        dw_db_max_abs_err=max(rec["dw"], rec.get("db", 0.0)))
    log(f"{name}: the backward (dx, dw" + (", db" if bias else "")
        + f" in one launch) {times['layer_norm_bwd'][0]:.4f} ms; the plain "
        f"and library times cover the same outputs; through the autograd "
        f"Function {full_bwd:.4f}; the dx-only kernel {dx_only:.4f}; a warm "
        f"call's host time {host:.4f} ms (autograd of F.layer_norm "
        f"{host_lib:.4f})  [{card}]")
    return recs


def ln_phase(card, rows_128):
    H = TB.BertConfig().hidden_size
    rows_16 = bert_batch(BERT_SEQS[0], 8)["ids"].shape[0] * BERT_SEQ
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for rows in (rows_16, 37, 1):
            for eps, bias in ((1e-12, True), (1e-5, False), (1e-12, False)):
                timed = (card if rows == rows_16 and eps == 1e-12 and bias
                         else None)
                rec = check_ln_case(
                    f"({tag}) rows {rows} x {H}, eps {eps:g}, "
                    f"{'bias' if bias else 'no bias'}", rows, H, dtype, eps,
                    bias, timed)
                if rec is not None:
                    recs[tag] = rec
    recs["rows_128"] = check_ln_case(
        f"(bf16) rows {rows_128} x {H} (128 sequences), eps 1e-12, bias",
        rows_128, H, torch.bfloat16, 1e-12, True, card)
    check_ln_case(f"(bf16) rows {rows_128} x {H} (128 sequences), eps "
                  f"1e-12, no bias", rows_128, H, torch.bfloat16, 1e-12, False)
    for rows, h in ((13, 100), (37, 100)):
        check_ln_case(f"(bf16) rows {rows} x {h} (no 16-byte words)", rows, h,
                      torch.bfloat16, 1e-5, True)
    check_ln_case("(bf16) rows 3 x 28680 (the column-tiled partial)", 3,
                  28680, torch.bfloat16, 1e-5, True)
    check_ln_case("(fp32) rows 37 x 4100 (the column-tiled partial)", 37,
                  4100, torch.float32, 1e-5, False)
    # the forward's held-row edges: 16-bit H 2048 held, 2056 walked; fp32
    # H 1024 held, 1028 walked; rows no multiple of the grid's warps
    for rows, h, dt in ((37, 2048, torch.bfloat16), (13, 2056, torch.bfloat16),
                        (37, 1024, torch.float32), (13, 1028, torch.float32)):
        check_ln_case(f"({str(dt)[6:]}) rows {rows} x {h} (the forward's "
                      f"held-row edge)", rows, h, dt, 1e-5, True)
    recs["fwd_sweep"] = ln_fwd_sweep(card, rows_16)
    torch.cuda.empty_cache()
    return recs


# -- phase 16 ---------------------------------------------------------------
def philox_bits_check():
    """q = k = 0 makes every probability 1 / S, and v = I reads the dropped
    row out of the forward; dO = I makes the dK/dV kernel's dV the dropped
    probabilities transposed. Both must equal the plain mask bit for bit."""
    B, S, H, p, seed = 2, 64, 3, 0.1, 2 ** 40 + 12345
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(B, S, H, S, device=DEV, dtype=dtype)
        eye = torch.eye(S, device=DEV, dtype=dtype)[None, :, None, :].expand(
            B, S, H, S).contiguous()
        out, lse = FA.flash_fwd(z, z, eye, False, 1.0, dropout_p=p, seed=seed)
        _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                                 False, 1.0, dropout_p=p, seed=seed)
        keep = FA.dropout_keep_mask(seed, B, H, S, S, p, DEV)
        fwd_ok = torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
        dkv_ok = torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)
        log(f"Philox masks ({dtype}): forward kernel == plain {fwd_ok}, "
            f"dK/dV kernel == plain {dkv_ok}; keep rate "
            f"{keep.float().mean().item():.4f} (1 - p = {1 - p})")
        require(fwd_ok and dkv_ok, "the CUDA and torch Philox masks differ")


def keep_bits_across_tiles_check():
    """The 16-bit forward's and dQ's keep bits past their first key tile
    (the checks above span one tile of the forward's 128 keys): Sk = 320
    keys, q = k = 0 so every probability is 1 / Sk. The forward reads D
    keys a call through v one-hot on keys [w, w + D), bit for bit. dQ: with
    dO . v = 1 for every pair dP is the keep bit over (1 - p), so its
    d-bias p (dP - delta) is positive exactly where a key was kept, and
    delta is the row's kept count over Sk (1 - p). At D 128 and 256 (the
    tiles of 128, 64 and 32 keys), with a zero bias and without."""
    B, Sq, Sk, H, p, seed = 2, 192, 320, 2, 0.3, 2 ** 40 + 4242
    dt = torch.bfloat16
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, DEV)
    want = keep.float().sum(-1) / (Sk * (1 - p))
    for D in (128, 256):
        zq = torch.zeros(B, Sq, H, D, device=DEV, dtype=dt)
        zk = torch.zeros(B, Sk, H, D, device=DEV, dtype=dt)
        ones = zk.clone()
        ones[..., 0] = 1
        do = zq.clone()
        do[..., 0] = 1
        for bias in (None, torch.zeros(1, 1, Sq, Sk, device=DEV, dtype=dt)):
            var = dict(bias=bias, dropout_p=p, seed=seed)
            fwd_ok = True
            for w in range(0, Sk, D):
                n = min(D, Sk - w)
                v = zk.clone()
                idx = torch.arange(n, device=DEV)
                v[:, w + idx, :, idx] = 1
                out, lse = FA.flash_fwd(zq, zk, v, False, 1.0, **var)
                fwd_ok &= torch.equal(
                    out[..., :n].permute(0, 2, 1, 3) > 0, keep[..., w:w + n])
            got = FA.flash_bwd_dq(zq, zk, ones, lse, do, False, 1.0,
                                  bias_grad=bias is not None, **var)
            delta_err = ((got[1] - want).abs() / want).max().item()
            dq_ok = delta_err <= 1e-5 and (
                bias is None or torch.equal(got[2] > 0, keep))
            log(f"Philox masks over {Sk} keys, D {D}, "
                f"{'a zero bias' if bias is not None else 'no bias'}: "
                f"forward kernel == plain {fwd_ok}, dQ kernel "
                f"{'d-bias == plain ' if bias is not None else ''}"
                f"{dq_ok} (delta rel err {delta_err:.2e})")
            require(fwd_ok and dq_ok, "past the first key tile, the CUDA and "
                    "torch Philox masks differ")


def flash_variant_phase(card):
    cfg = TB.BertConfig()
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    batch = bert_batch(BERT_SEQS[0], cfg.vocab_size)
    seg_np = batch["seg"]
    B, S = seg_np.shape
    seg = torch.from_numpy(seg_np).to(DEV)
    pairs = seg_pairs(seg_np)
    log(f"packed rows [{B}, {S}]: {int((seg_np >= 0).sum())} real tokens, "
        f"{pairs} visible pairs per head ({pairs / (B * S * S):.1%} of "
        f"B S^2)")
    philox_bits_check()
    keep_bits_across_tiles_check()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(16)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                                   device=DEV).to(dtype) for _ in range(4))
        for p in (0.1, 0.0):
            timed = card if dtype == torch.bfloat16 else None
            rec = check_attn(
                f"({tag}) packed [{B}, {S}, {H}, {D}] segments, dropout {p}",
                q, k, v, do, False, dict(q_seg=seg, kv_seg=seg, dropout_p=p,
                                         seed=1234 + int(p * 10)),
                card=timed, pairs=pairs * H)
            recs[f"{tag}_p{p}"] = rec
        del q, k, v, do
        torch.cuda.empty_cache()
    # untimed: a dead row, GQA, causal with segments
    S2 = 512
    seg2 = torch.from_numpy(np.stack([
        np.r_[np.zeros(300), np.full(212, 5)], np.zeros(S2)]).astype(
            np.int32)).to(DEV)
    kseg2 = seg2.clone()
    kseg2[0, 300:] = 4                 # query id 5 matches no key
    q, k, v, do = (torch.randn(2, S2, H, D, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = FA.flash_fwd(q, k, v, False, scale, q_seg=seg2, kv_seg=kseg2,
                            dropout_p=0.1, seed=5)
    dq, dk, dv = FA.flash_bwd(q, k, v, lse, do, False, scale,
                              q_seg=seg2, kv_seg=kseg2, dropout_p=0.1, seed=5)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, lse, do, False,
                                          scale, q_seg=seg2, kv_seg=kseg2,
                                          dropout_p=0.1, seed=5)
    dead_ok = (bool((out[0, 300:] == 0).all()) and bool((dq[0, 300:] == 0)
                                                        .all())
               and bool((lse[0, :, 300:] == -1e30).all()))
    tiles = [tile_rel_err(a, b) for a, b in ((dk, dk_p), (dv, dv_p))]
    log(f"(bf16) dead rows (query id 5 matches no key): zeros, lse -1e30 and "
        f"no dq: {dead_ok}; dk / dv worst tile {tiles[0]:.3e} / "
        f"{tiles[1]:.3e}")
    require(dead_ok and max(tiles) <= FLASH_TOL[torch.bfloat16][1],
            "dead rows with segments")
    gseg = torch.from_numpy(np.stack([seg_np[0], seg_np[1]])).to(DEV)
    qg, kg, vg, dog = (torch.randn(2, S2, H, D, generator=gen,
                                   device=DEV).to(torch.bfloat16)
                       for _ in range(4))
    kg, vg = kg[:, :, :4].contiguous(), vg[:, :, :4].contiguous()
    check_attn("(bf16) GQA 12/4, segments, dropout 0.1", qg, kg, vg, dog,
               False, dict(q_seg=gseg, kv_seg=gseg, dropout_p=0.1, seed=77))
    check_attn("(bf16) causal, segments, dropout 0.1", qg, qg, qg, dog, True,
               dict(q_seg=gseg, kv_seg=gseg, dropout_p=0.1, seed=78))
    del q, k, v, do, qg, kg, vg, dog
    recs["converged_keys"] = converged_keys_check(seg, gen)
    torch.cuda.empty_cache()
    return recs


def converged_keys_check(seg, gen, spread=0.03, p=0.1, seed=9):
    """The packed shape with keys and values that nearly coincide (a common
    vector per head plus ``spread`` noise), as the token states of the
    random-init BERT do in its deep layers: there the true dq is tiny beside
    |dO| |O|. The kernels' dq, dk and dv (bf16, segments, dropout) against
    fp64 autograd through the composed attention on the same inputs, the
    same segment mask and the kernels' own dropout mask: l2 rel err, limit
    1e-2, as tests/test_torch_flash_attention.py holds the plain version
    on a small case of this kind."""
    B, S = seg.shape
    H, D = 12, 64
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=DEV,  # noqa
                                  dtype=torch.float64)
    q, do = rnd(B, S, H, D), rnd(B, S, H, D)
    k = rnd(1, 1, H, D) + spread * rnd(B, S, H, D)
    v = rnd(1, 1, H, D) + spread * rnd(B, S, H, D)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    var = dict(q_seg=seg, kv_seg=seg, dropout_p=p, seed=seed)
    lse = FA.flash_fwd(q, k, v, False, scale, **var)[1]
    got = FA.flash_bwd(q, k, v, lse, do, False, scale, **var)
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    same = (seg[:, None, :, None] == seg[:, None, None, :])
    prob = torch.softmax(sc.masked_fill(~same, float("-inf")), -1)
    keep = FA.dropout_keep_mask(seed, B, H, S, S, p, DEV)
    prob = torch.where(keep, prob / (1.0 - p), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, vd)
    ref = torch.autograd.grad(o, (qd, kd, vd), do.double())
    errs = {n: ((g.double() - r).norm() / r.norm()).item()
            for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    log(f"(bf16) converged keys (spread {spread}), segments, dropout {p}: "
        f"kernel vs fp64 l2 rel err "
        f"{', '.join(f'{n} {e:.3e}' for n, e in errs.items())} (tol 1e-2)")
    require(max(errs.values()) <= 1e-2, f"converged keys: {errs}")
    return errs


# -- phases 17-18b ----------------------------------------------------------
def bert_model(cfg, device=DEV, dtype=torch.bfloat16):
    """The model built on the host from seed 0, and its trainable state on
    ``device`` with the >= 2-D parameters in ``dtype`` (``_bert_job``'s
    cast), the 1-D ones fp32."""
    with TR.rng_guard(torch.Generator().manual_seed(0)):
        model = TB.BertForPretraining(cfg)
    params, _, buffers = TNN.functional_train_graph(model, device=device)
    params = {k: v.to(dtype) if v.dim() >= 2 else v
              for k, v in params.items()}
    return model, params, buffers


def bert_tensors(batch, device):
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in ("ids", "seg", "pos", "mlm", "nsp")}


def bert_layout(t):
    """The batch's layout as BertModel takes it: the padded rows' 4-D mask,
    or the packed rows' segment ids and positions."""
    if "mask" in t:
        return dict(attention_mask=t["mask"])
    return dict(pack_segment_ids=t["seg"], position_ids=t["pos"])


def bert_loss_and_grads(model, params, buffers, t):
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    (lm, ns), _ = TNN.functional_call(model, params, buffers, t["ids"],
                                      **bert_layout(t))
    loss = TB.bert_pretrain_loss(lm, ns, t["mlm"], t["nsp"])
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    for p in params.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def bert_step(model, params, buffers, opt, state, t):
    loss, grads = bert_loss_and_grads(model, params, buffers, t)
    opt.apply(params, grads, state)
    return loss


@contextlib.contextmanager
def layer_plain_path():
    """The plain path of the eager layer models on the card: the LayerNorm
    and RMSNorm kernels' plain versions (autograd through their fp32
    arithmetic), the composed attention (_sdpa_reference) and the fused
    leaves' plain Adam."""
    def layer_norm(x, weight, bias, epsilon):
        H = x.shape[-1]
        return LN.layer_norm_fwd_plain(x.reshape(-1, H), weight, bias,
                                       epsilon)[0].reshape(x.shape)

    def rms_norm(x, weight, epsilon):
        H = x.shape[-1]
        return RN.rms_norm_fwd_plain(x.reshape(-1, H), weight,
                                     epsilon)[0].reshape(x.shape)

    def sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
             training=True, name=None, segment_ids=None, generator=None):
        return _sdpa_reference(q, k, v, attn_mask, dropout_p, is_causal,
                               training=training, segment_ids=segment_ids,
                               generator=generator)

    def adam(p, g, slot, lr, step, seed, **kw):
        sr = seed is not None and slot["moment2"].dtype == torch.bfloat16
        noise = FAD.sr_noise(p.shape, seed, p.device) if sr else None
        return FAD.adam_update_plain(p, g, slot, lr, step, noise, **kw)
    orig = (TFN._layer_norm_kernel, TFN._rms_norm_kernel,
            TF.scaled_dot_product_attention, O.adam_update)
    (TFN._layer_norm_kernel, TFN._rms_norm_kernel,
     TF.scaled_dot_product_attention, O.adam_update) = (layer_norm, rms_norm,
                                                        sdpa, adam)
    try:
        yield
    finally:
        (TFN._layer_norm_kernel, TFN._rms_norm_kernel,
         TF.scaled_dot_product_attention, O.adam_update) = orig


def reset_bert_counts():
    for fn in (LN.layer_norm_fwd, LN.layer_norm_bwd, FA.flash_fwd,
               FA.flash_bwd_dq, FA.flash_bwd_dkv, FAD.adam_update):
        fn.LAUNCHES = 0
    for route in LN.layer_norm_bwd.ROUTES:
        LN.layer_norm_bwd.ROUTES[route] = 0


def bert_counts():
    """The kernels' launches; ``layer_norm_bwd_sums`` counts the LayerNorm
    backwards that formed dw and db inside their launch (held or tiled):
    every one of them, so no composed sum ran."""
    routes = LN.layer_norm_bwd.ROUTES
    return dict(layer_norm_fwd=LN.layer_norm_fwd.LAUNCHES,
                layer_norm_bwd=LN.layer_norm_bwd.LAUNCHES,
                layer_norm_bwd_sums=routes["held"] + routes["tiled"],
                flash_fwd=FA.flash_fwd.LAUNCHES,
                flash_bwd_dq=FA.flash_bwd_dq.LAUNCHES,
                flash_bwd_dkv=FA.flash_bwd_dkv.LAUNCHES,
                fused_adam=FAD.adam_update.LAUNCHES)


def compare_bert_grads(tag, got, ref, tol_rel, stat, zero_tol, skip=()):
    """compare_grads over a BERT name -> gradient dict, with the key bias
    (exactly zero in exact arithmetic) held below ``zero_tol`` of the
    largest gradient on both paths; the leaves in ``skip`` are held
    elsewhere."""
    gmax = max(r.float().abs().max().item() for r in ref.values())
    zero = {n for n in ref if n.endswith(ZERO_GRAD)}
    for n in sorted(zero):
        small = max(got[n].float().abs().max().item(),
                    ref[n].float().abs().max().item())
        require(small <= zero_tol * gmax, f"{tag}: {n} = {small}, not ~0")
    log(f"{tag}: the {len(zero)} key-projection biases (zero gradient) are "
        f"below {zero_tol:g} of the largest gradient ({gmax:.3e}) on both "
        f"paths")
    rest = zero | set(skip)
    return compare_grads(tag, {n: g for n, g in got.items() if n not in rest},
                         {n: r for n, r in ref.items() if n not in rest},
                         tol_rel, stat)


def qk_witness_check(g_k, g_p, g32, floor=5e-2, slack=1.25):
    """The query / key projection gradients of the bf16 kernel path and the
    bf16 plain path, each against the fp32 witness (the kernel path in
    fp32 on the same weights and batch): the tokens' states converge with
    depth, so these gradients shrink by three orders of magnitude by the
    last layer and bf16 rounding anywhere upstream shows in them. Each
    kernel-path leaf is held to max(slack x the plain path's error, floor):
    no further from fp32 than the plain path, up to noise, and within the
    5e-2 that every other leaf is held to where both are small. Returns
    {name: (witness norm, kernel err, plain err)}."""
    qk = sorted(n for n in g32 if ".self_attn.q_proj." in n
                or n.endswith("self_attn.k_proj.weight"))
    rows = {}
    for n in qk:
        w = g32[n].float()
        wn = w.norm().item()
        rows[n] = (wn, (g_k[n].float() - w).norm().item() / wn,
                   (g_p[n].float() - w).norm().item() / wn)
    log("bf16 full depth, query / key projection grads against the fp32 "
        "witness (l2 rel err):\n  leaf  witness norm  kernel path  plain "
        "path")
    for n, (wn, ek, ep) in rows.items():
        if n.endswith("q_proj.weight") or n.endswith("k_proj.weight"):
            log(f"  {n[len('bert.encoder.'):]}  {wn:.3e}  {ek:.3e}  "
                f"{ep:.3e}")
    bad = [(n, ek, ep) for n, (_, ek, ep) in rows.items()
           if ek > max(slack * ep, floor)]
    require(not bad, f"bf16 q / k grads further from fp32 than "
            f"max({slack} x the plain path's, {floor}): {bad}")
    return {n: list(r) for n, r in rows.items()}


def tiny_bert_phase():
    cfg = TB.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout=0.0)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(1, 512, (n,)) for n in (90, 30, 128, 60, 20, 100)]
    ids, seg, pos, _, _ = TB.pack_sequences(seqs, 128)
    mlm = np.where((rng.rand(*ids.shape) < 0.2) & (seg >= 0),
                   rng.randint(0, 512, ids.shape), -100)
    batch = dict(ids=ids, seg=seg, pos=pos, mlm=mlm,
                 nsp=rng.randint(0, 2, (ids.shape[0],)))

    def run(dev):
        model, params, buffers = bert_model(cfg, dev, torch.float32)
        init = {k: v.clone() for k, v in params.items()}
        opt = AdamW(1e-3)
        state = opt.init_state(params)
        t = bert_tensors(batch, dev)
        losses = [bert_step(model, params, buffers, opt, state, t).item()
                  for _ in range(3)]
        return losses, {k: v.cpu() for k, v in params.items()}, init

    reset_bert_counts()
    card_losses, card_params, init = run(DEV)
    counts = bert_counts()
    cpu_losses, cpu_params, _ = run("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    worst, moved = 0.0, 0.0
    for n, p in cpu_params.items():
        if n.endswith(ZERO_GRAD):     # Adam steps rounding noise by ~lr
            moved = max(moved, (card_params[n] - init[n].cpu()).abs().max()
                        .item())
            continue
        worst = max(worst, (card_params[n] - p).abs().max().item())
    log(f"card: {card_losses}\ncpu:  {cpu_losses}\nmax loss rel diff "
        f"{rel:.2e} (tol 1e-5); parameters after 3 steps max_abs_err "
        f"{worst:.2e} (tol 1e-4); key biases moved {moved:.2e} (bound 4.5e-3 "
        f"= 3 steps x 1.5 lr); card launches {counts}")
    require(rel <= 1e-5, f"tiny BERT: card and CPU losses differ by {rel}")
    require(worst <= 1e-4, f"tiny BERT: parameters differ by {worst}")
    require(moved <= 4.5e-3, f"tiny BERT: a key bias moved {moved}")
    require(all(v > 0 for v in counts.values()),
            f"a BERT kernel did not launch: {counts}")


def _kernel_class_bert(name):
    if "ln_fwd" in name or "ln_bwd" in name:
        return "layernorm"
    return _kernel_class_train(name)


def bert_train_cell(card, n_seqs, model, params, buffers, opt, state, cfg):
    batch = bert_batch(n_seqs, cfg.vocab_size)
    t = bert_tensors(batch, DEV)
    lens = batch["lens"]
    rows = batch["ids"].shape[0]
    t_real = int(lens.sum())
    emb = (cfg.vocab_size + cfg.max_position_embeddings
           + cfg.type_vocab_size) * cfg.hidden_size
    n_matmul = sum(p.numel() for p in params.values()) - emb
    flops = (6.0 * n_matmul * t_real + 12.0 * cfg.num_layers
             * cfg.hidden_size * float((lens.astype(np.int64) ** 2).sum()))
    log(f"{n_seqs} sequences, {t_real} real tokens, packed into {rows} rows "
        f"of {BERT_SEQ}; {flops:.4g} useful FLOP per step (_bert_job's "
        f"formula, {n_matmul} matmul parameters)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [bert_step(model, params, buffers, opt, state, t)]   # warm
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # main path: the counts go to 0 just before and are read just after
    reset_bert_counts()
    t0 = time.perf_counter()
    for _ in range(BERT_TIMED_STEPS):
        losses.append(bert_step(model, params, buffers, opt, state, t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bert_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    ms = wall * 1e3 / BERT_TIMED_STEPS
    tok_s = t_real * BERT_TIMED_STEPS / wall
    mfu = flops / (ms / 1e3) / BF16_FLOPS
    log(f"warm step {warm:.2f} s; {BERT_TIMED_STEPS} timed steps: {ms:.2f} "
        f"ms/step, {tok_s:.1f} real tokens/s, MFU {mfu:.2%} (useful FLOPs, "
        f"989 TFLOP/s bf16 peak); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB  [{card}]")
    log(f"losses (warm, then timed): {losses}")
    L = cfg.num_layers
    want = dict(layer_norm_fwd=2 * L + 2, layer_norm_bwd=2 * L + 2,
                layer_norm_bwd_sums=2 * L + 2, flash_fwd=L, flash_bwd_dq=L,
                flash_bwd_dkv=L, fused_adam=77)
    log(f"launches in the timed steps: {counts}; per step expected {want}")
    require(all(math.isfinite(x) for x in losses), "a BERT loss is not finite")
    for k, per_step in want.items():
        require(counts[k] == per_step * BERT_TIMED_STEPS,
                f"{k}: {counts[k]} launches in {BERT_TIMED_STEPS} steps, "
                f"expected {per_step} per step")
    profile = profile_train_step(
        lambda: bert_step(model, params, buffers, opt, state, t), card,
        classify=_kernel_class_bert)
    return dict(n_seqs=n_seqs, rows=rows, real_tokens=t_real,
                tokens_per_s=tok_s, ms_per_step=ms, mfu=mfu,
                useful_flops=flops, peak_bytes=peak, losses=losses,
                launches={k: v // BERT_TIMED_STEPS for k, v in counts.items()},
                launches_total=counts, warm_s=warm, **profile)


def bert_train_phase(card):
    cfg = TB.BertConfig()
    model, params, buffers = bert_model(cfg)
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_state(params)
    cells = {}
    for n_seqs in BERT_SEQS:
        log(f"--- cell: {n_seqs} sequences ---")
        cells[n_seqs] = bert_train_cell(card, n_seqs, model, params, buffers,
                                        opt, state, cfg)
        torch.cuda.empty_cache()
    del params, state, opt, model
    torch.cuda.empty_cache()
    return cells


def bert_exactness_phase(t=None):
    """The kernel path against the plain path on the packed batch, or on
    ``t`` (phase 27b: the padded batch)."""
    if t is None:
        t = bert_tensors(bert_batch(BERT_SEQS[0], TB.BertConfig().vocab_size),
                         DEV)
    # fp32, full width, 2 layers, dropout 0: kernel path vs plain path
    cfg = TB.BertConfig(num_layers=2, hidden_dropout=0.0)
    model, params, buffers = bert_model(cfg, dtype=torch.float32)
    loss_k, g_k = bert_loss_and_grads(model, params, buffers, t)
    with layer_plain_path():
        loss_p, g_p = bert_loss_and_grads(model, params, buffers, t)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"fp32 2-layer: loss kernel {loss_k.item():.7f} plain "
        f"{loss_p.item():.7f} rel {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, f"fp32 2-layer BERT loss rel err {rel}")
    fp32_worst = compare_bert_grads("fp32 2-layer", g_k, g_p, 1e-3, "max",
                                    1e-6)
    del model, params, g_k, g_p
    torch.cuda.empty_cache()
    # bf16, full depth, dropout 0: TRAJECTORY steps from one init on each
    # path, each with its own AdamW (bf16 moments, SR on); the first step's
    # gradients also against the fp32 witness
    cfg = TB.BertConfig(hidden_dropout=0.0)
    model, pk, buffers = bert_model(cfg)
    pp = {k: v.clone() for k, v in pk.items()}
    loss_32, g32 = bert_loss_and_grads(
        model, {k: v.float() for k, v in pk.items()}, buffers, t)
    log(f"fp32 witness (kernel path in fp32 on the bf16 weights): loss "
        f"{loss_32.item():.5f}")
    ok, op = (AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
              for _ in range(2))
    sk, sp = ok.init_state(pk), op.init_state(pp)
    traj_k, traj_p, bf16_worst = [], [], None
    for step in range(BERT_TRAJECTORY_STEPS):
        loss_k, g_k = bert_loss_and_grads(model, pk, buffers, t)
        with layer_plain_path():
            loss_p, g_p = bert_loss_and_grads(model, pp, buffers, t)
        if step == 0:
            rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            log(f"bf16 full depth, first step: loss kernel "
                f"{loss_k.item():.5f} plain {loss_p.item():.5f} rel "
                f"{rel:.2e} (tol 1e-3)")
            require(rel <= 1e-3, f"bf16 BERT loss rel err {rel}")
            qn = [g_p[f"bert.encoder.layers.{i}.self_attn.q_proj.weight"]
                  .float().norm().item() for i in (0, cfg.num_layers - 1)]
            with torch.no_grad():
                seq = TNN.functional_call(
                    model.bert, {k[5:]: v for k, v in pk.items()
                                 if k.startswith("bert.")}, buffers,
                    t["ids"], **bert_layout(t))[0][0].float().reshape(
                        -1, cfg.hidden_size)
            log(f"bf16 full depth: query projection grad norm layer 0 "
                f"{qn[0]:.3e}, layer {cfg.num_layers - 1} {qn[1]:.3e}; last "
                f"hidden states: norm of their mean over tokens "
                f"{seq.mean(0).norm().item():.3f} against their mean norm "
                f"{seq.norm(dim=1).mean().item():.3f} (the tokens' states "
                f"converge with depth)")
            qk = qk_witness_check(g_k, g_p, g32)
            bf16_worst = compare_bert_grads("bf16 full depth", g_k, g_p,
                                            5e-2, "l2", 1e-3, skip=qk)
            del g32
        ok.apply(pk, g_k, sk)
        with layer_plain_path():
            op.apply(pp, g_p, sp)
        traj_k.append(loss_k.item())
        traj_p.append(loss_p.item())
        del g_k, g_p
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(traj_k, traj_p))
    log(f"bf16 full depth, {BERT_TRAJECTORY_STEPS} AdamW steps: kernel path "
        f"{traj_k}\n  plain path {traj_p}\n  max rel diff {traj_rel:.2e} "
        f"(tol 1e-2: bf16 rounding on two paths, SR noise from two "
        f"generators)")
    require(traj_rel <= 1e-2, f"bf16 BERT trajectories differ by {traj_rel}")
    del model, pk, pp, sk, sp
    torch.cuda.empty_cache()
    return dict(fp32_grad_max_rel=fp32_worst, bf16_grad_l2_rel=bf16_worst,
                bf16_qk_vs_fp32_witness=qk,
                bf16_trajectory_kernel=traj_k, bf16_trajectory_plain=traj_p)


# ---------------------------------------------------------------------------
# phases 19-23: the Llama slice
# ---------------------------------------------------------------------------
LLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
             num_layers=22, num_heads=16, num_kv_heads=4, max_seq_len=1024,
             rope_theta=1e4, rms_eps=1e-5)            # bench_llama
LLAMA_BATCH, LLAMA_SEQ = 8, 1024
LLAMA_TIMED_STEPS = 5
LLAMA_TRAJECTORY_STEPS = 4    # phase 22b: kernel path vs plain path
# RMSNorm / RoPE kernel vs plain: max-abs err / max-abs ref; fp32 sums in
# another order, bf16 one rounding of the output (an fp32 difference flips
# one ulp)
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# per element: the backward's dx 7, its dw sum 3
RMS_FLOPS = {"rms_norm_fwd": 4, "rms_norm_bwd": 10}
ROPE_FLOPS = 6                                          # per pair


def row_bound(nbytes, flops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def rms_bounds(rows, H, dtype):
    it = torch.tensor([], dtype=dtype).element_size()
    work = {"rms_norm_fwd": 2 * rows * H * it + H * 4 + 4 * rows,
            "rms_norm_bwd": 3 * rows * H * it + 2 * H * 4 + 4 * rows}
    return {name: (*row_bound(nbytes, RMS_FLOPS[name] * rows * H), nbytes,
                   RMS_FLOPS[name] * rows * H)
            for name, nbytes in work.items()}


# -- phase 19 ---------------------------------------------------------------
def check_rms_case(name, rows, H, dtype, eps, card=None):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(rows + H)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=DEV) * scale + shift
    x = rnd(rows, H, scale=3.0, shift=1.0).to(dtype)
    w = rnd(H)
    dy = rnd(rows, H).to(dtype)
    y, rstd = RN.rms_norm_fwd(x, w, eps)
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
    dx2, dw2 = RN.rms_norm_bwd(x, w, rstd, dy)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yk = RN.rms_norm(xr, wr, eps)
    gk = torch.autograd.grad(yk, (xr, wr), dy, retain_graph=True)
    torch.cuda.synchronize()
    require(torch.equal(dw, dw2) and torch.equal(dx, dx2),
            f"{name}: two backward calls differ in their bits")
    plan = RN.bwd_plan(x, w, dy)
    fplan = RN.fwd_plan(x, w, y)
    y_p, rstd_p = RN.rms_norm_fwd_plain(x, w, eps)
    dx_p, _ = RN.rms_norm_bwd_plain(x, w, rstd_p, dy)
    # dw is an fp32 sum of the same products on both sides (the kernel's
    # rstd given to both): only the order of the sums may differ
    _, dw_p = RN.rms_norm_bwd_plain(x, w, rstd, dy, need_dx=False)
    tol, dw_tol = NORM_TOL[dtype], NORM_TOL[torch.float32]
    rec = {}
    for what, got, ref, t in (("y", y, y_p, tol), ("dx", dx, dx_p, tol),
                              ("dw", dw, dw_p, dw_tol),
                              ("dx_autograd", gk[0], dx_p, tol),
                              ("dw_autograd", gk[1], dw_p, dw_tol)):
        require(got.dtype == ref.dtype and got.shape == ref.shape,
                f"{name} {what}: {got.dtype} {tuple(got.shape)} vs "
                f"{ref.dtype} {tuple(ref.shape)}")
        require(torch.isfinite(got.float()).all(), f"{name} {what} not finite")
        err, rel = _rel_err(got, ref)
        require(rel <= t, f"{name} {what}: rel err {rel} > {t}")
        rec[what] = err
    srel = ((rstd - rstd_p).abs() / rstd_p).max().item()
    require(srel <= 1e-5, f"{name} rstd rel err {srel}")
    log(f"{name}: max_abs_err y {rec['y']:.3e} dx {rec['dx']:.3e} dw "
        f"{rec['dw']:.3e}, rstd rel {srel:.2e} (tol {tol}, dw {dw_tol}); "
        f"forward path {fplan['path']}, {fplan['blocks']} blocks; backward path "
        f"{plan['path']}, {plan['blocks']} blocks; dw bit for bit across "
        f"two calls")
    if card is None:
        return None
    bounds = rms_bounds(rows, H, dtype)
    F_ = torch.nn.functional
    wl = w.to(dtype)
    xl, wlr = x.clone().requires_grad_(True), wl.clone().requires_grad_(True)
    yl = F_.rms_norm(xl, (H,), wlr, eps)
    # the dense form's composed _rms (rounds before the gain), forward and
    # autograd backward, beside the kernels: the two RMSNorms of this slice
    xc, wc = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yc = TL._rms(xc, wc, eps)
    times = {
        "rms_norm_fwd": (
            cuda_ms(lambda: RN.rms_norm_fwd(x, w, eps)),
            cuda_ms(lambda: RN.rms_norm_fwd_plain(x, w, eps)),
            cuda_ms(lambda: F_.rms_norm(x, (H,), wl, eps))),
        "rms_norm_bwd": (
            cuda_ms(lambda: RN.rms_norm_bwd(x, w, rstd, dy)),
            cuda_ms(lambda: RN.rms_norm_bwd_plain(x, w, rstd, dy)),
            cuda_ms(lambda: torch.autograd.grad(yl, (xl, wlr), dy,
                                                retain_graph=True))),
    }
    # the backward as the model runs it (the autograd Function: the one
    # launch and dw's cast), and the dx-only kernels a frozen weight takes
    full_bwd = cuda_ms(lambda: torch.autograd.grad(yk, (xr, wr), dy,
                                                   retain_graph=True))
    dx_only = cuda_ms(lambda: RN.rms_norm_bwd(x, w, rstd, dy, need_dw=False))
    composed = (cuda_ms(lambda: TL._rms(x, w, eps)),
                cuda_ms(lambda: torch.autograd.grad(
                    yc, (xc, wc), yc.detach(), retain_graph=True)))
    # a warm call's host time (the wrapper's checks and the launch, the grid
    # from the occupancy kept in the library)
    torch.cuda.synchronize()
    host = {"rms_norm_fwd": host_overhead_ms(lambda: RN.rms_norm_fwd(x, w,
                                                                    eps)),
            "rms_norm_bwd": host_overhead_ms(lambda: RN.rms_norm_bwd(
                x, w, rstd, dy))}
    torch.cuda.synchronize()
    errs = {"rms_norm_fwd": rec["y"], "rms_norm_bwd": max(rec["dx"],
                                                          rec["dw"])}
    recs = {}
    for kname, (kern, plain, lib) in times.items():
        bound, by, nbytes, flops = bounds[kname]
        log(f"{name} {kname}: kernel_ms {kern:.4f} plain_ms {plain:.4f} "
            f"library_ms {lib:.4f} bound_ms {bound:.4f} ({by}: {nbytes} B, "
            f"{flops} FLOP) kernel/bound {kern / bound:.1f}x  [{card}]")
        recs[kname] = dict(max_abs_err=errs[kname], ms=kern, plain_ms=plain,
                           library_ms=lib, bound_ms=bound, bound_by=by,
                           bytes=nbytes, flops=flops, host_ms=host[kname])
    recs["rms_norm_bwd"].update(ms_autograd=full_bwd, dx_only_ms=dx_only,
                                path=plan["path"], blocks=plan["blocks"],
                                dw_max_abs_err=rec["dw"])
    recs["rms_norm_fwd"].update(composed_fwd_bwd_ms=composed,
                                path=fplan["path"], blocks=fplan["blocks"])
    log(f"{name}: the backward (dx and dw, one launch) "
        f"{times['rms_norm_bwd'][0]:.4f} ms, autograd of F.rms_norm "
        f"{times['rms_norm_bwd'][2]:.4f}, bound "
        f"{bounds['rms_norm_bwd'][0]:.4f}; through the autograd Function "
        f"{full_bwd:.4f}; the dx-only kernels {dx_only:.4f}; the dense "
        f"form's composed _rms forward {composed[0]:.4f} ms, its autograd "
        f"backward {composed[1]:.4f} ms; a warm call's host time: forward "
        f"{host['rms_norm_fwd']:.4f} ms, backward "
        f"{host['rms_norm_bwd']:.4f} ms  [{card}]")
    return recs


def rms_phase(card):
    R, H = LLAMA_BATCH * LLAMA_SEQ, LLAMA["hidden_size"]
    recs = check_rms_case(f"(bf16) rows {R} x {H}, eps 1e-5, fp32 weight",
                          R, H, torch.bfloat16, 1e-5, card)
    # the same bytes in rows twice as wide, timed beside it
    recs["wide"] = check_rms_case(
        f"(bf16) rows {R // 2} x {2 * H}, eps 1e-5, fp32 weight", R // 2,
        2 * H, torch.bfloat16, 1e-5, card)
    check_rms_case(f"(fp32) rows {R} x {H}, eps 1e-5", R, H, torch.float32,
                   1e-5)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for rows in (37, 1, 13):
            for h in (100, 4095):
                check_rms_case(f"({tag}) rows {rows} x {h}, eps 1e-6", rows,
                               h, dtype, 1e-6)
        check_rms_case(f"({tag}) rows 37 x 30000, eps 1e-6", 37, 30000,
                       dtype, 1e-6)
    torch.cuda.empty_cache()
    return recs


# -- phase 20 ---------------------------------------------------------------
def rope_bound(x):
    B, S, H, D = x.shape
    nbytes = 2 * x.numel() * x.element_size() + 2 * S * (D // 2) * 4
    flops = ROPE_FLOPS * B * S * H * (D // 2)
    return (*row_bound(nbytes, flops), nbytes, flops)


def check_rope_case(name, x, cos, sin):
    """Forward and -sin against the plain version; returns max-abs errs."""
    errs = []
    for neg in (False, True):
        got, ref = RP.rope(x, cos, sin, neg), RP.rope_plain(x, cos, sin, neg)
        require(got.dtype == x.dtype and got.shape == x.shape,
                f"{name}: {got.dtype} {tuple(got.shape)}")
        err, rel = _rel_err(got, ref)
        require(rel <= NORM_TOL[x.dtype],
                f"{name} neg_sin={neg}: rel err {rel}")
        errs.append(err)
    log(f"{name}: max_abs_err forward {errs[0]:.3e}, -sin {errs[1]:.3e} "
        f"(tol {NORM_TOL[x.dtype]})")
    return errs


def rope_phase(card):
    cfg = TL.LlamaConfig(**LLAMA)
    B, S, D = LLAMA_BATCH, LLAMA_SEQ, cfg.head_dim
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    q = rnd(B, S, cfg.num_heads, D).requires_grad_(True)
    k = rnd(B, S, cfg.num_kv_heads, D).requires_grad_(True)
    gq, gk = rnd(B, S, cfg.num_heads, D), rnd(B, S, cfg.num_kv_heads, D)
    cos, sin = TL.rope_tables(cfg, S, DEV)
    # the main path: fused_rotary_position_embedding with its default
    # (theta 10000) tables, forward and backward; counts 0 just before
    RP.rope.LAUNCHES = 0
    oq, ok, ov = TI.fused_rotary_position_embedding(q, k)
    torch.autograd.backward((oq, ok), (gq, gk))
    torch.cuda.synchronize()
    launches = RP.rope.LAUNCHES
    log(f"fused_rotary_position_embedding(q {tuple(q.shape)}, k "
        f"{tuple(k.shape)}) bf16, forward and backward: {launches} rope "
        f"launches (expected 2 forward + 2 backward)")
    require(ov is None and launches == 4, f"rope launches {launches} != 4")
    errs = {}
    for what, got, ref in (
            ("q", oq, RP.rope_plain(q.detach(), cos, sin)),
            ("k", ok, RP.rope_plain(k.detach(), cos, sin)),
            ("dq", q.grad, RP.rope_plain(gq, cos, sin, True)),
            ("dk", k.grad, RP.rope_plain(gk, cos, sin, True))):
        err, rel = _rel_err(got, ref)
        require(rel <= NORM_TOL[torch.bfloat16], f"fused rope {what}: {rel}")
        errs[what] = err
    log(f"fused rope vs plain (the model's tables): max_abs_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    qd, kd = q.detach(), k.detach()
    recs = {}
    for tag, x in (("q", qd), ("k", kd)):
        bound, by, nbytes, flops = rope_bound(x)
        kern = cuda_ms(lambda: RP.rope(x, cos, sin))
        back = cuda_ms(lambda: RP.rope(x, cos, sin, True))
        plain = cuda_ms(lambda: RP.rope_plain(x, cos, sin))
        log(f"rope {tag} {tuple(x.shape)} bf16: kernel_ms {kern:.4f} (-sin "
            f"{back:.4f}) plain_ms {plain:.4f} library_ms none bound_ms "
            f"{bound:.4f} ({by}: {nbytes} B, {flops} FLOP) kernel/bound "
            f"{kern / bound:.1f}x  [{card}]")
        recs[tag] = dict(max_abs_err=errs[tag], ms=kern, neg_sin_ms=back,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by, bytes=nbytes, flops=flops)
    recs["launches"] = launches
    # untimed: odd D/2, fp32, a strided view, v given
    for shape in ((2, 7, 3, 6), (1, 5, 2, 10), (2, 33, 2, 24)):
        c, s_ = (t[:shape[1], :shape[3] // 2].contiguous() for t in
                 (cos, sin))
        for dtype in (torch.bfloat16, torch.float32):
            check_rope_case(f"({dtype}) {shape}", rnd(*shape, dtype=dtype),
                            c, s_)
    check_rope_case(f"(fp32) q {tuple(qd.shape)}", qd.float(), cos, sin)
    qkv = rnd(2, S, cfg.num_heads, 3, D)
    check_rope_case(f"(bf16) a strided view of {tuple(qkv.shape)}",
                    qkv[:, :, :, 1], cos, sin)
    v = rnd(B, S, cfg.num_kv_heads, D)
    n = RP.rope.LAUNCHES
    outs = TI.fused_rotary_position_embedding(qd, kd, v, sin=sin, cos=cos)
    require(RP.rope.LAUNCHES == n + 3, "v given: three rope launches")
    for t, o in zip((qd, kd, v), outs):
        _, rel = _rel_err(o, RP.rope_plain(t, cos, sin))
        require(rel <= NORM_TOL[torch.bfloat16], f"v given: rel err {rel}")
    log("fused rope with v given: three launches, each within tolerance")
    del q, k, gq, gk, oq, ok, qkv, v, outs
    torch.cuda.empty_cache()
    return recs


# -- phases 21-23 -----------------------------------------------------------
def reset_llama_counts():
    for fn in (RN.rms_norm_fwd, RN.rms_norm_bwd, RP.rope, FA.flash_fwd,
               FA.flash_bwd_dq, FA.flash_bwd_dkv, FAD.adam_update):
        fn.LAUNCHES = 0


def llama_counts():
    return dict(rms_norm_fwd=RN.rms_norm_fwd.LAUNCHES,
                rms_norm_bwd=RN.rms_norm_bwd.LAUNCHES,
                rope=RP.rope.LAUNCHES,
                flash_fwd=FA.flash_fwd.LAUNCHES,
                flash_bwd_dq=FA.flash_bwd_dq.LAUNCHES,
                flash_bwd_dkv=FA.flash_bwd_dkv.LAUNCHES,
                fused_adam=FAD.adam_update.LAUNCHES)


def llama_model(cfg, seed=0):
    """The eager model built on the host from ``seed`` (its own fp32
    parameters stay there: the card holds the trained state)."""
    with device_guard("cpu"), TR.rng_guard(torch.Generator().manual_seed(
            seed)):
        return TL.Llama(cfg)


def llama_state(model, device=DEV, dtype=torch.bfloat16):
    """The trainable state on ``device``: >= 2-D parameters in ``dtype``,
    the RMSNorm weights fp32."""
    params = TNN.functional_train_graph(model, device=device)[0]
    return {k: v.to(dtype) if v.dim() >= 2 else v for k, v in params.items()}


def llama_batch(vocab, device=DEV):
    rng = np.random.RandomState(0)             # bench_llama
    shape = (LLAMA_BATCH, LLAMA_SEQ)
    return (torch.from_numpy(rng.randint(0, vocab, shape)).to(device),
            torch.from_numpy(rng.randint(0, vocab, shape)).to(device))


def llama_loss_and_grads(model, params, tokens, labels):
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    logits, _ = TNN.functional_call(model, params, {}, tokens)
    loss = TF.cross_entropy(logits, labels)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    for p in params.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def llama_step(model, params, opt, state, tokens, labels):
    loss, grads = llama_loss_and_grads(model, params, tokens, labels)
    opt.apply(params, grads, state)
    return loss


def incubate_card_vs_cpu():
    """incubate's fused ops on the card and on the CPU, fp32."""
    gen = torch.Generator().manual_seed(21)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)
    x, w, b = rnd(4, 37, 256), rnd(256), rnd(256)
    q, k, v = rnd(2, 64, 4, 64), rnd(2, 64, 2, 64), rnd(2, 64, 2, 64)
    lw, lb = rnd(256, 96), rnd(96)
    ops = {
        "fused_rms_norm": lambda d: TI.fused_rms_norm(x.to(d), w.to(d),
                                                      epsilon=1e-5),
        "fused_layer_norm": lambda d: TI.fused_layer_norm(
            x.to(d), w.to(d), b.to(d), 1e-5),
        "fused_rotary_position_embedding": lambda d: torch.cat([
            t.flatten() for t in TI.fused_rotary_position_embedding(
                q.to(d), k.to(d), v.to(d))]),
        "swiglu": lambda d: TI.swiglu(x.to(d)),
        "fused_linear": lambda d: TI.fused_linear(x.to(d), lw.to(d),
                                                  lb.to(d)),
        "fused_bias_act": lambda d: TI.fused_bias_act(x.to(d), b.to(d),
                                                      "geglu"),
    }
    n = (RN.rms_norm_fwd.LAUNCHES, RP.rope.LAUNCHES,
         LN.layer_norm_fwd.LAUNCHES)
    worst = {}
    for name, fn in ops.items():
        _, worst[name] = _rel_err(fn(DEV).cpu(), fn("cpu"))
        require(worst[name] <= 1e-5, f"incubate {name}: card vs CPU "
                f"{worst[name]}")
    launched = (RN.rms_norm_fwd.LAUNCHES - n[0], RP.rope.LAUNCHES - n[1],
                LN.layer_norm_fwd.LAUNCHES - n[2])
    require(launched == (1, 3, 1), f"incubate launches {launched}")
    log("incubate ops, card vs CPU (fp32, rel err, tol 1e-5): "
        + ", ".join(f"{n_} {e:.2e}" for n_, e in worst.items())
        + f"; kernel launches rms / rope / layer_norm {launched}")


def tiny_llama_phase():
    cfg = TL.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                         num_heads=4, num_kv_heads=2, intermediate_size=512,
                         dtype=torch.float32)
    model = llama_model(cfg)
    rng = np.random.RandomState(0)
    tokens, labels = (torch.from_numpy(rng.randint(0, 512, (4, 128)))
                      for _ in range(2))

    def run(dev):
        params = llama_state(model, dev, torch.float32)
        opt = AdamW(1e-3)
        state = opt.init_state(params)
        losses = [llama_step(model, params, opt, state, tokens.to(dev),
                             labels.to(dev)).item() for _ in range(3)]
        return losses, {k: v.cpu() for k, v in params.items()}

    reset_llama_counts()
    card_losses, card_params = run(DEV)
    counts = llama_counts()
    cpu_losses, cpu_params = run("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    worst = max((card_params[n] - p).abs().max().item()
                for n, p in cpu_params.items())
    log(f"card: {card_losses}\ncpu:  {cpu_losses}\nmax loss rel diff "
        f"{rel:.2e} (tol 1e-5); parameters after 3 steps max_abs_err "
        f"{worst:.2e} (tol 1e-4); card launches {counts}")
    require(rel <= 1e-5, f"tiny Llama: card and CPU losses differ by {rel}")
    require(worst <= 1e-4, f"tiny Llama: parameters differ by {worst}")
    L = cfg.num_layers
    require(counts["rms_norm_fwd"] == counts["rms_norm_bwd"] == 3 * (2 * L + 1),
            f"tiny Llama: RMSNorm launches {counts}")
    require(counts["flash_fwd"] == 3 * L, f"tiny Llama: flash {counts}")
    incubate_card_vs_cpu()


def _kernel_class_llama(name):
    low = name.lower()
    if "rms_fwd" in low or "rms_bwd" in low:
        return "rmsnorm"
    if "gemm" in low and any(w in low for w in ("sgemm", "f32f32", "simt",
                                                "gemm_f32")):
        return "head_gemm_fp32"
    return _kernel_class_train(name)


def head_gemm_ms(cfg, card):
    """The eager head's fp32 GEMMs alone, forward (x @ W) and backward
    (dlogits @ W^T, x^T @ dlogits), at the step's shapes: TF32 is off, so
    they run on the fp32 pipe (67 TFLOP/s peak)."""
    T, H, V = LLAMA_BATCH * LLAMA_SEQ, cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    x = torch.randn(T, H, generator=gen, device=DEV)
    w = torch.randn(H, V, generator=gen, device=DEV) * 0.02
    g = torch.randn(T, V, generator=gen, device=DEV)
    ms = (cuda_ms(lambda: x @ w, runs=5), cuda_ms(lambda: g @ w.T, runs=5),
          cuda_ms(lambda: x.T @ g, runs=5))
    flops = 3 * 2.0 * T * H * V
    log(f"head GEMMs fp32 [{T}, {H}] x [{H}, {V}]: forward {ms[0]:.3f} ms, "
        f"backward {ms[1]:.3f} + {ms[2]:.3f} ms; {flops / 1e12:.3f} TFLOP, "
        f"{flops / (sum(ms) / 1e3) / 1e12:.1f} TFLOP/s  [{card}]")
    del x, w, g
    torch.cuda.empty_cache()
    return dict(fwd_ms=ms[0], bwd_ms=ms[1] + ms[2], total_ms=sum(ms),
                flops=flops)


def timed_steps(step, want, tokens_per_step, flops_per_token, card, tag,
                reset=None, read=None, collect=False):
    """One warm step, then LLAMA_TIMED_STEPS timed steps with the counts
    (``reset`` / ``read``: the Llama kernels' by default) set to 0 just
    before and read just after; checks every count against ``want`` (per
    step); ``collect``: a full garbage collection between the warm step and
    the timed ones. CUDA events between the timed steps (no extra
    synchronize) give each step's span on the device's timeline; the host
    clock where each step's enqueue ended, the Python garbage collections
    in the timed steps, and the caching allocator's counters (cudaMalloc,
    free, retry) say where a slow step's time went."""
    alloc_keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    torch.cuda.reset_peak_memory_stats()
    st0 = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    losses = [step()]                                              # warm
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    st1 = torch.cuda.memory_stats()
    if collect:
        gc.collect()
    (reset or reset_llama_counts)()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(LLAMA_TIMED_STEPS + 1)]
    collections, host = [], []

    def on_gc(when, info, start=[0.0]):
        if when == "start":
            start[0] = time.perf_counter()
        else:
            collections.append((info["generation"],
                                (time.perf_counter() - start[0]) * 1e3))
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(LLAMA_TIMED_STEPS):
        losses.append(step())
        ev[i + 1].record()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    st2 = torch.cuda.memory_stats()
    counts = (read or llama_counts)()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    allocs = {k: (st1.get(k, 0) - st0.get(k, 0), st2.get(k, 0) - st1.get(k, 0))
              for k in alloc_keys}
    losses = [x.item() for x in losses]
    ms = wall * 1e3 / LLAMA_TIMED_STEPS
    tok_s = tokens_per_step * LLAMA_TIMED_STEPS / wall
    mfu = FL.mfu(tok_s, flops_per_token,
                 FL.peak_flops(torch.cuda.get_device_name(0)))
    log(f"{tag}: warm step {warm:.2f} s; {LLAMA_TIMED_STEPS} timed steps: "
        f"{ms:.2f} ms/step, {tok_s:.1f} tokens/s, MFU {mfu:.2%} "
        f"({flops_per_token:.4g} FLOP/token, 989 TFLOP/s bf16 peak); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    log(f"{tag}: each timed step on the device's timeline (ms): "
        f"{[round(t, 2) for t in step_ms]}; allocator (warm step, timed "
        f"steps): {allocs}; reserved peak "
        f"{st2.get('reserved_bytes.all.peak', 0) / 2**30:.2f} GiB")
    med = statistics.median(step_ms)
    med_tok_s = tokens_per_step / (med / 1e3)
    med_mfu = FL.mfu(med_tok_s, flops_per_token,
                     FL.peak_flops(torch.cuda.get_device_name(0)))
    log(f"{tag}: the median timed step on the device's timeline {med:.2f} "
        f"ms: {med_tok_s:.1f} tokens/s, MFU {med_mfu:.2%}  [{card}]")
    gc_ms = sum(t for _, t in collections)
    log(f"{tag}: host clock at each step's end of enqueue (ms from the "
        f"first): {[round(t, 1) for t in host]}; {len(collections)} garbage "
        f"collections in the timed steps, {gc_ms:.1f} ms, the longest "
        f"{max((t for _, t in collections), default=0.0):.1f} ms (generations "
        f"{sorted({g for g, _ in collections})})")
    log(f"{tag}: losses (warm, then timed): {losses}")
    log(f"{tag}: launches in the timed steps: {counts}; per step expected "
        f"{want}")
    require(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not "
            f"finite")
    for k, per_step in want.items():
        require(counts[k] == per_step * LLAMA_TIMED_STEPS,
                f"{tag} {k}: {counts[k]} launches in {LLAMA_TIMED_STEPS} "
                f"steps, expected {per_step} per step")
    return dict(tokens_per_s=tok_s, ms_per_step=ms, mfu=mfu,
                flops_per_token=flops_per_token, peak_bytes=peak,
                losses=losses, warm_s=warm, step_ms=step_ms,
                median_step_ms=med, median_tokens_per_s=med_tok_s,
                median_mfu=med_mfu, host_enqueue_end_ms=host,
                allocator=allocs,
                gc_collections=len(collections), gc_ms=gc_ms,
                launches={k: v // LLAMA_TIMED_STEPS for k, v in counts.items()},
                launches_total=counts)


def llama_train_phase(card):
    cfg = TL.LlamaConfig(**LLAMA, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = llama_model(cfg)
    params = llama_state(model)
    n_params = sum(p.numel() for p in params.values())
    log(f"eager Llama at bench_llama's width: {n_params} parameters "
        f"({FL._llama_matmul_params(cfg)} in matmuls without the "
        f"embedding), {sum(p.dim() < 2 for p in params.values())} fp32 "
        f"RMSNorm weights; built on the host and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_state(params)
    tokens, labels = llama_batch(cfg.vocab_size)
    L = cfg.num_layers

    def step():
        return llama_step(model, params, opt, state, tokens, labels)
    want = dict(rms_norm_fwd=2 * L + 1, rms_norm_bwd=2 * L + 1, rope=0,
                flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L,
                fused_adam=7 * L + 2)
    rec = timed_steps(step, want, LLAMA_BATCH * LLAMA_SEQ,
                      FL.llama_flops_per_token(cfg, LLAMA_SEQ)["model"],
                      card, "eager Llama")
    rec.update(profile_train_step(step, card, classify=_kernel_class_llama))
    del params, state, opt
    torch.cuda.empty_cache()
    rec["head_gemm"] = head_gemm_ms(cfg, card)
    rec["head_gemm_share"] = rec["head_gemm"]["total_ms"] / rec["ms_per_step"]
    log(f"the fp32 head GEMMs alone take {rec['head_gemm']['total_ms']:.2f} "
        f"ms, {rec['head_gemm_share']:.1%} of the timed step")
    return rec, model


def llama_exactness_phase(model):
    """Kernel path (RMSNorm, flash and Adam kernels) against the plain path
    on the card: fp32 at 2 layers, then bf16 at full depth."""
    tokens, labels = llama_batch(LLAMA["vocab_size"])
    # fp32, full width, the first 2 layers of the full model's weights
    cfg2 = TL.LlamaConfig(**dict(LLAMA, num_layers=2), dtype=torch.float32)
    with device_guard("cpu"):
        two = TL.Llama(cfg2)
    two.load_state_dict({k: v for k, v in model.state_dict().items()
                         if k in two.state_dict()})
    params = llama_state(two, DEV, torch.float32)
    loss_k, g_k = llama_loss_and_grads(two, params, tokens, labels)
    with layer_plain_path():
        loss_p, g_p = llama_loss_and_grads(two, params, tokens, labels)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"fp32 2-layer: loss kernel {loss_k.item():.7f} plain "
        f"{loss_p.item():.7f} rel {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, f"fp32 2-layer Llama loss rel err {rel}")
    fp32_worst = compare_grads("fp32 2-layer", g_k, g_p, 1e-3, "max")
    del two, params, g_k, g_p
    torch.cuda.empty_cache()
    pk = llama_state(model)
    pp = {k: v.clone() for k, v in pk.items()}
    ok, op = (AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
              for _ in range(2))
    sk, sp = ok.init_state(pk), op.init_state(pp)
    traj_k, traj_p, bf16_worst = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for step in range(LLAMA_TRAJECTORY_STEPS):
        loss_k, g_k = llama_loss_and_grads(model, pk, tokens, labels)
        with layer_plain_path():
            loss_p, g_p = llama_loss_and_grads(model, pp, tokens, labels)
        if step == 0:
            rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            log(f"bf16 full depth, first step: loss kernel "
                f"{loss_k.item():.5f} plain {loss_p.item():.5f} rel "
                f"{rel:.2e} (tol 1e-3); peak with both paths "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            require(rel <= 1e-3, f"bf16 Llama loss rel err {rel}")
            bf16_worst = compare_grads("bf16 full depth", g_k, g_p, 5e-2,
                                       "l2")
        ok.apply(pk, g_k, sk)
        with layer_plain_path():
            op.apply(pp, g_p, sp)
        traj_k.append(loss_k.item())
        traj_p.append(loss_p.item())
        del g_k, g_p
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(traj_k, traj_p))
    log(f"bf16 full depth, {LLAMA_TRAJECTORY_STEPS} AdamW steps: kernel path "
        f"{traj_k}\n  plain path {traj_p}\n  max rel diff {traj_rel:.2e} "
        f"(tol 1e-2: bf16 rounding on two paths, SR noise from two "
        f"generators)")
    require(traj_rel <= 1e-2, f"bf16 Llama trajectories differ by {traj_rel}")
    del pk, pp, sk, sp
    torch.cuda.empty_cache()
    return dict(fp32_grad_max_rel=fp32_worst, bf16_grad_l2_rel=bf16_worst,
                bf16_trajectory_kernel=traj_k, bf16_trajectory_plain=traj_p)


def llama_dense_phase(card):
    """bench_llama's own step: dense_loss (composed _rms and _rope, flash
    GQA, per-block remat) with every parameter bf16, AdamW bf16 moments."""
    cfg = TL.LlamaConfig(**LLAMA, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = TL.init_hybrid_params(cfg, 0, DEV)
    log(f"init_hybrid_params (host draws, seed 0): "
        f"{FL.param_count(params) + params['wte'].numel()} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_state(params)
    tokens, labels = llama_batch(cfg.vocab_size)
    names, leaves = zip(*flat_leaves(params))

    def step():
        for t in leaves:
            t.requires_grad_(True)
        loss = TL.dense_loss(params, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        opt.apply(params, unflatten(names, grads), state)
        return loss.detach()
    L = cfg.num_layers
    want = dict(rms_norm_fwd=0, rms_norm_bwd=0, rope=0, flash_fwd=2 * L,
                flash_bwd_dq=L, flash_bwd_dkv=L, fused_adam=9)
    rec = timed_steps(step, want, LLAMA_BATCH * LLAMA_SEQ,
                      FL.llama_flops_per_token(cfg, LLAMA_SEQ)["model"],
                      card, "dense_loss")
    rec.update(profile_train_step(step, card, classify=_kernel_class_llama))
    del params, state, opt
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 24-27b: the padded BERT slice
# ---------------------------------------------------------------------------
PADDED_B = 16                 # bench_bert_base: 16 sequences padded to 512
# an fp32 ALiBi-like bias beside bf16 q: -56 - slope |i - j|, floored at
# -64, where bf16 steps by 0.25 (the kernels read the bias in its own dtype)
ALIBI_SLOPES = (0.0313, 0.0219, 0.0437, 0.0251)
# phase 25: head dims checked against plain (B 2, S 256, H 4) and timed at
# B 8, S 1024, H 16 causal
HEAD_DIMS = (32, 40, 80, 96, 160, 256)
TIMED_DIMS = ((32, torch.bfloat16), (96, torch.bfloat16),
              (160, torch.bfloat16), (256, torch.bfloat16),
              (256, torch.float16), (128, torch.float16),
              (256, torch.float32), (160, torch.float32))


def padded_batch(vocab):
    """``benchmarks/configs_bench.py`` ``_bert_job`` / ``bench_bert_base``:
    RandomState(0) lengths in U[S/8, S], random tokens padded with 0 to
    [16, 512], the bool mask ``valid[:, None, None, :] & valid[:, None, :,
    None]`` (:176-181), 15 % MLM labels on valid tokens, NSP labels; numpy,
    in the bench's order of draws."""
    B, S = PADDED_B, BERT_SEQ
    rng = np.random.RandomState(0)
    lens = rng.randint(S // 8, S + 1, (B,))
    seqs = [rng.randint(0, vocab, (n,)) for n in lens]
    ids = np.zeros((B, S), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    valid = np.arange(S)[None, :] < lens[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    mlm = np.where((rng.rand(B, S) < 0.15) & valid,
                   rng.randint(0, vocab, (B, S)), -100)
    nsp = rng.randint(0, 2, (B,))
    return dict(ids=ids, mask=mask, mlm=mlm, nsp=nsp, lens=lens)


def padded_tensors(batch, device):
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in ("ids", "mask", "mlm", "nsp")}


def bias_dropout_bits_check():
    """With a bias the three kernels still draw dropout_keep_mask: q = k = 0
    and a zero bias make every probability 1 / S, v = I reads the dropped
    row out of the forward, dO = I reads it out of dK/dV's dV, and dQ's
    d-bias is zero exactly where a probability was dropped."""
    B, S, H, p, seed = 2, 64, 3, 0.1, 2 ** 40 + 54321
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(B, S, H, S, device=DEV, dtype=dtype)
        eye = torch.eye(S, device=DEV, dtype=dtype)[None, :, None, :].expand(
            B, S, H, S).contiguous()
        bias = torch.zeros(1, 1, S, S, device=DEV, dtype=dtype)
        var = dict(bias=bias, dropout_p=p, seed=seed)
        out, lse = FA.flash_fwd(z, z, eye, False, 1.0, **var)
        _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                                 False, 1.0, **var)
        keep = FA.dropout_keep_mask(seed, B, H, S, S, p, DEV)
        fwd_ok = torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
        dkv_ok = torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)
        log(f"Philox masks with a bias ({dtype}): forward kernel == plain "
            f"{fwd_ok}, dK/dV kernel == plain {dkv_ok}")
        require(fwd_ok and dkv_ok, "with a bias, the CUDA and torch Philox "
                "masks differ")


def flash_padded_phase(card):
    """Phase 24: the padded BERT's flash call, B 16, S 512, H 12, D 64, the
    [16, 1, 512, 512] bool mask as a bias in q's dtype."""
    cfg = TB.BertConfig()
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    batch = padded_batch(cfg.vocab_size)
    B, S = batch["ids"].shape
    mask = torch.from_numpy(batch["mask"]).to(DEV)
    pairs = int(mask.sum().item()) * H
    log(f"padded rows [{B}, {S}], lengths {batch['lens'].tolist()}: "
        f"{int(batch['lens'].sum())} real tokens, {pairs} visible pairs over "
        f"{H} heads ({pairs / (B * H * S * S):.1%} of B H S^2); every pad "
        f"query row sees no key")
    bias_dropout_bits_check()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(24)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                                   device=DEV).to(dtype) for _ in range(4))
        bias = torch.where(mask, 0.0, -1e30).to(dtype)
        timed = card if dtype == torch.bfloat16 else None
        for p in (0.1, 0.0):
            recs[f"{tag}_bias_p{p}"] = check_attn(
                f"({tag}) padded [{B}, {S}, {H}, {D}], bias "
                f"[{B}, 1, {S}, {S}], dropout {p}", q, k, v, do, False,
                dict(bias=bias, dropout_p=p, seed=2400 + int(10 * p)),
                card=timed, pairs=pairs)
        # a bias with segments: BertModel's 2-D mask beside packed ids
        seg = torch.from_numpy(bert_batch(BERT_SEQS[0], cfg.vocab_size)
                               ["seg"][:2]).to(DEV)
        key_bias = torch.where(seg[:, None, None, :] >= 0, 0.0,
                               -1e30).to(dtype)
        recs[f"{tag}_bias_segments"] = check_attn(
            f"({tag}) packed rows [2, {S}] segments with a [2, 1, 1, {S}] "
            f"key bias, dropout 0.1", q[:2], k[:2], v[:2], do[:2], False,
            dict(bias=key_bias, q_seg=seg, kv_seg=seg, dropout_p=0.1,
                 seed=2410))
        del q, k, v, do, bias
        torch.cuda.empty_cache()
    # an fp32 bias beside bf16 q: read in fp32 (rounded to bf16 it moves a
    # logit by up to 0.125 and the plain version misses the bf16 tier)
    Hs = len(ALIBI_SLOPES)
    q, k, v, do = (torch.randn(4, S, Hs, D, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(4))
    pos = torch.arange(S, device=DEV, dtype=torch.float32)
    slopes = torch.tensor(ALIBI_SLOPES, device=DEV)
    alibi = (-56.0 - slopes[:, None, None] * (pos[None, :] - pos[:, None])
             .abs()).clamp_min(-64.0)[None]
    alibi = alibi + torch.rand(1, Hs, S, S, generator=gen, device=DEV) * 1e-3
    recs["alibi_fp32_bias_bf16_q"] = check_attn(
        f"(bf16 q, fp32 bias) ALiBi-like bias [1, {Hs}, {S}, {S}] in "
        f"[-64, -56]", q, k, v, do, False, dict(bias=alibi))
    scale = 1.0 / math.sqrt(D)
    ref = FA.flash_fwd_plain(q, k, v, False, scale, alibi)[0]
    rounded = FA.flash_fwd_plain(q, k, v, False, scale,
                                 alibi.to(torch.bfloat16))[0]
    miss = tile_rel_err(rounded, ref)
    log(f"the same bias rounded to bf16 first: plain vs plain worst tile "
        f"{miss:.3e} (above the bf16 tier {FLASH_TOL[torch.bfloat16][0]}: "
        f"the check tells the two readings apart)")
    require(miss > FLASH_TOL[torch.bfloat16][0], "the ALiBi check cannot "
            "tell an fp32 bias from a rounded one")
    recs["alibi_rounded_miss"] = miss
    # the d-bias at three bias shapes, B 2
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do = (torch.randn(2, S, H, D, generator=gen,
                                   device=DEV).to(dtype) for _ in range(4))
        for mb, mh in ((2, H), (1, H), (1, 1)):
            learned = torch.randn(mb, mh, S, S, generator=gen,
                                  device=DEV).to(dtype)
            recs[f"{tag}_dbias_{mb}x{mh}"] = check_attn(
                f"({tag}) d-bias, bias [{mb}, {mh}, {S}, {S}], causal", q, k,
                v, do, True, dict(bias=learned), bias_grad=True)
        del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def head_dims_phase(card):
    """Phase 25: every D of the family's members and between them, fp32,
    bf16 and fp16, causal and not, GQA 4:1 and Sq != Sk, against plain; fp32
    at D 160 and 256 with dropout (the TF32 forward, dQ and dK/dV draw one
    mask); then D 32, 96, 160, 256 in bf16, D 256, 128 in fp16 and D 256 and
    160 in fp32 (the forward, dQ and dK/dV on the TF32 tensor cores, with
    their TF32 bounds beside the FP32-pipe ones, dQ and dK/dV beside SDPA's
    fp32 backward) timed at B 8,
    S 1024, H 16, causal, the Llama GQA 16/4 call timed with its bound and
    SDPA (enable_gqa), the dK/dV design at every 16-bit D, D 160 and 256
    through the registry op (the counts set to 0 just before, read just
    after), and the registry op's route for D 320."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(25)

    def rnd(dtype, *shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    worst = {}
    for D in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for causal in (False, True):
                q, k, v, do = (rnd(dtype, 2, 256, 4, D) for _ in range(4))
                rec = check_attn(f"D {D} {dtype} causal={causal}", q, k, v,
                                 do, causal, {})
                key = f"{D}_{str(dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), *(
                    rec[w + "_tile"] for w in ("out", "dq", "dk", "dv")))
    for D in (80, 256):
        for dtype in (torch.bfloat16, torch.float16):
            for sq, sk in ((200, 320), (320, 200)):
                q, do = (rnd(dtype, 2, sq, 8, D) for _ in range(2))
                k, v = (rnd(dtype, 2, sk, 2, D) for _ in range(2))
                check_attn(f"GQA 8/2 D {D} {dtype} sq {sq} sk {sk} causal",
                           q, k, v, do, True, {})
    recs = {"worst_tile": worst}
    # fp32 at D_pad 192 / 256: the forward, dQ and dK/dV on the TF32 tensor
    # cores (16- and 32-row tiles); with dropout each must draw
    # dropout_keep_mask's bits, held by the plain versions
    for D in (160, 256):
        for causal in (True, False):
            q, do = (rnd(torch.float32, 2, 256, 4, D) for _ in range(2))
            k, v = (rnd(torch.float32, 2, 200, 2, D) for _ in range(2))
            rec = check_attn(f"fp32 D {D} dropout 0.1 GQA 4/2 causal={causal}",
                             q, k, v, do, causal, dict(dropout_p=0.1, seed=25))
            worst[f"{D}_float32_dropout"] = max(
                worst.get(f"{D}_float32_dropout", 0.0),
                *(rec[w + "_tile"] for w in ("out", "dq", "dk", "dv")))
    B, S, H = 8, 1024, 16
    for D, dtype in TIMED_DIMS:
        q, k, v, do = (rnd(dtype, B, S, H, D) for _ in range(4))
        recs[f"D{D}_{str(dtype)[6:]}"] = check_attn(
            f"({str(dtype)[6:]}) B={B} S={S} H={H} D={D} causal", q, k, v, do,
            True, {}, card=card, pairs=visible_pairs(S, S, True) * B * H)
        del q, k, v, do
        torch.cuda.empty_cache()
    for D in (160, 256):
        got = {n: r["design"] for n, r in recs[f"D{D}_float32"].items()}
        require(got == dict.fromkeys(FLASH_KERNELS, "wgmma-3xtf32"),
                f"fp32 D {D}: designs {got} (every kernel on TF32)")
    # the 16-bit dK/dV: the wgmma kernel at every width (128 keys a block
    # to D_pad 128, the split's 64 past it)
    designs = {(D, str(dt)[6:]): FA.kernel_plan("flash_bwd_dkv", D, dt)
               for D in range(1, 257)
               for dt in (torch.bfloat16, torch.float16)}
    off = {k: p["design"] for k, p in designs.items()
           if p["design"] != "wgmma+tma"}
    require(not off, f"16-bit dK/dV off the wgmma kernel: {off}")
    log("dK/dV design by D_pad: " + "; ".join(
        f"{d}: {designs[(d, 'bfloat16')]['design']}, "
        f"{designs[(d, 'bfloat16')]['keys']} keys x "
        f"{designs[(d, 'bfloat16')]['query_rows']} queries a tile"
        for d in (32, 64, 96, 128, 192, 256)))
    # D 160 and 256 through the registry op, forward and backward: each
    # kernel once, the gradients those of the direct kernel calls
    for D in (160, 256):
        q, k, v, do = (rnd(torch.bfloat16, B, S, H, D) for _ in range(4))
        scale = 1.0 / math.sqrt(D)
        _, lse = FA.flash_fwd(q, k, v, True, scale)
        _, delta = FA.flash_bwd_dq(q, k, v, lse, do, True, scale)
        dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, True, scale)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        reset_flash_counts()
        out = scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        grads = torch.autograd.grad(out, (qr, kr, vr), do)
        torch.cuda.synchronize()
        counts = flash_counts()
        err = max(tile_rel_err(grads[1], dk), tile_rel_err(grads[2], dv))
        log(f"D {D} bf16 [{B}, {S}, {H}, {D}] causal through "
            f"scaled_dot_product_attention: launches {counts}; dk / dv "
            f"against the direct kernel calls, worst tile {err:.3e}")
        require(all(counts[n] == 1 for n in FLASH_KERNELS)
                and counts["DENSE_MASK"] == counts["COMPOSED"] == 0,
                f"D {D}: a flash kernel did not launch once: {counts}")
        tol = FLASH_TOL[torch.bfloat16][1]
        require(err <= tol, f"D {D}: the registry op's dk / dv are {err} "
                f"off the direct calls' (tol {tol})")
        recs[f"D{D}_entry_launches"] = counts
        del q, k, v, do, qr, kr, vr, out, grads, dk, dv
        torch.cuda.empty_cache()
    q, do = (rnd(torch.bfloat16, B, S, H, 128) for _ in range(2))
    k, v = (rnd(torch.bfloat16, B, S, 4, 128) for _ in range(2))
    recs["llama_gqa"] = check_attn(
        f"(bf16) Llama GQA 16/4 q [{B}, {S}, {H}, 128] k / v [{B}, {S}, 4, "
        f"128] causal", q, k, v, do, True, {}, card=card,
        pairs=visible_pairs(S, S, True) * B * H)
    del q, k, v, do
    torch.cuda.empty_cache()
    scaled_dot_product_attention.COMPOSED = 0
    x = rnd(torch.bfloat16, 2, 128, 4, 320).requires_grad_(True)
    n = FA.flash_fwd.LAUNCHES
    out = scaled_dot_product_attention(x, x, x, is_causal=True)
    out.float().sum().backward()
    torch.cuda.synchronize()
    ref = _sdpa_reference(x.detach(), x.detach(), x.detach(), is_causal=True)
    log(f"D 320 through scaled_dot_product_attention: COMPOSED = "
        f"{scaled_dot_product_attention.COMPOSED}, flash launches "
        f"{FA.flash_fwd.LAUNCHES - n}, equal to _sdpa_reference "
        f"{torch.equal(out, ref)}, grad finite "
        f"{bool(torch.isfinite(x.grad.float()).all())}")
    require(scaled_dot_product_attention.COMPOSED == 1
            and FA.flash_fwd.LAUNCHES == n and torch.equal(out, ref)
            and bool(torch.isfinite(x.grad.float()).all()),
            "D 320 did not take the counted composed route")
    recs["composed_d320"] = scaled_dot_product_attention.COMPOSED
    return recs


def tiny_padded_bert_phase():
    """Phase 26: a tiny fp32 BERT with a 4-D bool mask over ragged lengths,
    dropout off: logits at the valid positions, the loss and every gradient
    on the card against the CPU."""
    cfg = TB.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout=0.0)
    rng = np.random.RandomState(26)
    lens = np.array([128, 97, 40, 71, 12, 128])
    ids = np.zeros((len(lens), 128), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 512, n)
    valid = np.arange(128)[None, :] < lens[:, None]
    batch = dict(ids=ids, mask=valid[:, None, None, :] & valid[:, None, :,
                                                                 None],
                 mlm=np.where((rng.rand(*ids.shape) < 0.2) & valid,
                              rng.randint(0, 512, ids.shape), -100),
                 nsp=rng.randint(0, 2, (len(lens),)))

    def run(dev):
        """(loss, MLM logits, gradients, the launches of the loss and its
        gradients)."""
        model, params, buffers = bert_model(cfg, dev, torch.float32)
        t = padded_tensors(batch, dev)
        with torch.no_grad():
            (lm, _), _ = TNN.functional_call(model, params, buffers,
                                             t["ids"], **bert_layout(t))
        reset_bert_counts()
        loss, grads = bert_loss_and_grads(model, params, buffers, t)
        return loss, lm, grads, bert_counts()
    l_card, lm_card, g_card, counts = run(DEV)
    l_cpu, lm_cpu, g_cpu, _ = run("cpu")
    rel = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    real = torch.from_numpy(valid)
    lm_err = ((lm_card.cpu()[real] - lm_cpu[real]).abs().max()
              / lm_cpu[real].abs().max()).item()
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    worst = 0.0
    for n, g in g_cpu.items():
        err = (g_card[n].cpu() - g).abs().max().item() / max(
            g.abs().max().item(), 1e-3 * gmax)
        worst = max(worst, err)
    log(f"tiny padded BERT: loss card {l_card.item():.7f} cpu "
        f"{l_cpu.item():.7f} rel {rel:.2e} (tol 1e-5); logits at valid "
        f"positions max err / max {lm_err:.2e} (tol 2e-5); every gradient "
        f"max err / max(its max, 1e-3 of the largest) {worst:.2e} (tol "
        f"1e-4); card launches {counts}")
    require(rel <= 1e-5 and lm_err <= 2e-5 and worst <= 1e-4,
            "tiny padded BERT: card and CPU differ")
    require(counts["flash_fwd"] == cfg.num_layers
            and counts["flash_bwd_dq"] == cfg.num_layers
            and counts["flash_bwd_dkv"] == cfg.num_layers,
            f"tiny padded BERT: flash launches {counts}")
    return dict(loss_rel=rel, logits_rel=lm_err, grad_rel=worst)


def padded_train_phase(card):
    """Phase 27: BERT-base padded pretraining at bench_bert_base's size."""
    cfg = TB.BertConfig()
    model, params, buffers = bert_model(cfg)
    opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_state(params)
    batch = padded_batch(cfg.vocab_size)
    t = padded_tensors(batch, DEV)
    lens = batch["lens"].astype(np.int64)
    B, S = batch["ids"].shape
    t_real = int(lens.sum())
    emb = (cfg.vocab_size + cfg.max_position_embeddings
           + cfg.type_vocab_size) * cfg.hidden_size
    n_matmul = sum(p.numel() for p in params.values()) - emb
    flops = (6.0 * n_matmul * t_real + 12.0 * cfg.num_layers
             * cfg.hidden_size * float((lens ** 2).sum()))
    log(f"padded [{B}, {S}]: {t_real} real tokens of {B * S}; {flops:.4g} "
        f"useful FLOP per step (_bert_job's formula, {n_matmul} matmul "
        f"parameters)")
    L = cfg.num_layers

    def step():
        return bert_step(model, params, buffers, opt, state, t)
    want = dict(layer_norm_fwd=2 * L + 2, layer_norm_bwd=2 * L + 2,
                layer_norm_bwd_sums=2 * L + 2, flash_fwd=L, flash_bwd_dq=L,
                flash_bwd_dkv=L, fused_adam=77)
    rec = timed_steps(step, want, B * S, flops / (B * S), card,
                      "BERT-base padded", reset=reset_bert_counts,
                      read=bert_counts, collect=True)
    dt = rec["ms_per_step"] / 1e3
    rec.update(padded_tokens_per_s=B * S / dt, real_tokens_per_s=t_real / dt,
               median_real_tokens_per_s=t_real / (rec["median_step_ms"] / 1e3),
               real_tokens=t_real, useful_flops=flops)
    log(f"BERT-base padded: {B * S / dt:.1f} padded tokens/s (the bench's "
        f"metric), {t_real / dt:.1f} real tokens/s; median step "
        f"{rec['median_step_ms']:.2f} ms, "
        f"{rec['median_real_tokens_per_s']:.1f} real tokens/s  [{card}]")
    rec.update(profile_train_step(step, card, classify=_kernel_class_bert))
    del params, state, opt, model
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 28-30: the flashmask rows and the sliding window (flashmask_attention)
# ---------------------------------------------------------------------------
# phase 29's two cells at bench_llama's attention width (16 query heads and 4
# kv heads of 128, bf16): (a) a causal document mask, (b) a sliding window
FM_DOC = dict(B=8, S=1024, lo=64, hi=513)
FM_WINDOW = dict(B=2, S=4096, w=1024)
FM_H, FM_HKV, FM_D = 16, 4, 128
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def doc_rows(B, S, rng, lo, hi):
    """A causal document mask as C = 1 flashmask rows, int32 [B, 1, S]:
    each row packed with document lengths rng.randint(lo, hi) until its S
    positions are full (the last cut to fit); start[j] = the end of the
    document that holds key j, so a query sees its own document's keys up
    to itself."""
    rows = np.zeros((B, 1, S), np.int32)
    for b in range(B):
        pos = 0
        while pos < S:
            n = min(int(rng.randint(lo, hi)), S - pos)
            rows[b, 0, pos:pos + n] = pos + n
            pos += n
    return rows


def band_rows(B, hm, Sk, Sq, rng, width=64):
    """Random C = 2 rows: start in [0, Sq), end = start + [1, width)."""
    start = rng.randint(0, Sq, size=(B, hm, Sk))
    end = np.minimum(start + rng.randint(1, width, size=start.shape), Sq)
    return start.astype(np.int32), end.astype(np.int32)


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_tiles(name, var, D):
    """(query rows, keys, key-major) of the tiles the bf16 kernel `name`
    walks at head dim D with the variant `var`, as the built library
    reports them (FA.kernel_plan)."""
    plan = FA.kernel_plan(name, D, torch.bfloat16,
                          bias=var.get("bias") is not None)
    return plan["query_rows"], plan["keys"], plan["key_major"]


def tile_shares(Sq, Sk, causal, window, fm=None, bq=64, bk=64,
                key_major=False):
    """The tiles a kernel runs, counted on the host with its rules written
    in numpy (flash_hopper.cuh blk_key_begin / blk_key_end for a
    query-major kernel of bq-row blocks over bk-key tiles, flash_common.cuh
    query_begin / query_end for the key-major dK/dV, and the flashmask skip:
    a tile is skipped when max start <= q0 and min end >= min(q0 + bq,
    Sq)), summed over the rows' (batch, mask head) slabs, against the tiles
    the causal bound alone runs at the same tile sizes. Returns (tiles run,
    causal tiles)."""
    left, right = FA._norm_window(window) or (None, None)
    lo = -left if left is not None else -2 ** 30
    hi = right if right is not None else 2 ** 30
    if causal:
        hi = min(hi, 0)
    off, nq, nk = Sk - Sq, -(-Sq // bq), -(-Sk // bk)
    q0, k0 = np.arange(nq) * bq, np.arange(nk) * bk

    def band(lo, hi):   # [nq, nk]: tile (query block, key tile) walked
        if key_major:
            qfirst = k0 - off - hi
            qb = np.where(qfirst <= 0, 0, qfirst // bq * bq)
            qe = np.clip(k0 + bk - off - lo, 0, Sq)
            return (q0[:, None] >= qb[None]) & (q0[:, None] < qe[None])
        first = q0 + off + lo
        kb = np.where(first <= 0, 0, first // bk * bk)
        ke = np.clip(q0 + bq + off + hi, 0, Sk)
        return (k0[None] >= kb[:, None]) & (k0[None] < ke[:, None])
    run, causal_band = band(lo, hi), band(-2 ** 30, 0)
    if fm is None:
        return int(run.sum()), int(causal_band.sum())
    start, end = (t.cpu().numpy() for t in fm)
    B, hm, _ = start.shape
    pad = ((0, 0), (0, 0), (0, nk * bk - Sk))
    mx = np.pad(start, pad, constant_values=INT32_MIN).reshape(
        B, hm, nk, bk).max(-1)
    mn = np.pad(end, pad, constant_values=INT32_MAX).reshape(
        B, hm, nk, bk).min(-1)
    qn = np.minimum(q0 + bq, Sq)
    masked = (mx[:, :, None, :] <= q0[:, None]) & (
        mn[:, :, None, :] >= qn[:, None])
    return int((run & ~masked).sum()), int(causal_band.sum()) * B * hm


def fm_pairs(q, k, causal, var):
    """Visible (query, key) pairs over all heads under the rows and the
    window (the mask is [Sq, Sk], or [B, H_mask, Sq, Sk] with rows)."""
    vis = FA._visible(q.shape[1], k.shape[1], causal, q.device,
                      fm=var.get("fm"), window=var.get("window"))
    B, H = q.shape[0], q.shape[2]
    n = int(vis.sum().item())
    return n * B * H if vis.dim() == 2 else n * (H // vis.shape[1])


def fm_forms(dtype, D, gen, rng):
    """(name, q, k, v, dO, causal, variant) of every form at B 2, S 256,
    GQA 4 / 2 (and Sq 128 / Sk 256)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    B, S, H, Hkv = 2, 256, 4, 2
    q, do, k, v = (rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, Hkv, D),
                   rnd(B, S, Hkv, D))
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    doc = dev(doc_rows(B, S, rng, 16, 97))
    full = torch.full_like(doc, S)
    st, en = (dev(a) for a in band_rows(B, H, S, S, rng))
    seg = dev(np.repeat(np.arange(4), [60, 70, 90, 36])[None].repeat(B, 0)
              .astype(np.int32))
    rs, re_ = (dev(a) for a in band_rows(B, 1, S, 128, rng, 40))
    dead = torch.arange(S, device=DEV, dtype=torch.int32).expand(
        B, 1, S).contiguous()
    return [
        ("C=1 causal (a document mask)", q, k, v, do, True,
         dict(fm=(doc, full))),
        ("C=2 causal H_mask 1", q, k, v, do, True,
         dict(fm=(st[:, :1], en[:, :1]))),
        ("C=2 causal H_mask H", q, k, v, do, True, dict(fm=(st, en))),
        ("window 96 causal", q, k, v, do, True, dict(window=(96, None))),
        ("window 96 not causal", q, k, v, do, False,
         dict(window=(96, None))),
        ("window (40, 24) not causal", q, k, v, do, False,
         dict(window=(40, 24))),
        ("rows + window 80", q, k, v, do, True,
         dict(fm=(doc, full), window=(80, None))),
        ("rows + bias", q, k, v, do, True,
         dict(fm=(st, en), bias=rnd(B, 1, S, S))),
        ("rows + segments", q, k, v, do, True,
         dict(fm=(st[:, :1], en[:, :1]), q_seg=seg, kv_seg=seg)),
        ("rows + dropout 0.1", q, k, v, do, True,
         dict(fm=(doc, full), dropout_p=0.1, seed=2 ** 33 + 7)),
        ("rows + window, sq 128 sk 256", q[:, :128], k, v, do[:, :128], True,
         dict(fm=(rs, re_), window=(48, None))),
        ("dead rows (start[j] = j)", q, k, v, do, True,
         dict(fm=(dead, full)))]


def fm_dropout_bits_check():
    """With the rows and a window the three kernels still draw
    dropout_keep_mask: q = k = 0 makes every visible probability equal,
    v = I reads the dropped row out of the forward and dO = I reads it out
    of dK/dV's dV; both equal the plain keep-mask on the visible pairs bit
    for bit (dQ draws the same words: the rows + dropout form holds its dq
    to the plain one)."""
    B, S, H, p, seed = 2, 128, 2, 0.1, 2 ** 40 + 777
    fm = (torch.from_numpy(doc_rows(B, S, np.random.RandomState(5), 16, 49))
          .to(DEV), torch.full((B, 1, S), S, dtype=torch.int32, device=DEV))
    var = dict(fm=fm, window=(70, None), dropout_p=p, seed=seed)
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(B, S, H, S, device=DEV, dtype=dtype)
        eye = torch.eye(S, device=DEV, dtype=dtype)[None, :, None, :].expand(
            B, S, H, S).contiguous()
        out, lse = FA.flash_fwd(z, z, eye, True, 1.0, **var)
        _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                                 True, 1.0, **var)
        keep = FA.dropout_keep_mask(seed, B, H, S, S, p, DEV) & FA._visible(
            S, S, True, DEV, fm=fm, window=(70, None))
        fwd_ok = torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
        dkv_ok = torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)
        log(f"Philox masks with rows and a window ({dtype}): forward kernel "
            f"== plain {fwd_ok}, dK/dV kernel == plain {dkv_ok}")
        require(fwd_ok and dkv_ok, "with rows and a window, the CUDA and "
                "torch Philox masks differ")


def flashmask_forms_phase():
    """Phase 28: every form of the rows and the window against the plain
    versions at D 64, 128, 256 in fp32, bf16 and fp16 (untimed), the d-bias
    with rows, the Philox mask with rows and a window; the share of the
    causal tiles each mask runs."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(28)
    rng = np.random.RandomState(28)
    worst, shares = {}, {}
    for D in (64, 128, 256):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for name, q, k, v, do, causal, var in fm_forms(dtype, D, gen,
                                                           rng):
                rec = check_attn(f"D {D} {str(dtype)[6:]} {name}", q, k, v,
                                 do, causal, var)
                key = f"{D}_{str(dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), *(
                    rec[w + "_tile"] for w in ("out", "dq", "dk", "dv")))
                if name.startswith("dead"):
                    require(rec["dead_rows"] == q.shape[0] * q.shape[1]
                            * q.shape[2], "dead rows: a row saw a key")
                if D == 64 and dtype == torch.bfloat16:
                    shares[name] = {}
                    for kname in FLASH_KERNELS:
                        run, c = tile_shares(q.shape[1], k.shape[1], causal,
                                             var.get("window"),
                                             var.get("fm"),
                                             *flash_tiles(kname, var, D))
                        shares[name][kname] = dict(share=run / c, causal=c)
    for dtype in (torch.bfloat16, torch.float32):
        name, q, k, v, do, causal, var = fm_forms(dtype, 64, gen, rng)[7]
        rec = check_attn(f"({str(dtype)[6:]}) d-bias with {name}", q, k, v,
                         do, causal, var, bias_grad=True)
        worst[f"dbias_{str(dtype)[6:]}"] = rec["dbias_l2"]
    fm_dropout_bits_check()
    for name, sh in shares.items():
        log(f"tiles run ({name}), of the causal tiles at each kernel's tile "
            f"sizes: " + ", ".join(
                f"{kname} {r['share']:.1%} of {r['causal']}"
                for kname, r in sh.items()))
    log(f"worst tile L2 rel err per D and dtype: {worst}")
    torch.cuda.empty_cache()
    return {"worst_tile": worst, "tile_shares": shares}


def time_flash(q, k, v, do, causal, var):
    """{kernel: ms} of the three kernels (CUDA events, median, cold L2)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    _, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    _, delta = FA.flash_bwd_dq(q, k, v, lse, do, causal, scale, **var)
    return {"flash_fwd": cuda_ms(lambda: FA.flash_fwd(q, k, v, causal, scale,
                                                      **fwd)),
            "flash_bwd_dq": cuda_ms(lambda: FA.flash_bwd_dq(
                q, k, v, lse, do, causal, scale, **var)),
            "flash_bwd_dkv": cuda_ms(lambda: FA.flash_bwd_dkv(
                q, k, v, lse, delta, do, causal, scale, **var))}


def fm_cell(cell):
    """q, k, v, dO (bf16, seeded) and the variant of phase 29's cell."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(29)
    if cell == "doc":
        B, S = FM_DOC["B"], FM_DOC["S"]
        rows = torch.from_numpy(doc_rows(
            B, S, np.random.RandomState(0), FM_DOC["lo"], FM_DOC["hi"]))
        var = dict(fm=(rows.to(DEV), torch.full_like(rows, S).to(DEV)))
    else:
        B, S = FM_WINDOW["B"], FM_WINDOW["S"]
        var = dict(window=(FM_WINDOW["w"], None))
    q, do = (torch.randn(B, S, FM_H, FM_D, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, FM_HKV, FM_D, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(2))
    return q, k, v, do, var


def flashmask_timed_phase(card):
    """Phase 29: (a) the causal document mask and (b) the sliding window at
    bench_llama's attention width, bf16: each kernel against its bound, the
    plain version, SDPA on the same dense bool mask and the port's own
    kernels on that mask as a bias (the route a dense mask takes); the
    causal call at the same shape and the share of its tiles each mask
    runs."""
    recs = {}
    for cell, title in (("doc", "(a) causal document mask"),
                        ("window", "(b) causal sliding window 1024")):
        q, k, v, do, var = fm_cell(cell)
        B, S = q.shape[:2]
        pairs = fm_pairs(q, k, True, var)
        causal_pairs = visible_pairs(S, S, True) * B * FM_H
        log(f"{title}: q {list(q.shape)}, k / v {list(k.shape)}; {pairs} "
            f"visible pairs ({pairs / (B * FM_H):.1f} a head, "
            f"{pairs / causal_pairs:.1%} of causal)")
        rec = check_attn(f"(bf16) {title}", q, k, v, do, True, var,
                         card=card, pairs=pairs)
        causal_ms = time_flash(q, k, v, do, True, {})
        vis = FA._visible(S, S, True, DEV, fm=var.get("fm"),
                          window=var.get("window"))
        bias = torch.where(vis, 0.0, -1e30).to(torch.bfloat16)
        bias = bias[:, :1] if bias.dim() == 4 else bias[None, None]
        dense_ms = time_flash(q, k, v, do, False, dict(bias=bias))
        for name in FLASH_KERNELS:
            run, c = tile_shares(S, S, True, var.get("window"),
                                 var.get("fm"), *flash_tiles(name, var, FM_D))
            share = run / c
            r = rec[name]
            r.update(causal_ms=causal_ms[name], dense_bias_ms=dense_ms[name],
                     tile_share=share,
                     ms_share_of_causal=r["ms"] / causal_ms[name])
            log(f"{title} {name}: {r['ms']:.4f} ms = "
                f"{r['ms_share_of_causal']:.1%} of the causal call's "
                f"{causal_ms[name]:.4f} ms, running {share:.1%} of its {c} "
                f"tiles; SDPA on the dense mask {r['library_ms']:.4f} ms; "
                f"the port's kernels on it as a bias {dense_ms[name]:.4f} "
                f"ms  [{card}]")
        recs[cell] = rec
        del q, k, v, do, var, vis, bias
        torch.cuda.empty_cache()
    return recs


def reset_flash_counts():
    for fn in (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv):
        fn.LAUNCHES = 0
    TF.flashmask_attention.DENSE_MASK = 0
    scaled_dot_product_attention.COMPOSED = 0


def flash_counts():
    return {"flash_fwd": FA.flash_fwd.LAUNCHES,
            "flash_bwd_dq": FA.flash_bwd_dq.LAUNCHES,
            "flash_bwd_dkv": FA.flash_bwd_dkv.LAUNCHES,
            "DENSE_MASK": TF.flashmask_attention.DENSE_MASK,
            "COMPOSED": scaled_dot_product_attention.COMPOSED}


def flashmask_call(q, k, v, do, idx, causal, w):
    """out and the q / k / v gradients of flashmask_attention through
    autograd."""
    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = TF.flashmask_attention(*ts, idx, causal=causal, window_size=w)[0]
    return [out.detach()] + list(torch.autograd.grad(out, ts, do))


def flashmask_entry_phase(card):
    """Phase 30: nn.functional.flashmask_attention, forward and backward
    through autograd, on (a) and (b) with exact launch counts, against the
    plain path at full width; a tiny fp32 case card vs CPU; the
    bidirectional forms through the counted dense-mask route; the kernels
    without rows or window re-timed at the GPT flagship and packed BERT
    calls."""
    recs = {}
    for cell, w in (("doc", None), ("window", FM_WINDOW["w"])):
        q, k, v, do, var = fm_cell(cell)
        idx = var["fm"][0][..., None] if "fm" in var else None
        reset_flash_counts()
        got = flashmask_call(q, k, v, do, idx, True, w)
        torch.cuda.synchronize()
        counts = flash_counts()
        log(f"({cell}) flashmask_attention forward + backward: launches "
            f"{counts}")
        require(counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1, "DENSE_MASK": 0,
                           "COMPOSED": 0}, f"({cell}) launch counts {counts}")
        scale = 1.0 / math.sqrt(FM_D)
        out_p, lse_p = FA.flash_fwd_plain(q, k, v, True, scale, **var)
        ref = [out_p] + list(FA.flash_bwd_plain(q, k, v, lse_p, do, True,
                                                scale, **var))
        tiles = {n: tile_rel_err(a, b) for n, a, b in
                 zip(("out", "dq", "dk", "dv"), got, ref)}
        log(f"({cell}) kernel path vs plain path, worst tile L2 rel err "
            f"{tiles} (tol {FLASH_TOL[torch.bfloat16][0]})")
        require(max(tiles.values()) <= FLASH_TOL[torch.bfloat16][0] and all(
            torch.isfinite(t.float()).all() for t in got),
            f"({cell}) kernel path vs plain path")
        recs[cell] = dict(launches=counts, tile_rel_err=tiles)
        del q, k, v, do, got, ref, out_p, lse_p
        torch.cuda.empty_cache()
    # a tiny fp32 case, card vs CPU, and the dense-mask route
    gen = torch.Generator().manual_seed(30)
    B, S, H, Hkv, D = 2, 192, 4, 2, 32
    host = [torch.randn(B, S, h, D, generator=gen) for h in (H, Hkv, Hkv)]
    do = torch.randn(B, S, H, D, generator=gen)
    rng = np.random.RandomState(30)
    doc = torch.from_numpy(doc_rows(B, S, rng, 16, 97))[..., None]
    r1 = rng.randint(0, S, size=(B, H, S, 1))
    c2 = np.concatenate([r1, np.minimum(r1 + 30, S)], -1).astype(np.int32)
    c4 = np.concatenate([c2, c2[..., ::-1]], -1).copy()
    worst = 0.0
    for name, idx, causal, w in (
            ("C=1 causal", doc, True, None),
            ("C=2 causal window 50", torch.from_numpy(c2), True, 50),
            ("window 64", None, True, 64),
            ("C=2 bidirectional", torch.from_numpy(c2), False, None),
            ("C=4 bidirectional window 40", torch.from_numpy(c4), False,
             40)):
        cpu = flashmask_call(*host, do, idx, causal, w)
        reset_flash_counts()
        dev = flashmask_call(*(t.to(DEV) for t in host), do.to(DEV),
                             None if idx is None else idx.to(DEV), causal, w)
        torch.cuda.synchronize()
        counts = flash_counts()
        dense = idx is not None and not causal
        require(counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1, "DENSE_MASK": int(dense),
                           "COMPOSED": 0}, f"tiny {name}: counts {counts}")
        err = max(_rel_err(a.cpu(), b)[1] for a, b in zip(dev, cpu))
        worst = max(worst, err)
        log(f"tiny fp32 {name}: card vs CPU max rel err {err:.3e} (out, "
            f"dq, dk, dv); launches {counts}"
            f"{' (the dense mask into the bias kernels)' if dense else ''}")
        require(err <= 1e-4, f"tiny fp32 {name}: card vs CPU {err}")
    recs["tiny_card_vs_cpu"] = worst
    # the kernels without rows or window at earlier calls, re-timed
    q, k, v, do = flash_case(TRAIN["batch"], TRAIN["seq"], TRAIN["seq"],
                             FULL["num_heads"], FULL["num_heads"], 128,
                             torch.bfloat16, seed=2 * TRAIN["seq"] + 16)
    recs["gpt_flagship"] = time_flash(q, k, v, do, True, {})
    del q, k, v, do
    cfg = TB.BertConfig()
    seg = torch.from_numpy(bert_batch(BERT_SEQS[0], cfg.vocab_size)["seg"]
                           ).to(DEV)
    Bp, Sp = seg.shape
    gen = torch.Generator(device=DEV)
    gen.manual_seed(16)
    q, k, v, do = (torch.randn(Bp, Sp, cfg.num_heads, 64, generator=gen,
                               device=DEV).to(torch.bfloat16)
                   for _ in range(4))
    recs["bert_packed"] = time_flash(q, k, v, do, False, dict(
        q_seg=seg, kv_seg=seg, dropout_p=0.1, seed=1235))
    for tag in ("gpt_flagship", "bert_packed"):
        now = recs[tag]
        log(f"no rows, no window, {tag}: forward / dQ / dK/dV "
            f"{now['flash_fwd']:.4f} / {now['flash_bwd_dq']:.4f} / "
            f"{now['flash_bwd_dkv']:.4f} ms  [{card}]")
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 31-32: the tile primitives, and fp16 in the norm, RoPE, Adam and
# paged attention kernels
# ---------------------------------------------------------------------------
# kernel vs plain: max-abs err / max-abs ref; bf16 / fp16 one rounding of the
# output, fp32 (the row sums, dg / db) sums in another order
PRIM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# a generated primitive's call traces fn on the host (a few ms) before its
# launch: a device-side sleep of ~50 ms holds the stream past it, so the
# events bracket the kernel alone
PRIM_SLEEP_CYCLES = 100_000_000
KPS_LN_FLOPS = {"fwd": 8, "bwd": 12}           # per element


def gelu_tanh_by_hand(x):
    """The GPT FFN activation as a user writes it for ``elementwise``."""
    return 0.5 * x * (1 + torch.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


def mul_add(a, b):
    return a * b + 1.0


def cold_build(src):
    """Build one generated source alone; (cold nvcc seconds, or None when
    an earlier run of this checkout left it built; ptxas lines)."""
    from paddle_tpu_torch.kernels import _build
    path = _build.build_generated(src)
    rec = _build.GEN_LOG[str(path)]
    lines = [ln.strip() for ln in rec["output"].splitlines()
             if any(w in ln for w in ("registers", "spill", "error",
                                      "warning"))]
    return None if rec["cached"] else rec["seconds"], lines


def host_overhead_ms(call, n=20):
    """Median host time of a warm primitive's work before its launch: the
    trace of fn, the source text and the cache lookup."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        call()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def prim_rec(name, err, kern, plain, lib, nbytes, flops, card, lib_name):
    bound, by = row_bound(nbytes, flops)
    log(f"{name}: kernel_ms {kern:.4f} plain_ms {plain:.4f} library_ms "
        + (f"{lib:.4f} ({lib_name})" if lib is not None else "none")
        + f" bound_ms {bound:.4f} ({by}: {nbytes} B, {flops} FLOP) "
        f"kernel/bound {kern / bound:.1f}x max_abs_err {err:.3e}  [{card}]")
    return dict(max_abs_err=err, ms=kern, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def primitives_phase(card):
    from paddle_tpu_torch.kernels import _codegen as CG
    from paddle_tpu_torch.kernels import primitives as PR
    F_ = torch.nn.functional
    gen = torch.Generator(device=DEV)
    gen.manual_seed(31)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=DEV) * scale
                + shift).to(dtype)
    R, H = TRAIN["batch"] * TRAIN["seq"], FULL["hidden_size"]
    x_ffn = rnd(R, 4 * H)                               # [8192, 8192]
    a, b = rnd(R, H), rnd(R, H)                         # [8192, 2048]
    logits = rnd(R, LLAMA["vocab_size"], scale=4.0)     # [8192, 32000]
    ew = {"gelu_tanh": (gelu_tanh_by_hand, [x_ffn]), "mul_add": (mul_add,
                                                                 [a, b])}
    red = {"sum": (torch.add, 0.0), "max": (torch.maximum, -math.inf)}
    ln_cases = {}
    for tag, h in (("bert", TB.BertConfig().hidden_size), ("flagship", H)):
        ln_cases[tag] = (rnd(R, h, scale=3.0, shift=1.0),
                         rnd(h, dtype=torch.float32, scale=0.5, shift=1.0),
                         rnd(h, dtype=torch.float32, scale=0.1),
                         rnd(R, h))

    # 1. each generated kernel built alone, cold
    builds, srcs = {}, {}
    for name, (fn, xs) in ew.items():
        srcs[name] = lambda fn=fn, xs=xs: CG.elementwise_source(
            CG.trace(fn, len(xs)), [x.dtype for x in xs], xs[0].dtype)
    for name, (fn, ident) in red.items():
        srcs[name] = lambda fn=fn, ident=ident: CG.row_reduce_source(
            CG.trace(fn, 2), ident, logits.dtype)
    for name, make in srcs.items():
        secs, lines = cold_build(make())
        builds[name] = secs
        log(f"generated {name}: "
            + (f"cold nvcc {secs:.2f} s; " if secs is not None
               else "built by an earlier run of this checkout; ")
            + "; ".join(lines))

    # 2. the main path: one call of each primitive through its public entry
    PR.elementwise.LAUNCHES = PR.row_reduce.LAUNCHES = 0
    PR.ln_fwd.LAUNCHES = PR.ln_bwd.LAUNCHES = 0
    outs = {name: PR.elementwise(fn, *xs) for name, (fn, xs) in ew.items()}
    outs.update({name: PR.row_reduce(fn, ident, logits)
                 for name, (fn, ident) in red.items()})
    for tag, (x, g, bb, dy) in ln_cases.items():
        leaves = [t.clone().requires_grad_(True) for t in (x, g, bb)]
        y = PR.layer_norm(*leaves, 1e-5)
        outs[tag] = (y.detach(), torch.autograd.grad(y, leaves, dy))
    torch.cuda.synchronize()
    launches = {"elementwise": PR.elementwise.LAUNCHES,
                "row_reduce": PR.row_reduce.LAUNCHES,
                "ln_fwd": PR.ln_fwd.LAUNCHES, "ln_bwd": PR.ln_bwd.LAUNCHES}
    log(f"main path (2 elementwise, 2 row_reduce, 2 layer_norm forward and "
        f"backward calls): launches {launches}")
    require(launches == {"elementwise": 2, "row_reduce": 2, "ln_fwd": 2,
                         "ln_bwd": 2}, f"primitive launches {launches}")

    # 3. each held to its plain version
    errs = {}

    def hold(what, got, ref):
        require(got.dtype == ref.dtype and got.shape == ref.shape,
                f"{what}: {got.dtype} {tuple(got.shape)} vs {ref.dtype} "
                f"{tuple(ref.shape)}")
        require(torch.isfinite(got.float()).all(), f"{what}: not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        tol = PRIM_TOL[got.dtype]
        require(rel <= tol, f"{what}: rel err {rel} > {tol}")
        log(f"{what}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol})")
        errs[what] = err
    for name, (fn, xs) in ew.items():
        hold(name, outs[name], PR.elementwise_plain(fn, xs, xs[0].dtype))
    for name, (fn, ident) in red.items():
        hold(name, outs[name], PR.row_reduce_plain(fn, ident, logits))
    stats = {}
    for tag, (x, g, bb, dy) in ln_cases.items():
        y_p, mu_p, rstd_p = PR.ln_fwd_plain(x, g, bb, 1e-5)
        dx_p, dg_p, db_p = PR.ln_bwd_plain(x, g, mu_p, rstd_p, dy)
        y, (dx, dg, db) = outs[tag]
        for what, got, ref in (("y", y, y_p), ("dx", dx, dx_p),
                               ("dg", dg, dg_p), ("db", db, db_p)):
            hold(f"layer_norm {tag} {what}", got, ref)
        # dg / db bit for bit across two calls, one launch each
        _, mu, rstd = PR.ln_fwd(x, g, bb, 1e-5)
        n = PR.ln_bwd.LAUNCHES
        first = PR.ln_bwd(x, g, mu, rstd, dy)
        second = PR.ln_bwd(x, g, mu, rstd, dy)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(first[1:], second[1:]))
        log(f"layer_norm {tag} backward twice: dg / db bit-identical {same}, "
            f"launches +{PR.ln_bwd.LAUNCHES - n}")
        require(same and PR.ln_bwd.LAUNCHES == n + 2,
                f"layer_norm {tag}: dg / db differ across calls or launches")
        stats[tag] = (mu, rstd)

    # 4. timed against bound, plain and one library call
    recs = {"launches": launches, "cold_nvcc_s": builds}
    one = torch.ones((), dtype=a.dtype, device=DEV)
    lib_mul_add = torch.addcmul(one, a, b)
    lib_err, lib_rel = _rel_err(lib_mul_add, outs["mul_add"])
    log(f"torch.addcmul(one, a, b) against the generated a * b + 1: "
        f"max_abs_err {lib_err:.3e} rel {lib_rel:.3e}")
    require(lib_mul_add.shape == a.shape and lib_rel <= PRIM_TOL[a.dtype],
            "the addcmul yardstick does not compute a * b + 1")
    del lib_mul_add
    for name, (fn, xs) in ew.items():
        kern = cuda_ms(lambda: PR.elementwise(fn, *xs),
                       sleep=PRIM_SLEEP_CYCLES)
        plain = cuda_ms(lambda: PR.elementwise_plain(fn, xs, xs[0].dtype))
        # one PyTorch call each: the tanh GELU; a * b + 1 as addcmul of a
        # 0-d one (rounded once, as the generated kernel)
        lib = (cuda_ms(lambda: F_.gelu(xs[0], approximate="tanh"))
               if name == "gelu_tanh" else
               cuda_ms(lambda: torch.addcmul(one, xs[0], xs[1])))
        n_ops = len(CG.trace(fn, len(xs)).nodes)
        nbytes = sum(x.numel() * x.element_size() for x in xs) \
            + xs[0].numel() * xs[0].element_size()
        recs[name] = prim_rec(f"elementwise {name} {tuple(xs[0].shape)} "
                              f"bf16", errs[name], kern, plain, lib, nbytes,
                              n_ops * xs[0].numel(), card,
                              "F.gelu(approximate='tanh')"
                              if name == "gelu_tanh" else
                              "torch.addcmul(one, a, b), one 0-d")
        recs[name]["host_overhead_ms"] = host_overhead_ms(
            lambda: CG.library(srcs[name]()))
        log(f"elementwise {name}: a warm call's host work (trace, source, "
            f"cache lookup) {recs[name]['host_overhead_ms']:.3f} ms")
    libs = {"sum": (lambda: logits.sum(-1, dtype=torch.float32),
                    "x.sum(-1, dtype=torch.float32)"),
            "max": (lambda: logits.amax(-1).float(), "x.amax(-1).float()")}
    for name, (fn, ident) in red.items():
        kern = cuda_ms(lambda: PR.row_reduce(fn, ident, logits),
                       sleep=PRIM_SLEEP_CYCLES)
        plain = cuda_ms(lambda: PR.row_reduce_plain(fn, ident, logits),
                        runs=10)
        lib = cuda_ms(libs[name][0])
        recs[name] = prim_rec(f"row_reduce {name} {tuple(logits.shape)} "
                              f"bf16", errs[name], kern, plain, lib,
                              logits.numel() * 2 + R * 4, logits.numel(),
                              card, libs[name][1])
        recs[name]["host_overhead_ms"] = host_overhead_ms(
            lambda: CG.library(srcs[name]()))
    for tag, (x, g, bb, dy) in ln_cases.items():
        h = x.shape[1]
        mu, rstd = stats[tag]
        gl, bl = g.to(x.dtype), bb.to(x.dtype)
        xl, gll, bll = (t.clone().requires_grad_(True) for t in (x, gl, bl))
        yl = F_.layer_norm(xl, (h,), gll, bll, 1e-5)
        fwd = prim_rec(
            f"layer_norm {tag} forward {tuple(x.shape)} bf16",
            errs[f"layer_norm {tag} y"],
            cuda_ms(lambda: PR.ln_fwd(x, g, bb, 1e-5)),
            cuda_ms(lambda: PR.ln_fwd_plain(x, g, bb, 1e-5)),
            cuda_ms(lambda: F_.layer_norm(x, (h,), gl, bl, 1e-5)),
            2 * x.numel() * 2 + 2 * h * 4 + 8 * R,
            KPS_LN_FLOPS["fwd"] * x.numel(), card, "F.layer_norm")
        bwd = prim_rec(
            f"layer_norm {tag} backward (dx, dg, db) {tuple(x.shape)} bf16",
            errs[f"layer_norm {tag} dx"],
            cuda_ms(lambda: PR.ln_bwd(x, g, mu, rstd, dy)),
            cuda_ms(lambda: PR.ln_bwd_plain(x, g, mu, rstd, dy)),
            cuda_ms(lambda: torch.autograd.grad(yl, (xl, gll, bll), dy,
                                                retain_graph=True)),
            3 * x.numel() * 2 + h * 4 + 8 * R + 2 * h * 4,
            KPS_LN_FLOPS["bwd"] * x.numel(), card,
            "autograd of F.layer_norm: dx, dw, db")
        # the backward is the ported LayerNorm's (PERF.md row 8): dx, dw and
        # db in one cooperative launch, so row 8's route time is its own
        bwd["row8_route_ms"] = bwd["ms"]
        bwd["dg_db_max_abs_err"] = max(errs[f"layer_norm {tag} dg"],
                                       errs[f"layer_norm {tag} db"])
        fplan, bplan = LN.fwd_plan(x, g, bb), LN.bwd_plan(x, g, dy)
        fwd.update(path=fplan["path"], blocks=fplan["blocks"])
        bwd.update(path=bplan["path"], blocks=bplan["blocks"])
        log(f"layer_norm {tag}: the forward on {fplan['path']} "
            f"({fplan['blocks']} blocks), the backward on row 8's kernel, "
            f"{bplan['path']} ({bplan['blocks']} blocks)")
        recs[f"ln_fwd_{tag}"], recs[f"ln_bwd_{tag}"] = fwd, bwd
    del x_ffn, a, b, logits, outs, ln_cases
    torch.cuda.empty_cache()
    return recs


def fp16_phase(card):
    """fp16 through the kernels the JAX gates admit it to, each against its
    plain version, with the launches that show the kernel ran; the main
    shapes timed beside their bf16 readings (phases 3, 7, 10, 15, 19, 20)."""
    h16 = torch.float16
    recs = {}
    rows_16 = bert_batch(BERT_SEQS[0], 8)["ids"].shape[0] * BERT_SEQ
    n = (LN.layer_norm_fwd.LAUNCHES, LN.layer_norm_bwd.LAUNCHES)
    recs["layer_norm"] = check_ln_case(
        f"(fp16) rows {rows_16} x 768, eps 1e-12, bias", rows_16, 768, h16,
        1e-12, True, card)
    check_ln_case("(fp16) rows 13 x 100 (no 16-byte words)", 13, 100, h16,
                  1e-5, False)
    require(LN.layer_norm_fwd.LAUNCHES > n[0]
            and LN.layer_norm_bwd.LAUNCHES > n[1], "fp16 LayerNorm launches")
    R, H = LLAMA_BATCH * LLAMA_SEQ, LLAMA["hidden_size"]
    n = (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd.LAUNCHES)
    recs["rms_norm"] = check_rms_case(f"(fp16) rows {R} x {H}, eps 1e-5", R,
                                      H, h16, 1e-5, card)
    check_rms_case("(fp16) rows 37 x 4095, eps 1e-6", 37, 4095, h16, 1e-6)
    require(RN.rms_norm_fwd.LAUNCHES > n[0]
            and RN.rms_norm_bwd.LAUNCHES > n[1], "fp16 RMSNorm launches")

    cfg = TL.LlamaConfig(**LLAMA)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(32)
    q = torch.randn(LLAMA_BATCH, LLAMA_SEQ, cfg.num_heads, cfg.head_dim,
                    generator=gen, device=DEV).to(h16)
    cos, sin = TL.rope_tables(cfg, LLAMA_SEQ, DEV)
    n = RP.rope.LAUNCHES
    errs = check_rope_case(f"(fp16) q {tuple(q.shape)}", q, cos, sin)
    require(RP.rope.LAUNCHES == n + 2, "fp16 rope launches")
    bound, by, nbytes, flops = rope_bound(q)
    kern = cuda_ms(lambda: RP.rope(q, cos, sin))
    log(f"rope q {tuple(q.shape)} fp16: kernel_ms {kern:.4f} bound_ms "
        f"{bound:.4f} ({by})  [{card}]")
    recs["rope"] = dict(max_abs_err=errs[0], ms=kern, bound_ms=bound,
                        bound_by=by)
    del q

    # Adam: the 9 flagship leaves in fp16 (p, g, moments), then a bf16 leaf
    # with an fp32 gradient and an fp32 leaf with an fp16 gradient
    shapes = [s for _, s in flagship_shapes() if FAD.supported(
        torch.empty(s, device="meta"), torch.empty(s, device="meta"),
        {"moment1": torch.empty(s, device="meta"),
         "moment2": torch.empty(s, device="meta")})]

    def leaf(s, pdt, gdt, mdt):
        t = lambda sc, dt: (torch.randn(s, generator=gen, device=DEV)
                            * sc).to(dt)
        return t(0.02, pdt), t(1e-3, gdt), {"moment1": t(1e-3, mdt),
                                            "moment2": t(1e-2, mdt).square()}
    leaves = [leaf(s, h16, h16, h16) for s in shapes]
    worst = 0.0
    n = FAD.adam_update.LAUNCHES
    mixed = [leaf(shapes[1], torch.bfloat16, torch.float32, torch.bfloat16),
             leaf(shapes[1], torch.float32, h16, torch.float32)]
    for p, g, slot in leaves + mixed:
        kp, ks = p.clone(), {k: v.clone() for k, v in slot.items()}
        FAD.adam_update(kp, g, ks, 1e-4, 1, None, **ADAM)
        FAD.adam_update_plain(p, g, slot, 1e-4, 1, None, **ADAM)
        for got, ref in [(kp, p)] + [(ks[k], slot[k]) for k in ks]:
            d = (got.float() - ref.float()).abs()
            ulp = (torch.finfo(got.dtype).eps if got.dtype != torch.float32
                   else 1e-6) * ref.float().abs()
            floor = 2.0 ** -24 if got.dtype == h16 else 1e-30  # subnormals
            require(bool((d <= ulp + floor).all()),
                    f"fp16 adam: beyond one ulp of the plain version")
            worst = max(worst, d.max().item())
    require(FAD.adam_update.LAUNCHES == n + len(leaves) + 2,
            "fp16 adam launches")
    kern = cuda_ms(lambda: [FAD.adam_update(p, g, s, 1e-4, 1, None, **ADAM)
                            for p, g, s in leaves], runs=10)
    elems = sum(p.numel() for p, _, _ in leaves)
    bound, by = row_bound(elems * 14, elems * ADAM_FLOPS_PER_ELEMENT)
    log(f"fused adam fp16 over {len(leaves)} leaves ({elems} elements; and a "
        f"bf16 leaf with an fp32 gradient, an fp32 leaf with an fp16 one): "
        f"within one ulp of the plain version (max_abs_err {worst:.3e}); "
        f"kernel_ms {kern:.4f} bound_ms {bound:.4f} ({by})  [{card}]")
    recs["fused_adam"] = dict(max_abs_err=worst, ms=kern, bound_ms=bound,
                              bound_by=by, elements=elems)
    del leaves, mixed
    torch.cuda.empty_cache()

    rng = np.random.RandomState(32)
    lens = [100, 173, 256, 311, 400, 467, 555, 640]     # phase 3's case (a)
    n = PA.paged_decode_attention.LAUNCHES
    recs["paged_decode_attention"] = check_decode_case(
        "(a) decode B=8 H=16 D=128 bs=32 fp16",
        decode_case(rng, lens, 16, 16, dtype=h16), card)
    n_r = RPA.ragged_paged_attention.LAUNCHES
    recs["ragged_paged_attention"] = check_kernel_case(
        "(a) ragged decode R=8 fp16", make_case(rng, [1] * 8, lens, C=1,
                                                hq=16, hkv=16, dtype=h16),
        card)
    check_kernel_case("(b) ragged mixed R=4 C=128 GQA 16/4 fp16", make_case(
        rng, [128, 100, 1, 0], [384, 100, 517, 0], C=128, hq=16, hkv=4,
        dtype=h16), None)
    require(PA.paged_decode_attention.LAUNCHES > n
            and RPA.ragged_paged_attention.LAUNCHES > n_r,
            "fp16 paged attention launches")

    # the public entries route fp16 to the kernels: counts 0 just before
    x = torch.randn(8, 512, 768, generator=gen, device=DEV).to(h16)
    w = torch.randn(768, generator=gen, device=DEV).requires_grad_(True)
    bb = torch.randn(768, generator=gen, device=DEV).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    p16 = {"w": torch.randn(1024, 2048, generator=gen, device=DEV).to(h16)}
    opt = AdamW(1e-4, weight_decay=0.01)
    state = opt.init_state(p16)
    qk = [torch.randn(2, 256, hh, 128, generator=gen, device=DEV).to(
        h16).requires_grad_(True) for hh in (16, 4)]
    for fn in (LN.layer_norm_fwd, LN.layer_norm_bwd, RN.rms_norm_fwd,
               RN.rms_norm_bwd, RP.rope):
        fn.LAUNCHES = 0
    FAD.adam_update.LAUNCHES = 0
    y = TF.layer_norm(xr, 768, w, bb, 1e-5)
    y.float().sum().backward()
    y2 = TF.rms_norm(xr, w, epsilon=1e-6)
    y2.float().sum().backward()
    oq, ok, _ = TI.fused_rotary_position_embedding(*qk)
    (oq.float().sum() + ok.float().sum()).backward()
    opt.apply(p16, {"w": torch.randn_like(p16["w"]) * 1e-3}, state)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.LAUNCHES for fn in (
        LN.layer_norm_fwd, LN.layer_norm_bwd, RN.rms_norm_fwd,
        RN.rms_norm_bwd, RP.rope, FAD.adam_update)}
    log(f"fp16 through nn.functional.layer_norm, nn.functional.rms_norm, "
        f"fused_rotary_position_embedding and AdamW.apply: launches {counts}")
    require(counts == {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                       "rms_norm_fwd": 1, "rms_norm_bwd": 1, "rope": 4,
                       "adam_update": 1}, f"fp16 entry launches {counts}")
    recs["entry_launches"] = counts
    del x, xr, y, y2, p16, state, qk, oq, ok
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 33-35: single-device MoE (GPT-MoE, MoELayer, fused_moe)
# ---------------------------------------------------------------------------
# tests/test_moe_hybrid.py's CFG (phase 33)
MOE_TINY = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                max_seq_len=16, moe_num_experts=4, moe_capacity_factor=8.0,
                moe_aux_weight=1e-2)
MOE_TINY_STEPS = 3
# bench.py _run_moe_config: SECONDARY (bench.py:32) with E 8 experts in every
# second layer, capacity factor 2.0, batch 16 x 1024, bf16, AdamW bf16
# moments (phase 34)
MOE_FULL = dict(vocab_size=32768, hidden_size=1024, num_layers=16,
                num_heads=16, max_seq_len=1024, moe_num_experts=8,
                moe_capacity_factor=2.0)
MOE_BATCH = (16, 1024)
MOE_TIMED_STEPS = 3
MOE_INDEX_LOSS_TOL = 1e-3     # first step, index vs dense, relative
# configs_bench.py bench_moe (phase 35): switch top-1, H 2048, F 8192, E 8,
# capacity factor 1.25, T 16384 bf16, loss mean(y^2), SGD lr 1e-4
BENCH_MOE = dict(H=2048, F=8192, E=8, T=16384, cf=1.25)
BENCH_MOE_STEPS = 5
FUSED_MOE_TOL = 2e-2          # bf16 fused_moe vs the capacity layer, l2 rel


def _moe_dispatch(form):
    from paddle_tpu_torch.distributed.comm_overlap import MoeDispatchConfig
    return MoeDispatchConfig(index=True) if form == "index" else None


def moe_loss_and_grads(params, tokens, labels, cfg, form, M=1):
    """The one-device GPT-MoE loss (``hybrid_loss_fn`` with no mesh) and its
    gradients."""
    names, leaves = zip(*flat_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = G.hybrid_loss_fn(params, tokens, labels, cfg, M,
                            moe=_moe_dispatch(form))
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), unflatten(names, grads)


def tiny_moe_trainer_phase():
    """3 AdamW steps of test_moe_hybrid.py's tiny fp32 GPT-MoE on the card
    and on the CPU, dense and index dispatch: the losses within phase 8's
    1e-4 relative, the flash kernels launched on the card."""
    cfg = G.GPTConfig(**MOE_TINY, dtype=torch.float32)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 64, (8, 16)))
    labels = torch.from_numpy(rng.randint(0, 64, (8, 16)))
    init = G.init_hybrid_params(cfg, 0, "cpu")

    def run(dev, form):
        params = unflatten(*zip(*[(n, t.clone().to(dev))
                                  for n, t in flat_leaves(init)]))
        opt = AdamW(1e-2)
        state = opt.init_state(params)
        out = []
        for _ in range(MOE_TINY_STEPS):
            loss, grads = moe_loss_and_grads(params, tokens.to(dev),
                                             labels.to(dev), cfg, form)
            opt.apply(params, grads, state)
            out.append(loss.item())
        return out, float(G.MOE_RECORD["drop_frac"])

    rec = {}
    for form in ("dense", "index"):
        reset_training_counts()
        card, drop = run(DEV, form)
        counts = training_counts()
        cpu, _ = run("cpu", form)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        log(f"{form}: card {card}\n  cpu  {cpu}\n  max rel diff {rel:.2e} "
            f"(tol 1e-4: fp32 sums in another order); drop fraction {drop}; "
            f"card launches {counts}")
        require(rel <= 1e-4, f"tiny GPT-MoE {form}: card and CPU losses "
                f"differ by {rel}")
        require(all(counts[k] > 0 for k in FLASH_KERNELS),
                f"tiny GPT-MoE {form}: a flash kernel did not launch: "
                f"{counts}")
        rec[form] = dict(card=card, cpu=cpu, rel=rel, launches=counts)
    return rec


def _moe_cfg(dtype):
    return G.GPTConfig(**MOE_FULL, dtype=dtype, param_dtype=dtype)


def moe_train_phase(card):
    """GPT-MoE at bench.py _run_moe_config's width through
    ``build_hybrid_train_step`` at world size 1 over NCCL, mesh {dp 1, ep 1,
    pp 1, mp 1}, dense dispatch (``moe_dispatch=None``) and index
    (``MoeDispatchConfig(index=True)``): one warm step and 3 timed steps
    each, a garbage collection before the timed steps and none inside
    them; ms/step, tokens/s, peak memory, the device-busy share of a
    profiled step, the drop fraction, the tokens per expert, the launches
    a step. The index form's first loss within 1e-3 relative of the dense
    form's."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(rank=0, world_size=1)
    require(tdist.get_backend() == "nccl",
            f"the process group runs {tdist.get_backend()}, not NCCL")
    mesh = D.build_mesh({"dp": 1, "ep": 1, "pp": 1, "mp": 1})
    cfg = _moe_cfg(torch.bfloat16)
    tokens, labels = _batch(cfg.vocab_size, MOE_BATCH)
    ntok = MOE_BATCH[0] * MOE_BATCH[1]
    L = cfg.num_layers
    E, H, FF = cfg.moe_num_experts, cfg.hidden_size, cfg.ffn_hidden
    C = math.ceil(ntok / E * cfg.moe_capacity_factor)
    out = {}
    for form in ("dense", "index"):
        params = G.init_hybrid_params(cfg, 0, DEV)
        n_params = sum(t.numel() for _, t in flat_leaves(params))
        fused_leaves = _fused_eligible(params)
        opt = AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
        step, shard, init = G.build_hybrid_train_step(
            cfg, mesh, opt, num_microbatches=1,
            moe_dispatch=_moe_dispatch(form), comm_overlap=None,
            zero_stage=0, donate=True)
        p = shard(params)
        del params
        s = init(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, s, loss = step(p, s, tokens, labels, 1e-4)              # warm
        losses = [loss]
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        first = dict(drop_frac=float(G.MOE_RECORD["drop_frac"]),
                     tokens_per_expert=[int(v) for v in
                                        G.MOE_RECORD["tokens"].tolist()])
        gc.collect()
        gc.disable()
        try:
            # main path: the counts go to 0 just before and are read just
            # after
            reset_training_counts()
            t0 = time.perf_counter()
            for _ in range(MOE_TIMED_STEPS):
                p, s, loss = step(p, s, tokens, labels, 1e-4)
                losses.append(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = training_counts()
        finally:
            gc.enable()
        peak = torch.cuda.max_memory_allocated()
        losses = [x.item() for x in losses]
        drop = float(G.MOE_RECORD["drop_frac"])
        per_expert = [int(v) for v in G.MOE_RECORD["tokens"].tolist()]
        ms = wall * 1e3 / MOE_TIMED_STEPS
        tok_s = ntok * MOE_TIMED_STEPS / wall
        per_step = {k: v // MOE_TIMED_STEPS for k, v in counts.items()}
        log(f"{form}: {n_params / 1e6:.1f}M parameters; warm step "
            f"{warm:.2f} s; {MOE_TIMED_STEPS} timed steps: {ms:.1f} ms/step, "
            f"{tok_s:.1f} tokens/s; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB  [{card}]")
        log(f"  losses (warm, then timed): {losses}")
        log(f"  capacity {C} a MoE layer; first step: drop fraction "
            f"{first['drop_frac']:.6f}, tokens per expert over {L // 2} MoE "
            f"layers {first['tokens_per_expert']}; last step: "
            f"{drop:.6f}, {per_expert}")
        log(f"  launches a step: {per_step} (expected flash {L} each, "
            f"fused_adam {fused_leaves})")
        require(all(math.isfinite(x) for x in losses),
                f"GPT-MoE {form}: a loss is not finite")
        require(sum(per_expert) == ntok * (L // 2),
                f"GPT-MoE {form}: {sum(per_expert)} routed tokens")
        want = dict(flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L,
                    fused_adam=fused_leaves)
        for k, v in want.items():
            require(counts[k] == v * MOE_TIMED_STEPS,
                    f"GPT-MoE {form}: {k} {counts[k]} launches in "
                    f"{MOE_TIMED_STEPS} steps, expected {v} a step")
        gc.collect()
        profile = profile_train_step(
            lambda: step(p, s, tokens, labels, 1e-4), card)
        out[form] = dict(ms_per_step=ms, tokens_per_s=tok_s, peak_bytes=peak,
                         losses=losses, drop_frac=drop,
                         tokens_per_expert=per_expert, first_step=first,
                         launches=counts,
                         launches_per_step=per_step, warm_s=warm,
                         capacity=C, parameters=n_params, card=card,
                         **profile)
        del p, s, opt, step, shard, init
        gc.collect()
        torch.cuda.empty_cache()
    tdist.destroy_process_group()
    d, i = out["dense"]["losses"], out["index"]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(i, d)]
    log(f"index vs dense, relative loss gap a step: {gaps} (first step "
        f"tol {MOE_INDEX_LOSS_TOL}: the same math, bf16 sums in another "
        f"order; later steps recorded)")
    require(gaps[0] <= MOE_INDEX_LOSS_TOL,
            f"GPT-MoE: index and dense first losses differ by {gaps[0]}")
    out["index_vs_dense_rel"] = gaps
    return out


def moe_exactness_phase():
    """GPT-MoE's kernel path (flash kernels) against the plain path (the
    composed attention) on the card, index dispatch: fp32 at full width
    and 2 layers (one pair; loss 1e-5, every gradient 1e-3 max-abs rel),
    and bf16 at full depth, one step, at capacity factors 2.0 and 8.0 (loss
    1e-3; the gradients of gate_w, w1, the MoE and dense qkv_w and head_w
    each no further from the fp32 witness than max(1.25 x the plain
    path's error, 5e-2), phase 18b's rule)."""
    tokens, labels = _batch(MOE_FULL["vocab_size"], MOE_BATCH)
    rec = {}
    cfg = G.GPTConfig(**dict(MOE_FULL, num_layers=2), dtype=torch.float32,
                      param_dtype=torch.float32)
    params = G.init_hybrid_params(cfg, 0, DEV)
    loss_k, g_k = moe_loss_and_grads(params, tokens, labels, cfg, "index")
    with plain_path():
        loss_p, g_p = moe_loss_and_grads(params, tokens, labels, cfg,
                                         "index")
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"fp32 2 layers: loss kernel {loss_k.item():.7f} plain "
        f"{loss_p.item():.7f} rel {rel:.2e} (tol 1e-5)")
    require(rel <= 1e-5, f"GPT-MoE fp32 loss rel err {rel}")
    rec["fp32_loss_rel"] = rel
    rec["fp32_grad_max_rel"] = compare_grads("GPT-MoE fp32 2 layers", g_k,
                                             g_p, 1e-3, "max")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    # bf16 at full depth, one step from one init, at bench.py's capacity
    # factor 2.0 and at 8.0 (C = T: no token can overflow), each bf16 path
    # against the fp32 witness (phase 18b's rule: the kernel path in fp32 on
    # the same weights and batch). The router's and the experts' gradients
    # are sums over a token's expert in which most terms cancel (a softmax's
    # Jacobian; the mean-field experts at init), so bf16 rounding anywhere
    # upstream shows there: every leaf of the kernel path is held to
    # max(1.25 x the plain path's error, 5e-2) from the witness
    keys = ("blocks.moe.gate_w", "blocks.moe.w1", "blocks.moe.qkv_w",
            "blocks.dense.qkv_w", "head_w")
    for cf in (MOE_FULL["moe_capacity_factor"], 8.0):
        full = dict(MOE_FULL, moe_capacity_factor=cf)
        cfg = G.GPTConfig(**full, dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16)
        params = G.init_hybrid_params(cfg, 0, DEV)
        loss_k, g_k = moe_loss_and_grads(params, tokens, labels, cfg,
                                         "index")
        rec_k = {k: v.clone() for k, v in G.MOE_RECORD.items()}
        with plain_path():
            loss_p, g_p = moe_loss_and_grads(params, tokens, labels, cfg,
                                             "index")
        moved = int((rec_k["tokens"] - G.MOE_RECORD["tokens"]).abs().sum()
                    .item()) // 2
        g_k, g_p = (dict((k, v) for k, v in flat_leaves(g)
                         if k in keys) for g in (g_k, g_p))
        cfg32 = G.GPTConfig(**full, dtype=torch.float32,
                            param_dtype=torch.float32)
        params = unflatten(*zip(*[(n, t.float())
                                  for n, t in flat_leaves(params)]))
        _, g32 = moe_loss_and_grads(params, tokens, labels, cfg32, "index")
        g32 = dict((k, v) for k, v in flat_leaves(g32) if k in keys)
        del params
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        tag = f"bf16 full depth, capacity factor {cf}"
        log(f"{tag}: loss kernel {loss_k.item():.5f} plain "
            f"{loss_p.item():.5f} rel {rel:.2e} (tol 1e-3); drop fraction "
            f"kernel {float(rec_k['drop_frac']):.6f} plain "
            f"{float(G.MOE_RECORD['drop_frac']):.6f}; at least {moved} "
            f"(token, MoE layer) routings differ between the paths")
        require(rel <= 1e-3, f"GPT-MoE {tag} loss rel err {rel}")
        out = dict(loss_rel=rel, routings_moved_at_least=moved,
                   drop_frac=float(rec_k["drop_frac"]))
        log("  grads against the fp32 witness (l2 rel err): leaf, kernel "
            "path, plain path, kernel vs plain; tol max(1.25 x plain, "
            "5e-2)")
        for key in keys:
            w = g32[key].float()
            wn = w.norm().clamp_min(1e-30)
            a, b = g_k[key].float(), g_p[key].float()
            require(torch.isfinite(a).all(), f"{key}: grad not finite")
            ek = ((a - w).norm() / wn).item()
            ep = ((b - w).norm() / wn).item()
            kp = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            log(f"  {key}: {ek:.3e}  {ep:.3e}  {kp:.3e}")
            require(ek <= max(1.25 * ep, 5e-2),
                    f"GPT-MoE {tag} {key}: kernel path {ek} from the fp32 "
                    f"witness, plain path {ep}")
            out[key] = dict(kernel_vs_witness=ek, plain_vs_witness=ep,
                            kernel_vs_plain=kp)
        rec[f"bf16_cf{cf}"] = out
        del g_k, g_p, g32
        torch.cuda.empty_cache()
    return rec


def _timed_ms(fn, steps):
    """(ms a call over ``steps`` calls after one warm call, host clock
    ending in a synchronize)."""
    fn()
    torch.cuda.synchronize()
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def bench_moe_phase(card):
    """configs_bench.py bench_moe's layer: MoELayer(2048, 8192, 8,
    gate="switch", capacity_factor=1.25) on T 16384 bf16, loss mean(y^2),
    an SGD update, in index and einsum dispatch; the expert bank alone on
    an [E, C, H] batch; each form's ms/step and expert-GEMM share of the
    dense bf16 peak (3 * 4 * E * C * H * F FLOPs at 989 TFLOP/s). Then
    fused_moe (top-2, norm_topk_prob) against a MoELayer with a naive top-2
    gate whose capacity drops nothing, forward, within 2e-2 l2 rel."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.nn.functional import fused_moe
    H, F, E, T, cf = (BENCH_MOE[k] for k in ("H", "F", "E", "T", "cf"))
    gen = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn((T, H), generator=gen, device=DEV).to(torch.bfloat16)
    with device_guard(DEV), TR.rng_guard(torch.Generator().manual_seed(0)):
        layer = MoELayer(H, F, E, gate="switch", capacity_factor=cf)
    params, _, buffers = TNN.functional_train_graph(layer, device=DEV)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    C = layer.gate.capacity(T)
    expert_flops = 3 * 4 * E * C * H * F
    rec = {"capacity": C, "expert_flops": expert_flops,
           "peak": "989 TFLOP/s dense bf16 (H100 SXM)"}

    def sgd(ps, loss_fn):
        leaves = list(ps.values())
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(ps)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(1e-4 * g.to(t.dtype))
                t.requires_grad_(False)
        return loss

    def layer_loss(ps):
        y, _ = TNN.functional_call(layer, ps, buffers, x)
        return torch.mean(torch.square(y.float()))

    for mode in ("index", "einsum"):
        layer.dispatch_mode = mode
        torch.cuda.reset_peak_memory_stats()
        ms = _timed_ms(lambda: sgd(params, layer_loss), BENCH_MOE_STEPS)
        share = expert_flops / (ms / 1e3) / BF16_FLOPS
        log(f"MoELayer {mode}: {ms:.2f} ms/step, {T / ms * 1e3:.0f} "
            f"tokens/s, expert-GEMM share of the bf16 peak {share:.2%}, "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        rec[mode] = dict(ms_per_step=ms, expert_gemm_share=share,
                         tokens_per_s=T / ms * 1e3)
    xe = torch.randn((E, C, H), generator=gen, device=DEV).to(torch.bfloat16)
    bank = {k: params[f"experts.{k}"].clone() for k in ("w1", "b1", "w2",
                                                         "b2")}

    def bank_loss(ps):
        y = layer.experts.apply(xe, ps["w1"], ps["b1"], ps["w2"], ps["b2"])
        return torch.mean(torch.square(y.float()))
    ms = _timed_ms(lambda: sgd(bank, bank_loss), BENCH_MOE_STEPS)
    share = expert_flops / (ms / 1e3) / BF16_FLOPS
    log(f"expert bank alone on [{E}, {C}, {H}]: {ms:.2f} ms/step, "
        f"expert-GEMM share of the bf16 peak {share:.2%}; routing and "
        f"dispatch take {1 - ms / rec['index']['ms_per_step']:.1%} of the "
        f"index step")
    rec["bank"] = dict(ms_per_step=ms, expert_gemm_share=share)
    del bank, xe
    # fused_moe against the capacity layer where nothing drops: capacity
    # factor E / top_k gives every expert room for every token
    with device_guard(DEV), TR.rng_guard(torch.Generator().manual_seed(1)):
        naive = MoELayer(H, F, E, gate="naive", top_k=2,
                         capacity_factor=E / 2, dispatch_mode="index")
    naive = naive.to(torch.bfloat16)
    g = naive.gate.weight
    ex = naive.experts
    with torch.no_grad():
        want = naive(x)
        got, probs = fused_moe(x, g, ex.w1, ex.b1, ex.w2, ex.b2, top_k=2,
                               norm_topk_prob=True)
        err = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        fused_ms = _timed_ms(lambda: fused_moe(x, g, ex.w1, ex.b1, ex.w2,
                                               ex.b2, top_k=2),
                             BENCH_MOE_STEPS)
        layer_ms = _timed_ms(lambda: naive(x), BENCH_MOE_STEPS)
    log(f"fused_moe top-2 vs MoELayer(naive top-2, capacity "
        f"{naive.gate.capacity(T)}: nothing drops), forward: l2 rel "
        f"{err:.3e} (tol {FUSED_MOE_TOL}: bf16 roundings in another order); "
        f"fused_moe {fused_ms:.2f} ms, MoELayer index {layer_ms:.2f} ms  "
        f"[{card}]")
    require(probs.shape == (T, E) and torch.isfinite(got).all(),
            "fused_moe: output not finite")
    require(err <= FUSED_MOE_TOL, f"fused_moe vs MoELayer l2 rel {err}")
    rec["fused_moe"] = dict(l2_rel=err, ms=fused_ms, layer_index_ms=layer_ms)
    del layer, naive, params, x, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t_all = phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = phase("2. build")
    from paddle_tpu_torch.kernels import _build
    _build.load_library()
    log(f"built {_build.BUILD_LOG['path']} in "
        f"{_build.BUILD_LOG['seconds']:.1f} s "
        f"(cached={_build.BUILD_LOG['cached']}, phase {time.perf_counter() - t0:.1f} s)")
    for line in _build.BUILD_LOG["output"].splitlines():
        if any(w in line for w in ("registers", "spill", "error", "warning")):
            log("  " + line.strip())
    spills = [int(n) for n in re.findall(
        r"(\d+) bytes spill stores", _build.BUILD_LOG["output"])]
    if spills:
        log(f"{len(spills)} kernels compiled, {sum(n > 0 for n in spills)} "
            f"with spill stores (at most {max(spills)} bytes a thread)")
    wg = wgmma_ptxas(_build.BUILD_LOG["output"])
    for name, ty, d, *rest in wg:
        flags = (f", bias {rest[0]}, ints {rest[1]}, dropout {rest[2]}"
                 if rest[0] >= 0 else "")
        note = (" (setmaxnreg then moves them to the consumers)" if flags
                else "")
        log(f"  {name}<{ty}, D_pad {d}{flags}>: {rest[3]} registers at "
            f"launch{note}, {rest[4]} bytes spill stores")
    if wg:
        dkv = [r for r in wg if r[0] == "flash_dkv_wgmma_kernel"]
        log(f"{len(wg)} wgmma instances, "
            f"{sum(r[-1] > 0 for r in wg)} with spill stores, "
            f"{sum(r[-1] > 0 for r in wg if r[2] <= 128)} of them at D_pad "
            f"<= 128; dK/dV {sum(r[-1] > 0 for r in dkv)} of {len(dkv)}")
        # the split dK/dV (D_pad 192 / 256) holds no spill
        split = [r for r in dkv if r[2] > 128]
        require(len(split) == 32 and not any(r[-1] for r in split),
                f"dK/dV split instances: {len(split)}, spilling "
                f"{[r for r in split if r[-1]]}")
    rag = ragged_ptxas(_build.BUILD_LOG["output"])
    for name, q, pool, d, ring, regs, spill in rag:
        log(f"  {name}<{q} q, {pool} pool, D_pad {d}, {ring} ring>: {regs} "
            f"registers, {spill} bytes spill stores")
    if _build.BUILD_LOG["output"]:
        # no ragged wgmma instance spills: the 16-bit kernel (bf16 / fp16 q
        # over 16-bit, int8 and fp8 pools at D_pad 64-256, the TMA and the
        # gathered ring: 48) and the TF32 kernel (fp32 q over fp32, int8
        # and fp8 pools at D_pad 64-256: 12)
        n16 = sum(r[0] == "ragged_wgmma_kernel" for r in rag)
        require(n16 == 48 and len(rag) == 60 and not any(r[-1] for r in rag),
                f"ragged wgmma instances: {n16} 16-bit, {len(rag) - n16} "
                f"TF32, spilling {[r for r in rag if r[-1]]}")
    ln_inst = ln_fwd_ptxas(_build.BUILD_LOG["output"])
    for ty, nw, regs, spill in ln_inst:
        log(f"  ln_fwd_held<{ty}, {nw} words a lane>: {regs} registers, "
            f"{spill} bytes spill stores")
    if _build.BUILD_LOG["output"]:
        require(len(ln_inst) == 24 and not any(r[-1] for r in ln_inst),
                f"LayerNorm forward held instances: {len(ln_inst)}, spilling "
                f"{[r for r in ln_inst if r[-1]]}")
    tf32 = tf32_ptxas(_build.BUILD_LOG["output"])
    for name, d, bias, ints, drop, regs, spill in tf32:
        log(f"  {name}<D_pad {d}, bias {bias}, ints {ints}, dropout {drop}>: "
            f"{regs} registers at launch, {spill} bytes spill stores")
    if _build.BUILD_LOG["output"]:
        # the fp32 forward, dQ and dK/dV (4 widths each: 96) on the TF32
        # tensor cores hold no spill (the fp32 ragged kernel's instances:
        # above)
        require(len(tf32) == 96 and not any(r[-1] for r in tf32),
                f"fp32 TF32 instances: {len(tf32)}, spilling "
                f"{[r for r in tf32 if r[-1]]}")
        # the TF32 instances at D_pad 192 and 256: the fp32 forward, dQ and
        # dK/dV (16- and 32-row tiles) and the fp32 ragged kernel
        for d in (192, 256):
            rg = [r for r in rag if r[0] == "ragged_tf32_kernel"
                  and r[3] == d]
            parts = []
            for kname in ("flash_fwd_tf32_wide_kernel", "flash_dq_tf32_kernel",
                          "flash_dkv_tf32_kernel"):
                got = [r for r in tf32 if r[0] == kname and r[1] == d]
                require(len(got) == 8, f"D_pad {d}: {len(got)} {kname} "
                        f"instances")
                parts.append(f"{kname} {len(got)} instances, registers "
                             f"{min(r[-2] for r in got)}-"
                             f"{max(r[-2] for r in got)}, spill stores "
                             f"{max(r[-1] for r in got)} B")
            log(f"D_pad {d}: " + "; ".join(parts) + f"; fp32 ragged {len(rg)} "
                f"instances (fp32 / int8 / fp8 pools), registers "
                f"{min(r[-2] for r in rg)}-{max(r[-2] for r in rg)}, spill "
                f"stores {max(r[-1] for r in rg)} B")
            require(len(rg) == 3, f"D_pad {d}: {len(rg)} ragged TF32 "
                    f"instances")
    dec_inst = decode_ptxas(_build.BUILD_LOG["output"])
    for ty, rb, dp, regs, spill in dec_inst:
        log(f"  paged_decode_hopper_kernel<{ty}, rows {rb}, D_pad {dp}>: "
            f"{regs} registers, {spill} bytes spill stores")
    if dec_inst:
        f32 = [r for r in dec_inst if r[0] == "fp32"]
        require(len(f32) == 12 and not any(r[-1] for r in f32),
                f"fp32 paged decode instances: {len(f32)}, spilling "
                f"{[r for r in f32 if r[-1]]}")

    t0 = phase("3. kernel vs plain on the card")
    rng = np.random.RandomState(0)
    dec = make_case(rng, [1] * 8, [100, 173, 256, 311, 400, 467, 555, 640],
                    C=1, hq=16, hkv=16)
    mixed_q, mixed_kv = [128, 100, 1, 0], [384, 100, 517, 0]
    mixed = make_case(rng, mixed_q, mixed_kv, C=128, hq=16, hkv=16)
    gqa = make_case(rng, mixed_q, mixed_kv, C=128, hq=16, hkv=4)
    rec_dec = check_kernel_case("(a) decode R=8", dec, card)
    rec_mixed = check_kernel_case("(b) mixed R=4 C=128", mixed, card)
    check_kernel_case("(c) GQA 16/4 mixed", gqa, None)
    sweep = decode_sweep(rng, card)
    sweep["long_rows"] = long_row_decode(rng, card)
    # fp32 queries over fp32 pools take the TF32 route (held at 1e-5): timed
    # at case (a)'s and case (b)'s batches
    rec_dec32 = check_kernel_case("(a) decode R=8 fp32", make_case(
        rng, [1] * 8, [100, 173, 256, 311, 400, 467, 555, 640], C=1, hq=16,
        hkv=16, dtype=torch.float32), card)
    rec_mixed32 = check_kernel_case("(b) mixed R=4 C=128 fp32", make_case(
        rng, mixed_q, mixed_kv, C=128, hq=16, hkv=16, dtype=torch.float32),
        card)
    require(rec_dec32["design"] == rec_mixed32["design"] == "wgmma-3xtf32",
            "fp32 ragged cases off the TF32 route")
    # head dims past 128: 16-bit queries on the wgmma kernel at D_pad 192
    # and 256 (D 256 bf16 timed at case (a)'s and case (b)'s batches), fp32
    # queries on the TF32 kernel there (key tiles of 16; D 256 timed at case
    # (a)'s and case (b)'s batches, D 160 at case (a)'s); D 99 / 250 fp32
    # and D 100 bf16 (not whole 16-byte words) on the CUDA-core route
    dec_lens = [100, 173, 256, 311, 400, 467, 555, 640]
    wide = {
        "D256_bf16": check_kernel_case("(a) decode R=8 D=256 bf16", make_case(
            rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, D=256), card),
        "D256_bf16_mixed": check_kernel_case(
            "(b) mixed R=4 C=128 D=256 bf16", make_case(
                rng, mixed_q, mixed_kv, C=128, hq=16, hkv=16, D=256), card),
        "D256_fp32": check_kernel_case("(a) decode R=8 D=256 fp32", make_case(
            rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, D=256,
            dtype=torch.float32), card),
        "D256_fp32_mixed": check_kernel_case(
            "(b) mixed R=4 C=128 D=256 fp32", make_case(
                rng, mixed_q, mixed_kv, C=128, hq=16, hkv=16, D=256,
                dtype=torch.float32), card),
        "D160_fp32_decode": check_kernel_case(
            "(a) decode R=8 D=160 fp32", make_case(
                rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, D=160,
                dtype=torch.float32), card),
        # fp32 D 250 (not whole 16-byte words): the CUDA-core kernel's wide
        # instance (32 outputs a thread), timed at case (a)'s batch
        "D250_fp32_decode": check_kernel_case(
            "(a) decode R=8 D=250 fp32", make_case(
                rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, D=250,
                dtype=torch.float32), card)}
    for tag, D, dt in (("D160_bf16", 160, torch.bfloat16),
                       ("D160_fp16", 160, torch.float16),
                       ("D256_fp16", 256, torch.float16),
                       ("D160_fp32", 160, torch.float32),
                       ("D99_fp32", 99, torch.float32),
                       ("D100_bf16", 100, torch.bfloat16)):
        wide[tag] = check_kernel_case(f"(c) GQA 16/4 mixed D={D} {tag[-4:]}",
                                      make_case(rng, mixed_q, mixed_kv, C=128,
                                                hq=16, hkv=4, D=D, dtype=dt),
                                      None)
    # a page size that is not a multiple of 8 (the gathered rings), timed
    # at case (a)'s batch with pages of 12 keys: bf16, fp32, and bf16 q
    # over int8 pools
    for tag, dt in (("bs12_bf16", torch.bfloat16),
                    ("bs12_fp32", torch.float32)):
        wide[tag] = check_kernel_case(
            f"(a) decode R=8 bs=12 {tag[-4:]}", make_case(
                rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, bs=12, NB=300,
                nb=54, dtype=dt), card)
    bs12_int8 = make_case(rng, [1] * 8, dec_lens, C=1, hq=16, hkv=16, bs=12,
                          NB=300, nb=54)
    fill_quantized(bs12_int8, torch.int8, rng)
    wide["bs12_int8"] = check_quantized_case("(a) int8 decode R=8 bs=12",
                                             bs12_int8, card)
    on_route = {"D256_bf16": "wgmma+tma", "D256_bf16_mixed": "wgmma+tma",
                "D160_bf16": "wgmma+tma", "D160_fp16": "wgmma+tma",
                "D256_fp16": "wgmma+tma", "bs12_bf16": "wgmma+gather",
                "bs12_int8": "wgmma+gather",
                "bs12_fp32": "wgmma-3xtf32", "D256_fp32": "wgmma-3xtf32",
                "D256_fp32_mixed": "wgmma-3xtf32",
                "D160_fp32_decode": "wgmma-3xtf32",
                "D160_fp32": "wgmma-3xtf32"}
    require(all(r["design"] == on_route.get(t, "fp32")
                for t, r in wide.items()),
            f"wide / odd head dims and pages of 12 off their routes: "
            f"{ {t: r['design'] for t, r in wide.items()} }")
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("4. tiny fp32 engine: card vs CPU")
    small_engine_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("5. GPT-1.3B shape, bf16, ragged engine")
    full = full_width_bf16_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("5b. GPT-1.3B shape, fp32, exactness")
    # main path of the fp32 ragged kernel: the counts go to 0 just before
    # and are read just after
    RPA.ragged_paged_attention.LAUNCHES = 0
    for route in RPA.ragged_paged_attention.ROUTES:
        RPA.ragged_paged_attention.ROUTES[route] = 0
    ragged_fp32_outs = full_width_fp32_phase()
    ragged32 = dict(launches=RPA.ragged_paged_attention.LAUNCHES,
                    routes=dict(RPA.ragged_paged_attention.ROUTES))
    log(f"fp32 ragged engine: ragged_paged_attention LAUNCHES "
        f"{ragged32['launches']}, by route {ragged32['routes']}")
    require(ragged32["launches"] > 0 and ragged32["routes"]["wgmma-3xtf32"]
            == ragged32["launches"], f"fp32 ragged launches off the TF32 "
            f"route: {ragged32['routes']}")
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("6. flash attention kernels vs plain on the card")
    flash_recs = flash_phase(card)
    flash = flash_recs["bf16"]
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("7. fused Adam vs plain on the card")
    adam = adam_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("8. tiny fp32 trainer: card vs CPU")
    tiny_trainer_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("9. GPT-1.3B flagship training, bf16")
    train = flagship_train_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("9b. exactness at full width: kernel path vs plain path")
    exact = exactness_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("9c. GPT-1.3B flagship through the dp / ZeRO engine over "
               "NCCL")
    dpz = dp_zero_phase(card, train)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("9d. ZeRO levels and moments offload over NCCL (2.76B "
               "offload, 1.3B p_g_os)")
    shoff = sharded_offload_phase(card, train)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("9e. GPT-6.7B streamed from pinned host memory (the main "
               "path of distributed/sharding)")
    pstream = param_stream_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("10. paged decode kernel vs plain on the card")
    dec = paged_decode_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("11. flash forward with a bias vs plain on the card")
    bias = flash_bias_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("12. ragged kernel over int8 / fp8 pools vs plain on the card")
    quant = quantized_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("13. GPT-1.3B shape, two-program engine (the default path)")
    two = two_program_phase(card, ragged_fp32_outs)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("14. GPT-1.3B shape, ragged engine with int8 / fp8 KV pools")
    qeng = quantized_engine_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    rows_128 = bert_batch(BERT_SEQS[1], 8)["ids"].shape[0] * BERT_SEQ
    t0 = phase("15. LayerNorm kernels vs plain on the card")
    ln = ln_phase(card, rows_128)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("16. flash kernels with segments and dropout vs plain")
    fvar = flash_variant_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("17. tiny fp32 BERT trainer: card vs CPU")
    tiny_bert_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("18. BERT-base packed pretraining, bf16")
    bert = bert_train_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("18b. BERT exactness: kernel path vs plain path")
    bert_exact = bert_exactness_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("19. RMSNorm kernels vs plain on the card")
    rms = rms_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("20. RoPE kernel vs plain on the card")
    rope = rope_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("21. tiny fp32 eager Llama trainer: card vs CPU")
    tiny_llama_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("22. eager Llama at bench_llama's width, bf16")
    llama, llama_host_model = llama_train_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("22b. Llama exactness: kernel path vs plain path")
    llama_exact = llama_exactness_phase(llama_host_model)
    del llama_host_model
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("23. bench_llama's dense_loss step, bf16")
    dense = llama_dense_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("24. flash kernels with a bias vs plain at the padded BERT "
               "call")
    fpad = flash_padded_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("25. flash kernels at every head dim and dtype vs plain")
    fdims = head_dims_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("26. tiny fp32 padded BERT: card vs CPU")
    tiny_padded_bert_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("27. BERT-base padded pretraining (bench_bert_base), bf16")
    padded = padded_train_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("27b. padded BERT exactness: kernel path vs plain path")
    padded_exact = bert_exactness_phase(padded_tensors(
        padded_batch(TB.BertConfig().vocab_size), DEV))
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("28. flash kernels with flashmask rows and a window vs plain")
    fm_forms_rec = flashmask_forms_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("29. flashmask rows and the window timed at bench_llama's "
               "attention width")
    fm_timed = flashmask_timed_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("30. nn.functional.flashmask_attention on the card")
    fm_entry = flashmask_entry_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("31. tile primitives at the models' widths")
    prim = primitives_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("32. fp16 in the norm, RoPE, Adam and paged attention kernels")
    half = fp16_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    t0 = phase("33. tiny fp32 GPT-MoE trainer: card vs CPU")
    moe_tiny = tiny_moe_trainer_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("34. GPT-MoE at bench.py's MoE width through the hybrid step "
               "over NCCL, bf16")
    moe = moe_train_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("34b. GPT-MoE exactness: kernel path vs plain path")
    moe_exact = moe_exactness_phase()
    log(f"phase {time.perf_counter() - t0:.1f} s")
    t0 = phase("35. bench_moe's MoE layer, the expert bank and fused_moe")
    bmoe = bench_moe_phase(card)
    log(f"phase {time.perf_counter() - t0:.1f} s")

    log(f"\nall phases {time.perf_counter() - t_all:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    ragged = dict(
        name="ragged_paged_attention", route="cuda",
        source="paddle_tpu_torch/csrc/ragged_paged_attention_hopper.cu",
        replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:121",
        launches=full["launches"], **{k: rec_dec[k] for k in keys},
        design=rec_dec["design"], splits=rec_dec["splits"],
        shape="decode R=8 H=16 D=128 bs=32 bf16, kv_len 100..640",
        mixed={k: rec_mixed[k] for k in keys + ("design", "splits")},
        wide_head_dims={t: {k: r[k] for k in keys + ("design",) if k in r}
                        for t, r in wide.items()},
        decode_sweep=sweep, serving=full,
        serving_pages_of_12=qeng["bf16_bs12"])
    ragged32_rec = dict(
        name="ragged_paged_attention_fp32", route="cuda",
        source="paddle_tpu_torch/csrc/ragged_paged_attention_tf32_hopper.cu",
        replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:121",
        launches=ragged32["routes"]["wgmma-3xtf32"],
        **{k: rec_dec32[k] for k in keys}, design=rec_dec32["design"],
        splits=rec_dec32["splits"],
        tf32x3_bound_ms=rec_dec32["tf32x3_bound_ms"],
        shape="decode R=8 H=16 D=128 bs=32 fp32, kv_len 100..640",
        mixed={k: rec_mixed32[k] for k in keys + (
            "design", "splits", "tf32x3_bound_ms")},
        # D_pad 192 / 256 (key tiles of 16): decode (a) at D 256 and 160,
        # mixed (b) at D 256; fp32 q over int8 / fp8 pools at D 256
        wide={t: {k: r[k] for k in keys + ("design", "splits")}
              for t, r in (("D256_decode", wide["D256_fp32"]),
                           ("D256_mixed", wide["D256_fp32_mixed"]),
                           ("D160_decode", wide["D160_fp32_decode"]),
                           ("D256_int8_decode", quant["int8_fp32_q_d256"]),
                           ("D256_fp8_decode", quant["fp8_fp32_q_d256"]))},
        launches_from="phase 5b, the fp32 ragged engine's wave",
        serving_over_int8=qeng["fp32_int8"])
    shape = "B=8 S=1024 H=16 D=128 causal bf16, q/k/v views of qkv"
    fa = "paddle_tpu/kernels/pallas/flash_attention.py"
    bert_main = bert[BERT_SEQS[0]]
    bert_shape = ("packed [10, 512, 12, 64] bf16, the corpus' segment ids, "
                  "dropout 0.1")
    padded_shape = ("padded [16, 512, 12, 64] bf16, bias [16, 1, 512, 512] "
                    "bf16 from bench_bert_base's bool mask, dropout 0.1")
    fm_keys = keys + ("causal_ms", "dense_bias_ms", "tile_share",
                      "ms_share_of_causal")
    fm_shape = {
        "doc": "q [8, 1024, 16, 128], k / v [8, 1024, 4, 128] bf16, causal, "
               "flashmask_attention C = 1 rows: a document mask (lengths "
               "RandomState(0).randint(64, 513))",
        "window": "q [2, 4096, 16, 128], k / v [2, 4096, 4, 128] bf16, "
                  "causal, flashmask_attention window_size 1024"}
    kernels = [ragged] + [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=train["launches"][name],
             **{k: flash[name][k] for k in keys}, shape=shape,
             bert=dict(launches=bert_main["launches_total"][name],
                       shape=bert_shape,
                       **{k: fvar["bf16_p0.1"][name][k] for k in keys},
                       p0={k: fvar["bf16_p0.0"][name][k] for k in keys}),
             llama=dict(launches=llama["launches_total"][name],
                        shape="q [8, 1024, 16, 128], k / v [8, 1024, 4, "
                              "128] causal bf16 (the eager Llama)",
                        **{k: fdims["llama_gqa"][name][k] for k in keys}),
             bert_padded=dict(
                 launches=padded["launches_total"][name], shape=padded_shape,
                 **{k: fpad["bf16_bias_p0.1"][name][k] for k in keys},
                 p0={k: fpad["bf16_bias_p0.0"][name][k] for k in keys}),
             head_dims={tag: {k: fdims[tag][name][k] for k in keys}
                        for tag in ("D32_bfloat16", "D96_bfloat16",
                                    "D160_bfloat16", "D256_bfloat16",
                                    "D256_float16", "D128_float16",
                                    "D256_float32", "D160_float32")},
             head_dims_entry_launches={
                 f"D{D}": fdims[f"D{D}_entry_launches"][name]
                 for D in (160, 256)},
             flashmask=dict(
                 launches=fm_entry["doc"]["launches"][name],
                 shape=fm_shape["doc"],
                 **{k: fm_timed["doc"][name][k] for k in fm_keys}),
             window=dict(
                 launches=fm_entry["window"]["launches"][name],
                 shape=fm_shape["window"],
                 **{k: fm_timed["window"][name][k] for k in fm_keys}),
             no_mask_retimed={tag: fm_entry[tag][name]
                              for tag in ("gpt_flagship", "bert_packed")},
             dp_zero={tag: dict(launches=r["launches"][name],
                                launches_per_step=r["launches_per_step"][
                                    name],
                                microbatches=r["microbatches"])
                      for tag, r in dpz.items()},
             # 9d / 9e: the offload tiers (distributed/sharding)
             sharded_offload={tag: dict(
                 launches=r["launches"][name],
                 launches_per_step=r["launches_per_step"][name])
                 for tag, r in shoff.items()},
             param_stream={tag: dict(
                 launches=r["launches"][name],
                 launches_per_step=r["launches_per_step"][name])
                 for tag, r in pstream.items()},
             # phase 34: GPT-MoE through the hybrid step, 3 timed steps
             gpt_moe={form: dict(
                 launches=moe[form]["launches"][name],
                 launches_per_step=moe[form]["launches_per_step"][name])
                 for form in ("dense", "index")},
             fp32=dict(shape="B=8 S=1024 H=16 D=128 causal fp32, q/k/v "
                             "views of qkv",
                       **{k: v for k, v in flash_recs["fp32"][name].items()
                          if k in keys + ("design", "tf32x3_bound_ms")},
                       # D_pad 192 / 256, phase 25
                       wide={f"D{D}": {
                           k: v for k, v in fdims[f"D{D}_float32"][
                               name].items()
                           if k in keys + ("design", "tf32x3_bound_ms")}
                           for D in (160, 256)}))
        for name, src, rep in (
            ("flash_fwd", "paddle_tpu_torch/csrc/flash_fwd_hopper.cu",
             f"{fa}:451"),
            ("flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_dkv_hopper.cu",
             f"{fa}:747"),
            ("flash_bwd_dq", "paddle_tpu_torch/csrc/flash_dq_hopper.cu",
             f"{fa}:796"))]
    for k in kernels:
        if k["name"] in FLASH_KERNELS:
            k["design"] = flash_designs(k["name"])
    f32 = flash_recs["fp32"]["flash_fwd"]
    kernels += [ragged32_rec, dict(
        name="flash_fwd_fp32", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd_tf32_hopper.cu",
        replaces=f"{fa}:451", launches=two["fp32"]["flash_fwd_launches"],
        **{k: f32[k] for k in keys}, design=f32["design"],
        tf32x3_bound_ms=f32["tf32x3_bound_ms"],
        shape="B=8 S=1024 H=16 D=128 causal fp32, q/k/v views of qkv",
        launches_from="phase 13, the fp32 two-program engine's prefill "
                      "(bias [P, 1, C, cap])",
        # D_pad 192 / 256 (64 query rows over 16-key tiles), phase 25
        wide={f"D{D}": {k: v for k, v in fdims[f"D{D}_float32"][
            "flash_fwd"].items() if k in keys + ("design", "tf32x3_bound_ms")}
            for D in (160, 256)})]
    kernels.append(dict(
        name="fused_adam", route="cuda",
        source="paddle_tpu_torch/csrc/fused_adam.cu",
        replaces="paddle_tpu/kernels/pallas/fused_adam.py:101",
        launches=train["launches"]["fused_adam"],
        **{k: adam[k] for k in keys},
        shape=f"9 flagship leaves, {adam['elements']} bf16 elements, SR on",
        ms_sr_off=adam["ms_sr_off"], training=train, exactness=exact,
        dp_zero=dpz, sharded_offload=shoff, param_stream=pstream,
        llama_launches=llama["launches_total"]["fused_adam"],
        bert_padded_launches=padded["launches_total"]["fused_adam"],
        gpt_moe_launches={form: moe[form]["launches"]["fused_adam"]
                          for form in ("dense", "index")},
        gpt_moe=dict(train=moe, exactness=moe_exact, tiny=moe_tiny,
                     bench_moe=bmoe)))
    kernels += [
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode_hopper.cu",
             replaces="paddle_tpu/kernels/pallas/paged_attention.py:97",
             launches=two["launches"]["paged_decode_attention"],
             **{k: dec[k] for k in keys},
             design=dec["design"], splits=dec["splits"],
             shape="decode B=8 H=16 D=128 bs=32 bf16, lens 100..640",
             ragged_same_batch_ms=dec["ragged_same_batch_ms"],
             stages=dec["stages"], stage_keys=dec["stage_keys"],
             fp32=dict(source="paddle_tpu_torch/csrc/paged_decode_hopper.cu",
                       **{k: dec["fp32"][k] for k in keys + (
                           "design", "splits", "stages", "stage_keys")},
                       two_program=two["fp32"]),
             long_rows={tag: {k: r[k] for k in keys + (
                 "splits", "unsplit_ms")}
                 for tag, r in dec["long_rows"].items()},
             two_program=two),
        dict(name="flash_fwd_bias", route="cuda",
             source="paddle_tpu_torch/csrc/flash_fwd_hopper.cu",
             design=flash_designs("flash_fwd"),
             replaces=f"{fa}:275",
             launches=two["launches"]["flash_fwd"],
             **{k: bias[k] for k in keys},
             shape="prefill P=8 C=128 cap=640 H=16 D=128 bf16, bias "
                   "[8,1,128,640], q a view of qkv, k/v gathered views"),
        dict(name="ragged_paged_attention_quantized", route="cuda",
             source=("paddle_tpu_torch/csrc/ragged_paged_attention_hopper.cu"
                     if quant["int8"]["design"] == "wgmma+tma" else
                     "paddle_tpu_torch/csrc/ragged_paged_attention.cu"),
             design=quant["int8"]["design"],
             replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:58",
             launches=qeng["int8"]["launches"]["ragged_paged_attention"],
             **{k: quant["int8"][k] for k in keys},
             shape="decode R=8 H=16 D=128 bs=32, bf16 q, int8 pools, kv_len "
                   "100..640",
             fp8={k: quant["fp8"][k] for k in keys},
             mixed={k: quant["int8_mixed"][k] for k in keys},
             d256={t: {k: quant[f"{t}_d256"][k] for k in keys + ("design",)}
                   for t in ("int8", "fp8")},
             fp32_q={t: {k: quant[f"{t}_fp32_q"][k]
                         for k in keys + ("design",)}
                     for t in ("int8", "fp8")},
             fp32_q_d256={t: {k: quant[f"{t}_fp32_q_d256"][k]
                              for k in keys + ("design",)}
                          for t in ("int8", "fp8")},
             fp32_q_d200={t: {k: quant[f"{t}_fp32_q_d200"][k]
                              for k in ("max_abs_err", "design")}
                          for t in ("int8", "fp8")},
             fp8_launches=qeng["fp8_e4m3"]["launches"][
                 "ragged_paged_attention"],
             serving=qeng)]
    for name, line in (("layer_norm_fwd", 100), ("layer_norm_bwd", 130)):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/layer_norm.cu",
            replaces=f"paddle_tpu/kernels/pallas/layer_norm.py:{line}",
            launches=bert_main["launches_total"][name],
            **{k: ln["bf16"][name][k] for k in keys},
            shape="x [5120, 768] bf16, fp32 weight and bias, eps 1e-12"
                  + ("; dx, dw and db in one launch"
                     if name == "layer_norm_bwd" else ""),
            **({k: ln["bf16"][name][k] for k in (
                "ms_autograd", "dx_only_ms", "path", "blocks", "host_ms",
                "library_host_ms")}
               if name == "layer_norm_bwd" else
               {k: ln["bf16"][name][k] for k in ("path", "blocks")}),
            **({"fwd_sweep": ln["fwd_sweep"]}
               if name == "layer_norm_fwd" else {}),
            fp32={k: ln["fp32"][name][k] for k in keys},
            rows_128={k: ln["rows_128"][name][k] for k in keys},
            bert=bert if name == "layer_norm_fwd" else None,
            bert_exactness=bert_exact if name == "layer_norm_fwd" else None,
            bert_padded_launches=padded["launches_total"][name],
            bert_padded=padded if name == "layer_norm_fwd" else None,
            bert_padded_exactness=(padded_exact if name == "layer_norm_fwd"
                                   else None)))
    for name, line in (("rms_norm_fwd", 66), ("rms_norm_bwd", 92)):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/rms_norm.cu",
            replaces=f"paddle_tpu/kernels/pallas/rms_norm.py:{line}",
            launches=llama["launches_total"][name],
            **{k: rms[name][k] for k in keys},
            shape="x [8192, 2048] bf16, fp32 weight, eps 1e-5",
            rows_4096_x_4096={k: rms["wide"][name][k] for k in keys},
            **({k: rms[name][k] for k in (
                "ms_autograd", "dx_only_ms", "path", "blocks", "host_ms")}
               if name == "rms_norm_bwd" else
               {k: rms[name][k] for k in ("path", "blocks", "host_ms")}),
            llama=llama if name == "rms_norm_fwd" else None,
            llama_exactness=llama_exact if name == "rms_norm_fwd" else None,
            dense_loss=dense if name == "rms_norm_fwd" else None))
    kernels.append(dict(
        name="rope", route="cuda", source="paddle_tpu_torch/csrc/rope.cu",
        replaces="paddle_tpu/kernels/pallas/rope.py:63",
        launches=rope["launches"], **{k: rope["q"][k] for k in keys},
        shape="q [8, 1024, 16, 128] bf16, fp32 [1024, 64] tables, through "
              "fused_rotary_position_embedding (q and k, forward and "
              "backward)",
        neg_sin_ms=rope["q"]["neg_sin_ms"],
        # the dense Llama block rotates with the composed rotate: no launch
        param_stream_llama_launches=pstream["llama2_7b_4l"]["launches"][
            "rope"],
        k={k: rope["k"][k] for k in keys + ("neg_sin_ms",)}))
    pr = "paddle_tpu/kernels/pallas/primitives.py"
    kernels += [
        dict(name="kps_elementwise", route="cuda",
             source="paddle_tpu_torch/csrc/kps_elementwise.cuh",
             replaces=f"{pr}:58", launches=prim["launches"]["elementwise"],
             **{k: prim["gelu_tanh"][k] for k in keys},
             shape="the GPT flagship FFN activation [8192, 8192] bf16, a "
                   "tanh GELU written by hand as fn",
             mul_add={k: prim["mul_add"][k] for k in keys},
             cold_nvcc_s=prim["cold_nvcc_s"],
             host_overhead_ms=prim["gelu_tanh"]["host_overhead_ms"]),
        dict(name="kps_row_reduce", route="cuda",
             source="paddle_tpu_torch/csrc/kps_row_reduce.cuh",
             replaces=f"{pr}:90", launches=prim["launches"]["row_reduce"],
             **{k: prim["sum"][k] for k in keys},
             shape="the Llama logits [8192, 32000] bf16, fn torch.add",
             max={k: prim["max"][k] for k in keys},
             host_overhead_ms=prim["sum"]["host_overhead_ms"]),
        dict(name="kps_layer_norm_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces=f"{pr}:212", launches=prim["launches"]["ln_fwd"],
             **{k: prim["ln_fwd_flagship"][k] for k in keys + (
                 "path", "blocks")},
             shape="x [8192, 2048] bf16, fp32 g and b (the same CUDA "
                   "kernel as layer_norm_fwd)",
             bert={k: prim["ln_fwd_bert"][k] for k in keys + (
                 "path", "blocks")}),
        dict(name="kps_layer_norm_bwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces=f"{pr}:238", launches=prim["launches"]["ln_bwd"],
             **{k: prim["ln_bwd_flagship"][k] for k in keys + (
                 "path", "blocks")},
             shape="x [8192, 2048] bf16, fp32 g; dx, dg and db in one "
                   "launch (the same CUDA kernel as layer_norm_bwd)",
             row8_route_ms=prim["ln_bwd_flagship"]["row8_route_ms"],
             bert={k: prim["ln_bwd_bert"][k] for k in keys + (
                 "row8_route_ms", "path", "blocks")})]
    # fp16 readings beside the bf16 ones of the kernels phase 32 timed
    fp16 = {"ragged_paged_attention": half["ragged_paged_attention"],
            "paged_decode_attention": half["paged_decode_attention"],
            "fused_adam": half["fused_adam"], "rope": half["rope"],
            "layer_norm_fwd": half["layer_norm"]["layer_norm_fwd"],
            "layer_norm_bwd": half["layer_norm"]["layer_norm_bwd"],
            "rms_norm_fwd": half["rms_norm"]["rms_norm_fwd"],
            "rms_norm_bwd": half["rms_norm"]["rms_norm_bwd"]}
    for k in kernels:
        if k["name"] in fp16:
            k["fp16"] = fp16[k["name"]]
    require(len(kernels) == 19, f"{len(kernels)} kernels in the record")
    log(f"kernels: {[k['name'] for k in kernels]}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
