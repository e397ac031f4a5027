#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. setup   — torch version, device name, ``nvidia-smi`` name and power
             limit; TF32 off (asserted); build the ten CUDA kernels from
             the five sources in ``src/repro_torch/kernels/csrc`` (one nvcc
             each, in parallel).
2. kernels — the packed-wire kernels at the full-width round (N = 32
             clients, k_n in {3, 4},
             T = 30 tasks, d = 1,327,140, the LoRA task-vector size of
             ViT-B/32 at rank 16 on attn/wq, attn/wo and mlp/down): each
             kernel against its plain PyTorch version on the same inputs,
             bitwise (kernels 1–3 also run to run; kernel 3 also against
             ``sgn @ sgn.T`` and its first design, the T > 64 route), then
             timed (median of CUDA-event-timed calls; kernels 1–3 also by
             device time, each device function's share) beside its plain
             version and its bound; one whole round with kernels against
             the same round with the plain versions.
3. round   — three rounds of ``MaTUStrategy.aggregate`` at that width;
             round r+1 starts from ``task_init`` (the downlink, modulated)
             plus a seeded perturbation in place of local training.  Each
             packed-path kernel's launch count must rise every round.  One
             more round runs under ``torch.profiler`` (device busy time,
             idle share, the ops that take the most device time).
4. bool    — the bool/fp32 A/B layout at the same width, on bf16-valued
             task vectors: each of its kernels (``fused_unify``,
             ``masked_agg_batched``, ``sign_sim``, and ``unify`` for one
             client of K = 4, fp32 and bf16, in fp32 bit patterns and run
             to run) against its plain version, bitwise, and timed with
             its device time (``masked_agg_batched`` also run to run, by device
             time, and its τ̂ against ``masked_agg_batched_packed``'s on
             the same bits; ``sign_sim``, whose T <= 64 route runs the
             int8 tensor cores and writes S in the same C call, also run
             to run, against the packed form and its first design (the
             ``__dp4a`` route for T > 64, here forced), by device time
             beside that design's, after a check that torch's S on the
             card is the reciprocal form its epilogue computes); one bool
             round through the entry points
             (``batched_client_unify(packed=False)`` → ``pack_from_slots``
             → ``RoundEngine.run_packed`` → ``downlinks``) with its launch
             counts, against the same round with the plain versions and
             against the packed round, bit for bit.
5. app     — the quickstart (6 tasks in 3 groups, 9 clients,
             ``MLPBackbone(32, hidden=64, lora_rank=8)``) through
             ``FedSimulator`` for 3 rounds with MaTU and FedAvg.
6. serve   — multi-tenant serving of qwen2-0.5b at full width (24 layers,
             d_model 896, vocab 151,936; random weights from a seed).
             Kernel checks: ``modulated_matmul`` at B = 8 on the three
             LoRA factor shapes (896, 16), (4864, 16), (16, 896) at S = 1,
             16 and 128, and on xlstm-1.3b's five at S = 1 and 16 (S <= 16
             takes the split-K decode route), τ in fp32 and bf16, against
             its plain version, bitwise with x = I and with one-hot rows at
             decode, bitwise run to run and B = 1 against B = 8 at S = 1,
             timed with the device functions a call runs, and a misaligned
             leaf refused; then one MaTU round
             through ``MaTUServer.round`` at d = 3,588,168 (T = 30, N = 32,
             3–4 tasks each), ``serving_downlink`` → ``ModulatorStore``,
             single-task ``masked_agg`` (``ops.masked_agg``; its
             member-row route: only the γ > 0 rows streamed) on one task of
             that round against its plain version, the batched kernel's row
             and the round's τ̂, run to run, timed with device time, and
             one bf16 ``MultiTenantDecoder(fused=True)
             .generate`` (B = 8 mixed tasks, 128-token prompts, 32 new
             tokens, greedy) whose launches are counted (144 per forward);
             prefill logits against the plain versions, the dense-routed
             decoder's tokens, step times, tokens/s, peak memory and a
             profiled prefill and decode window; then the same
             configuration in fp32, where fused and dense-routed decode
             must give identical tokens.
7. vit     — federated LoRA training of ViT-B/32 at full width (12
             layers, d_model 768, 49 patches of 3,072; fp32, random
             weights from a seed), LoRA d = 1,327,140: the synthetic
             constellation at 3,072 built with its QRs and products on
             the card in fp64, after one task built so is held against
             numpy's (R within 1e-6, W bitwise); one local step on
             the card against the same step on the CPU (loss within rtol
             1e-5, every gradient leaf within rel L2 1e-4); then
             ``ViTBackbone`` → ``FedSimulator`` (30 tasks in 6 groups,
             32 clients of 3 tasks, 128 samples each) →
             ``make_local_trainer`` (4 AdamW steps at B = 32 a slot) →
             ``MaTUStrategy.aggregate_batch`` for 2 rounds, kernels 1–3
             launched every round, every upload finite and nonzero,
             accuracies in [0, 1]; round 1's trained uploads through the
             kernels against the plain versions, bitwise (the clients'
             unify, τ̂, S, task vectors, downlink words, bf16 values and
             λ); each round's walls, one local step timed (median of
             20) and profiled, and peak memory.
8. baselines — the paper's baselines and MaTU's coded wire in Table 2's
             setting on ViT-B/32 at full width (8 tasks in 3 groups with
             the conflict pair (0, 1), 8 clients of 2 tasks, ζ_t 0.5, 64
             samples each, 2 rounds of 2 AdamW steps at B = 32; the
             paper's 16 clients and 40 rounds cut for chip time): the
             linearised features at τ = 0 bitwise the features; one
             NTK-FedAvg and one FedProx (μ 0.1) step on the card against
             the CPU (the vit phase's bars) and the three objectives'
             walls; eight runs through ``STRATEGIES`` → ``FedSimulator``
             (MaTU raw, MaTU with ``code_masks``, FedAvg, FedProx,
             NTK-FedAvg, TIES, FedPer, MaT-FL), each with its accuracies,
             its uplink and downlink bits a round and its wall; kernels
             1–3 launched every MaTU round; the coded run bitwise the raw
             one (task vectors, similarity, accuracies, downlink λ and
             words, every uplink decoded), coded bits never above raw
             plus a 5-byte header a row, the coded shares of the mask
             bits and of the link each way and the host coder's walls;
             the coded serving handoff's store ingest bitwise the raw
             one's; each baseline's round-1 merge on the card against
             the CPU (rtol 1e-5 / atol 1e-7; TIES's kept set bitwise and
             its elected signs but where a column sum is within fp32
             rounding of 0; MaT-FL's groups; FedPer's personal slices
             bitwise); round 1's trained MaTU uploads through kernels 1–3
             bitwise.
9. lmtrain — LoRA training of qwen2-0.5b at full width (bf16, rank 16,
             d = 3,588,168) through ``make_train_step`` (AdamW 5e-3, clip
             1.0) on seeded B 4 × S 512 batches: chunked against
             unchunked CE (rel 1e-5, fp32 head), LoRA gradients with and
             without the layers' checkpoint twin (rel L2 1e-6); four
             clients (tasks [0], [1], [2], [0, 2]) take 3 steps each on
             a repeated batch (losses finite, the third below the
             first), ``unify_with_modulators`` → ``ClientUpload`` → one
             ``MaTUServer.round`` (kernels 1–3 launched); step wall,
             tokens/s, round wall and peak memory.
10. granite — multi-tenant serving of granite-moe-3b-a800m at full width
             (32 layers, d_model 1536, 24 heads (kv 8), 40 experts of
             d_ff 512, top-8, vocab 49,155; random weights from a seed):
             kernel 9 at its factor shapes (1536, 16) and (16, 1536), S =
             1, 16 and 128, as in the serve phase; one round at d =
             3,145,792 (kernels 1–3 there against their
             plain versions bitwise and timed by device function),
             ``serving_downlink`` → ``ModulatorStore``, one bf16 fused
             generate (B = 8 over 7 tasks, 128-token prompts, 32 new
             tokens) whose kernel-9 launches are counted (128 a forward:
             ``mixer/wq`` and ``mixer/wo``, two factors each, 32 layers);
             prefill and decode-step walls, layer 0's prefill split into
             attention and MoE, the prefill's capacity drops, profiled
             prefill and decode windows, bf16 prefill logits against the
             plain versions, and fp32, where fused and dense-routed decode
             must agree token for token unless a router near-tie flip
             (printed with its layer and margin) comes first.
11. whisper — multi-tenant serving of whisper-large-v3 at full width (32
             encoder + 32 decoder layers, d_model 1280, 20 heads, d_ff
             5120, vocab 51,866, 1,500 frames; random weights and frame
             embeddings from a seed): kernel 9 at its factor shapes
             (1280, 16), (5120, 16) and (16, 1280), S = 1, 4, 16 and
             1,500, as in the serve phase; one round at d = 14,418,176
             (kernels 1–3 there against their plain versions bitwise and
             timed), ``serving_downlink`` → ``ModulatorStore``, then
             ``route_batch(fused=True)`` and a bf16 greedy generate through
             ``prefill_step`` (encoder over the frames, decoder over
             4-token prompts, both caches filled) and ``decode_fn`` (B = 8
             over 7 tasks, 32 new tokens) whose kernel-9 launches are
             counted (512 at prefill: 3 encoder and 5 decoder sites, two
             factors each, 32 layers; 320 a decode step); encoder,
             prefill and decode-step walls, profiled encoder, prefill
             and decode windows, peak memory, the caches' bytes, bf16
             prefill logits against the plain versions, and fp32, where
             fused and dense-routed decode must agree token for token.
12. hymba  — multi-tenant serving of hymba-1.5b at full width (32
             layers of attention (25 heads, kv 5, a 2,048-token sliding
             window) beside a Mamba branch (d_inner 3,200, d_state 16),
             SwiGLU d_ff 5,504, vocab 32,001; random weights from a
             seed): kernel 9 at its five factor shapes (1600, 16),
             (3200, 16), (5504, 16), (16, 1600), (16, 6400), S = 1 and
             2,040, as in the serve phase; one round at d = 13,467,808
             (kernels 1–3 there against their plain versions bitwise and
             timed), ``serving_downlink`` → ``ModulatorStore``, one bf16
             fused generate (B = 8 over 7 tasks, 2,040-token prompts, 32
             new tokens) whose kernel-9 launches are counted (320 a
             forward: five sites, two factors each, 32 layers); its decode
             steps wrap the attention's 2,048-slot ring, and every
             layer's ring is checked slot for slot after it; prefill and
             decode-step walls, layer 0's attention and Mamba branch walls
             at S = 2,040, a profiled window of layer 0's Mamba branch and
             of 4 decode steps, bf16 logits against the plain versions at
             the prefill and at a decode step past the wrap, and fp32 on
             the prompts' first 128 tokens, where fused and dense-routed
             decode must agree token for token.
13. vlm    — multi-tenant serving of qwen2-vl-7b at full width (28
             layers, d_model 3,584, 28 heads (kv 4), SwiGLU d_ff 18,944,
             vocab 152,064, M-RoPE sections (16, 24, 24); random weights
             and 1,024 vision embeddings a request from a seed, the
             vision encoder a stub as in the JAX package): kernel 9 at
             its factor shapes (3584, 16), (18944, 16), (16, 3584), S = 1
             and 1,152, as in the serve phase; one round at d =
             16,515,156 (kernels 1–3 there against their plain versions
             bitwise and timed), ``serving_downlink`` →
             ``ModulatorStore``, then ``route_batch(fused=True)`` and a
             bf16 greedy generate through ``prefill_step`` (each request
             a 32 × 32 grid of vision embeddings prepended to 128 text
             tokens at Qwen2-VL's (t, h, w) positions) and ``decode_fn``
             (B = 8 over 7 tasks, 32 new tokens) whose kernel-9 launches
             are counted (168 a forward: three sites, two factors each,
             28 layers); every layer's ``kpos`` after it; prefill and
             decode-step walls, profiled prefill and decode windows, the
             prefill logits at the grid positions against text positions
             (they must differ: M-RoPE live), bf16 logits against the
             plain versions, and fp32, where fused and dense-routed
             decode must agree token for token.
14. deepseek — multi-tenant serving of deepseek-v2-236b at full width,
             cut in depth to 2 of its 60 layers (d_model 5,120, 128 heads
             of Multi-head Latent Attention: q_lora 1,536, kv_lora 512,
             nope 128 + rope 64, v 128; 160 routed experts of d_ff 1,536,
             top-6, and 2 shared; vocab 102,400; random weights from a
             seed): kernel 9 at its five factor shapes (5120, 16),
             (16384, 16), (3072, 16), (16, 1536), (16, 5120), S = 1 and
             640, as in the serve phase; one round at d = 1,163,270
             (kernels 1–3 there against their plain versions bitwise and
             timed), ``serving_downlink`` → ``ModulatorStore``, one bf16
             fused generate (B = 8 over 7 tasks, 640-token prompts: one
             full 512-row query chunk and one padded; 32 new tokens)
             whose kernel-9 launches are counted (12 a forward:
             ``mixer/wq_a``, ``mixer/wo`` and ``ffn/shared/down``, two
             factors each, 2 layers); the MLA latent cache's bytes and
             every layer's ``kpos``; prefill and decode-step walls, layer
             0's prefill split into MLA and MoE, the prefill's capacity
             drops, profiled prefill and decode windows, bf16 prefill
             logits against the plain versions (a printed router flip
             excuses a miss), layer 0's absorbed MLA decode against its
             naive form (printed), and fp32, where fused and dense-routed
             decode must agree token for token unless a router near-tie
             flip comes first, and layer 0's absorbed decode must agree
             with the naive form within rel L2 1e-4.
15. xlstm  — multi-tenant serving of xlstm-1.3b at full width (24
             (mLSTM, sLSTM) units, d_model 2048, 4 heads, Dk 256, Dv 1024,
             vocab 50,304; random weights from a seed).  Kernel checks:
             ``mlstm_chunkwise`` at B = 8, chunk 256, S = 512, a ragged
             500 and a ragged three-chunk 700, fp32 and bf16, zero and
             random initial state, h and the final (C, n, m) against its
             plain version, its pre-pass alone against the pre-pass's
             plain version, run to run and C in place bitwise; timed
             with each of its device functions' share of a call and its
             workspace bytes; then one
             round at d = 12,058,464 (kernel 3 checked and timed on the
             sign planes of its task vectors), ``serving_downlink`` →
             ``ModulatorStore``, and one bf16 fused generate (B = 8 over 7
             tasks, 512-token prompts, 32 new tokens) whose launches are
             counted (24 of kernel 10, 192 of kernel 9 per forward);
             prefill logits against the plain versions, step and
             per-block times, profiled prefill and decode windows; then
             fp32, where fused and dense-routed decode must agree token
             for token.
16. summary — the host µs a call of every kernel wrapper and of the
             call path's pieces (``time.perf_counter_ns`` over 10,000
             calls on small inputs, :func:`host_costs`), a ``kernels:``
             line, one JSON line with every kernel's numbers
             (``host_us`` among them), and the last line ``{"ok": true,
             "device": …}``.

The script needs a CUDA device and the rest of the repository: without
either it exits nonzero before printing any result.  ``--only round``
runs setup and the kernel phase alone (kernels 1–3 against their plain
versions and timed, and the whole-round gates: a quick loop for a
round-kernel change); ``--only bool`` runs setup and the bool phase
alone (kernels 4–7 and the bool round: a quick loop for a change to
them); ``--only devtime`` times kernels 3–8 alone by device function
(rows 4–7 at the full-width bool round, 8 on 9 member rows of 32 at
d = 3,588,168), any fill or conversion of a wrapper listed apart, then
kernel 7 warm and with a cold L2 (a 256 MB fill or read before each
call) and the host µs a call of every wrapper and of the call path's
pieces (it also runs from the root of an earlier checkout, to measure
it); ``--only
mlstm`` runs setup and kernel 10's checks and timings alone (a quick loop
for a kernel-10 change); ``--only granite``, ``--only whisper``, ``--only
hymba``, ``--only vlm`` and ``--only deepseek`` run setup and the granite,
whisper, hymba, vlm or deepseek phase alone; ``--only vit``, ``--only
baselines`` and ``--only lmtrain`` the vit, baselines or lmtrain phase.  None of them prints the summary or
the "ok" line.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N, K_MAX, T, D = 32, 4, 30, 1_327_140
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; fp32 outside the
# tensor cores — the table's only scalar-ALU rate, used for the integer
# popcount work too; dense bf16 and int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
INT8_TC_OPS_PER_S = 1979e12
REPS = 25
# device_ms: idle host time inside a profiled window before and after
# its calls (doubled for each window taken again), and the most
# windows it takes
PROFILE_MARGIN_S = 0.05
PROFILE_WINDOWS = 8


def log(msg: str = "") -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3,
            before=None) -> float:
    """Median device time of ``fn`` over ``reps`` CUDA-event-timed calls;
    ``before`` (an L2 flush), if given, runs and is waited for ahead of
    each timed call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def bound(n_bytes: float, n_ops: float, bf16_ops: float = 0.0,
          int8_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of bytes over the HBM rate,
    ``n_ops`` over the scalar fp32 peak, ``bf16_ops`` (products of bf16
    operands) over the bf16 tensor-core peak and ``int8_ops`` over the
    int8 tensor-core peak."""
    tb = n_bytes / HBM_BYTES_PER_S
    to = max(n_ops / SCALAR_OPS_PER_S, bf16_ops / BF16_TC_OPS_PER_S,
             int8_ops / INT8_TC_OPS_PER_S)
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations")


def max_abs(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(torch, name, got, want, rtol, atol) -> float:
    err = max_abs(torch, got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} "
                             f"beyond rtol {rtol}, atol {atol}")
    return err


def check_equal(torch, name, got, want) -> None:
    if not torch.equal(got, want):
        n_bad = int((got != want).sum())
        raise AssertionError(f"{name}: kernel vs plain differ in {n_bad} "
                             f"entries (must be identical)")


def bf16_bits(torch, x):
    return x.contiguous().view(torch.int16)


def setup(torch):
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("fp32 matmuls must run in full fp32 (no TF32)")
    from repro_torch.kernels import build, ops
    secs = build.timed_build(ops.KERNELS)
    log(f"built {len(ops.KERNELS)} kernels in {secs:.2f} s")
    for src, text in sorted(build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    return card


def make_round_inputs(torch, dev):
    """Full-width round inputs from a seeded generator on the card:
    (task_vectors (N, K, D) fp32 zero-padded, valid, slot_tasks,
    slot_sizes, ks)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    ks = 3 + (torch.rand(N, generator=g, device=dev) < 0.5).long()
    valid = torch.arange(K_MAX, device=dev)[None, :] < ks[:, None]
    tv = torch.randn((N, K_MAX, D), generator=g, device=dev) \
        * valid[:, :, None]
    tasks = torch.full((N, K_MAX), T, dtype=torch.int32, device=dev)
    for i in range(N):
        k = int(ks[i])
        perm = torch.randperm(T, generator=g, device=dev)[:k]
        tasks[i, :k] = torch.sort(perm).values.to(torch.int32)
    sizes = torch.randint(10, 200, (N, K_MAX), generator=g, device=dev)
    sizes = (sizes * valid).float()
    return tv, valid, tasks, sizes, [int(k) for k in ks.tolist()]


def kernel_phase(torch, dev):
    from repro_torch.core.engine import (EngineConfig, RoundEngine,
                                         pack_from_slots)
    from repro_torch.kernels import bitpack, fused_unify, masked_agg, ops

    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev)
    n_valid = sum(ks)
    w = bitpack.packed_width(D)
    rows = {}

    # -- fused_unify_packed: client upload construction -------------------
    got = fused_unify.fused_unify_packed_cuda(tv, valid)
    want = fused_unify.plain(tv, valid)
    torch.cuda.synchronize()
    check_equal(torch, "fused_unify words", got[1], want[1])
    check_equal(torch, "fused_unify unified (bf16 bits)",
                bf16_bits(torch, got[0]), bf16_bits(torch, want[0]))
    check_equal(torch, "fused_unify num", got[2], want[2])
    check_equal(torch, "fused_unify den", got[3], want[3])
    err = 0.0
    ms = time_ms(torch, lambda: fused_unify.fused_unify_packed_cuda(tv, valid))
    dev_ms, _, per_fn = device_ms(
        torch, "fused_unify",
        lambda: fused_unify.fused_unify_packed_cuda(tv, valid))
    plain_ms = time_ms(torch, lambda: fused_unify.plain(tv, valid), reps=5)
    # valid slot rows and the valid flags read; unified, words, num and
    # den written (the per-block partials are the kernel's own scratch)
    n_bytes = (n_valid * D * 4 + N * K_MAX + N * D * 2 + N * K_MAX * w * 4
               + 2 * N * K_MAX * 4)
    b_ms, b_by = bound(n_bytes, 10 * n_valid * D)
    rows["fused_unify_packed"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/fused_unify.cu",
        replaces="src/repro/kernels/fused_unify.py:124", max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        check="words, bf16 bits, num and den identical")
    log(f"fused_unify_packed (upload, B={N} K={K_MAX} d={D}, {n_valid} "
        f"valid slots): {ms:.4f} ms (device {dev_ms:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_fn.items())
        + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"num/den identical")

    # -- the round's dense inputs -----------------------------------------
    uni, words, lams = ops.fused_unify_packed(tv, valid)
    words_d, lams_d, member_d, sizes_d = ops.slots_to_dense_packed(
        words, lams, sizes, valid, tasks, T)
    memf = member_d.float()
    gam = sizes_d * memf
    gam = gam / torch.clamp(gam.sum(0, keepdim=True), min=1e-12)
    n_member_rows = int(member_d.sum())

    # -- masked_agg_batched_packed ----------------------------------------
    args = (uni, words_d, lams_d, gam, member_d, D, 0.4)
    got = masked_agg.masked_agg_batched_packed_cuda(*args)
    want = masked_agg.plain(*args)
    torch.cuda.synchronize()
    check_equal(torch, "masked_agg alpha_num", got[1], want[1])
    check_equal(torch, "masked_agg tau_hat", got[0], want[0])
    again = masked_agg.masked_agg_batched_packed_cuda(*args)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, again)):
        check_equal(torch, f"masked_agg run to run, output {i}", a, b)
    err = max_abs(torch, got[0], want[0])
    tau_hats = got[0]
    ms = time_ms(torch, lambda: masked_agg.masked_agg_batched_packed_cuda(
        *args))
    dev_ms, _, per_fn = device_ms(
        torch, "masked_agg",
        lambda: masked_agg.masked_agg_batched_packed_cuda(*args))
    plain_ms = time_ms(torch, lambda: masked_agg.plain(*args), reps=5)
    n_bytes = (N * D * 2 + n_member_rows * w * 4 + 2 * N * T * 4
               + 2 * T * D * 4)
    b_ms, b_by = bound(n_bytes, 8 * n_member_rows * D)
    rows["masked_agg_batched_packed"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/masked_agg.cu",
        replaces="src/repro/kernels/masked_agg.py:139", max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        check="alpha_num and tau_hat identical")
    tile = masked_agg.packed_tile(N, uni.element_size())
    log(f"masked_agg_batched_packed (N={N} T={T} d={D}, {n_member_rows} "
        f"member rows; tile {tile}): {ms:.4f} ms (device {dev_ms:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_fn.items())
        + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"max|err| {err}")

    # -- sign_sim_packed --------------------------------------------------
    pos, nz = bitpack.sign_planes(tau_hats)
    rows["sign_sim_packed"] = sign_sim_packed_check(torch, pos, nz, tau_hats)

    # -- one whole round: kernels vs plain versions -----------------------
    engine = RoundEngine(EngineConfig(n_tasks=T), device=dev)
    cids = list(range(N))
    tids = [tasks[i, :ks[i]].tolist() for i in range(N)]
    packed = pack_from_slots(cids, tids, uni, words, lams, tasks, valid,
                             sizes, T, d=D)
    out_k = engine.run_packed(packed)
    out_p = engine.run_packed(packed, mode="ref")
    torch.cuda.synchronize()
    check_equal(torch, "round alpha_num", out_k.alpha_num, out_p.alpha_num)
    check_equal(torch, "round n_held", out_k.n_held, out_p.n_held)
    check_equal(torch, "round similarity", out_k.similarity,
                out_p.similarity)
    check_equal(torch, "round task_vectors", out_k.task_vectors,
                out_p.task_vectors)
    bits_k = bitpack.unpack_bits(out_k.down_masks, D)
    bits_p = bitpack.unpack_bits(out_p.down_masks, D)
    valid_bits = valid[:, :, None].expand_as(bits_k)
    agree = float((bits_k == bits_p)[valid_bits].float().mean())
    check_equal(torch, "round downlink mask bits", bits_k[valid_bits],
                bits_p[valid_bits])
    ulp = (bf16_bits(torch, out_k.down_unified).int()
           - bf16_bits(torch, out_p.down_unified).int()).abs().max()
    check_equal(torch, "round downlink bf16 bits",
                bf16_bits(torch, out_k.down_unified),
                bf16_bits(torch, out_p.down_unified))
    if not torch.isfinite(out_k.task_vectors).all():
        raise AssertionError("round task vectors not finite")
    log(f"round kernels vs plain: downlink bits agree {agree}, bf16 max "
        f"ulp {int(ulp)}, task vectors max|err| "
        f"{max_abs(torch, out_k.task_vectors, out_p.task_vectors)}")

    # -- fused_unify_packed: downlink re-unification ----------------------
    tvs_slots = out_k.task_vectors[torch.clamp(tasks.long(), max=T - 1)]
    got = fused_unify.fused_unify_packed_cuda(tvs_slots, valid)
    want = fused_unify.plain(tvs_slots, valid)
    torch.cuda.synchronize()
    check_equal(torch, "downlink words", got[1], want[1])
    check_equal(torch, "downlink bf16 bits", bf16_bits(torch, got[0]),
                bf16_bits(torch, want[0]))
    check_equal(torch, "downlink num", got[2], want[2])
    check_equal(torch, "downlink den", got[3], want[3])
    again = fused_unify.fused_unify_packed_cuda(tvs_slots, valid)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, again)):
        check_equal(torch, f"downlink run to run, output {i}", a, b)
    ms_down = time_ms(torch, lambda: fused_unify.fused_unify_packed_cuda(
        tvs_slots, valid))
    dev_down, _, _ = device_ms(
        torch, "fused_unify",
        lambda: fused_unify.fused_unify_packed_cuda(tvs_slots, valid))
    log(f"fused_unify_packed (downlink, same shape): {ms_down:.4f} ms "
        f"(device {dev_down:.4f} ms); num/den identical, run to run "
        f"identical")
    del tv, tvs_slots, out_k, out_p, bits_k, bits_p, packed
    torch.cuda.empty_cache()
    return rows


def sign_sim_packed_check(torch, pos, nz, x):
    """Kernel 3 on the sign planes (pos, nz) of ``x`` (T, d): its dots
    against the plain version and the fp32 ``sgn(x) @ sgn(x).T``, run to
    run, and the first design's (the route for T > 64, here forced) —
    all bitwise; timed by CUDA events and by device time (each device
    function's share), beside the first design's, the plain version and
    the library product.  Returns the kernel's row."""
    from repro_torch.kernels import sign_sim
    t, w = pos.shape
    blocks, per, route = sign_sim.packed_plan(
        t, w, torch.cuda.get_device_properties(pos.device)
        .multi_processor_count)
    got = sign_sim.sign_sim_packed_cuda(pos, nz)
    again = sign_sim.sign_sim_packed_cuda(pos, nz)
    first = sign_sim.sign_sim_packed_cuda(pos, nz, route="popc")
    want = sign_sim.plain(pos, nz)
    sgn = torch.sign(x)
    lib = sgn @ sgn.T
    del sgn
    torch.cuda.synchronize()
    check_equal(torch, "sign_sim_packed dots", got, want)
    check_equal(torch, "sign_sim_packed dots vs sgn @ sgn.T", got, lib)
    check_equal(torch, "sign_sim_packed run to run", again, got)
    check_equal(torch, "sign_sim_packed first design", first, want)
    ms = time_ms(torch, lambda: sign_sim.sign_sim_packed_cuda(pos, nz))
    dev_ms, _, per_fn = device_ms(
        torch, "sign_sim_packed", lambda: sign_sim.sign_sim_packed_cuda(pos, nz))
    first_ms = time_ms(torch, lambda: sign_sim.sign_sim_packed_cuda(
        pos, nz, route="popc"))
    first_dev, _, first_fn = device_ms(
        torch, "sign_sim_packed",
        lambda: sign_sim.sign_sim_packed_cuda(pos, nz, route="popc"))
    plain_ms = time_ms(torch, lambda: sign_sim.plain(pos, nz), reps=5)
    lib_ms = time_ms(torch, lambda: torch.sign(x) @ torch.sign(x).T)
    # planes read once, dots written; the pairs' int8 products (a
    # multiply and an add a coordinate) on the tensor cores
    b_ms, b_by = bound(2 * t * w * 4 + t * t * 4, 0.0,
                       int8_ops=2 * (t * (t + 1) // 2) * 32 * w)

    def share(fns):
        return ", ".join(f"{fn_name(k)} {v:.4f}" for k, v in fns.items())
    log(f"sign_sim_packed (T={t} w={w}; {route}: {blocks} blocks of {per} "
        f"words): {ms:.4f} ms (device {dev_ms:.4f} ms: {share(per_fn)}); "
        f"first design {first_ms:.4f} ms (device {first_dev:.4f} ms: "
        f"{share(first_fn)}); plain {plain_ms:.4f} ms, library sign@sign.T "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); dots identical to "
        f"the plain version, sgn @ sgn.T and the first design, run to run "
        f"identical")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sign_sim.cu",
        replaces="src/repro/kernels/sign_sim.py:70", max_abs_err=0.0,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, first_design_ms=first_ms,
        first_design_device_ms=first_dev,
        check="dots identical to the plain version, the fp32 sgn @ sgn.T "
        "and the first design; run to run identical")


def sim_form_check(torch, dev, d):
    """Which form ``ref.sim_from_dots`` takes on the card: its S for every
    integer dot in [-d, d] against 0.5 * (dots * fl32(1/d) + 1) and
    0.5 * (dots / d + 1), each rounded once an operation (numpy fp32 on
    the host).  The dense kernel writes the first; raises unless the card
    gives it bit for bit.  Returns the entries where each form differs."""
    import numpy as np
    from repro_torch.kernels import ref, sign_sim
    dots = np.arange(-d, d + 1, dtype=np.float32)
    card = ref.sim_from_dots(torch.from_numpy(dots).to(dev), d).cpu().numpy()
    half, one = np.float32(0.5), np.float32(1.0)
    recip = half * (dots * np.float32(sign_sim.reciprocal(d)) + one)
    div = half * (dots / np.float32(d) + one)
    n_recip = int((card != recip).sum())
    n_div = int((card != div).sum())
    log(f"sim_from_dots on the card at d={d}: differs from the reciprocal "
        f"form in {n_recip} of {dots.size} dots, from the division in "
        f"{n_div}")
    if n_recip:
        raise AssertionError("torch's S on the card is not 0.5 * (dots * "
                             "fl32(1/d) + 1): the dense kernel's epilogue "
                             "would differ from the packed round's S")
    return {"reciprocal": n_recip, "division": n_div}


def sign_sim_dense_check(torch, x):
    """Kernel 6 on dense (T, d) fp32 ``x``: its S against the plain
    version, the packed form (``ops.sign_sim_packed`` on the sign planes
    of ``x``), run to run and the first design's (the route for T > 64,
    here forced) -- all bitwise; timed by CUDA events and by device time
    (each device function's share), beside the first design's, the plain
    version and the library product.  Returns the kernel's row."""
    from repro_torch.kernels import bitpack, ops, sign_sim
    t, d = x.shape
    blocks, per, route = sign_sim.dense_plan(
        t, d, torch.cuda.get_device_properties(x.device)
        .multi_processor_count)
    forms = sim_form_check(torch, x.device, d)
    got = sign_sim.sign_sim_cuda(x)
    again = sign_sim.sign_sim_cuda(x)
    first = sign_sim.sign_sim_cuda(x, route="dp4a")
    want = sign_sim.plain_dense(x)
    packed = ops.sign_sim_packed(*bitpack.sign_planes(x), d)
    torch.cuda.synchronize()
    check_equal(torch, "sign_sim S", got, want)
    check_equal(torch, "sign_sim vs the popcount form", got, packed)
    check_equal(torch, "sign_sim run to run", again, got)
    check_equal(torch, "sign_sim first design", first, want)
    ms = time_ms(torch, lambda: sign_sim.sign_sim_cuda(x))
    dev_ms, _, per_fn = device_ms(torch, "sign_sim",
                                  lambda: sign_sim.sign_sim_cuda(x))
    first_ms = time_ms(torch, lambda: sign_sim.sign_sim_cuda(x, route="dp4a"))
    first_dev, _, first_fn = device_ms(
        torch, "sign_sim", lambda: sign_sim.sign_sim_cuda(x, route="dp4a"))
    plain_ms = time_ms(torch, lambda: sign_sim.plain_dense(x), reps=5)
    lib_ms = time_ms(torch, lambda: torch.sign(x) @ torch.sign(x).T)
    # x read once, S written; the pairs' int8 sign products (a multiply
    # and an add a coordinate) on the tensor cores
    b_ms, b_by = bound(t * d * 4 + t * t * 4, 0.0,
                       int8_ops=2 * (t * (t + 1) // 2) * d)

    def share(fns):
        return ", ".join(f"{fn_name(k)} {v:.4f}" for k, v in fns.items())
    log(f"sign_sim (T={t} d={d}; {route}: {blocks} blocks of {per} "
        f"coordinates): {ms:.4f} ms (device {dev_ms:.4f} ms: "
        f"{share(per_fn)}); first design {first_ms:.4f} ms (device "
        f"{first_dev:.4f} ms: {share(first_fn)}); plain {plain_ms:.4f} ms, "
        f"library sign@sign.T {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"S identical to the plain version, the packed form and the first "
        f"design, run to run identical")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sign_sim.cu",
        replaces="src/repro/kernels/sign_sim.py:37", max_abs_err=0.0,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, first_design_ms=first_ms,
        first_design_device_ms=first_dev, sim_form_mismatches=forms,
        check="S identical to the plain version, the packed form "
        "(sim_from_dots of kernel 3's dots) and the first design; run to "
        "run identical")


def round_phase(torch, dev):
    from repro_torch.fed.strategies import MaTUStrategy, Upload
    from repro_torch.kernels import ops

    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev)
    tids = [tasks[i, :ks[i]].tolist() for i in range(N)]
    szs = [sizes[i, :ks[i]].tolist() for i in range(N)]
    uploads = [Upload(i, tids[i], tv[i, :ks[i]].clone(), szs[i])
               for i in range(N)]
    del tv
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    strat = MaTUStrategy(T, D, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for r in range(3):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strat.aggregate(uploads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        rose = {k: after[k] - before[k] for k in ops.PACKED_ROUND_KERNELS}
        if min(rose.values()) < 1:
            raise AssertionError(f"round {r}: a kernel was not launched: "
                                 f"{rose}")
        tv_out = strat.server.last_task_vectors
        if not torch.isfinite(tv_out).all() or tv_out.shape != (T, D):
            raise AssertionError(f"round {r}: bad task vectors")
        log(f"round {r}: wall {1e3 * wall:.2f} ms, uplink "
            f"{strat.uplink_bits(uploads)} bits, downlink "
            f"{strat.downlink_bits()} bits, launches {rose}")
        uploads = [Upload(u.client_id, u.task_ids, torch.stack(
            [strat.task_init(u.client_id, t) for t in u.task_ids])
            + 0.1 * torch.randn((len(u.task_ids), D), generator=g,
                                device=dev), u.data_sizes) for u in uploads]
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    log(f"round phase: peak device memory {peak / 2**30:.3f} GiB, "
        f"launches {counts}")
    profile_round(torch, strat, uploads)
    del uploads, strat
    torch.cuda.empty_cache()
    return counts


def profile_round(torch, strat, uploads, top: int = 8) -> None:
    """One more full-width round under ``torch.profiler``: the summed
    device time of its kernels and copies against the host wall time
    (the idle share), and the ops that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        strat.aggregate(uploads)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    log(f"profiled round: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


def bool_phase(torch, dev):
    """The bool/fp32 A/B layout at full width: each kernel against its
    plain version, then one bool round through the entry points (its
    launch counts read around it), held against the plain round and the
    packed round bit for bit.  Returns (rows, launches by kernel)."""
    from repro_torch.core.engine import (EngineConfig, RoundEngine,
                                         batched_client_unify,
                                         pack_from_slots)
    from repro_torch.kernels import (bitpack, fused_unify, masked_agg, ops,
                                     sign_sim)

    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev)
    # bf16-valued task vectors: unify elects one of them per coordinate,
    # so the fp32 unified vectors equal the packed round's bf16 ones
    tv = tv.to(torch.bfloat16).float()
    n_valid = sum(ks)
    rows = {}

    def row(name, source, replaces, got, want, ms, plain_ms, n_bytes, n_ops,
            library_ms=None, dev=None):
        b_ms, b_by = bound(n_bytes, n_ops)
        err = max(max_abs(torch, a, b) for a, b in zip(got, want))
        rows[name] = dict(
            route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            check="every output identical to the plain version")
        share = ""
        if dev is not None:               # (device ms, {function: ms})
            rows[name]["device_ms"] = dev[0]
            share = f" (device {dev[0]:.4f} ms: " + ", ".join(
                f"{fn_name(k)} {v:.4f}" for k, v in dev[1].items()) + ")"
        log(f"{name}: {ms:.4f} ms{share}, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})"
            + ("" if library_ms is None else f", library {library_ms:.4f} ms")
            + f"; max|err| {err}")

    def same(name, got, want):
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            check_equal(torch, f"{name} output {i}", a, b)

    # -- fused_unify (bool): client upload construction -------------------
    got = fused_unify.fused_unify_cuda(tv, valid)
    want = fused_unify.plain_bool(tv, valid)
    same("fused_unify", got, want)
    # its wrapper's fill and ref._tree_total's adds count in its device time
    _, _, per_fn = device_ms(
        torch, "fused_unify", lambda: fused_unify.fused_unify_cuda(tv, valid),
        apart=True)
    row("fused_unify", "fused_unify.cu", "src/repro/kernels/fused_unify.py:60",
        got, want,
        time_ms(torch, lambda: fused_unify.fused_unify_cuda(tv, valid)),
        time_ms(torch, lambda: fused_unify.plain_bool(tv, valid), reps=5),
        # valid slot rows and flags read; fp32 unified, mask bytes, num
        # and den written
        n_valid * D * 4 + N * K_MAX + N * D * 4 + N * K_MAX * D
        + 2 * N * K_MAX * 4, 10 * n_valid * D,
        dev=(sum(per_fn.values()), per_fn))

    # -- unify: one client of the most slots, fp32 and bf16 ----------------
    k1 = max(ks)
    x1 = tv[ks.index(k1), :k1]

    def unify_row(name, x, fp32_out=None):
        """Kernel 7 on ``x`` against its plain version and run to run in
        fp32 bit patterns (and against ``fp32_out``, the output of the
        same values in fp32), timed; returns its output."""
        got = fused_unify.unify_cuda(x)
        again = fused_unify.unify_cuda(x)
        want = fused_unify.plain_unify(x)
        torch.cuda.synchronize()
        pairs = [("", got, want), (" run to run", again, want)]
        if fp32_out is not None:
            pairs.append((" vs fp32 input", got, fp32_out))
        for what, a, b in pairs:
            check_equal(torch, f"{name}{what} (fp32 bits)",
                        a.view(torch.int32), b.view(torch.int32))
        vec, blocks, per, route = fused_unify.unify_plan(
            k1, D, x.dtype, (x.data_ptr() % 8) // x.element_size())
        row(name, "fused_unify.cu", "src/repro/kernels/unify.py:37",
            (got,), (want,),
            time_ms(torch, lambda: fused_unify.unify_cuda(x)),
            time_ms(torch, lambda: fused_unify.plain_unify(x), reps=5),
            k1 * D * x.element_size() + D * 4, 4 * k1 * D,
            dev=device_ms(torch, "unify",
                          lambda: fused_unify.unify_cuda(x))[::2])
        log(f"  ({name} at K={k1}, d={D}; {route} route, V={vec}, "
            f"{blocks} blocks, tiles of {per}; fp32 bits identical to the "
            f"plain version, run to run)")
        return got

    # bf16-valued task vectors: the bf16 copy holds the same values
    fp32_out = unify_row("unify", x1)
    unify_row("unify bf16", x1.to(torch.bfloat16), fp32_out)
    rows["unify"]["bf16"] = rows.pop("unify bf16")
    del fp32_out                            # not held through the round

    # -- masked_agg_batched (bool) ----------------------------------------
    uni, masks, lams = ops.fused_unify(tv, valid)
    masks_d, lams_d, member_d, sizes_d = ops.slots_to_dense(
        masks, lams, sizes, valid, tasks, T)
    memf = member_d.float()
    gam = sizes_d * memf
    gam = gam / torch.clamp(gam.sum(0, keepdim=True), min=1e-12)
    n_member_rows = int(member_d.sum())
    args = (uni, masks_d, lams_d, gam, member_d, 0.4)
    got = masked_agg.masked_agg_batched_cuda(*args)
    want = masked_agg.plain_bool(*args)
    same("masked_agg_batched", got, want)
    same("masked_agg_batched run to run", got,
         masked_agg.masked_agg_batched_cuda(*args))
    # kernel 2 on the same mask bits: the same tau_hat
    same("masked_agg_batched vs masked_agg_batched_packed", got[:1],
         masked_agg.masked_agg_batched_packed_cuda(
             uni.to(torch.bfloat16), bitpack.pack_bits(masks_d), lams_d, gam,
             member_d, D, 0.4)[:1])
    tau_hats = got[0]
    dev_ms, _, per_fn = device_ms(
        torch, "masked_agg", lambda: masked_agg.masked_agg_batched_cuda(*args))
    row("masked_agg_batched", "masked_agg.cu",
        "src/repro/kernels/masked_agg.py:67", got, want,
        time_ms(torch, lambda: masked_agg.masked_agg_batched_cuda(*args)),
        time_ms(torch, lambda: masked_agg.plain_bool(*args), reps=5),
        # unified once, the member mask rows, the (N, T) scalars; tau_hat
        # and m_hat written
        N * D * 4 + n_member_rows * D + 3 * N * T * 4 + 2 * T * D * 4,
        8 * n_member_rows * D, dev=(dev_ms, per_fn))
    log(f"  ({n_member_rows} member rows; tau_hat identical to "
        f"masked_agg_batched_packed's on the same bits, run to run "
        f"identical)")
    del masks_d, args

    # -- sign_sim (dense) -------------------------------------------------
    rows["sign_sim"] = sign_sim_dense_check(torch, tau_hats)
    del uni, masks, lams, tau_hats, got, want

    # -- one bool round through the entry points --------------------------
    engine = RoundEngine(EngineConfig(n_tasks=T), device=dev)
    cids = list(range(N))
    tids = [tasks[i, :ks[i]].tolist() for i in range(N)]

    def bool_round(mode=None):
        uni, masks, lams = batched_client_unify(tv, valid, packed=False,
                                                device=dev, mode=mode)
        batch = pack_from_slots(cids, tids, uni, masks, lams, tasks, valid,
                                sizes, T, d=D)
        out = engine.run_packed(batch, mode=mode)
        return (uni, masks, lams), batch, out, engine.downlinks(batch, out)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    up_b, batch_b, out_b, downs_b = bool_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want_counts = {"fused_unify": 2, "masked_agg_batched": 1, "sign_sim": 1}
    if any(counts[k] != v for k, v in want_counts.items()) or any(
            counts[k] for k in ops.PACKED_ROUND_KERNELS):
        raise AssertionError(f"bool round launches {counts}, expected "
                             f"{want_counts} and no packed-path kernel")
    if not torch.isfinite(out_b.task_vectors).all() or \
            out_b.task_vectors.shape != (T, D) or len(downs_b) != N:
        raise AssertionError("bool round: bad task vectors or downlinks")
    log(f"bool round: wall {1e3 * wall:.2f} ms (first), peak device memory "
        f"{peak / 2**30:.3f} GiB, uplink {batch_b.wire_bits()} bits (paper "
        f"accounting), launches { {k: counts[k] for k in want_counts} }")

    # kernels against the plain versions, whole round
    up_r, _, out_r, _ = bool_round(mode="ref")
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(up_b, up_r)):
        check_equal(torch, f"bool upload {i} kernels vs plain", a, b)
    for f in out_b._fields:
        a, b = getattr(out_b, f), getattr(out_r, f)
        if isinstance(a, torch.Tensor):
            check_equal(torch, f"bool round {f} kernels vs plain", a, b)
    del out_r, up_r

    # the packed round on the same task vectors, bit for bit
    uni_p, words_p, lams_p = batched_client_unify(tv, valid, device=dev)
    batch_p = pack_from_slots(cids, tids, uni_p, words_p, lams_p, tasks,
                              valid, sizes, T, d=D)
    out_p = engine.run_packed(batch_p)
    torch.cuda.synchronize()
    pairs = [
        ("upload masks", bitpack.pack_bits(up_b[1]), words_p),
        ("upload bf16 unified", bf16_bits(torch, up_b[0].to(torch.bfloat16)),
         bf16_bits(torch, uni_p)),
        ("upload lambda", up_b[2], lams_p),
        ("m_hat", out_b.m_hats, out_p.m_hats),
        ("similarity", out_b.similarity, out_p.similarity),
        ("tau_hat", out_b.tau_hats, out_p.tau_hats),
        ("task vectors", out_b.task_vectors, out_p.task_vectors),
        ("downlink masks", bitpack.pack_bits(out_b.down_masks),
         out_p.down_masks),
        ("downlink lambda", out_b.down_lams, out_p.down_lams),
        ("downlink bf16 unified",
         bf16_bits(torch, out_b.down_unified.to(torch.bfloat16)),
         bf16_bits(torch, out_p.down_unified))]
    for name, a, b in pairs:
        check_equal(torch, f"bool vs packed round: {name}", a, b)
    log(f"bool round: identical to the plain round and to the packed round "
        f"({len(pairs)} outputs); packed uplink {batch_p.wire_bits()} bits")

    # unify has no round path: its entry point, driven once
    ops.reset_launch_counts()
    u1 = ops.unify(x1)
    counts["unify"] = ops.launch_counts()["unify"]
    check_equal(torch, "ops.unify", u1, fused_unify.plain_unify(x1))
    del tv, batch_b, out_b, batch_p, out_p, up_b, downs_b
    torch.cuda.empty_cache()
    return rows, counts


FLUSH_BYTES = 256 << 20        # more than twice the H100's 50 MB L2
HOST_CALLS = 10_000
UNIFY_REPS = 101               # a cold call is cheap: more reps steady the median


def unify_cold(torch, dev, x1):
    """Kernel 7 (``fused_unify.unify_cuda``) on ``x1`` (K, d) fp32 and on
    its bf16 copy: warm (its input left in L2 by the call before, as for
    every other row) and cold.  Before each cold call a 256 MB buffer
    goes through L2 once: overwritten by one fill ("fill": L2 then holds
    the fill's dirty lines, written back while the kernel runs) or read
    by one sum ("read": clean lines).  The flush is waited for outside
    the CUDA events, and its device time is listed apart from the
    kernel's.  Returns {dtype: numbers}."""
    from repro_torch.kernels import fused_unify
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flushes = {"fill": lambda: flush.fill_(1.0), "read": flush.sum}
    out = {}
    for name, x in (("fp32", x1), ("bf16", x1.to(torch.bfloat16))):
        k, d = x.shape
        b_ms, _ = bound(k * d * x.element_size() + d * 4, 4 * k * d)
        row = {"bound_ms": b_ms}
        for how, before in (("warm", None), *flushes.items()):
            def call():
                return fused_unify.unify_cuda(x)

            def flushed():
                before()
                return call()
            ms = time_ms(torch, call, reps=UNIFY_REPS, before=before)
            own, _, per = device_ms(torch, "unify",
                                    call if before is None else flushed,
                                    apart=True)
            row[how] = dict(ms=ms, device_ms=own, by_function={
                fn_name(key): v for key, v in per.items()})
            log(f"unify {name} (K={k} d={d}) {how}: {ms:.4f} ms a call, "
                f"device {own:.4f} ms ({100 * b_ms / own:.0f} % of the "
                f"{b_ms:.4f} ms bound); " + ", ".join(
                    f"{fn_name(key)} {v:.4f}" for key, v in per.items()))
        out[name] = row
    return out


def host_us(torch, fn, n: int = HOST_CALLS, batches: int = 10) -> float:
    """Host µs a call of ``fn``: ``time.perf_counter_ns`` over ``n``
    calls (after 100 to warm up) in ``batches`` runs of equal length, the
    least batch mean (the host is shared, and what other work adds only
    ever lengthens a batch).  The device is kept ahead: callers pass
    inputs small enough that the device time of a call is below its host
    time, so the launch queue never fills."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter_ns()
        for _ in range(n // batches):
            fn()
        best = min(best, time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    return best / (n // batches) / 1e3


def host_costs(torch, dev):
    """Host µs a call of every kernel wrapper on small inputs (device
    time well under the host's), and of the pieces of a wrapper's call
    path (the device guard, the stream lookup, the output allocation, a
    bound kernel's load), each over :data:`HOST_CALLS` calls.  Pieces an
    earlier checkout lacks are left out.  Returns {name: µs}."""
    from repro_torch.kernels import (bitpack, build, fused_unify, masked_agg,
                                     mlstm_chunk, modulated_matmul,
                                     sign_sim)
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    b, k, d, n, t = 2, 4, 4096, 4, 3
    tv = torch.randn((b, k, d), generator=g, device=dev)
    valid = torch.ones((b, k), dtype=torch.bool, device=dev)
    x1 = tv[0].contiguous()
    uni = torch.randn((n, d), generator=g, device=dev)
    masks = torch.rand((n, t, d), generator=g, device=dev) < 0.7
    words = bitpack.pack_bits(masks)
    lams = torch.rand((n, t), generator=g, device=dev) + 0.5
    member = torch.ones((n, t), dtype=torch.bool, device=dev)
    gam = torch.full((n, t), 1.0 / n, device=dev)
    uni_h = uni.to(torch.bfloat16)
    m1, l1, g1 = (a[:, 0].contiguous() for a in (masks, lams, gam))
    tau = torch.randn((t, d), generator=g, device=dev)
    pos, nz = bitpack.sign_planes(tau)
    xm = torch.randn((2, 1, 896), generator=g, device=dev)
    base = torch.randn((896, 16), generator=g, device=dev)
    taum = base.to(torch.bfloat16)
    wm = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 896 * 16 // 32),
                       generator=g, device=dev, dtype=torch.int32)
    lm = torch.rand(2, generator=g, device=dev)
    margs, mst = mlstm_inputs(torch, dev, g, 1, 1, 64, 16, 16,
                              torch.float32, True)
    wrappers = {
        "fused_unify_packed": lambda: fused_unify.fused_unify_packed_cuda(
            tv, valid),
        "masked_agg_batched_packed": lambda: (
            masked_agg.masked_agg_batched_packed_cuda(
                uni_h, words, lams, gam, member, d, 0.4)),
        "sign_sim_packed": lambda: sign_sim.sign_sim_packed_cuda(pos, nz),
        "fused_unify": lambda: fused_unify.fused_unify_cuda(tv, valid),
        "masked_agg_batched": lambda: masked_agg.masked_agg_batched_cuda(
            uni, masks, lams, gam, member, 0.4),
        "sign_sim": lambda: sign_sim.sign_sim_cuda(tau),
        "unify": lambda: fused_unify.unify_cuda(x1),
        "masked_agg": lambda: masked_agg.masked_agg_cuda(
            uni, m1, l1, g1, 0.4),
        "modulated_matmul": lambda: modulated_matmul.modulated_matmul_cuda(
            xm, base, taum, wm, lm),
        "mlstm_chunkwise": lambda: mlstm_chunk.mlstm_chunkwise_cuda(
            *margs, mst, chunk=64)}
    pieces = {
        "torch.cuda.device enter/exit": lambda: _enter(torch.cuda.device(
            dev)),
        "torch.cuda.current_stream().cuda_stream": lambda: (
            torch.cuda.current_stream(dev).cuda_stream),
        "torch.empty((d,))": lambda: torch.empty((d,), dtype=torch.float32,
                                                 device=dev),
        "CudaKernel.load() once bound": fused_unify.KERNEL_UNIFY.load,
        "build.stream_handle": lambda: build.stream_handle(x1)}
    if hasattr(build, "on_device"):
        pieces["build.on_device enter/exit"] = lambda: _enter(
            build.on_device(x1))
    out = {}
    for label, group in (("wrapper", wrappers), ("piece", pieces)):
        for name, fn in group.items():
            out[name] = host_us(torch, fn)
            log(f"host {label} {name}: {out[name]:.3f} us a call")
    return out


def _enter(ctx) -> None:
    with ctx:
        pass


def devtime_phase(torch, dev):
    """Kernels 3-8 alone (4: ``fused_unify_cuda``, 5: bool
    ``masked_agg_batched_cuda``, 6: ``sign_sim_cuda``, 7: ``unify_cuda``
    at K = 4, all at the full-width bool round; 3: ``sign_sim_packed_cuda``
    there and on seeded random planes of the xLSTM round's width,
    w = 376,827; 8: ``masked_agg_cuda`` on seeded bf16 unified rows at
    the qwen2 round's d = 3,588,168, N = 32 of which 9 members, the rest
    with a mask and gamma = 0): ms a call, device time by function, any
    other launch of a wrapper (a fill, a conversion) listed apart; then
    kernel 7 with a cold L2 (:func:`unify_cold`) and the host µs a call
    of every wrapper and of the call path's pieces (:func:`host_costs`).  It calls only entry
    points that every slice of the port since the serve slice has (or
    checks that a piece exists), so it also measures an earlier checkout
    of the package: copy this script into that checkout's root and run
    it there with ``--only devtime``.  Returns the numbers as a dict."""
    from repro_torch.kernels import (bitpack, fused_unify, masked_agg, ops,
                                     sign_sim)
    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev)
    tv = tv.to(torch.bfloat16).float()
    x1 = tv[ks.index(max(ks)), :max(ks)].contiguous()
    uni, masks, lams = ops.fused_unify(tv, valid)
    masks_d, lams_d, member_d, sizes_d = ops.slots_to_dense(
        masks, lams, sizes, valid, tasks, T)
    del masks
    gam = sizes_d * member_d.float()
    gam = gam / torch.clamp(gam.sum(0, keepdim=True), min=1e-12)
    args = (uni, masks_d, lams_d, gam, member_d, 0.4)
    tau_hats = masked_agg.masked_agg_batched_cuda(*args)[0]
    planes = bitpack.sign_planes(tau_hats)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    nz = torch.randint(-2 ** 31, 2 ** 31 - 1, (T, 376_827), generator=g,
                       device=dev, dtype=torch.int32)
    wide = (torch.randint(-2 ** 31, 2 ** 31 - 1, nz.shape, generator=g,
                          device=dev, dtype=torch.int32) & nz, nz)
    # kernel 8: 9 members of 32 rows, the others a mask and gamma = 0
    n_mem = 9
    u8 = (0.05 * torch.randn((N, SERVE_D), generator=g, device=dev)).to(
        torch.bfloat16)
    m8 = torch.rand((N, SERVE_D), generator=g, device=dev) < 0.7
    l8 = torch.rand(N, generator=g, device=dev) + 0.5
    sz = torch.randint(10, 200, (N,), generator=g, device=dev).float()
    sz[torch.randperm(N, generator=g, device=dev)[n_mem:]] = 0.0
    g8 = sz / sz.sum()
    cases = {
        "fused_unify": ("fused_unify", lambda: (
            fused_unify.fused_unify_cuda(tv, valid))),
        "masked_agg_batched": ("masked_agg", lambda: (
            masked_agg.masked_agg_batched_cuda(*args))),
        "sign_sim": ("sign_sim", lambda: sign_sim.sign_sim_cuda(tau_hats)),
        "unify": ("unify", lambda: fused_unify.unify_cuda(x1)),
        "masked_agg": ("masked_agg", lambda: (
            masked_agg.masked_agg_cuda(u8, m8, l8, g8, 0.4))),
        "sign_sim_packed": ("sign_sim_packed", lambda: (
            sign_sim.sign_sim_packed_cuda(*planes))),
        "sign_sim_packed_w376827": ("sign_sim_packed", lambda: (
            sign_sim.sign_sim_packed_cuda(*wide)))}
    out = {}
    for name, (prefix, fn) in cases.items():
        ms = time_ms(torch, fn)
        own, _, per = device_ms(torch, prefix, fn, apart=True)
        out[name] = dict(ms=ms, device_ms=own, by_function={
            fn_name(k): v for k, v in per.items()})
        log(f"{name}: {ms:.4f} ms a call, device {own:.4f} ms; "
            + ", ".join(f"{fn_name(k)} {v:.4f}" for k, v in per.items()))
    out["unify_cold"] = unify_cold(torch, dev, x1)
    out["host_us"] = host_costs(torch, dev)
    return out


def app_phase(torch, dev):
    import numpy as np
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import FedAvgStrategy, MaTUStrategy
    from repro_torch.fed.testbed import MLPBackbone
    from repro_torch.kernels import ops

    n_tasks = 6
    con = make_constellation(n_tasks=n_tasks, n_groups=3, feat_dim=32,
                             n_classes=8, conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=9, n_tasks=n_tasks, n_classes=8,
                            zeta_t=0.5, tasks_per_client=2, seed=0)
    bb = MLPBackbone(32, hidden=64, lora_rank=8)
    cfg = FedConfig(rounds=3, local_steps=25, lr=1e-2, eval_every=1, seed=0)
    counts = {}
    for name, cls in [("matu", MaTUStrategy), ("fedavg", FedAvgStrategy)]:
        ops.reset_launch_counts()
        strat = cls(n_tasks, bb.d, device=dev)
        t0 = time.perf_counter()
        hist = FedSimulator(cfg, con, split, bb, strat, device=dev).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        for r, acc in zip(hist.rounds, hist.mean_acc):
            log(f"app {name} round {r}: mean acc {acc:.4f}")
        if not all(0.0 <= a <= 1.0 for a in hist.mean_acc):
            raise AssertionError(f"app {name}: accuracy out of range")
        log(f"app {name}: {wall:.2f} s for {cfg.rounds} rounds, uplink "
            f"{hist.uplink_bits_per_round} bits, launches {counts[name]}")
        if name == "matu":
            if min(counts[name][k] for k in ops.PACKED_ROUND_KERNELS) \
                    < cfg.rounds:
                raise AssertionError(f"app matu: kernels not launched every "
                                     f"round: {counts[name]}")
            s = strat.server.last_similarity.cpu().numpy()
            groups = [con.group_of(t) for t in range(n_tasks)]
            pairs = [(a, b) for a in range(n_tasks)
                     for b in range(a + 1, n_tasks)]
            same = np.mean([s[a, b] for a, b in pairs
                            if groups[a] == groups[b]])
            cross = np.mean([s[a, b] for a, b in pairs
                             if groups[a] != groups[b]])
            log(f"app matu: within-group S {same:.4f}, cross-group S "
                f"{cross:.4f}")
            if not same > cross:
                raise AssertionError("app matu: within-group S is not above "
                                     "cross-group S")
    return counts

# -- vit phase: federated LoRA training of ViT-B/32 at full width -----------

VIT_D = 1_327_140              # ViT-B/32's LoRA task-vector size at rank 16
VIT_FINGERPRINT = "8193ac2a083e3e4f"
VIT_GROUPS, VIT_CLASSES, VIT_TASKS_PER_CLIENT = 6, 8, 3
VIT_FED = dict(rounds=2, local_steps=4, batch_size=32, local_data=128,
               eval_every=1)
VIT_STEP_REPS = 20
# the constellation's R built on the card (fp64 QRs) against numpy's:
# fp64 rounding may move an fp32 entry by an ulp (< 1.2e-7 for |R| < 1)
VIT_DATA_R_ATOL = 1e-6
# one local step on the card against the CPU, fp32 without TF32 (cuBLAS
# sums in another order than the CPU): the loss within this rtol, each
# gradient leaf within this rel L2
VIT_LOSS_RTOL, VIT_GRAD_REL_L2 = 1e-5, 1e-4


def vit_data(torch, dev, feat_dim: int, *, n_tasks=None, n_groups=None,
             n_clients=None, tasks_per_client=None, conflict_pairs=None):
    """A ViT phase's data: the constellation (``n_tasks`` tasks in
    ``n_groups`` groups at ``feat_dim``; the vit phase's ``T`` in
    ``VIT_GROUPS``, the default, take 36 QRs and 30 products of
    feat_dim² on the card in fp64) and the split of ``n_tasks`` over
    ``n_clients`` clients (default ``N``), ``tasks_per_client`` each
    (default ``VIT_TASKS_PER_CLIENT``), ζ_t 0.5.  The card route is
    first held against numpy's (the JAX package's numbers) at full width
    on a one-group, one-task constellation: R within
    ``VIT_DATA_R_ATOL``, W bitwise.  Returns (constellation, split,
    {what: seconds})."""
    n_tasks = T if n_tasks is None else n_tasks
    n_groups = VIT_GROUPS if n_groups is None else n_groups
    n_clients = N if n_clients is None else n_clients
    tasks_per_client = tasks_per_client or VIT_TASKS_PER_CLIENT
    import numpy as np
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    secs = {}
    t0 = time.perf_counter()
    one = dict(n_tasks=1, n_groups=1, feat_dim=feat_dim,
               n_classes=VIT_CLASSES, seed=SEED)
    (host,), (card,) = (make_constellation(**one).tasks,
                        make_constellation(**one, device=dev).tasks)
    err = float(np.abs(host.r - card.r).max())
    secs["check"] = time.perf_counter() - t0
    log(f"vit data: one task's R at feat_dim {feat_dim}, card (fp64 QR) vs "
        f"numpy: max|err| {err:.3e} (bar {VIT_DATA_R_ATOL}), "
        f"{int((host.r != card.r).sum())} of {host.r.size} entries differ; "
        f"W bitwise {np.array_equal(host.w, card.w)}")
    if err > VIT_DATA_R_ATOL or not np.array_equal(host.w, card.w):
        raise AssertionError("vit data: the card's constellation is not "
                             "numpy's")
    t0 = time.perf_counter()
    con = make_constellation(n_tasks=n_tasks, n_groups=n_groups,
                             feat_dim=feat_dim, n_classes=VIT_CLASSES,
                             conflict_pairs=conflict_pairs, seed=SEED,
                             device=dev)
    split = dirichlet_split(n_clients=n_clients, n_tasks=n_tasks,
                            n_classes=VIT_CLASSES, zeta_t=0.5,
                            tasks_per_client=tasks_per_client, seed=SEED)
    secs["build"] = time.perf_counter() - t0
    return con, split, secs


def vit_step_flops(cfg, b: int) -> float:
    """Operations of one local step of ``cfg``'s ViT at batch ``b``: the
    forward's products (patch embedding, four d×d and two d×d_ff
    products a token and layer, the attention's scores and sums) and
    as many again for the backward to the activations, two operations a
    multiply-add.  The frozen weights take no gradient, and the LoRA
    products (rank 16) are left out."""
    tok, d, L = cfg.n_patches + 1, cfg.d_model, cfg.n_layers
    macs = (cfg.n_patches * cfg.patch_dim * d
            + L * tok * (4 * d * d + 2 * d * cfg.d_ff)
            + L * 2 * tok * tok * d)
    return 2.0 * 2.0 * b * macs


def cpu_backbone(torch, bb):
    """``bb``'s twin on the CPU, its frozen weights carried over."""
    from repro_torch.common.tree import tree_map
    from repro_torch.fed.testbed import ArchBackbone
    to_np = lambda tree: tree_map(  # noqa: E731
        lambda t: t.detach().cpu().numpy(), tree)
    return ArchBackbone.from_numpy(bb.arch, to_np(bb.params), to_np(bb.lora0),
                                   reduced=bb.reduced, device="cpu")


def vit_step_check(torch, dev, bb, x, y, n_classes: int, seed: int, *,
                   cpu_bb=None, prox_mu: float = 0.0, linearize: bool = False,
                   label: str = "vit"):
    """One local step (the trainer's objective, ``local_objective``: CE
    of a linear head on the LoRA features, FedProx's proximal term with
    ``prox_mu``, NTK-FedAvg's linearised features with ``linearize``)
    on the card against the same step on the CPU, in fp32: the weights
    carried over from the card, the same τ and anchor (0.01·N(0, 1)
    each), head and batch.  The loss within ``VIT_LOSS_RTOL``, each LoRA
    gradient leaf and the head's within ``VIT_GRAD_REL_L2``.  Returns
    (loss rel err, {leaf: rel L2})."""
    from repro_torch.common.tree import (tree_leaves, tree_leaves_with_path,
                                         tree_map)
    from repro_torch.fed.local import local_objective
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the step check needs fp32 products (no TF32)")
    t0 = time.perf_counter()
    cpu_bb = cpu_bb or cpu_backbone(torch, bb)
    g = torch.Generator().manual_seed(seed)
    tv = 0.01 * torch.randn(bb.d, generator=g)
    head = 0.1 * torch.randn((bb.feat_out, n_classes), generator=g)
    anchor = 0.01 * torch.randn(bb.d, generator=g)
    out = []
    for b, d in ((bb, dev), (cpu_bb, torch.device("cpu"))):
        objective, to_model, _ = local_objective(b, prox_mu=prox_mu,
                                                 linearize=linearize)
        params = (tree_map(lambda p: p.clone().requires_grad_(True),
                           to_model(tv.to(d))),
                  head.to(d).requires_grad_(True))
        loss = objective(params, x.to(d), y.to(d), to_model(anchor.to(d)))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((float(loss.detach()),
                    [gr.detach().cpu() for gr in grads]))
    names = ["head" if p == ("1",) else "/".join(p[1:])
             for p, _ in tree_leaves_with_path(params)]
    (l_card, g_card), (l_cpu, g_cpu) = out
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    rels = {n: _rel_l2(torch, a, c) for n, a, c in zip(names, g_card, g_cpu)}
    worst = max(rels, key=rels.get)
    log(f"{label} step check (B={x.shape[0]}, card vs CPU, fp32, "
        f"{time.perf_counter() - t0:.1f} s): loss {l_card:.7f} vs "
        f"{l_cpu:.7f} (rel {loss_err:.3e}); gradient rel L2 worst "
        f"{rels[worst]:.3e} ({worst}); " + ", ".join(
            f"{n} {v:.2e}" for n, v in rels.items()))
    if loss_err > VIT_LOSS_RTOL or rels[worst] > VIT_GRAD_REL_L2:
        raise AssertionError(
            f"{label} step: card vs CPU loss rel {loss_err:.3e} (bar "
            f"{VIT_LOSS_RTOL}), {worst} gradient rel L2 {rels[worst]:.3e} "
            f"(bar {VIT_GRAD_REL_L2})")
    return loss_err, rels


def trained_round_check(torch, dev, server, batch):
    """A round's real uploads (a ``RoundBatch`` of trained task vectors):
    the clients' unify (kernel 1) against its plain version — unified
    bf16 bits, mask words, λ — then the round through kernels 1–3
    against the plain versions, bitwise, and timed
    (:func:`round_kernels_at`).  Returns its numbers."""
    from repro_torch.core.engine import batched_client_unify
    tv, valid = batch.task_vectors, batch.valid
    got = batched_client_unify(tv, valid, device=dev)
    want = batched_client_unify(tv, valid, device=dev, mode="ref")
    torch.cuda.synchronize()
    check_equal(torch, "trained uploads' unified bf16 bits",
                bf16_bits(torch, got[0]), bf16_bits(torch, want[0]))
    check_equal(torch, "trained uploads' mask words", got[1], want[1])
    check_equal(torch, "trained uploads' lambda", got[2], want[2])
    del want
    ks = [len(u.task_ids) for u in batch.uploads]
    return round_kernels_at(torch, dev, server, (
        got[0], got[1], got[2], batch.slot_tasks.to(dev), valid,
        batch.slot_sizes.to(dev), ks))


def traced_run(torch, label, sim, strat, on_round=None):
    """``sim.run()`` with each aggregation and evaluation synchronised
    and timed: per round the aggregate's ms, the packed-round kernels'
    launches during it (``rose``), the evaluation's ms and the round's
    end, and what ``on_round(r, batch)`` returns, called just after the
    aggregation.  Every upload must be finite and nonzero.  Returns
    (history, [round info], run seconds, run start)."""
    from repro_torch.kernels import ops
    rounds = []
    agg, evaluate = strat.aggregate_batch, sim.evaluate

    def timed_agg(batch):
        for u in batch.uploads:
            v = u.task_vectors
            if not bool(torch.isfinite(v).all()) or \
                    bool((v.abs().amax(dim=1) == 0).any()):
                raise AssertionError(f"{label}: client {u.client_id} uploads "
                                     f"a non-finite or zero task vector")
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        agg(batch)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        info = dict(agg_ms=1e3 * (time.perf_counter() - t), eval_ms=0.0,
                    rose={k: after[k] - before[k]
                          for k in ops.PACKED_ROUND_KERNELS})
        info.update(on_round(len(rounds), batch) if on_round else {})
        info["end"] = time.perf_counter()
        rounds.append(info)

    def timed_eval():
        torch.cuda.synchronize()
        t = time.perf_counter()
        acc = evaluate()
        torch.cuda.synchronize()
        rounds[-1]["eval_ms"] = 1e3 * (time.perf_counter() - t)
        rounds[-1]["end"] = time.perf_counter()
        return acc

    strat.aggregate_batch, sim.evaluate = timed_agg, timed_eval
    try:
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        hist = sim.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        strat.aggregate_batch, sim.evaluate = agg, evaluate
    return hist, rounds, run_s, t_run


def vit_phase(torch, dev, reduced: bool = False):
    """MaTU rounds with real local LoRA training of ViT-B/32 at full
    width: ``ViTBackbone`` → ``FedSimulator`` → ``make_local_trainer``
    (autograd, AdamW) → ``MaTUStrategy.aggregate_batch`` (kernels 1–3)
    → downlinks → the next round.  Returns its numbers."""
    from repro_torch.common.tree import tree_leaves, tree_like, tree_map
    from repro_torch.fed.local import cross_entropy
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import MaTUStrategy
    from repro_torch.fed.testbed import ViTBackbone
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    bb = ViTBackbone(seed=SEED, reduced=reduced, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(bb.params))
    log(f"ViT-B/32{' (reduced)' if reduced else ''}: {n_params} parameters "
        f"(fp32), LoRA d = {bb.d}, layout {bb.fingerprint}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    if not reduced and (bb.d, bb.fingerprint) != (VIT_D, VIT_FINGERPRINT):
        raise AssertionError(f"vit LoRA d {bb.d} / layout {bb.fingerprint} "
                             f"!= {VIT_D} / {VIT_FINGERPRINT}")
    cfg = FedConfig(seed=SEED, **VIT_FED)
    con, split, data_s = vit_data(torch, dev, bb.cfg.patch_dim)
    t0 = time.perf_counter()
    strat = MaTUStrategy(T, bb.d, device=dev)
    sim = FedSimulator(cfg, con, split, bb, strat, device=dev)
    torch.cuda.synchronize()
    log(f"vit set-up: {T} tasks in {VIT_GROUPS} groups, feat_dim "
        f"{bb.cfg.patch_dim} (tiled across {bb.cfg.n_patches} patches), "
        f"{N} clients x {VIT_TASKS_PER_CLIENT} tasks, {cfg.local_data} "
        f"samples each: the card-vs-numpy check {data_s['check']:.1f} s, "
        f"the constellation and split {data_s['build']:.1f} s, the "
        f"simulator {time.perf_counter() - t0:.1f} s")

    x, y = sim.local_data[(0, split.tasks[0][0])]
    x, y = x[:cfg.batch_size], y[:cfg.batch_size]
    vit_step_check(torch, dev, bb, x, y, VIT_CLASSES, SEED + 7)

    # the main path: FedSimulator.run, its aggregations and evaluations
    # timed on the way (each synchronised), round 1's uploads kept
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    hist, rounds, run_s, t_run = traced_run(
        torch, "vit", sim, strat,
        lambda r, batch: {"batch": batch} if r == 0 else {})
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    slots = sum(len(tasks) for tasks in split.tasks)
    steps = cfg.rounds * slots * cfg.local_steps
    start, walls = t_run, []
    for r, info in enumerate(rounds):
        wall = 1e3 * (info["end"] - start)
        start = info["end"]
        walls.append(dict(wall_ms=wall, agg_ms=info["agg_ms"],
                          eval_ms=info["eval_ms"]))
        train_ms = wall - info["agg_ms"] - info["eval_ms"]
        log(f"vit round {r + 1}: wall {wall:.1f} ms (training {train_ms:.1f}"
            f" ms for {slots * cfg.local_steps} steps, aggregate "
            f"{info['agg_ms']:.2f} ms at d={bb.d}, evaluation "
            f"{info['eval_ms']:.1f} ms), mean acc {hist.mean_acc[r]:.4f}, "
            f"uplink {hist.uplink_bits_per_round[r]} bits, launches "
            f"{info['rose']}")
        if min(info["rose"].values()) < 1:
            raise AssertionError(f"vit round {r + 1}: a kernel was not "
                                 f"launched: {info['rose']}")
    if len(rounds) != cfg.rounds or not all(
            0.0 <= a <= 1.0 for acc in hist.task_acc for a in acc.values()):
        raise AssertionError(f"vit: {len(rounds)} rounds, accuracies "
                             f"{hist.task_acc}")
    log(f"vit main path: {cfg.rounds} rounds, {steps} local steps (B="
        f"{cfg.batch_size} x {bb.cfg.n_patches + 1} tokens) in "
        f"{run_s:.2f} s, peak device memory {peak / 2**30:.3f} GiB, "
        f"launches {launches}")

    at_d = trained_round_check(torch, dev, strat.server, rounds[0]["batch"])
    del rounds

    # one local step (the trainer's body) timed alone and profiled
    opt = adamw(cfg.lr)
    g = torch.Generator().manual_seed(SEED + 8)
    params = (bb.space.unflatten((0.01 * torch.randn(bb.d, generator=g))
                                 .to(dev)),
              sim.heads[0].clone())
    state = [opt.init(params)]
    held = [params]

    def step():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), held[0])
        loss = cross_entropy(bb.features_tree(ps[0], x), ps[1], y)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        held[0], state[0] = opt.update(tree_like(ps, grads), state[0], ps)

    for _ in range(3):
        step()
    step_walls = []
    for _ in range(VIT_STEP_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_walls.append(1e3 * (time.perf_counter() - t))
    step_ms = float(statistics.median(step_walls))
    flops = vit_step_flops(bb.cfg, cfg.batch_size)
    b_ms, _ = bound(0.0, flops)
    log(f"vit local step (B={cfg.batch_size}): median {step_ms:.3f} ms of "
        f"{VIT_STEP_REPS} (min {min(step_walls):.3f}, max "
        f"{max(step_walls):.3f}), "
        f"{1e3 * cfg.batch_size / step_ms:.1f} examples/s, "
        f"{flops / 1e12:.4f} TFLOP a step -> {flops / step_ms / 1e9:.2f} "
        f"TFLOP/s; fp32 bound {b_ms:.3f} ms ({b_ms / step_ms:.3f} of it)")
    wall_p, busy_p, ops_p = profile_window(torch, "vit local step", step)
    torch.cuda.empty_cache()
    return dict(launches=launches, at_d=at_d, step_ms=step_ms,
                step_bound_ms=b_ms, examples_per_s=1e3 * cfg.batch_size
                / step_ms, run_s=run_s, peak_gib=peak / 2**30,
                mean_acc=hist.mean_acc, rounds=walls,
                profile=dict(wall_ms=wall_p, busy_ms=busy_p))


# -- baselines phase: the paper's Table 2 setting on ViT-B/32 ----------------

# Table 2's setting (multi-task clients, ζ_t 0.5, 2 tasks a client, 8
# tasks in 3 groups with the conflict pair (0, 1), 8 classes), cut from
# 16 clients and 40 rounds to 8 clients and 2 rounds for chip time
BASE_TASKS, BASE_GROUPS, BASE_CLIENTS, BASE_TASKS_PER_CLIENT = 8, 3, 8, 2
BASE_CONFLICT = [(0, 1)]
BASE_FED = dict(rounds=2, local_steps=2, batch_size=32, local_data=64,
                eval_every=2)
# the six baseline runs' rounds: the named cut, should the whole script
# pass 1,050 s, is 1 (the two MaTU runs keep 2: round 2 starts from the
# coded downlink)
BASE_BASELINE_ROUNDS = 2
BASE_RUNS = (("matu", "matu", {}), ("matu coded", "matu", {"code_masks": True}),
             ("fedavg", "fedavg", {}), ("fedprox", "fedprox", {}),
             ("ntk-fedavg", "ntk-fedavg", {}), ("ties", "ties", {}),
             ("fedper", "fedper", {}), ("mat-fl", "mat-fl", {}))
# a baseline's merge on the card against the CPU: cuBLAS and the CPU sum
# the M = 16 rows in other orders
BASE_MERGE_RTOL, BASE_MERGE_ATOL = 1e-5, 1e-7
BASE_STEP_REPS = 10
FP32_UNIT_ROUNDOFF = 2.0 ** -24


def merge_check(torch, label, got, want):
    """A merge on the card (``got``) within the bar of the CPU's."""
    err = max_abs(torch, got, want.to(got.device))
    if not torch.allclose(got.cpu(), want.cpu(), rtol=BASE_MERGE_RTOL,
                          atol=BASE_MERGE_ATOL):
        raise AssertionError(f"{label}: card vs CPU max |err| {err:.3e} "
                             f"beyond rtol {BASE_MERGE_RTOL}, atol "
                             f"{BASE_MERGE_ATOL}")
    return err


def baseline_aggregate_check(torch, dev, name, bb, batch):
    """Round 1's uploads of a baseline run aggregated by a fresh strategy
    on the card and one on the CPU: FedAvg / FedProx / NTK merges and
    FedPer's shared slice within the merge bar, FedPer's personal slices
    bitwise; TIES's kept set bitwise, its elected signs equal except
    where the CPU's column sum lies within fp32 rounding of 0 (counted),
    its merge within the bar elsewhere; MaT-FL's groups identical and
    its group vectors within the bar.  Returns a summary line."""
    from repro_torch.core.baselines import (cosine_similarity_matrix,
                                            greedy_group, mean_rows,
                                            ties_trim)
    from repro_torch.fed.strategies import STRATEGIES, Upload
    kw = {"split_point": bb.split_point} if name == "fedper" else {}
    card = STRATEGIES[name](BASE_TASKS, bb.d, device=dev, **kw)
    host = STRATEGIES[name](BASE_TASKS, bb.d, device="cpu", **kw)
    card.aggregate(batch.uploads)
    host.aggregate([Upload(u.client_id, list(u.task_ids),
                           u.task_vectors.cpu(), list(u.data_sizes))
                    for u in batch.uploads])
    if name in ("fedavg", "fedprox", "ntk-fedavg"):
        err = merge_check(torch, name, card.global_v, host.global_v)
        return f"merge max|err| {err:.3e}"
    if name == "fedper":
        err = merge_check(torch, "fedper shared", card.shared, host.shared)
        for c, v in card.personal.items():
            check_equal(torch, f"fedper client {c} personal slice", v.cpu(),
                        host.personal[c])
        return (f"shared max|err| {err:.3e}, {len(card.personal)} personal "
                f"slices bitwise")
    if name == "mat-fl":
        means = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            means[where] = torch.stack([mean_rows(u.task_vectors.to(d))
                                        for u in batch.uploads])
        groups = {w: greedy_group(cosine_similarity_matrix(m).cpu().numpy(),
                                  card.threshold) for w, m in means.items()}
        if groups["card"] != groups["cpu"]:
            raise AssertionError(f"mat-fl groups: card {groups['card']}, "
                                 f"CPU {groups['cpu']}")
        err = max(merge_check(torch, f"mat-fl client {c}", v,
                              host.client_v[c])
                  for c, v in card.client_v.items())
        return f"groups {groups['card']} identical, max|err| {err:.3e}"
    # ties: the kept set, the elected signs, the disjoint mean
    stack = torch.stack([u.task_vectors[i].float() for u in batch.uploads
                         for i in range(len(u.task_ids))])
    trim_card = ties_trim(stack, card.keep_frac)
    trim_cpu = ties_trim(stack.cpu(), host.keep_frac)
    check_equal(torch, "ties kept set", trim_card.cpu(), trim_cpu)
    col_card, col_cpu = trim_card.sum(0).cpu(), trim_cpu.sum(0)
    flip = torch.sign(col_card) != torch.sign(col_cpu)
    # two orders of one fp32 sum of M terms differ by at most
    # 2·M·u·Σ|term| (u the unit roundoff)
    near_zero = col_cpu.abs() <= (2 * stack.shape[0] * FP32_UNIT_ROUNDOFF
                                  * trim_cpu.abs().sum(0))
    if bool((flip & ~near_zero).any()):
        raise AssertionError(f"ties: {int((flip & ~near_zero).sum())} "
                             f"elected signs differ away from 0")
    keep = ~flip
    err = merge_check(torch, "ties merge", card.global_v.cpu()[keep],
                      host.global_v[keep])
    return (f"kept set bitwise ({int((trim_cpu != 0).sum())} of "
            f"{trim_cpu.numel()} entries), {int(flip.sum())} elected signs "
            f"differ (column sums within fp32 rounding of 0), merge "
            f"max|err| {err:.3e} elsewhere")


def step_costs(torch, dev, bb, x, y, prox_mu: float):
    """Median wall (ms, synchronised) of the local objective and its
    gradient on the card, plain, with FedProx's term and linearised
    (NTK-FedAvg), over ``BASE_STEP_REPS`` calls each after two warm-up
    calls; the optimizer update is left out."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.fed.local import local_objective
    g = torch.Generator().manual_seed(SEED + 10)
    tv = (0.01 * torch.randn(bb.d, generator=g)).to(dev)
    head = (0.1 * torch.randn((bb.feat_out, VIT_CLASSES), generator=g)).to(dev)
    out = {}
    for label, mu, lin in (("plain", 0.0, False), ("fedprox", prox_mu, False),
                           ("ntk", 0.0, True)):
        objective, to_model, _ = local_objective(bb, prox_mu=mu,
                                                 linearize=lin)
        delta, anchor = to_model(tv), to_model(torch.zeros_like(tv))

        def step():
            ps = (tree_map(lambda p: p.detach().requires_grad_(True), delta),
                  head.detach().requires_grad_(True))
            torch.autograd.grad(objective(ps, x, y, anchor), tree_leaves(ps))

        walls = []
        for i in range(BASE_STEP_REPS + 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 2:
                walls.append(1e3 * (time.perf_counter() - t))
        out[label] = float(statistics.median(walls))
    log(f"baselines local objective + gradient (B={x.shape[0]}, median of "
        f"{BASE_STEP_REPS}): plain {out['plain']:.3f} ms, fedprox "
        f"{out['fedprox']:.3f} ms, ntk (jvp, reverse over forward) "
        f"{out['ntk']:.3f} ms = {out['ntk'] / out['plain']:.2f}x plain")
    return out


def wire_snapshot(torch, strat):
    """A MaTU round's wire, on the host: per client the uplink's and the
    downlink's mask words (decoded where coded), their measured bits,
    the downlink's λ, and the round's task vectors and similarity."""
    ups = {u.client_id: u for u in strat._last_uploads}
    snap = dict(tv=strat.server.last_task_vectors.cpu(),
                sim=strat.server.last_similarity.cpu(), up={}, down={})
    for cid, u in ups.items():
        dl = strat.downlinks[cid]
        k = len(u.task_ids)
        snap["up"][cid] = dict(masks=u.masks.cpu(), bits=u.uplink_bits(),
                               k=k)
        snap["down"][cid] = dict(masks=dl.masks.cpu(), bits=dl.downlink_bits(),
                                 words=dl.mask_row(slice(0, k)).cpu(),
                                 lams=dl.lams.cpu(), k=k)
    return snap


def coded_wire_check(torch, d, raw, coded):
    """The coded MaTU run against the raw one, round by round (snapshots
    of :func:`wire_snapshot`): task vectors, similarity, downlink λ and
    words bitwise; every coded uplink decodes to the raw upload's words;
    coded bits never above raw bits plus a 5-byte header a row.  Returns
    the coded shares of the mask bits and of the whole link, each way,
    over the rounds."""
    from repro_torch.fed.compression import HEADER_BYTES, decode_mask_rows
    from repro_torch.kernels import bitpack
    tot = dict(up_mask=[0, 0], up_link=[0, 0], down_mask=[0, 0],
               down_link=[0, 0])
    for r, (a, b) in enumerate(zip(raw, coded)):
        check_equal(torch, f"round {r + 1} coded vs raw task vectors",
                    b["tv"], a["tv"])
        check_equal(torch, f"round {r + 1} coded vs raw similarity",
                    b["sim"], a["sim"])
        for cid, ra in a["down"].items():
            rb, k = b["down"][cid], ra["k"]
            check_equal(torch, f"round {r + 1} client {cid} downlink lambda",
                        rb["lams"], ra["lams"])
            check_equal(torch, f"round {r + 1} client {cid} decoded "
                        "downlink words", rb["words"], ra["words"])
            ua, ub = a["up"][cid], b["up"][cid]
            got = bitpack.words_from_numpy(decode_mask_rows(
                ub["masks"].numpy(), d, k))
            check_equal(torch, f"round {r + 1} client {cid} decoded uplink "
                        "words", got, ua["masks"])
            raw_mask = 8 * 4 * bitpack.packed_width(d) * k
            for way, xa, xb in (("up", ua, ub), ("down", ra, rb)):
                if xb["bits"] > xa["bits"] + 8 * HEADER_BYTES * k:
                    raise AssertionError(
                        f"round {r + 1} client {cid} {way}link: coded "
                        f"{xb['bits']} bits above raw {xa['bits']} + "
                        f"headers")
                tot[f"{way}_mask"][0] += 8 * xb["masks"].numel()
                tot[f"{way}_mask"][1] += raw_mask
                tot[f"{way}_link"][0] += xb["bits"]
                tot[f"{way}_link"][1] += xa["bits"]
    return {k: v[0] / v[1] for k, v in tot.items()}


def coder_walls(torch, d, snap, reps: int = 3):
    """Host ms (median of ``reps``) of one batched encode and one batched
    decode of a round's uplink rows and of its downlink rows, on the
    raw snapshot's words."""
    import numpy as np
    from repro_torch.fed.compression import (decode_mask_rows,
                                             encode_mask_rows_with_sizes)
    from repro_torch.kernels import bitpack
    out = {}
    for way in ("up", "down"):
        rows = np.concatenate([bitpack.words_to_numpy(x["masks"]
                                                      if way == "up" else
                                                      x["words"])
                               for x in snap[way].values()])
        enc, dec = [], []
        for _ in range(reps):
            t = time.perf_counter()
            stream, _sizes = encode_mask_rows_with_sizes(rows, d)
            enc.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            back = decode_mask_rows(stream, d, rows.shape[0])
            dec.append(1e3 * (time.perf_counter() - t))
        if not np.array_equal(back, rows):
            raise AssertionError(f"{way}link rows do not round-trip")
        out[way] = dict(rows=int(rows.shape[0]), bytes=int(stream.size),
                        encode_ms=float(statistics.median(enc)),
                        decode_ms=float(statistics.median(dec)))
    return out


def baselines_phase(torch, dev, reduced: bool = False):
    """The paper's baselines and MaTU's coded wire in Table 2's setting on
    ViT-B/32 at full width (8 clients × 2 tasks of 8, 2 rounds; the
    paper's 16 clients and 40 rounds cut for chip time): eight runs
    through ``STRATEGIES[name]`` → ``FedSimulator`` →
    ``make_local_trainer`` (FedProx's proximal term, NTK-FedAvg's
    linearised features) → the strategy's aggregate → ``eval_vectors``:
    MaTU on the raw wire, MaTU with ``code_masks`` (coded uploads,
    kernels 1–3 on the packed round, coded downlinks decoded on use),
    FedAvg, FedProx, NTK-FedAvg, TIES, FedPer and MaT-FL.  Checks: the
    linearised features at 0 equal the features bitwise; one NTK and one
    FedProx step card vs CPU; kernels 1–3 in every MaTU round and
    bitwise on round 1's trained uploads; the coded run ≡ the raw run
    bitwise; the coded serving handoff's ingest ≡ the raw one's; each
    baseline's round-1 merge card vs CPU.  Returns its numbers."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import sample_task_batch
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import STRATEGIES
    from repro_torch.fed.testbed import ViTBackbone
    from repro_torch.kernels import ops
    from repro_torch.serve.store import ModulatorStore

    t_phase = time.perf_counter()
    bb = ViTBackbone(seed=SEED, reduced=reduced, device=dev)
    if not reduced and (bb.d, bb.fingerprint) != (VIT_D, VIT_FINGERPRINT):
        raise AssertionError(f"vit LoRA d {bb.d} / layout {bb.fingerprint} "
                             f"!= {VIT_D} / {VIT_FINGERPRINT}")
    con, split, data_s = vit_data(
        torch, dev, bb.cfg.patch_dim, n_tasks=BASE_TASKS,
        n_groups=BASE_GROUPS, n_clients=BASE_CLIENTS,
        tasks_per_client=BASE_TASKS_PER_CLIENT, conflict_pairs=BASE_CONFLICT)
    cfg = FedConfig(seed=SEED, **BASE_FED)
    slots = sum(len(t) for t in split.tasks)
    log(f"baselines set-up: ViT-B/32{' (reduced)' if reduced else ''} "
        f"{sum(p.numel() for p in tree_leaves(bb.params))} parameters, d = "
        f"{bb.d}, layout {bb.fingerprint}, split point {bb.split_point}; "
        f"{BASE_TASKS} tasks in {BASE_GROUPS} groups (conflict "
        f"{BASE_CONFLICT}), {BASE_CLIENTS} clients x {BASE_TASKS_PER_CLIENT}"
        f" tasks ({slots} slots), {cfg.local_data} samples each; the "
        f"card-vs-numpy check {data_s['check']:.1f} s, the constellation and"
        f" split {data_s['build']:.1f} s")

    # the linearisation and the proximal term on one batch
    t0 = split.tasks[0][0]
    x, y = sample_task_batch(con.tasks[t0], torch.Generator().manual_seed(
        SEED + 9), cfg.batch_size)
    x, y = x.to(dev), y.to(dev)
    zero = torch.zeros(bb.d, device=dev)
    with torch.no_grad():
        check_equal(torch, "lin_features(0, x) vs features(0, x)",
                    bb.lin_features(zero, x), bb.features(zero, x))
    cpu_bb = cpu_backbone(torch, bb)
    ntk_err = vit_step_check(torch, dev, bb, x, y, VIT_CLASSES, SEED + 11,
                             cpu_bb=cpu_bb, linearize=True, label="ntk")
    prox_err = vit_step_check(torch, dev, bb, x, y, VIT_CLASSES, SEED + 12,
                              cpu_bb=cpu_bb, prox_mu=cfg.prox_mu,
                              label="fedprox")
    del cpu_bb
    steps_ms = step_costs(torch, dev, bb, x, y, cfg.prox_mu)

    # the main path: eight runs; MaTU's wire snapshotted every round, each
    # baseline's round-1 merge held card vs CPU after its run
    ops.reset_launch_counts()
    runs, snaps, first = {}, {}, {}
    for label, name, kw in BASE_RUNS:
        kw = dict(kw, split_point=bb.split_point) if name == "fedper" else kw
        strat = STRATEGIES[name](BASE_TASKS, bb.d, device=dev, **kw)
        run_cfg = cfg if name == "matu" else FedConfig(
            seed=SEED, **dict(BASE_FED, rounds=BASE_BASELINE_ROUNDS))
        sim = FedSimulator(run_cfg, con, split, bb, strat, device=dev)
        wire = []

        def on_round(r, batch, strat=strat, wire=wire, label=label,
                     name=name):
            if name == "matu":
                wire.append(wire_snapshot(torch, strat))
            if r == 0:
                first[label] = batch
            return dict(up=strat.uplink_bits(batch.uploads),
                        down=strat.downlink_bits())

        hist, rounds, run_s, _ = traced_run(torch, label, sim, strat,
                                            on_round)
        for r, info in enumerate(rounds):
            if name == "matu" and min(info["rose"].values()) < 1:
                raise AssertionError(f"{label} round {r + 1}: a kernel was "
                                     f"not launched: {info['rose']}")
        if len(rounds) != run_cfg.rounds or not all(
                0.0 <= a <= 1.0 for acc in hist.task_acc
                for a in acc.values()):
            raise AssertionError(f"{label}: {len(rounds)} rounds, "
                                 f"accuracies {hist.task_acc}")
        runs[label] = dict(
            run_s=run_s, mean_acc=hist.mean_acc,
            task_acc=[[acc[t] for t in sorted(acc)] for acc in hist.task_acc],
            up_bits=[i["up"] for i in rounds],
            down_bits=[i["down"] for i in rounds],
            agg_ms=[i["agg_ms"] for i in rounds],
            eval_ms=[i["eval_ms"] for i in rounds],
            launches=[i["rose"] for i in rounds])
        note = ""
        if name != "matu":
            note = "; round 1 card vs CPU: " + baseline_aggregate_check(
                torch, dev, name, bb, first.pop(label))
        else:
            snaps[label] = (wire, strat)
        log(f"baselines {label}: {run_cfg.rounds} rounds in {run_s:.2f} s "
            f"(aggregate " + ", ".join(f"{m:.2f}" for m in
                                       runs[label]["agg_ms"])
            + f" ms; evaluation {sum(runs[label]['eval_ms']):.1f} ms), mean "
            f"acc {hist.mean_acc}, uplink {runs[label]['up_bits']} and "
            f"downlink {runs[label]['down_bits']} bits a round, launches "
            f"{runs[label]['launches']}{note}")
    launches = ops.launch_counts()

    # the coded run against the raw one, and the serving handoff
    (raw, s_raw), (coded, s_coded) = snaps["matu"], snaps["matu coded"]
    if runs["matu coded"]["task_acc"] != runs["matu"]["task_acc"]:
        raise AssertionError(f"coded vs raw accuracies: "
                             f"{runs['matu coded']['task_acc']} vs "
                             f"{runs['matu']['task_acc']}")
    shares = coded_wire_check(torch, bb.d, raw, coded)
    walls = coder_walls(torch, bb.d, raw[0])
    stores = []
    for s, code in ((s_raw, False), (s_coded, True)):
        handoff = s.server.serving_downlink(code_masks=code,
                                            fingerprint=bb.fingerprint)
        store = ModulatorStore(bb.space, bb.lora0, device=dev)
        store.ingest(handoff)
        stores.append((store, handoff))
    (st_raw, h_raw), (st_coded, h_coded) = stores
    check_equal(torch, "serving handoff bf16 unified",
                bf16_bits(torch, h_coded.unified),
                bf16_bits(torch, h_raw.unified))
    for t in range(BASE_TASKS):
        check_equal(torch, f"store task {t} words", st_coded.mask_words(t),
                    st_raw.mask_words(t))
        check_equal(torch, f"store task {t} lambda", st_coded.lam(t),
                    st_raw.lam(t))
    handoff_share = (8 * h_coded.masks.numel()
                     / (8 * 4 * h_raw.masks.numel()))
    log(f"baselines coded wire: 2 rounds coded = raw bitwise (task vectors, "
        f"similarity, accuracies, downlink lambda and words; every uplink "
        f"decodes to the raw words); coded share of the mask bits up "
        f"{shares['up_mask']:.4f}, down {shares['down_mask']:.4f}, of the "
        f"whole link up {shares['up_link']:.4f}, down "
        f"{shares['down_link']:.4f}; host coder on round 1's rows: uplink "
        f"{walls['up']['rows']} rows encode {walls['up']['encode_ms']:.1f} ms"
        f" / decode {walls['up']['decode_ms']:.1f} ms, downlink "
        f"{walls['down']['rows']} rows encode "
        f"{walls['down']['encode_ms']:.1f} ms / decode "
        f"{walls['down']['decode_ms']:.1f} ms; serving handoff "
        f"{BASE_TASKS} rows coded {h_coded.masks.numel()} B "
        f"({handoff_share:.4f} of raw), its store ingest = the raw one's")
    at_d = trained_round_check(torch, dev, s_raw.server, first.pop("matu"))
    first.clear()
    del raw, coded, snaps, stores, s_raw, s_coded
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"baselines phase: {phase_s:.1f} s, launches {launches}")
    return dict(launches=launches, at_d=at_d, runs=runs, steps_ms=steps_ms,
                ntk_step=dict(loss_rel=ntk_err[0],
                              worst_grad_rel_l2=max(ntk_err[1].values())),
                fedprox_step=dict(loss_rel=prox_err[0],
                                  worst_grad_rel_l2=max(
                                      prox_err[1].values())),
                coded_share=shares, coder_ms=walls,
                handoff_share=handoff_share, phase_s=phase_s)


# -- lmtrain phase: LoRA training of qwen2-0.5b at full width ----------------

LMTRAIN_B, LMTRAIN_S, LMTRAIN_STEPS = 4, 512, 3
LMTRAIN_CLIENT_TASKS = [[0], [1], [2], [0, 2]]
LMTRAIN_LR = 5e-3
LMTRAIN_REGION = 4096          # the tokens one task's batches draw from
LMTRAIN_CE_RTOL = 1e-5         # chunked against unchunked CE, fp32 head
LMTRAIN_REMAT_REL_L2 = 1e-6    # LoRA gradients with and without remat


def lm_task_batch(torch, dev, cfg, task: int, b: int, s: int, seed: int):
    """A seeded (B, S) batch of task ``task``'s tokens (drawn from its
    own region of the vocabulary, tasks 0–2); the labels are the next
    tokens, the last one ignored."""
    g = torch.Generator(device=dev).manual_seed(seed)
    region = min(LMTRAIN_REGION, (cfg.vocab - 1) // 4)
    lo = 1 + task * region
    tok = torch.randint(lo, lo + region, (b, s), generator=g, device=dev)
    labels = torch.cat([tok[:, 1:], torch.full((b, 1), -100,
                                               dtype=tok.dtype, device=dev)],
                       dim=1)
    return {"tokens": tok, "labels": labels}


def lmtrain_checks(torch, model, params, lora0, space, batch):
    """On one batch: ``chunked_cross_entropy`` against the unchunked
    ``cross_entropy`` on the same hidden states (the head in fp32), and
    the LoRA gradients with and without the layers' checkpoint twin
    (``remat``) on a perturbed LoRA tree (every leaf's gradient
    nonzero).  Returns their readings."""
    from repro_torch.common.tree import tree_leaves, tree_like, tree_map
    from repro_torch.models.lm import chunked_cross_entropy, cross_entropy
    lm = model.model
    with torch.no_grad():
        hidden = lm.forward(params, batch["tokens"], lora=lora0,
                            return_hidden=True).float()
        p32 = {k: tree_map(lambda t: t.float(), params[k])
               for k in ("final_norm", "embed", "lm_head") if k in params}
        head = lambda xc: lm._head(p32, xc)  # noqa: E731
        chunked = float(chunked_cross_entropy(hidden, head, batch["labels"]))
        full = float(cross_entropy(head(hidden), batch["labels"]))
    del hidden
    ce_rel = abs(chunked - full) / abs(full)
    g = torch.Generator(device=lm.device).manual_seed(SEED + 31)
    lora = space.unflatten(0.01 * torch.randn(space.d, generator=g,
                                              device=lm.device))
    lora = tree_map(torch.add, lora0, lora)
    grads, peaks = {}, {}
    for remat in (True, False):
        lm.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lo = tree_map(lambda t: t.detach().requires_grad_(True), lora)
        loss = model.loss(params, lo, batch)
        grads[remat] = space.flatten(tree_like(
            lo, torch.autograd.grad(loss, tree_leaves(lo))))
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
    lm.remat = True
    remat_rel = _rel_l2(torch, grads[True], grads[False])
    log(f"lmtrain checks: chunked CE {chunked:.7f} vs unchunked "
        f"{full:.7f} (rel {ce_rel:.3e}, bar {LMTRAIN_CE_RTOL}); LoRA "
        f"gradients with / without remat rel L2 {remat_rel:.3e} (bar "
        f"{LMTRAIN_REMAT_REL_L2}); peak memory {peaks[True]:.3f} / "
        f"{peaks[False]:.3f} GiB")
    if ce_rel > LMTRAIN_CE_RTOL or remat_rel > LMTRAIN_REMAT_REL_L2:
        raise AssertionError(f"lmtrain: chunked CE rel {ce_rel:.3e}, remat "
                             f"gradient rel L2 {remat_rel:.3e}")
    return dict(ce_rel=ce_rel, remat_rel_l2=remat_rel,
                peak_gib_remat=peaks[True], peak_gib_no_remat=peaks[False])


def lmtrain_phase(torch, dev, cfg=None):
    """LoRA training of qwen2-0.5b at full width (``cfg``: another
    config, e.g. the reduced one for a rehearsal) through
    ``make_train_step`` (AdamW, clip 1.0), four clients of
    ``LMTRAIN_CLIENT_TASKS`` taking ``LMTRAIN_STEPS`` steps each on a
    repeated seeded batch, then ``unify_with_modulators`` →
    ``ClientUpload`` → one ``MaTUServer.round`` (kernels 1–3).  Returns
    its numbers."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.base import load_arch
    from repro_torch.core.client import ClientUpload
    from repro_torch.core.server import MaTUServer, MaTUServerConfig
    from repro_torch.core.unify import modulate, unify_with_modulators
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step

    full = cfg is None
    cfg = cfg or load_arch(SERVE_ARCH)
    model, _g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 30, (SERVE_D, SERVE_FINGERPRINT) if full
        else None, shape=", training")
    b, s = LMTRAIN_B, LMTRAIN_S
    checks = lmtrain_checks(torch, model, params, lora0, space,
                            lm_task_batch(torch, dev, cfg, 0, b, s, SEED + 32))
    step, opt = make_train_step(model, adamw(LMTRAIN_LR))
    n_tasks = 1 + max(max(t) for t in LMTRAIN_CLIENT_TASKS)
    server = MaTUServer(MaTUServerConfig(n_tasks=n_tasks), device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    uploads, walls = [], []
    for cid, tasks in enumerate(LMTRAIN_CLIENT_TASKS):
        tvs = []
        for t in tasks:
            batch = lm_task_batch(torch, dev, cfg, t, b, s,
                                  SEED + 40 + 10 * cid + t)
            # no downlink before the first round: the pretrained point
            lora = tree_map(torch.add, lora0, space.unflatten(torch.zeros(
                space.d, device=dev)))
            state = opt.init(lora)
            losses = []
            for _ in range(LMTRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lora, state, met = step(params, lora, state, batch)
                losses.append(float(met["loss"]))
                walls.append(1e3 * (time.perf_counter() - t0))
            log(f"lmtrain client {cid} task {t}: losses " + ", ".join(
                f"{v:.5f}" for v in losses))
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"lmtrain: a non-finite loss {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"lmtrain client {cid} task {t}: step "
                                     f"{LMTRAIN_STEPS}'s loss {losses[-1]} "
                                     f"is not below step 1's {losses[0]} "
                                     f"on the repeated batch")
            tvs.append(space.flatten(tree_map(torch.sub, lora, lora0)))
        unified, masks, lams = unify_with_modulators(torch.stack(tvs))
        uploads.append(ClientUpload(cid, list(tasks), unified, masks, lams,
                                    [b * s] * len(tasks),
                                    fingerprint=space.fingerprint))
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    downs = server.round(uploads)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0)
    path_s = time.perf_counter() - t_path
    after = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rose = {k: after[k] - before[k] for k in ops.PACKED_ROUND_KERNELS}
    if min(rose.values()) < 1:
        raise AssertionError(f"lmtrain round: a kernel was not launched: "
                             f"{rose}")
    tvo = server.last_task_vectors
    if tvo.shape != (n_tasks, space.d) or not bool(torch.isfinite(tvo).all()):
        raise AssertionError("lmtrain round: bad task vectors")
    for cid, tasks in enumerate(LMTRAIN_CLIENT_TASKS):
        dl = downs[cid]
        for i in range(len(tasks)):
            if not bool(torch.isfinite(modulate(dl.unified, dl.masks[i],
                                                dl.lams[i])).all()):
                raise AssertionError(f"lmtrain: client {cid}'s downlink "
                                     f"start is not finite")
    step_ms = float(statistics.median(walls))
    held = [lora, state]

    def one_step():
        held[0], held[1], _ = step(params, held[0], held[1], batch)

    wall_p, busy_p, _ = profile_window(torch, "lmtrain step", one_step)
    log(f"lmtrain main path ({cfg.name}, {cfg.dtype}, B={b} x S={s}): "
        f"{len(walls)} steps, median step {step_ms:.2f} ms (min "
        f"{min(walls):.2f}, max {max(walls):.2f}), "
        f"{1e3 * b * s / step_ms:.0f} tokens/s; round at d={space.d} "
        f"{round_ms:.2f} ms, launches {rose}; {path_s:.2f} s in all, peak "
        f"device memory {peak / 2**30:.3f} GiB")
    del params, lora0, uploads, downs, server, held, lora, state
    torch.cuda.empty_cache()
    return dict(launches=rose, step_ms=step_ms,
                tokens_per_s=1e3 * b * s / step_ms, round_ms=round_ms,
                peak_gib=peak / 2**30,
                profile=dict(wall_ms=wall_p, busy_ms=busy_p), **checks)


# -- serve phase: multi-tenant qwen2-0.5b at full width -----------------------

SERVE_ARCH = "qwen2-0.5b"
SERVE_D = 3_588_168            # its LoRA task-vector size at rank 16
SERVE_FINGERPRINT = "012bb33d0fb8e26e"
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 128, 32
# the three LoRA factor shapes of one layer: wq/wo a, down a, every b
SERVE_LEAVES = [(896, 16), (4864, 16), (16, 896)]
# per decode layer: wq and wo a-factors (896, 16), down's a (4864, 16),
# three b-factors (16, 896)
LAYER_MIX = {(896, 16): 2, (4864, 16): 1, (16, 896): 3}
# xlstm-1.3b's LoRA factor shapes at rank 16, as one (mLSTM, sLSTM) unit
# runs them: mlstm/up and slstm/wx (2048, 8192), mlstm/down (4096, 2048),
# slstm/ffn_down (2730, 2048); each an a and a b factor
XLSTM_UNIT_MIX = {(2048, 16): 2, (4096, 16): 1, (2730, 16): 1,
                  (16, 8192): 2, (16, 2048): 2}
# |kernel - plain| <= MM_RTOL * (|x| @ |w_eff|): both sum K fp32 products
# in different orders (worst case 2 K 2^-24 = 5.8e-4 at K = 4864)
MM_RTOL = 1e-4
# bf16 model, fused route through the kernels against the same route
# through the plain versions: ||l_k - l_p|| / ||l_p|| of the prefill
# logits.  The LoRA products sum in another order in fp32 and are cast
# to bf16, so a bf16 rounding can flip (2^-8 relative) and carry through
# 24 bf16 layers.
BF16_LOGIT_REL_L2 = 5e-2
# fp32 model, fused against dense-routed prefill logits: the JAX
# package's own bar (tests/test_serve_multitenant.py)
FP32_RTOL, FP32_ATOL = 5e-4, 1e-5


def serve_kernel_checks(torch, dev, leaves=None):
    """Kernel 9 at B = SERVE_B on each qwen2 leaf shape at S = 1, the
    decode route's largest S and the prompt length, and on each xlstm
    leaf shape at S = 1 and the decode route's largest S (or on
    ``leaves``: [((k, n), sequence lengths, x = I check)]), τ in fp32
    and bf16: against its plain version within MM_RTOL, bitwise with
    x = I (qwen2 leaves) and with one-hot rows at decode; at S = 1
    bitwise deterministic and batch-invariant; a misaligned leaf
    refused; timed beside its plain version and bound, with the device
    functions each call runs.  Returns {(k, n, s, tau): numbers}."""
    from repro_torch.kernels import bitpack, ops, ref
    from repro_torch.kernels import modulated_matmul as mm
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    b = SERVE_B
    per = {}
    dmax = mm.DECODE_MAX_S
    if leaves is None:
        leaves = ([(kn, (1, dmax, SERVE_PROMPT), True) for kn in SERVE_LEAVES]
                  + [(kn, (1, dmax), False) for kn in XLSTM_UNIT_MIX])
    for (k, n), seqs, check_eye in leaves:
        for tau_dt in (torch.float32, torch.bfloat16):
            base = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
            tau = (0.05 * torch.randn((k, n), generator=g, device=dev)).to(
                tau_dt)
            words = bitpack.pack_bits(
                torch.rand((b, k * n), generator=g, device=dev) < 0.7)
            lam = torch.rand(b, generator=g, device=dev) + 0.5
            w_eff = ref.modulated_weight_ref(base, tau, words, lam)
            if check_eye:
                eye = torch.eye(k, device=dev).expand(b, k, k).contiguous()
                got = mm.modulated_matmul_cuda(eye, base, tau, words, lam)
                torch.cuda.synchronize()
                check_equal(torch, f"modulated_matmul x=I ({k}, {n}) "
                            f"{tau_dt}", got, w_eff)
                del eye, got
            # one-hot rows at decode: the first rows, rows across the first
            # chunk boundary, the last chunk
            kc = mm.decode_chunks(k)[0]
            for k0, s1 in ((0, dmax), (kc - 3, 5), (k - dmax, dmax),
                           (k - 1, 1)):
                s1 = min(s1, k - k0)
                hot = torch.eye(k, device=dev)[k0:k0 + s1].expand(
                    b, s1, k).contiguous()
                got = mm.modulated_matmul_cuda(hot, base, tau, words, lam)
                torch.cuda.synchronize()
                check_equal(torch, f"modulated_matmul one-hot rows "
                            f"{k0}:{k0 + s1} ({k}, {n}) {tau_dt}", got,
                            w_eff[:, k0:k0 + s1])
            for s in seqs:
                x = torch.randn((b, s, k), generator=g, device=dev)
                got = mm.modulated_matmul_cuda(x, base, tau, words, lam)
                want = mm.plain(x, base, tau, words, lam)
                scale = torch.einsum("bsk,bkn->bsn", x.abs(), w_eff.abs())
                torch.cuda.synchronize()
                ratio = float(((got - want).abs()
                               / torch.clamp(scale, min=1e-30)).max())
                if not ratio <= MM_RTOL:
                    raise AssertionError(
                        f"modulated_matmul ({k}, {n}) S={s} {tau_dt}: "
                        f"|err| / (|x| @ |w|) = {ratio} > {MM_RTOL}")
                if s == 1:
                    again = mm.modulated_matmul_cuda(x, base, tau, words, lam)
                    alone = [mm.modulated_matmul_cuda(
                        x[i:i + 1].contiguous(), base, tau,
                        words[i:i + 1].contiguous(), lam[i:i + 1].contiguous())
                        for i in range(b)]
                    torch.cuda.synchronize()
                    check_equal(torch, f"modulated_matmul ({k}, {n}) S=1 "
                                f"{tau_dt} run to run", again, got)
                    check_equal(torch, f"modulated_matmul ({k}, {n}) S=1 "
                                f"{tau_dt} B=1 calls against B={b}",
                                torch.cat(alone), got)
                ms = time_ms(torch, lambda: mm.modulated_matmul_cuda(
                    x, base, tau, words, lam))
                plain_ms = time_ms(torch, lambda: mm.plain(
                    x, base, tau, words, lam))
                n_bytes = (x.numel() * 4 + k * n * 4 + k * n
                           * tau.element_size() + words.numel() * 4 + b * 4
                           + b * s * n * 4)
                b_ms, b_by = bound(n_bytes, 2 * b * s * k * n + 3 * b * k * n)
                err = max_abs(torch, got, want)
                dev_ms, fns, _ = device_ms(torch, "modulated_matmul_",
                                        lambda: mm.modulated_matmul_cuda(
                                            x, base, tau, words, lam))
                route = ("modulated_matmul_splitk_kernel" if s <= dmax
                         else "modulated_matmul_kernel<")
                # late in a long run the profiler can drop some of a
                # window's events: a window without the route's launch
                # is taken again, and the check fails only if none has it
                for _ in range(PROFILE_WINDOWS - 1):
                    if any(route in f for f in fns):
                        break
                    log(f"modulated_matmul S={s}: the profiler's window "
                        f"shows no {route} launch (only {list(fns)}); "
                        f"taken again")
                    dev_ms, fns, _ = device_ms(
                        torch, "modulated_matmul_",
                        lambda: mm.modulated_matmul_cuda(x, base, tau, words,
                                                         lam))
                if not any(route in f for f in fns):
                    raise AssertionError(f"modulated_matmul S={s}: no "
                                         f"{route} launch among {list(fns)}")
                per[(k, n, s, str(tau_dt))] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err, rel=ratio, device_ms=dev_ms,
                    device_functions=fns)
                log(f"modulated_matmul B={b} S={s} (K, N)=({k}, {n}) tau "
                    f"{str(tau_dt)[6:]}: {ms:.4f} ms a call (device "
                    f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                    f"{b_ms:.5f} ms ({b_by}); |err|/(|x||w|) {ratio:.2e}, "
                    f"max|err| {err}; a call runs "
                    + ", ".join(f"{c:g} x {f[:60]}" for f, c in fns.items()))
        kk, nn = (k + 1, n) if ((k + 1) * n) % 32 else (k, n + 1)
        x1 = torch.zeros((b, 1, kk), device=dev)
        bad = (x1, torch.zeros((kk, nn), device=dev),
               torch.zeros((kk, nn), device=dev),
               torch.zeros((b, -(-kk * nn // 32)), dtype=torch.int32,
                           device=dev), torch.ones(b, device=dev))
        for fn in (ops.modulated_matmul, mm.modulated_matmul_cuda):
            try:
                fn(*bad)
            except ValueError as e:
                if "word-aligned" not in str(e):
                    raise
            else:
                raise AssertionError(f"modulated_matmul took the misaligned "
                                     f"leaf ({kk}, {nn})")
        log(f"modulated_matmul: misaligned leaf ({kk}, {nn}) refused")
    return per


def device_ms(torch, prefix: str, fn, n: int = 10, apart: bool = False):
    """Device time of one call of ``fn``, from ``torch.profiler`` over
    ``n`` calls, without the host's launch overhead: for every device
    function the calls ran, its mean time a launch times its launches a
    call (its count over ``n``, rounded: the profiler can drop an event
    of a long window, so a plain total over ``n`` would read low),
    summed.  Each function must be named with ``prefix`` (the kernel's
    own).  Late in a long run on the card the profiler drops some or
    all of a window's device events: taken again after an idle pause
    outside it, one window came back empty eight times in a row; taken
    again at once, with idle time inside it, every one has been filled.
    So the calls run between two idle margins of ``PROFILE_MARGIN_S``,
    and a window that reports no device event is logged and taken again
    at once with margins twice as long, up to ``PROFILE_WINDOWS``
    windows.  ``apart``:
    functions not so named (a fill, a conversion) are listed beside the
    kernel's, not refused, and left out of its sum.  Returns (ms a call,
    {device function: launches seen / n}, {device function: its ms a
    call})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(PROFILE_WINDOWS):
        margin = PROFILE_MARGIN_S * 2 ** window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
        log(f"device_ms {prefix}: window {window} (margins "
            f"{margin * 1e3:g} ms) saw no device event; taken again")
    else:
        raise AssertionError(f"profiler saw no device function of {prefix} "
                             f"in {PROFILE_WINDOWS} windows")
    named = re.compile(r"(^|[\s:])" + re.escape(prefix))
    other = [e.key for e in on_card if not named.search(e.key)]
    if other and not apart:
        raise AssertionError(f"a call ran device functions not named "
                             f"{prefix}*: {other}")
    per = {e.key: e.self_device_time_total / e.count
           * max(1, round(e.count / n)) / 1e3 for e in on_card}
    own = sum(v for k, v in per.items() if k not in other)
    return own, {e.key: e.count / n for e in on_card}, per


def fn_name(key: str) -> str:
    """A device function's name from the profiler's key (its signature)."""
    m = re.search(r"(\w+)(<[^(]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m else key


def mm_row(per, s: int, mix=LAYER_MIX):
    """Kernel 9's numbers for one layer's launches (``mix``: the leaf
    shapes and their counts; a qwen2 layer's six by default) at sequence
    length ``s`` with bf16 τ, as the bf16 serving path calls it: the sum
    of the per-shape times."""
    keys = [((k, n, s, "torch.bfloat16"), c) for (k, n), c in mix.items()]
    tot = {f: sum(per[key][f] * c for key, c in keys)
           for f in ("ms", "plain_ms", "bound_ms", "device_ms")}
    by = {per[key]["bound_by"] for key, _ in keys}
    tot["bound_by"] = by.pop() if len(by) == 1 else "bytes"
    tot["max_abs_err"] = max(v["max_abs_err"] for v in per.values())
    return tot


def mm_decode_summary(label, ops_, calls: int, wall_ms: float,
                      busy_ms: float) -> float:
    """Kernel 9's share of a profiled decode window (``ops_`` from
    ``profile_window``; ``calls`` kernel-9 calls in it): every device
    function named ``modulated_matmul*``, summed; returns its ms."""
    fns = {k: v for k, v in ops_.items() if "modulated_matmul" in k}
    ms_ = sum(v[0] for v in fns.values())
    log(f"{label}: modulated_matmul device time {ms_:.3f} ms of "
        f"{busy_ms:.3f} busy ms ({ms_ / calls * 1e3:.2f} us per call over "
        f"{calls} calls, against {wall_ms / calls * 1e3:.2f} us of wall per "
        f"call slot); device functions: "
        + ", ".join(f"{k[:70]} x{v[1]}" for k, v in fns.items()))
    return ms_


def serve_round(torch, dev, space):
    """One MaTU round at the model's d through ``MaTUServer.round``:
    N clients of 3–4 tasks each (client i holds task i mod T, so every
    task is held), task vectors 0.05·N(0, 1) made on the card, uploads
    built by ``batched_client_unify`` and stamped with the manifest
    fingerprint.  Returns (server, uploads' unified / words / lams,
    tasks, valid, sizes, round output)."""
    from repro_torch.core.client import ClientUpload
    from repro_torch.core.engine import batched_client_unify
    from repro_torch.core.server import MaTUServer, MaTUServerConfig
    d = space.d
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    ks = 3 + (torch.rand(N, generator=g, device=dev) < 0.5).long()
    ks = [int(k) for k in ks.tolist()]
    tasks = torch.full((N, K_MAX), T, dtype=torch.int32, device=dev)
    for i, k in enumerate(ks):
        own = i % T
        rest = [int(t) for t in torch.randperm(T, generator=g, device=dev)
                .tolist() if t != own][:k - 1]
        tasks[i, :k] = torch.tensor(sorted([own] + rest), dtype=torch.int32)
    valid = torch.arange(K_MAX, device=dev)[None, :] < torch.tensor(
        ks, device=dev)[:, None]
    sizes = (torch.randint(10, 200, (N, K_MAX), generator=g, device=dev)
             * valid).float()
    tv = 0.05 * torch.randn((N, K_MAX, d), generator=g, device=dev) \
        * valid[:, :, None]
    uni, words, lams = batched_client_unify(tv, valid, device=dev)
    del tv
    uploads = [ClientUpload(i, tasks[i, :k].tolist(), uni[i], words[i, :k],
                            lams[i, :k], sizes[i, :k].tolist(),
                            fingerprint=space.fingerprint)
               for i, k in enumerate(ks)]
    server = MaTUServer(MaTUServerConfig(n_tasks=T), device=dev)
    server.round(uploads)
    return server, (uni, words, lams, tasks, valid, sizes, ks)


def single_task_check(torch, dev, round_data, server):
    """Kernel 8 through ``ops.masked_agg`` once, on the round's most-held
    task: member rows carry their mask for it and γ from the data sizes,
    every other row γ = 0 with a nonzero mask (its first slot's).  Held
    against its plain version, the batched bool kernel's row and the
    round's own τ̂ of that task, bitwise.  Returns (row, launches)."""
    from repro_torch.kernels import bitpack, masked_agg, ops
    uni, words, lams, tasks, valid, sizes, ks = round_data
    d = uni.shape[1]
    held = torch.zeros(T, dtype=torch.long, device=dev)
    held.index_add_(0, tasks[valid].long(), torch.ones_like(
        tasks[valid], dtype=torch.long))
    t0 = int(torch.argmax(held))
    hit = (tasks == t0) & valid                              # (N, K)
    slot = torch.where(hit.any(1), hit.float().argmax(1),
                       torch.zeros(N, dtype=torch.long, device=dev))
    rows = torch.arange(N, device=dev)
    masks = bitpack.unpack_bits(words[rows, slot], d)        # (N, d) bool
    lam = lams[rows, slot].float()
    member = hit.any(1)
    sz = torch.where(member, sizes[rows, slot], 0.0)
    gam = sz / torch.clamp(sz.sum(), min=1e-12)
    ops.reset_launch_counts()
    tau, m_hat = ops.masked_agg(uni, masks, lam, gam, rho=0.4)
    launches = ops.launch_counts()["masked_agg"]
    again = masked_agg.masked_agg_cuda(uni, masks, lam, gam, 0.4)
    want = masked_agg.plain_single(uni, masks, lam, gam, 0.4)
    row = masked_agg.masked_agg_batched_cuda(
        uni, (masks & member[:, None])[:, None], lam[:, None], gam[:, None],
        member[:, None], 0.4)
    out = server.engine.run_packed(_pack(torch, dev, server, round_data))
    torch.cuda.synchronize()
    for name, a, b in (("tau vs plain", tau, want[0]),
                       ("m_hat vs plain", m_hat, want[1]),
                       ("tau vs batched row", tau, row[0][0]),
                       ("m_hat vs batched row", m_hat, row[1][0]),
                       ("tau vs the round's tau_hat", tau, out.tau_hats[t0]),
                       ("m_hat vs the round's m_hat", m_hat, out.m_hats[t0]),
                       ("tau run to run", again[0], tau),
                       ("m_hat run to run", again[1], m_hat)):
        check_equal(torch, f"masked_agg (single task) {name}", a, b)
    n_mem = int(member.sum())
    args = (uni, masks, lam, gam, 0.4)
    ms = time_ms(torch, lambda: masked_agg.masked_agg_cuda(*args))
    dev_ms, _, per_fn = device_ms(
        torch, "masked_agg", lambda: masked_agg.masked_agg_cuda(*args))
    plain_ms = time_ms(torch, lambda: masked_agg.plain_single(*args), reps=5)
    b_ms, b_by = bound(n_mem * d * (uni.element_size() + 1) + 2 * N * 4
                       + 2 * d * 4, 8 * n_mem * d)
    log(f"masked_agg (task {t0}, N={N}, {n_mem} members, {N - n_mem} rows "
        f"with gamma = 0 and a mask, d={d}): {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms: " + ", ".join(
            f"{fn_name(k)} {v:.4f}" for k, v in per_fn.items())
        + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); equal "
        f"to the plain version, the batched row and the round's task, run "
        f"to run identical")
    rowd = dict(route="cuda", source="src/repro_torch/kernels/csrc/"
                "masked_agg.cu", replaces="src/repro/kernels/masked_agg.py:202",
                max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                check="tau_hat, m_hat identical to the plain version, the "
                "batched kernel's row and the round's task; run to run "
                "identical")
    return rowd, launches


def _pack(torch, dev, server, round_data):
    from repro_torch.core.engine import pack_from_slots
    uni, words, lams, tasks, valid, sizes, ks = round_data
    return pack_from_slots(list(range(len(ks))),
                           [tasks[i, :k].tolist() for i, k in enumerate(ks)],
                           uni, words, lams, tasks, valid, sizes,
                           server.cfg.n_tasks, d=uni.shape[1])


def profile_window(torch, label, fn, top: int = 6):
    """``fn`` under ``torch.profiler``: wall, summed device time, idle
    share, and the ops that take the most device time.  Returns
    (wall_ms, busy_ms, {op name: (device ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    log(f"profiled {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}")
    ops_ = {}
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total):
        ops_[e.key] = (e.self_device_time_total / 1e3, e.count)
    for key, (ms, calls) in list(ops_.items())[:top]:
        log(f"  {ms:8.3f} ms  x{calls:<5d} {key[:90]}")
    on_host = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("aten::")]
    host_us = sum(e.self_cpu_time_total for e in on_host)
    log(f"  {sum(e.count for e in on_card)} device kernels and copies; "
        f"{sum(e.count for e in on_host)} aten ops taking {host_us / 1e3:.3f}"
        f" ms of host time; most host time:")
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"  {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key}")
    return wall_us / 1e3, busy_us / 1e3, ops_


def _rel_l2(torch, a, b) -> float:
    """‖a − b‖ / ‖b‖: 0 where a equals b (also at b = 0), inf where b = 0
    and a does not."""
    num = float((a.float() - b.float()).norm())
    return 0.0 if num == 0.0 else num / float(b.float().norm())


# -- the serving phases' shared steps -------------------------------------


def build_served(torch, dev, cfg, seed, want, shape=""):
    """``cfg``'s model on the card, its parameters and LoRA factors
    random from ``seed``, and its task-vector space; raises unless its
    (d, fingerprint) is ``want`` (None: a reduced configuration, not
    checked).  ``shape`` is the family's part of the log line.  Returns
    (model, generator, params, lora0, space)."""
    from repro_torch.common.tree import TaskVectorSpace, tree_leaves
    t_build = time.perf_counter()
    model = cfg.build(device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(g)
    lora0 = model.lora_init(g)
    space = TaskVectorSpace.from_tree(lora0)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"{cfg.name} ({cfg.dtype}): {n_params} parameters{shape}, LoRA d = "
        f"{space.d} on {cfg.lora_targets()}, layout {space.fingerprint}, "
        f"built in {time.perf_counter() - t_build:.2f} s")
    if want is not None and (space.d, space.fingerprint) != want:
        raise AssertionError(f"LoRA d {space.d} / layout {space.fingerprint}"
                             f" != {want[0]} / {want[1]}")
    return model, g, params, lora0, space


def serve_requests(torch, dev, cfg, g, b, s, seed=SEED + 6):
    """B requests over B - 1 tasks (the last repeats the first's task)
    and their (B, S) prompts.  Returns (task ids, prompts)."""
    gcpu = torch.Generator().manual_seed(seed)
    ids = torch.randperm(T, generator=gcpu)[:b - 1].tolist()
    ids.append(ids[0])
    return ids, torch.randint(1, cfg.vocab, (b, s), generator=g, device=dev)


def decoder_generate(prompts, ids, new):
    """``gen(model, params, store, fused=True, mode=None)`` -> tokens
    (B, S + new): ``MultiTenantDecoder.generate``, greedy, the serving
    entry point of the one-stack families."""
    from repro_torch.serve import GenerationConfig, MultiTenantDecoder
    gen_cfg = GenerationConfig(max_new_tokens=new)

    def gen(model, params, store, fused=True, mode=None):
        return MultiTenantDecoder(model, params, store, fused=fused,
                                  cfg=gen_cfg, mode=mode,
                                  device=model.device).generate(prompts, ids)
    return gen


def prompt_length(batch) -> int:
    """A prefill batch's sequence length: its tokens and a vlm's prepended
    ``extra_embeds`` (whisper's ``audio_embeds`` feed its encoder, not
    this sequence)."""
    s = batch["tokens"].shape[1]
    return s + (batch["extra_embeds"].shape[1] if "extra_embeds" in batch
                else 0)


def served_generate(torch, model, params, lora, batch, new, mode=None):
    """The serving loop of the models whose prefill batch carries more
    than tokens (whisper's frames; the vlm's images and positions), as
    the JAX package serves them, through ``prefill_step`` and
    ``decode_fn`` (its decoder is token-only): prefill ``batch``, then
    ``new - 1`` greedy decode steps from position :func:`prompt_length`
    on.  Returns tokens (B, S + new) int32, S the batch's tokens."""
    prompts = batch["tokens"]
    n = prompt_length(batch)
    cache = model.init_cache(prompts.shape[0], n + new + 8)
    logits, cache = model.prefill_step(params, lora, batch, cache, mode=mode)
    out = [torch.argmax(logits, -1).to(torch.int32)]
    for pos in range(n, n + new - 1):
        logits, cache = model.decode_fn(params, lora,
                                        {"tokens": out[-1][:, None]}, cache,
                                        pos, mode=mode)
        out.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.cat([prompts.to(torch.int32), torch.stack(out, 1)], 1)


def served_prefill(model, params, batch, new):
    """``prefill(lora tree, mode=None)`` -> (last-token logits, cache):
    ``batch`` into a fresh cache of the generate's length."""
    b, s = batch["tokens"].shape[0], prompt_length(batch)

    def prefill(lora, mode=None):
        return model.prefill_step(params, lora, batch,
                                  model.init_cache(b, s + new + 8), mode=mode)
    return prefill


def round_to_store(torch, dev, label, space, lora0):
    """The main path's first half, from launch counts set to 0: one MaTU
    round at the model's d (:func:`serve_round`), its serving downlink
    and a store that ingests it, timed.  Returns (server, round data,
    store, ms)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ModulatorStore
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, round_data = serve_round(torch, dev, space)
    store = ModulatorStore(space, lora0, capacity=T, device=dev)
    store.ingest(server.serving_downlink(packed=True,
                                         fingerprint=space.fingerprint))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    rep = store.storage_report()
    log(f"{label}main path: round + downlink + ingest {ms:.1f} ms (T={T}, "
        f"N={N}, d={space.d}); store {rep['tasks']} tasks in "
        f"{rep['resident_bytes']} B vs {rep['checkpoint_bytes']} B of "
        f"checkpoints ({rep['ratio']:.2f}x)")
    return server, round_data, store, ms


def counted_generate(torch, label, cfg, prompts, ids, generate, want, new,
                     what="fused, bf16"):
    """The main path's second half: ``generate()`` -> tokens (B, S +
    new), timed, its serve-kernel launches held to ``want`` exactly,
    every packed-round kernel launched since the counts were set to 0,
    the prompts at the head of in-vocabulary tokens.  Returns (tokens,
    launches, ms, peak GiB)."""
    from repro_torch.kernels import ops
    b, s = prompts.shape
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = generate()
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = ops.launch_counts()
    launches = {k: counts[k] - before[k] for k in ops.SERVE_KERNELS}
    if launches != want:
        raise AssertionError(f"{label}generate launched {launches}, "
                             f"expected {want}")
    if min(counts[k] for k in ops.PACKED_ROUND_KERNELS) < 1:
        raise AssertionError(f"{label}round: a round kernel was not "
                             f"launched: {counts}")
    if out.shape != (b, s + new) or \
            not torch.equal(out[:, :s], prompts.to(out.dtype)) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{label}generate: bad output tokens")
    log(f"{label}generate ({what}, B={b}, tasks {ids}, prompt {s}, {new} "
        f"new): wall {1e3 * t_gen:.1f} ms, {b * new / t_gen:.1f} tokens/s, "
        f"peak device memory {peak:.3f} GiB, launches {launches}; round "
        f"kernels {counts}")
    return out, launches, 1e3 * t_gen, peak


def step_walls(torch, label, model, params, store, ids, prefill, s):
    """The fused route, three prefills through it and eight decode steps
    after the last, each timed between synchronises.  Returns (routed
    tree, the last prefill's logits, the cache after the steps, the
    first generated token (B, 1), prefill ms, step ms)."""
    from repro_torch.serve.router import route_batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora = route_batch(store, ids, fused=True)
    torch.cuda.synchronize()
    route_ms = 1e3 * (time.perf_counter() - t0)
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(lora)
        torch.cuda.synchronize()
        pre_ms.append(1e3 * (time.perf_counter() - t0))
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    step_ms = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.decode_fn(params, lora, {"tokens": tok}, cache,
                                   s + i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"{label}route (fused) {route_ms:.2f} ms; prefill "
        f"{[round(x, 2) for x in pre_ms]} ms; decode steps "
        f"{[round(x, 3) for x in step_ms]} ms (median "
        f"{statistics.median(step_ms):.3f})")
    return lora, logits, cache, tok, pre_ms, step_ms


def decode_window(torch, label, model, params, lora, tok, cache, s,
                  per_step):
    """Four decode steps from ``cache`` (positions s .. s + 3) under the
    profiler, and kernel 9's share of them (``per_step`` launches a
    step).  Returns (wall ms, busy ms)."""
    def four_steps():
        c = cache
        for i in range(4):
            _, c = model.decode_fn(params, lora, {"tokens": tok}, c, s + i)

    wall, busy, ops_ = profile_window(torch, f"{label}4 decode steps",
                                      four_steps)
    mm_decode_summary(f"{label}decode", ops_, 4 * per_step, wall, busy)
    return wall, busy


def bf16_gate(torch, label, logits_k, logits_p, bound, flip=None,
              what="prefill"):
    """bf16 logits (of the prefill, or ``what`` else) through the kernels
    against the same routed tree through the plain versions: finite, and
    within ``bound`` rel L2 unless an MoE router flip between the two
    runs (``flip``, from :func:`routing_diff`) explains it.  Returns the
    rel L2."""
    rel = _rel_l2(torch, logits_k, logits_p)
    log(f"{label}bf16 {what} logits, kernels vs plain versions: rel L2 "
        f"{rel:.3e} (bound {bound}), max|err| "
        f"{max_abs(torch, logits_k, logits_p)}")
    if not torch.isfinite(logits_k).all():
        raise AssertionError(f"{label}bf16 {what} logits not finite")
    if not rel <= bound:
        if flip is None:
            raise AssertionError(f"{label}bf16 {what} logits: rel L2 {rel}"
                                 f" with no router flip behind it")
        log(f"{label}bf16 {what} logits beyond the bound after a "
            f"{flip_text(flip)}: a near-tie flip, documented, not a fault")
    return rel


def token_agreements(torch, label, gen, model, params, store, out, s):
    """Printed, not required: the share of the fused generate's tokens
    that the same route through the plain versions, and the dense-routed
    route (its adapter rounds to bf16, the fused weights stay fp32),
    generate too."""
    agree = [float((gen(model, params, store, **kw)[:, s:] == out[:, s:])
                   .float().mean())
             for kw in ({"mode": "ref"}, {"fused": False})]
    log(f"{label}bf16 generated-token agreement with the fused route: plain "
        f"versions {agree[0]:.4f}, dense-routed {agree[1]:.4f} (printed, "
        f"not required)")


def fp32_check(torch, dev, cfg32, server, ids, batch, gen, new, seed,
               label="", root=("units", "blk"), then=None):
    """The same configuration in fp32, weights from ``seed``: fused
    (kernel) and dense-routed generates (``gen``) give identical tokens,
    prefill logits of ``batch`` agree within the JAX package's bar, and
    every factor of layer 0 at ``cfg32.lora_targets()`` (paths under
    ``root`` of the routed tree) built by the kernel with x = I equals
    the dense adapter leaf bit for bit; then ``then(model, params,
    store)``, if given, whose result it returns.  In an
    MoE model the two routes' LoRA products sum in other orders, so a
    near-tie can route a token to another expert: a token or logit
    difference passes only where such a router flip comes first, and is
    printed with its forward, layer and margin; any other difference
    fails."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ModulatorStore
    from repro_torch.serve.router import route_batch
    model, _, params, lora0, space = build_served(torch, dev, cfg32, seed,
                                                  None)
    store = ModulatorStore(space, lora0, capacity=T, device=dev)
    store.ingest(server.serving_downlink(packed=True,
                                         fingerprint=space.fingerprint))
    prefill = served_prefill(model, params, batch, new)
    b, s = batch["tokens"].shape
    outs, logits, gen_tr, pre_tr = {}, {}, {}, {}
    for fused in (True, False):
        with RoutingTrace(torch, model) as gen_tr[fused]:
            outs[fused] = gen(model, params, store, fused=fused)
        with RoutingTrace(torch, model) as pre_tr[fused]:
            logits[fused], _ = prefill(route_batch(store, ids, fused=fused))
    torch.cuda.synchronize()
    agree = float((outs[True] == outs[False]).float().mean())
    log(f"{label}fp32: fused vs dense-routed tokens identical: "
        f"{torch.equal(outs[True], outs[False])} (agreement {agree:.4f}); "
        f"prefill logits max|err| {max_abs(torch, logits[True], logits[False])}"
        f", rel L2 {_rel_l2(torch, logits[True], logits[False]):.3e}")
    flip = routing_diff(torch, gen_tr[True], gen_tr[False], cfg32.n_layers)
    if gen_tr[True].moe is not None:
        log(f"{label}fp32 routing, fused vs dense-routed: "
            + (flip_text(flip) if flip else "identical in every layer and "
               "forward"))
    if not torch.equal(outs[True], outs[False]):
        first = int((outs[True] != outs[False])[:, s:].any(0).nonzero()[0])
        if flip is None or flip["forward"] > first:
            check_equal(torch, f"{label}fp32 fused vs dense-routed tokens",
                        outs[True], outs[False])
        log(f"{label}fp32 tokens differ from generated token {first} on, "
            f"after the router flip above: a near-tie flip, documented, "
            f"not a fault")
    if not torch.allclose(logits[True], logits[False], rtol=FP32_RTOL,
                          atol=FP32_ATOL):
        pflip = routing_diff(torch, pre_tr[True], pre_tr[False],
                             cfg32.n_layers)
        if pflip is None:
            raise AssertionError(f"{label}fp32 prefill logits beyond rtol "
                                 f"{FP32_RTOL}, atol {FP32_ATOL}")
        log(f"{label}fp32 prefill logits beyond rtol {FP32_RTOL} after a "
            f"{flip_text(pflip)}: documented, not a fault")
    trees = []
    for fused in (True, False):
        tree = route_batch(store, ids, fused=fused)
        for key in root:
            tree = tree[key]
        trees.append(tree)
    sites = cfg32.lora_targets()
    for site in sites:
        fs, ds = trees
        for key in site.split("/"):
            fs, ds = fs[key], ds[key]
        for f in ("a", "b"):
            k = fs[f]["base"].shape[1]
            eye = torch.eye(k, device=dev).expand(b, k, k).contiguous()
            w = ops.modulated_matmul(eye, fs[f]["base"][0], fs[f]["tau"][0],
                                     fs[f]["words"][0], fs["lam"][0])
            check_equal(torch, f"{label}fp32 fused weight {site}/{f} layer 0"
                        f" vs dense adapter", w, ds[f][0])
            del eye, w
    log(f"{label}fp32: {2 * len(sites)} fused factor weights of layer 0 "
        f"(x = I) equal the dense adapter leaves bit for bit")
    out = then(model, params, store) if then is not None else None
    del model, params, store
    return out


def serve_phase(torch, dev, cfg=None):
    """Multi-tenant serving at full width (see the module docstring).
    Returns (rows, launches by kernel)."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch

    per = serve_kernel_checks(torch, dev)
    rows = {}

    full = cfg is None
    cfg = cfg or load_arch(SERVE_ARCH)
    b, s, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 4,
        (SERVE_D, SERVE_FINGERPRINT) if full else None)
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    batch = {"tokens": prompts}
    gen = decoder_generate(prompts, ids, new)
    per_fwd = launches_per_forward(cfg)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, _ = round_to_store(torch, dev, "", space,
                                                  lora0)
    out, serve_counts, _, _ = counted_generate(
        torch, "", cfg, prompts, ids, lambda: gen(model, params, store),
        {"modulated_matmul": per_fwd * new, "mlstm_chunkwise": 0}, new)
    rows["masked_agg"], serve_counts["masked_agg"] = single_task_check(
        torch, dev, round_data, server)
    del round_data

    # -- step times, and profiled prefill / decode windows -------------------
    prefill = served_prefill(model, params, batch, new)
    lora, logits_k, cache, tok, _, _ = step_walls(torch, "", model, params,
                                                  store, ids, prefill, s)
    del cache
    profile_window(torch, "prefill", lambda: prefill(lora))
    decode_window(torch, "", model, params, lora, tok, prefill(lora)[1], s,
                  per_fwd)

    # -- the same routed tree through the plain versions --------------------
    bf16_gate(torch, "", logits_k, prefill(lora, mode="ref")[0],
              BF16_LOGIT_REL_L2)
    token_agreements(torch, "", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               batch, gen, new, SEED + 7)
    del server
    torch.cuda.empty_cache()

    dec = mm_row(per, 1)
    pre = mm_row(per, SERVE_PROMPT)
    unit = mm_row(per, 1, XLSTM_UNIT_MIX)
    rows["modulated_matmul"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/modulated_matmul.cu",
        replaces="src/repro/kernels/modulated_matmul.py:55",
        max_abs_err=dec["max_abs_err"], ms=dec["ms"],
        plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=None,
        device_ms=dec["device_ms"], prefill_layer_ms=pre["ms"],
        prefill_layer_device_ms=pre["device_ms"],
        prefill_layer_plain_ms=pre["plain_ms"],
        prefill_layer_bound_ms=pre["bound_ms"],
        xlstm_unit_ms=unit["ms"], xlstm_unit_device_ms=unit["device_ms"],
        xlstm_unit_plain_ms=unit["plain_ms"],
        xlstm_unit_bound_ms=unit["bound_ms"],
        per_shape={f"{k}x{n} S={s} tau={t[6:]}": v
                   for (k, n, s, t), v in per.items()},
        check=f"|err| <= {MM_RTOL} (|x| @ |w|) against the plain version; "
        f"x = I and one-hot decode rows bitwise; S = 1 run to run and B = 1 "
        f"against B = {SERVE_B} bitwise; misaligned refused (ms / plain / "
        f"bound: one decode "
        f"layer's six launches, S=1, bf16 tau)")
    log(f"modulated_matmul per decode layer (6 launches, S=1): {dec['ms']:.4f}"
        f" ms of calls (device {dec['device_ms']:.4f} ms), plain "
        f"{dec['plain_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; per "
        f"prefill layer (S={SERVE_PROMPT}): {pre['ms']:.4f} ms (device "
        f"{pre['device_ms']:.4f} ms), plain {pre['plain_ms']:.4f} ms, bound "
        f"{pre['bound_ms']:.5f} ms; per xlstm decode unit (8 launches, S=1): "
        f"{unit['ms']:.4f} ms (device {unit['device_ms']:.4f} ms), plain "
        f"{unit['plain_ms']:.4f} ms, bound {unit['bound_ms']:.5f} ms")
    return rows, serve_counts


# -- xlstm phase: multi-tenant xlstm-1.3b at full width -----------------------

XLSTM_ARCH = "xlstm-1.3b"
XLSTM_D = 12_058_464           # its LoRA task-vector size at rank 16
XLSTM_FINGERPRINT = "03df97f531d3589f"
XLSTM_B, XLSTM_PROMPT, XLSTM_NEW = 8, 512, 32
XLSTM_RAGGED = 500             # a prompt length that pads the last chunk
XLSTM_RAGGED3 = 700            # three chunks of 256, the last one ragged
# kernel 10's device functions (the pre-pass's two kernels and the main
# kernel), as the profiler names them
K10_FUNCS = re.compile(r"(^|[\s:])mlstm_\w*kernel")
# kernel 10 against its plain version: fp32 to the JAX package's mLSTM
# bar (both sum in fp32, in other orders); bf16 h to 2^-6 relative and
# absolute (a few bf16 ulps at |h| <= 8: a summation-order difference can
# flip the bf16 rounding of a score, w, w @ v or h); the fp32 state to
# the fp32 bar at either input dtype
MLSTM_RTOL, MLSTM_ATOL = 1e-4, 1e-5
MLSTM_BF16_TOL = 2.0 ** -6
# bf16 model, fused route through the kernels against the same route
# through the plain versions: rel L2 of the prefill logits.  Kernels 9
# and 10 sum in other orders than their plain versions, so bf16 roundings
# flip and carry through 48 bf16 layers, as in the qwen2 phase
XLSTM_BF16_LOGIT_REL_L2 = 5e-2


def mlstm_inputs(torch, dev, g, b, h, s, dk, dv, dtype, random_state):
    """Model-shaped kernel-10 inputs made on the card: q, k ~ N(0, 1) /
    sqrt(dk), v ~ N(0, 1), gates i ~ N(0, 1), f ~ N(2, 1) in fp32; a
    random state is C, n ~ 0.3 N(0, 1), m ~ N(0, 1), else the zero state
    (m = -1e30)."""
    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k = rn(b, h, s, dk) * dk ** -0.5, rn(b, h, s, dk) * dk ** -0.5
    args = [q.to(dtype), k.to(dtype), rn(b, h, s, dv).to(dtype),
            rn(b, h, s), rn(b, h, s) + 2.0]
    if random_state:
        st = (0.3 * rn(b, h, dk, dv), 0.3 * rn(b, h, dk), rn(b, h))
    else:
        st = (torch.zeros((b, h, dk, dv), device=dev),
              torch.zeros((b, h, dk), device=dev),
              torch.full((b, h), -1e30, device=dev))
    return args, st


def mlstm_work(b, h, s, dk, dv, chunk, elt):
    """(bytes, state operations, intra-chunk operations) of one call: q,
    k, v, the gates and the state read once, h and the state written
    once; the multiply-adds of the real steps of each chunk, two each:
    q·C and the state fold (2·l·Dk·Dv each, fp32 C), and the causal q·k
    and w @ v (l(l+1)·Dk and l(l+1)·Dv, products of two model-dtype
    operands)."""
    n_bytes = (b * h * s * (2 * dk + dv) * elt + 2 * b * h * s * 4
               + 2 * b * h * (dk * dv + dk + 1) * 4 + b * h * s * dv * elt)
    state_ops = intra_ops = 0
    for c0 in range(0, s, chunk):
        l = min(chunk, s - c0)
        state_ops += 4 * l * dk * dv
        intra_ops += l * (l + 1) * (dk + dv)
    return n_bytes, b * h * state_ops, b * h * intra_ops


def mlstm_prepass_check(torch, ml, name, args, st, chunk, dtype):
    """Kernel 10's pre-pass alone against its plain version: every
    output, w / qn_intra / the divisor at h's bar (they carry the bf16
    score rounding), the rest at the fp32 bar.  Returns the entries of
    bcum that differ from the plain version's (printed: both sum in fp64
    and round once, but take log sigmoid by other formulas)."""
    q, k, _, i, f = args
    got = ml.mlstm_chunk_prepass_cuda(q, k, i, f, st[1], st[2], chunk=chunk)
    want = ml.plain_prepass(q, k, i, f, st[1], st[2], chunk=chunk)
    torch.cuda.synchronize()
    bf16_keys = ("w", "qn_intra", "den") if dtype == torch.bfloat16 else ()
    for key, w in want.items():
        tol = ((MLSTM_BF16_TOL, MLSTM_BF16_TOL) if key in bf16_keys
               else (MLSTM_RTOL, MLSTM_ATOL))
        check_close(torch, f"{name} pre-pass {key}", got[key], w, *tol)
    return int((got["bcum"] != want["bcum"]).sum())


def mlstm_kernel_checks(torch, dev, cfg):
    """Kernel 10 at the model's full width (B = XLSTM_B, its heads, Dk,
    Dv and chunk): S = XLSTM_PROMPT, a ragged XLSTM_RAGGED and a ragged
    three-chunk XLSTM_RAGGED3, fp32 and bf16, zero and random initial
    state: h and the final (C, n, m) against the plain version, the
    pre-pass alone against its plain version, run to run bitwise, and
    (random state) C read and written in place bitwise the
    separate-buffer call; timed at the serving shape, with each device
    function's share.  Returns the kernel's row."""
    from repro_torch.kernels import mlstm_chunk as ml
    from repro_torch.nn.ssm import MLSTMBlock
    blk = MLSTMBlock(cfg.d_model, cfg.n_heads, chunk=cfg.mlstm_chunk)
    b, h, dk, dv, chunk = XLSTM_B, cfg.n_heads, blk.dk, blk.dv, blk.chunk
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    err32, err16, timed = 0.0, 0.0, {}
    for s in (XLSTM_PROMPT, XLSTM_RAGGED, XLSTM_RAGGED3):
        for random_state in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                args, st = mlstm_inputs(torch, dev, g, b, h, s, dk, dv,
                                        dtype, random_state)
                got_h, got_st = ml.mlstm_chunkwise_cuda(*args, st,
                                                        chunk=chunk)
                again_h, again_st = ml.mlstm_chunkwise_cuda(*args, st,
                                                            chunk=chunk)
                want_h, want_st = ml.plain(*args, st, chunk=chunk)
                torch.cuda.synchronize()
                name = (f"mlstm_chunkwise S={s} {str(dtype)[6:]} "
                        f"{'random' if random_state else 'zero'} state")
                if got_h.shape != want_h.shape or got_h.dtype != dtype or \
                        not torch.isfinite(got_h).all():
                    raise AssertionError(f"{name}: bad h")
                if not torch.equal(got_h, again_h) or \
                        not all(torch.equal(a, w)
                                for a, w in zip(got_st, again_st)):
                    raise AssertionError(f"{name}: two calls differ")
                tol = ((MLSTM_RTOL, MLSTM_ATOL) if dtype == torch.float32
                       else (MLSTM_BF16_TOL, MLSTM_BF16_TOL))
                err = check_close(torch, f"{name} h", got_h, want_h, *tol)
                for part, a, w in zip("Cnm", got_st, want_st):
                    err32 = max(err32, check_close(torch, f"{name} {part}",
                                                   a, w, MLSTM_RTOL,
                                                   MLSTM_ATOL))
                rel = _rel_l2(torch, got_h, want_h)
                if dtype == torch.float32:
                    err32 = max(err32, err)
                else:
                    err16 = max(err16, err)
                n_bcum = mlstm_prepass_check(torch, ml, name, args, st, chunk,
                                             dtype)
                log(f"{name}: h max|err| {err} (rel L2 {rel:.2e}, bar rtol "
                    f"= {tol[0]}, atol = {tol[1]}); state within rtol "
                    f"{MLSTM_RTOL}, atol {MLSTM_ATOL}; run to run bitwise; "
                    f"pre-pass within its bars ({n_bcum} bcum entries not "
                    f"bitwise the plain version's)")
                if random_state:
                    # the model path's in-place C: the state's C is C_out
                    C = st[0].clone()
                    in_h, in_st = ml.mlstm_chunkwise_cuda(
                        *args, (C, st[1], st[2]), chunk=chunk, C_out=C)
                    torch.cuda.synchronize()
                    if in_st[0] is not C or not torch.equal(in_h, got_h) or \
                            not all(torch.equal(a, w)
                                    for a, w in zip(in_st, got_st)):
                        raise AssertionError(f"{name}: C read and written in "
                                             "place differs from C_out apart")
                    log(f"{name}: C in place bitwise the separate-buffer "
                        f"call")
                if s == XLSTM_PROMPT and not random_state:
                    timed[dtype] = (args, st)
    rows = {}
    for dtype, (args, st) in timed.items():
        fn = lambda: ml.mlstm_chunkwise_cuda(*args, st, chunk=chunk)  # noqa
        ms = time_ms(torch, fn)
        dev_ms, _, per_fn = device_ms(torch, "mlstm_", fn)
        plain_ms = time_ms(torch, lambda: ml.plain(*args, st, chunk=chunk),
                           reps=5)
        elt = args[0].element_size()
        n_bytes, state_ops, intra_ops = mlstm_work(
            b, h, XLSTM_PROMPT, dk, dv, chunk, elt)
        n_ops = state_ops + intra_ops
        # in bf16 the causal q·k and w @ v multiply bf16 operands, work
        # for the tensor cores; q·C and the fold take fp32 C
        b_ms, b_by = (bound(n_bytes, state_ops, intra_ops)
                      if dtype == torch.bfloat16 else bound(n_bytes, n_ops))
        ws_bytes = ml.workspace_bytes(b * h, XLSTM_PROMPT, chunk, dk, elt)
        rows[dtype] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                           ops=n_ops, workspace_bytes=ws_bytes,
                           device_functions=per_fn,
                           blocks_per_sm=ml.occupancy(dtype, chunk, dk))
        log(f"mlstm_chunkwise B={b} H={h} S={XLSTM_PROMPT} Dk={dk} Dv={dv} "
            f"chunk={chunk} {str(dtype)[6:]}: {ms:.4f} ms a call (device "
            f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB), "
            f"{n_ops / dev_ms / 1e9:.2f} TFLOP/s achieved; workspace "
            f"{ws_bytes} B; blocks a SM {rows[dtype]['blocks_per_sm']}")
        for f_name, f_ms in sorted(per_fn.items(), key=lambda x: -x[1]):
            log(f"  {f_ms:.4f} ms ({100 * f_ms / dev_ms:.1f} % of a call) "
                f"{f_name[:90]}")
    serve = rows[torch.bfloat16]
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        replaces="src/repro/kernels/mlstm_chunk.py:87", max_abs_err=err16,
        ms=serve["ms"], plain_ms=serve["plain_ms"],
        bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
        library_ms=None, device_ms=serve["device_ms"],
        workspace_bytes=serve["workspace_bytes"],
        device_functions=serve["device_functions"],
        blocks_per_sm=serve["blocks_per_sm"],
        fp32=rows[torch.float32],
        fp32_max_abs_err=err32,
        check=f"fp32 h and state rtol {MLSTM_RTOL}, atol {MLSTM_ATOL}; bf16 "
        f"h rtol = atol = {MLSTM_BF16_TOL} (max |err| fp32 {err32}, bf16 "
        f"{err16}); S = {XLSTM_PROMPT}, {XLSTM_RAGGED} and {XLSTM_RAGGED3}, "
        f"zero and random state; pre-pass within its bars; run to run and "
        f"C in place bitwise (ms / plain / bound: bf16, S = {XLSTM_PROMPT}, "
        f"zero state)")


def block_prefill_walls(torch, model, params, lora, prompts):
    """Host wall of one layer's prefill per block kind (layer 0, the
    routed LoRA, a fresh cache): the per-block split of a prefill."""
    lm = model.model
    cache = model.init_cache(XLSTM_B, XLSTM_PROMPT + XLSTM_NEW + 8)
    x = lm._embed_in(params, prompts)
    walls = {}
    for name, blk, p, l, c in next(lm._layers(params, lora, cache)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _ = blk.prefill(p, x, c, lora=l)
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0)
    return walls


def xlstm_phase(torch, dev, cfg=None):
    """Multi-tenant serving of xlstm-1.3b at full width (see the module
    docstring).  Returns (kernel 10's row, launches by kernel, kernel 3's
    row at the round's d)."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels import bitpack

    full = cfg is None
    cfg = cfg or load_arch(XLSTM_ARCH)
    row = mlstm_kernel_checks(torch, dev, cfg)
    torch.cuda.empty_cache()

    n_units = cfg.n_layers // 2
    b, s, new = XLSTM_B, XLSTM_PROMPT, XLSTM_NEW
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 9,
        (XLSTM_D, XLSTM_FINGERPRINT) if full else None,
        shape=f", {n_units} (mLSTM, sLSTM) units")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s, seed=SEED + 10)
    batch = {"tokens": prompts}
    gen = decoder_generate(prompts, ids, new)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, _ = round_to_store(torch, dev, "xlstm ",
                                                  space, lora0)
    del round_data
    # kernel 3 at this width, on the sign planes of the round's task
    # vectors (a launch of its own, not the main path's)
    tvs = server.last_task_vectors
    wide = sign_sim_packed_check(torch, *bitpack.sign_planes(tvs), tvs)
    del tvs
    torch.cuda.empty_cache()
    # kernel 9 eight times a unit a forward, kernel 10 once an mLSTM
    # layer at prefill
    out, launches, _, _ = counted_generate(
        torch, "xlstm ", cfg, prompts, ids, lambda: gen(model, params, store),
        {"modulated_matmul": 8 * n_units * new, "mlstm_chunkwise": n_units},
        new)

    # -- step times, per-block split, profiled prefill / decode windows -----
    prefill = served_prefill(model, params, batch, new)
    lora, logits_k, cache, tok, pre_ms, step_ms = step_walls(
        torch, "xlstm ", model, params, store, ids, prefill, s)
    del cache
    walls = block_prefill_walls(torch, model, params, lora, prompts)
    log("xlstm one layer's prefill: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())
        + f" (x {n_units} layers each)")
    _, _, pre_ops = profile_window(torch, "xlstm prefill",
                                   lambda: prefill(lora))
    # the launch counts above show that the prefill ran kernel 10; this
    # window only reads its device time (none if the profiler saw none)
    k10 = {k: v for k, v in pre_ops.items() if K10_FUNCS.search(k)}
    k10_ms = sum(ms for ms, _ in k10.values())
    log(f"xlstm prefill: kernel 10 {k10_ms:.3f} ms of device time over its "
        f"{len(k10)} device functions: " + ", ".join(
            f"{ms:.3f} ms x{calls} {re.search(r'mlstm_\w*', k).group(0)}"
            for k, (ms, calls) in k10.items()))
    decode_window(torch, "xlstm ", model, params, lora, tok,
                  prefill(lora)[1], s, 8 * n_units)

    # -- the same routed tree through the plain versions --------------------
    bf16_gate(torch, "xlstm ", logits_k, prefill(lora, mode="ref")[0],
              XLSTM_BF16_LOGIT_REL_L2)
    token_agreements(torch, "xlstm ", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               batch, gen, new, SEED + 11, label="xlstm ", root=("units",))
    del server
    torch.cuda.empty_cache()
    row["prefill_ms"] = pre_ms
    row["prefill_kernel10_ms"] = k10_ms
    row["decode_step_ms"] = statistics.median(step_ms)
    row["xlstm_modulated_matmul_launches"] = launches["modulated_matmul"]
    return row, launches, wide


# -- granite phase: multi-tenant granite-moe-3b-a800m at full width ----------

GRANITE_ARCH = "granite-moe-3b-a800m"
GRANITE_D = 3_145_792          # its LoRA task-vector size at rank 16
GRANITE_FINGERPRINT = "c35e17542cab0e2c"
GRANITE_B, GRANITE_PROMPT, GRANITE_NEW = 8, 128, 32
# a layer's kernel-9 launches: the a-factors (1536, 16) and the
# b-factors (16, 1536) of mixer/wq and mixer/wo
GRANITE_LAYER_MIX = {(1536, 16): 2, (16, 1536): 2}


class RoutingTrace:
    """While active, records every routing of a model's MoE layers: per
    call the expert ids (T, k) and the k + 1 largest router
    probabilities of each token.  A model without MoE records nothing.
    Kept off the timed runs (it sorts on the side)."""

    def __init__(self, torch, model):
        from repro_torch.nn.moe import MoE
        self.torch = torch
        blocks = getattr(model.model, "unit_blocks", ())   # none in encdec
        self.moe = next((b.ffn for _, b in blocks
                         if isinstance(getattr(b, "ffn", None), MoE)), None)
        self.calls = []

    def __enter__(self):
        if self.moe is not None:
            torch, moe = self.torch, self.moe
            route = type(moe).route

            def spy(router_w, xt, cap):
                out = route(moe, router_w, xt, cap)
                probs, _, idx, _, keep = out
                top = torch.sort(probs, dim=-1, descending=True,
                                 stable=True).values[:, :moe.top_k + 1]
                self.calls.append((idx, top, int(keep.sum()), keep.numel()))
                return out

            moe.route = spy
        return self

    def __exit__(self, *exc):
        if self.moe is not None:
            del self.moe.route

    def kept(self):
        """(kept, routed) (token, choice) rows over the recorded calls."""
        return (sum(c[2] for c in self.calls), sum(c[3] for c in self.calls))


def routing_diff(torch, a: RoutingTrace, b: RoutingTrace, n_layers: int):
    """The first MoE call at which two runs' traces route a token to
    other experts or in another order: {forward, layer, tokens, of them
    those with another expert set, and over those tokens the least
    gap between neighbouring probabilities of the k + 1 largest (the
    near-tie), the largest such gap and the k-th minus (k+1)-th margin,
    each the least of the two runs}; None when they never differ (or no
    MoE ran)."""
    for i, (ca, cb) in enumerate(zip(a.calls, b.calls)):
        rows = (ca[0] != cb[0]).any(-1)
        if bool(rows.any()):
            k = ca[0].shape[1]
            gap = torch.minimum((ca[1][:, :-1] - ca[1][:, 1:]).min(-1).values,
                                (cb[1][:, :-1] - cb[1][:, 1:]).min(-1).values)
            cut = torch.minimum(ca[1][:, k - 1] - ca[1][:, k],
                                cb[1][:, k - 1] - cb[1][:, k])
            sets = (ca[0].sort(-1).values != cb[0].sort(-1).values).any(-1)
            return dict(forward=i // n_layers, layer=i % n_layers,
                        tokens=int(rows.sum()), set_changed=int(sets.sum()),
                        gap_min=float(gap[rows].min()),
                        gap_max=float(gap[rows].max()),
                        cut_min=float(cut[rows].min()))
    return None


def flip_text(flip) -> str:
    return (f"router flip at forward {flip['forward']} (0 = prefill), layer "
            f"{flip['layer']}: {flip['tokens']} tokens routed otherwise "
            f"({flip['set_changed']} to another expert set, the rest in "
            f"another order); nearest neighbouring probabilities "
            f"{flip['gap_min']:.3e} to {flip['gap_max']:.3e} apart, k-th "
            f"minus (k+1)-th {flip['cut_min']:.3e}")


def traced_prefill(torch, label, model, prefill, lora, tokens: int):
    """An MoE model's prefill through the kernels under a
    :class:`RoutingTrace`, its capacity drops logged.  Returns (trace,
    last-token logits, kept rows, routed rows)."""
    with RoutingTrace(torch, model) as tr:
        logits, _ = prefill(lora)
    kept, routed = tr.kept()
    cap = model.model.unit_blocks[0][1].ffn.capacity(tokens)
    log(f"{label}prefill drops: {kept} of {routed} (token, choice) rows "
        f"kept over {model.cfg.n_layers} layers ({routed - kept} dropped, "
        f"{(routed - kept) / routed:.4%}; capacity {cap} rows an expert at "
        f"B*S = {tokens})")
    return tr, logits, kept, routed


def launches_per_forward(cfg) -> int:
    """Kernel-9 launches a forward of a one-block-a-layer model: two
    factors a LoRA site, every site word-aligned at rank 16."""
    return 2 * len(cfg.lora_targets()) * cfg.n_layers


def round_kernels_at(torch, dev, server, round_data):
    """Kernels 1–3 at the serve round's d, against their plain versions
    bitwise and timed by device function: the round re-run through the
    kernels and through the plain versions (τ̂, α_num, S, task vectors
    and downlink bits and λ equal); kernel 1 on the downlink's slots, kernel 2
    on the round's dense inputs, kernel 3 on the task vectors' sign
    planes.  Returns {kernel name: its numbers at this d}."""
    from repro_torch.kernels import bitpack, fused_unify, masked_agg, ops
    uni, words, lams, tasks, valid, sizes, ks = round_data
    d = uni.shape[1]
    packed = _pack(torch, dev, server, round_data)
    # the kernel round's outputs wait on the host while the plain round,
    # whose fp32 unify takes several (N, K, d) temporaries, runs
    fields = ("tau_hats", "alpha_num", "n_held", "similarity",
              "task_vectors", "down_masks", "down_unified", "down_lams")
    out_k = server.engine.run_packed(packed)
    tvs = out_k.task_vectors
    got = {f: getattr(out_k, f).cpu() for f in fields}
    del out_k
    out_p = server.engine.run_packed(packed, mode="ref")
    want = {f: getattr(out_p, f).cpu() for f in fields}
    del out_p
    for f in fields[:5]:
        check_equal(torch, f"round at d={d} {f}", got[f], want[f])
    on_host = valid.cpu()
    check_equal(torch, f"round at d={d} downlink words",
                got["down_masks"][on_host], want["down_masks"][on_host])
    check_equal(torch, f"round at d={d} downlink lambda",
                got["down_lams"][on_host], want["down_lams"][on_host])
    check_equal(torch, f"round at d={d} downlink bf16 bits",
                bf16_bits(torch, got["down_unified"]),
                bf16_bits(torch, want["down_unified"]))
    del got, want
    out = {}
    n_tasks = server.cfg.n_tasks
    slots = tvs[torch.clamp(tasks.long(), max=n_tasks - 1)]
    got = fused_unify.fused_unify_packed_cuda(slots, valid)
    want = fused_unify.plain(slots, valid)
    torch.cuda.synchronize()
    for i, name in enumerate(("unified", "words", "num", "den")):
        a, b = got[i], want[i]
        if a.dtype == torch.bfloat16:
            a, b = bf16_bits(torch, a), bf16_bits(torch, b)
        check_equal(torch, f"fused_unify_packed at d={d} {name}", a, b)
    out["fused_unify_packed"] = dict(
        ms=time_ms(torch, lambda: fused_unify.fused_unify_packed_cuda(
            slots, valid)),
        device_ms=device_ms(torch, "fused_unify",
                            lambda: fused_unify.fused_unify_packed_cuda(
                                slots, valid))[0])
    del slots, got, want
    words_d, lams_d, member_d, sizes_d = ops.slots_to_dense_packed(
        words, lams, sizes, valid, tasks, n_tasks)
    gam = sizes_d * member_d.float()
    gam = gam / torch.clamp(gam.sum(0, keepdim=True), min=1e-12)
    args = (uni, words_d, lams_d, gam, member_d, d, 0.4)
    got = masked_agg.masked_agg_batched_packed_cuda(*args)
    want = masked_agg.plain(*args)
    torch.cuda.synchronize()
    check_equal(torch, f"masked_agg_batched_packed at d={d} tau_hat",
                got[0], want[0])
    check_equal(torch, f"masked_agg_batched_packed at d={d} alpha_num",
                got[1], want[1])
    out["masked_agg_batched_packed"] = dict(
        ms=time_ms(torch, lambda: masked_agg.masked_agg_batched_packed_cuda(
            *args)),
        device_ms=device_ms(torch, "masked_agg",
                            lambda: masked_agg.masked_agg_batched_packed_cuda(
                                *args))[0])
    del got, want, args
    row = sign_sim_packed_check(torch, *bitpack.sign_planes(tvs), tvs)
    out["sign_sim_packed"] = {k: row[k] for k in ("ms", "device_ms",
                                                  "plain_ms", "bound_ms")}
    log(f"round at d={d}: kernels vs plain versions identical (tau_hat, "
        f"alpha_num, S, task vectors, downlink bits and lambda); kernel 1 "
        f"{out['fused_unify_packed']['ms']:.4f} ms (device "
        f"{out['fused_unify_packed']['device_ms']:.4f}), kernel 2 "
        f"{out['masked_agg_batched_packed']['ms']:.4f} ms (device "
        f"{out['masked_agg_batched_packed']['device_ms']:.4f}), kernel 3 "
        f"{row['ms']:.4f} ms (device {row['device_ms']:.4f})")
    del packed, tvs
    torch.cuda.empty_cache()
    return out


def layer_split(torch, model, params, lora, prompts, reps: int = 3):
    """Host wall of layer 0's prefill, median of ``reps``, split into the
    attention half (norm, mixer, residual) and the FFN half (norm, MoE,
    residual), each ending in a synchronise."""
    lm = model.model
    b, s = prompts.shape
    cache = model.init_cache(b, s + 8)
    x = lm._embed_in(params, prompts)
    positions = lm._default_positions(b, s)
    _, blk, p, l, c = next(lm._layers(params, lora, cache))[0]
    attn, ffn = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _ = blk.mixer.prefill(p["mixer"], blk.norm1(p["norm1"], x), c,
                                 positions=positions, lora=l.get("mixer"))
        y = x + h
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        blk._ffn_apply(p, y, l, None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        attn.append(1e3 * (t1 - t0))
        ffn.append(1e3 * (t2 - t1))
    return statistics.median(attn), statistics.median(ffn)


def granite_phase(torch, dev, cfg=None):
    """Multi-tenant serving of granite-moe-3b-a800m at full width (see
    the module docstring).  Returns a dict of its numbers: launches by
    kernel, walls, memory, drops and kernels 1–3 at the round's d."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels.modulated_matmul import DECODE_MAX_S

    full = cfg is None
    cfg = cfg or load_arch(GRANITE_ARCH)
    per = serve_kernel_checks(torch, dev, [
        (kn, (1, DECODE_MAX_S, GRANITE_PROMPT), True)
        for kn in GRANITE_LAYER_MIX])
    mm_dec = mm_row(per, 1, GRANITE_LAYER_MIX)
    mm_pre = mm_row(per, GRANITE_PROMPT, GRANITE_LAYER_MIX)
    log(f"modulated_matmul per granite layer (4 launches, bf16 tau): decode "
        f"(S=1) {mm_dec['ms']:.4f} ms of calls (device "
        f"{mm_dec['device_ms']:.4f} ms), plain {mm_dec['plain_ms']:.4f} ms, "
        f"bound {mm_dec['bound_ms']:.5f} ms; prefill (S={GRANITE_PROMPT}) "
        f"{mm_pre['ms']:.4f} ms (device {mm_pre['device_ms']:.4f} ms), plain "
        f"{mm_pre['plain_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
    b, s, new = GRANITE_B, GRANITE_PROMPT, GRANITE_NEW
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 12,
        (GRANITE_D, GRANITE_FINGERPRINT) if full else None,
        shape=f", {cfg.n_layers} layers of {cfg.n_experts} experts (top-"
        f"{cfg.top_k}, capacity factor {cfg.moe_capacity_factor})")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    batch = {"tokens": prompts}
    gen = decoder_generate(prompts, ids, new)
    per_fwd = launches_per_forward(cfg)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, round_ms = round_to_store(
        torch, dev, "granite ", space, lora0)
    out, launches, gen_ms, peak = counted_generate(
        torch, "granite ", cfg, prompts, ids,
        lambda: gen(model, params, store),
        {"modulated_matmul": per_fwd * new, "mlstm_chunkwise": 0}, new)
    at_d = round_kernels_at(torch, dev, server, round_data)
    del round_data

    # -- step times, the layer split, drops, profiled windows ---------------
    prefill = served_prefill(model, params, batch, new)
    lora, _, cache, tok, pre_ms, step_ms = step_walls(
        torch, "granite ", model, params, store, ids, prefill, s)
    del cache
    attn_ms, moe_ms = layer_split(torch, model, params, lora, prompts)
    log(f"granite layer 0's prefill: attention {attn_ms:.3f} ms, MoE "
        f"{moe_ms:.3f} ms (median of 3; x {cfg.n_layers} layers)")
    tr_k, logits_k, kept, routed = traced_prefill(
        torch, "granite ", model, prefill, lora, b * s)
    pre_wall, pre_busy, _ = profile_window(torch, "granite prefill",
                                           lambda: prefill(lora))
    dec_wall, dec_busy = decode_window(torch, "granite ", model, params,
                                       lora, tok, prefill(lora)[1], s,
                                       per_fwd)

    # -- the same routed tree through the plain versions --------------------
    with RoutingTrace(torch, model) as tr_p:
        logits_p, _ = prefill(lora, mode="ref")
    flip = routing_diff(torch, tr_k, tr_p, cfg.n_layers)
    log("granite bf16 prefill routing, kernels vs plain versions: "
        + (flip_text(flip) if flip else "identical in every layer"))
    rel = bf16_gate(torch, "granite ", logits_k, logits_p, BF16_LOGIT_REL_L2,
                    flip)
    token_agreements(torch, "granite ", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k, logits_p
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               batch, gen, new, SEED + 7, label="granite ")
    del server
    torch.cuda.empty_cache()
    return dict(launches=launches, generate_ms=gen_ms,
                tokens_per_s=b * new / gen_ms * 1e3, peak_gib=peak,
                round_ms=round_ms, prefill_ms=pre_ms,
                decode_step_ms=statistics.median(step_ms),
                layer0_attention_ms=attn_ms, layer0_moe_ms=moe_ms,
                prefill_kept=kept, prefill_routed=routed,
                prefill_busy_ms=pre_busy, prefill_wall_ms=pre_wall,
                decode4_busy_ms=dec_busy, decode4_wall_ms=dec_wall,
                bf16_rel_l2=rel, at_d=at_d,
                modulated_matmul_layer={"decode": mm_dec, "prefill": mm_pre})


# -- whisper phase: multi-tenant whisper-large-v3 at full width -------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_D = 14_418_176         # its LoRA task-vector size at rank 16
WHISPER_FINGERPRINT = "a2829b09233f62cc"
WHISPER_B, WHISPER_PROMPT, WHISPER_NEW = 8, 4, 32
# a layer's kernel-9 launches: an encoder layer's attn/wq and attn/wo
# a-factors (1280, 16), mlp/down's (5120, 16) and three b-factors
# (16, 1280); a decoder layer's four attention a-factors (self and
# cross wq, wo), mlp/down's a and five b-factors
WHISPER_ENC_MIX = {(1280, 16): 2, (5120, 16): 1, (16, 1280): 3}
WHISPER_DEC_MIX = {(1280, 16): 4, (5120, 16): 1, (16, 1280): 5}


def encdec_launches(cfg):
    """(prefill, decode step) kernel-9 launches of an encoder-decoder
    model: two factors a LoRA site, every site word-aligned at rank 16;
    the prefill runs the encoder's sites and the decoder's, a decode
    step the decoder's alone."""
    n_enc = sum(t.startswith("encoder/") for t in cfg.lora_targets())
    n_dec = sum(t.startswith("decoder/") for t in cfg.lora_targets())
    return 2 * (n_enc + n_dec) * cfg.n_layers, 2 * n_dec * cfg.n_layers


def whisper_phase(torch, dev, cfg=None):
    """Multi-tenant serving of whisper-large-v3 at full width (see the
    module docstring).  Returns a dict of its numbers: launches, walls,
    memory and kernels 1–3 at the round's d."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels.modulated_matmul import DECODE_MAX_S
    from repro_torch.serve.router import route_batch

    full = cfg is None
    cfg = cfg or load_arch(WHISPER_ARCH)
    b, s, new = WHISPER_B, WHISPER_PROMPT, WHISPER_NEW
    frames = cfg.enc_frames
    per = serve_kernel_checks(torch, dev, [
        (kn, tuple(sorted({1, s, DECODE_MAX_S, frames})), True)
        for kn in WHISPER_ENC_MIX])
    mm_enc = mm_row(per, frames, WHISPER_ENC_MIX)
    mm_dec = mm_row(per, 1, WHISPER_DEC_MIX)
    mm_dpre = mm_row(per, s, WHISPER_DEC_MIX)
    log(f"modulated_matmul per whisper layer (bf16 tau): encoder (6 "
        f"launches, S={frames}) {mm_enc['ms']:.4f} ms of calls (device "
        f"{mm_enc['device_ms']:.4f} ms), plain {mm_enc['plain_ms']:.4f} ms, "
        f"bound {mm_enc['bound_ms']:.5f} ms; decoder decode (10 launches, "
        f"S=1) {mm_dec['ms']:.4f} ms (device {mm_dec['device_ms']:.4f} ms), "
        f"plain {mm_dec['plain_ms']:.4f} ms, bound {mm_dec['bound_ms']:.5f} "
        f"ms; decoder prefill (S={s}) {mm_dpre['ms']:.4f} ms (device "
        f"{mm_dpre['device_ms']:.4f} ms), plain {mm_dpre['plain_ms']:.4f} "
        f"ms, bound {mm_dpre['bound_ms']:.5f} ms")
    torch.cuda.empty_cache()
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 13,
        (WHISPER_D, WHISPER_FINGERPRINT) if full else None,
        shape=f", {cfg.n_layers} encoder + {cfg.n_layers} decoder layers, "
        f"{frames} frames")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    audio = torch.randn((b, frames, cfg.d_model), generator=g, device=dev)
    batch = {"tokens": prompts, "audio_embeds": audio}
    pre_n, dec_n = encdec_launches(cfg)

    def gen(model, params, store, fused=True, mode=None):
        return served_generate(torch, model, params,
                               route_batch(store, ids, fused=fused), batch,
                               new, mode=mode)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, round_ms = round_to_store(
        torch, dev, "whisper ", space, lora0)
    out, launches, gen_ms, peak = counted_generate(
        torch, "whisper ", cfg, prompts, ids,
        lambda: gen(model, params, store),
        {"modulated_matmul": pre_n + dec_n * (new - 1), "mlstm_chunkwise": 0},
        new, what=f"route + prefill + {new - 1} decode steps; fused, bf16, "
        f"{frames} frames")
    at_d = round_kernels_at(torch, dev, server, round_data)
    del round_data

    # -- encoder, prefill and decode-step walls, profiled windows -----------
    prefill = served_prefill(model, params, batch, new)
    lora, logits_k, cache, tok, pre_ms, step_ms = step_walls(
        torch, "whisper ", model, params, store, ids, prefill, s)
    cross_bytes = sum(x.numel() * x.element_size()
                      for x in cache["cross"].values())
    self_bytes = sum(x.numel() * x.element_size()
                     for x in cache["self"].values())
    del cache
    enc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.model.encode(params, audio, lora=lora)
        torch.cuda.synchronize()
        enc_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"whisper encoder {[round(x, 2) for x in enc_ms]} ms, so the "
        f"decoder's prefill ~{statistics.median(pre_ms) - statistics.median(enc_ms):.2f}"
        f" ms; caches: cross {cross_bytes} B, self {self_bytes} B")
    enc_wall, enc_busy, _ = profile_window(
        torch, "whisper encoder", lambda: model.model.encode(params, audio,
                                                             lora=lora))
    pre_wall, pre_busy, pre_ops = profile_window(torch, "whisper prefill",
                                                 lambda: prefill(lora))
    mm_decode_summary("whisper prefill", pre_ops, pre_n, pre_wall, pre_busy)
    dec_wall, dec_busy = decode_window(torch, "whisper ", model, params,
                                       lora, tok, prefill(lora)[1], s, dec_n)

    # -- the same routed tree through the plain versions --------------------
    rel = bf16_gate(torch, "whisper ", logits_k,
                    prefill(lora, mode="ref")[0], BF16_LOGIT_REL_L2)
    token_agreements(torch, "whisper ", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               batch, gen, new, SEED + 14, label="whisper ", root=())
    del server
    torch.cuda.empty_cache()
    return dict(launches=launches, prefill_launches=pre_n,
                decode_step_launches=dec_n, generate_ms=gen_ms,
                tokens_per_s=b * new / gen_ms * 1e3, peak_gib=peak,
                cross_cache_bytes=cross_bytes, round_ms=round_ms,
                encoder_ms=enc_ms, prefill_ms=pre_ms,
                decode_step_ms=statistics.median(step_ms),
                encoder_busy_ms=enc_busy, encoder_wall_ms=enc_wall,
                prefill_busy_ms=pre_busy, prefill_wall_ms=pre_wall,
                decode4_busy_ms=dec_busy, decode4_wall_ms=dec_wall,
                bf16_rel_l2=rel, at_d=at_d,
                modulated_matmul_layer={"encoder": mm_enc, "decode": mm_dec,
                                        "decoder_prefill": mm_dpre})


# -- hymba phase: multi-tenant hymba-1.5b at full width ----------------------

HYMBA_ARCH = "hymba-1.5b"
HYMBA_D = 13_467_808           # its LoRA task-vector size at rank 16
HYMBA_FINGERPRINT = "4bc1bfd3518aa5c5"
# 2,040-token prompts fill 2,040 of the attention's 2,048 ring slots at
# prefill; the decode steps (positions 2,040-2,070) wrap it at 2,048
HYMBA_B, HYMBA_PROMPT, HYMBA_NEW = 8, 2040, 32
# a layer's kernel-9 launches: the a-factors (1600, 16) of attn/wq,
# attn/wo and mamba/in_proj, mamba/out_proj's (3200, 16), ffn/down's
# (5504, 16); the b-factors (16, 1600) of wq, wo, out_proj and down, and
# in_proj's (16, 6400)
HYMBA_LAYER_MIX = {(1600, 16): 3, (3200, 16): 1, (5504, 16): 1,
                   (16, 1600): 4, (16, 6400): 1}
# the last position of the decode run whose logits the second bf16 gate
# reads: three steps past the wrap
HYMBA_GATE_POS = 2050
# the fp32 fused-vs-dense check and the bf16 token agreements run on the
# first 128 tokens of the prompts: at 2,040 they took too much of the
# script's time limit once the training phases came (the bf16 gate past
# the wrap keeps the full prompts)
HYMBA_CHECK_PROMPT = 128


def keeping_caches(model, fn):
    """``fn()`` with every cache ``model.init_cache`` makes in it kept:
    returns (fn's result, [caches])."""
    caches, real = [], model.init_cache

    def keep(*a, **kw):
        caches.append(real(*a, **kw))
        return caches[-1]

    model.init_cache = keep
    try:
        return fn(), caches
    finally:
        del model.init_cache


def cache_check(torch, label, caches, last: int) -> int:
    """The one cache a generate made (``caches`` from
    :func:`keeping_caches`), written at positions 0..``last`` and never
    wrapped: every layer's ``kpos`` holds each position in its own slot
    and -1 in the rest, exactly.  Returns the cache's bytes."""
    (cache,) = caches
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in cache["blk"].values())
    kpos = cache["blk"]["kpos"]
    slots = torch.arange(kpos.shape[1], device=kpos.device)
    want = torch.where(slots <= last, slots, -1).to(torch.int32)
    check_equal(torch, f"{label}cache kpos", kpos,
                want[None].expand_as(kpos))
    log(f"{label}cache: {cache_bytes} B ({', '.join(cache['blk'])}); every "
        f"layer's kpos holds positions 0..{last} in their slots, -1 in the "
        f"rest of its {kpos.shape[1]}")
    return cache_bytes


def ring_check(torch, label, kpos, last: int) -> None:
    """Every layer's ``kpos`` (L, W) after positions 0..``last`` were
    written (last >= W - 1): slot i holds the largest position p <=
    last with p % W == i, exactly."""
    w = kpos.shape[1]
    slots = torch.arange(w, device=kpos.device)
    want = (last - (last - slots) % w).to(torch.int32)
    check_equal(torch, f"{label}ring kpos", kpos,
                want[None].expand_as(kpos))
    wrap = last - w + 1
    log(f"{label}ring after the generate: every layer's kpos exactly slots "
        f"[0..{wrap - 1}] -> {w}..{last}, [{wrap}..{w - 1}] -> "
        f"{wrap}..{w - 1} (window {w}, positions 0..{last} written)")


def hybrid_branch_walls(torch, model, params, lora, prompts, reps: int = 3):
    """Host wall of layer 0's prefill branches, median of ``reps``, each
    from a fresh one-layer cache and ending in a synchronise: the
    attention's ``prefill`` and the Mamba branch's ``forward``.  Returns
    (attention ms, Mamba ms, a function that runs the Mamba branch)."""
    lm = model.model
    b, s = prompts.shape
    x = lm._embed_in(params, prompts)
    positions = lm._default_positions(b, s)
    _, blk, p, l, _ = next(lm._layers(params, lora))[0]
    mix, pm, lr = blk.mixer, p["mixer"], l["mixer"]
    xn = blk.norm1(p["norm1"], x)
    attn, mamba = [], []
    for _ in range(reps):
        c = mix.init_cache(b, s + 8, device=x.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mix.attn.prefill(pm["attn"], xn, c["attn"], positions=positions,
                         lora=lr["attn"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mix.mamba.forward(pm["mamba"], xn, lora=lr["mamba"],
                          state=c["mamba"])
        torch.cuda.synchronize()
        attn.append(1e3 * (t1 - t0))
        mamba.append(1e3 * (time.perf_counter() - t1))
        del c
    return (statistics.median(attn), statistics.median(mamba),
            lambda: mix.mamba.forward(pm["mamba"], xn, lora=lr["mamba"]))


def forced_decode(model, params, lora, prefill, tokens, s, last,
                  mode=None):
    """Prefill, then decode steps at positions s..``last`` fed the given
    tokens (B, >= last - s + 1; teacher forcing, so two routes read the
    same inputs).  Returns the last step's logits."""
    _, cache = prefill(lora, mode=mode)
    for pos in range(s, last + 1):
        logits, cache = model.decode_fn(
            params, lora, {"tokens": tokens[:, pos - s:pos - s + 1]}, cache,
            pos, mode=mode)
    return logits


def hymba_phase(torch, dev, cfg=None):
    """Multi-tenant serving of hymba-1.5b at full width (see the module
    docstring).  Returns a dict of its numbers: launches, walls, memory,
    the ring check and kernels 1–3 at the round's d."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch

    full = cfg is None
    cfg = cfg or load_arch(HYMBA_ARCH)
    b, s, new = HYMBA_B, HYMBA_PROMPT, HYMBA_NEW
    per = serve_kernel_checks(torch, dev, [(kn, (1, s), True)
                                           for kn in HYMBA_LAYER_MIX])
    mm_dec = mm_row(per, 1, HYMBA_LAYER_MIX)
    mm_pre = mm_row(per, s, HYMBA_LAYER_MIX)
    log(f"modulated_matmul per hymba layer (10 launches, bf16 tau): decode "
        f"(S=1) {mm_dec['ms']:.4f} ms of calls (device "
        f"{mm_dec['device_ms']:.4f} ms), plain {mm_dec['plain_ms']:.4f} ms, "
        f"bound {mm_dec['bound_ms']:.5f} ms; prefill (S={s}) "
        f"{mm_pre['ms']:.4f} ms (device {mm_pre['device_ms']:.4f} ms), plain "
        f"{mm_pre['plain_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
    torch.cuda.empty_cache()
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 15,
        (HYMBA_D, HYMBA_FINGERPRINT) if full else None,
        shape=f", {cfg.n_layers} layers of attention (window "
        f"{cfg.hybrid_window}) ‖ Mamba (d_state {cfg.ssm_state})")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    batch = {"tokens": prompts}
    gen = decoder_generate(prompts, ids, new)
    per_fwd = launches_per_forward(cfg)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, round_ms = round_to_store(
        torch, dev, "hymba ", space, lora0)
    (out, launches, gen_ms, peak), caches = keeping_caches(
        model, lambda: counted_generate(
            torch, "hymba ", cfg, prompts, ids,
            lambda: gen(model, params, store),
            {"modulated_matmul": per_fwd * new, "mlstm_chunkwise": 0}, new))
    (cache,) = caches
    cache_bytes = sum(x.numel() * x.element_size()
                      for br in cache["blk"].values() for x in br.values())
    ring_check(torch, "hymba ", cache["blk"]["attn"]["kpos"], s + new - 2)
    if not all(bool(torch.isfinite(x).all())
               for x in cache["blk"]["mamba"].values()):
        raise AssertionError("hymba Mamba cache not finite after the "
                             "generate")
    log(f"hymba cache: {cache_bytes} B (attention ring and Mamba states)")
    del cache, caches
    at_d = round_kernels_at(torch, dev, server, round_data)
    del round_data

    # -- step times, layer 0's branches, profiled windows -------------------
    prefill = served_prefill(model, params, batch, new)
    lora, logits_k, cache, tok, pre_ms, step_ms = step_walls(
        torch, "hymba ", model, params, store, ids, prefill, s)
    del cache
    attn_ms, mamba_ms, mamba_fn = hybrid_branch_walls(torch, model, params,
                                                      lora, prompts)
    log(f"hymba layer 0's prefill (S={s}): attention branch {attn_ms:.3f} "
        f"ms, Mamba branch {mamba_ms:.3f} ms (median of 3; x {cfg.n_layers}"
        f" layers)")
    mb_wall, mb_busy, _ = profile_window(
        torch, "hymba layer 0 Mamba branch prefill", mamba_fn)
    del mamba_fn
    dec_wall, dec_busy = decode_window(torch, "hymba ", model, params, lora,
                                       tok, prefill(lora)[1], s, per_fwd)

    # -- the same routed tree through the plain versions --------------------
    rel = bf16_gate(torch, "hymba ", logits_k, prefill(lora, mode="ref")[0],
                    BF16_LOGIT_REL_L2)
    fed = out[:, s:]
    rel_wrap = bf16_gate(
        torch, "hymba ", *(forced_decode(model, params, lora, prefill, fed,
                                         s, HYMBA_GATE_POS, mode=m)
                           for m in (None, "ref")),
        BF16_LOGIT_REL_L2,
        what=f"decode-step (position {HYMBA_GATE_POS}, past the wrap)")
    s_chk = min(HYMBA_CHECK_PROMPT, s)
    gen_chk = decoder_generate(prompts[:, :s_chk].contiguous(), ids, new)
    token_agreements(torch, f"hymba ({s_chk}-token prompts) ", gen_chk,
                     model, params, store, gen_chk(model, params, store),
                     s_chk)
    del model, params, lora0, store, lora, logits_k
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               {"tokens": prompts[:, :s_chk].contiguous()}, gen_chk, new,
               SEED + 16, label=f"hymba ({s_chk}-token prompts) ")
    del server
    torch.cuda.empty_cache()
    return dict(launches=launches, generate_ms=gen_ms,
                tokens_per_s=b * new / gen_ms * 1e3, peak_gib=peak,
                cache_bytes=cache_bytes, round_ms=round_ms,
                prefill_ms=pre_ms, decode_step_ms=statistics.median(step_ms),
                layer0_attention_ms=attn_ms, layer0_mamba_ms=mamba_ms,
                layer0_mamba_busy_ms=mb_busy, layer0_mamba_wall_ms=mb_wall,
                decode4_busy_ms=dec_busy, decode4_wall_ms=dec_wall,
                bf16_rel_l2=rel, bf16_rel_l2_past_wrap=rel_wrap, at_d=at_d,
                modulated_matmul_layer={"decode": mm_dec, "prefill": mm_pre})


# -- vlm phase: multi-tenant qwen2-vl-7b at full width ------------------------

VLM_ARCH = "qwen2-vl-7b"
VLM_D = 16_515_156             # its LoRA task-vector size at rank 16
VLM_FINGERPRINT = "5ecc74948787cc41"
# 8 requests, each an image of VLM_GRID patches (1,024 = the config's
# vision_tokens) followed by 128 text tokens, and 32 new tokens
VLM_B, VLM_PROMPT, VLM_NEW = 8, 128, 32
VLM_GRID = (32, 32)
# a layer's kernel-9 launches: the a-factors (3584, 16) of mixer/wq and
# mixer/wo, ffn/down's (18944, 16), and three b-factors (16, 3584)
VLM_LAYER_MIX = {(3584, 16): 2, (18944, 16): 1, (16, 3584): 3}


def vlm_positions(torch, b, grid, n_txt, device=None):
    """Qwen2-VL's M-RoPE positions of an image followed by text, (B,
    gh·gw + n_txt, 3) int32: vision token i at (t, h, w) = (0, i // gw,
    i % gw) on the (gh, gw) patch grid, text token j at max(gh, gw) + j
    on all three coordinates."""
    gh, gw = grid
    i = torch.arange(gh * gw, device=device)
    img = torch.stack([torch.zeros_like(i), i // gw, i % gw], dim=-1)
    txt = torch.arange(max(gh, gw), max(gh, gw) + n_txt, device=device)
    pos = torch.cat([img, torch.stack([txt, txt, txt], dim=-1)])
    return pos.to(torch.int32)[None].expand(b, -1, -1)


def vlm_phase(torch, dev, cfg=None):
    """Multi-tenant serving of qwen2-vl-7b at full width (see the module
    docstring).  Returns a dict of its numbers: launches, walls, memory,
    the M-RoPE check and kernels 1–3 at the round's d."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch
    from repro_torch.nn.rope import text_mrope_positions
    from repro_torch.serve.router import route_batch

    full = cfg is None
    cfg = cfg or load_arch(VLM_ARCH)
    b, s, new = VLM_B, VLM_PROMPT, VLM_NEW
    n_img = VLM_GRID[0] * VLM_GRID[1]
    if n_img != cfg.vision_tokens:
        raise AssertionError(f"a {VLM_GRID} grid is {n_img} patches, the "
                             f"config {cfg.vision_tokens}")
    n = n_img + s
    per = serve_kernel_checks(torch, dev, [(kn, (1, n), True)
                                           for kn in VLM_LAYER_MIX])
    mm_dec = mm_row(per, 1, VLM_LAYER_MIX)
    mm_pre = mm_row(per, n, VLM_LAYER_MIX)
    log(f"modulated_matmul per vlm layer (6 launches, bf16 tau): decode "
        f"(S=1) {mm_dec['ms']:.4f} ms of calls (device "
        f"{mm_dec['device_ms']:.4f} ms), plain {mm_dec['plain_ms']:.4f} ms, "
        f"bound {mm_dec['bound_ms']:.5f} ms; prefill (S={n}) "
        f"{mm_pre['ms']:.4f} ms (device {mm_pre['device_ms']:.4f} ms), plain "
        f"{mm_pre['plain_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
    torch.cuda.empty_cache()
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 17, (VLM_D, VLM_FINGERPRINT) if full else None,
        shape=f", {cfg.n_layers} layers, M-RoPE sections "
        f"{cfg.mrope_sections}, {n_img} vision tokens")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    images = (0.02 * torch.randn((b, n_img, cfg.d_model), generator=g,
                                 device=dev)).to(torch.bfloat16)
    positions = vlm_positions(torch, b, VLM_GRID, s, dev)
    batch = {"tokens": prompts, "extra_embeds": images,
             "positions": positions}
    per_fwd = launches_per_forward(cfg)

    def gen(model, params, store, fused=True, mode=None):
        return served_generate(torch, model, params,
                               route_batch(store, ids, fused=fused), batch,
                               new, mode=mode)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, round_ms = round_to_store(
        torch, dev, "vlm ", space, lora0)
    (out, launches, gen_ms, peak), caches = keeping_caches(
        model, lambda: counted_generate(
            torch, "vlm ", cfg, prompts, ids,
            lambda: gen(model, params, store),
            {"modulated_matmul": per_fwd * new, "mlstm_chunkwise": 0}, new,
            what=f"route + prefill + {new - 1} decode steps; fused, bf16, "
            f"{n_img} vision + {s} text tokens"))
    cache_bytes = cache_check(torch, "vlm ", caches, n + new - 2)
    del caches

    # -- step times, profiled windows ----------------------------------------
    prefill = served_prefill(model, params, batch, new)
    lora, logits_k, cache, tok, pre_ms, step_ms = step_walls(
        torch, "vlm ", model, params, store, ids, prefill, n)
    del cache
    pre_wall, pre_busy, pre_ops = profile_window(torch, "vlm prefill",
                                                 lambda: prefill(lora))
    mm_decode_summary("vlm prefill", pre_ops, per_fwd, pre_wall, pre_busy)
    dec_wall, dec_busy = decode_window(torch, "vlm ", model, params, lora,
                                       tok, prefill(lora)[1], n, per_fwd)

    # -- M-RoPE is live: the image's grid positions against text positions --
    flat = text_mrope_positions(
        torch.arange(n, device=dev, dtype=torch.int32)[None].expand(b, n))
    logits_flat = served_prefill(model, params, dict(batch, positions=flat),
                                 new)(lora)[0]
    rel_m = _rel_l2(torch, logits_flat, logits_k)
    same_top = float((logits_flat.argmax(-1) == logits_k.argmax(-1))
                     .float().mean())
    log(f"vlm M-RoPE: prefill logits at the grid positions against the "
        f"same prompts at text positions 0..{n - 1}: rel L2 {rel_m:.3e}, "
        f"top-1 agreement {same_top:.3f}")
    if torch.equal(logits_flat, logits_k):
        raise AssertionError("vlm prefill logits do not depend on the "
                             "image's M-RoPE grid positions")
    del logits_flat

    # -- the same routed tree through the plain versions --------------------
    rel = bf16_gate(torch, "vlm ", logits_k, prefill(lora, mode="ref")[0],
                    BF16_LOGIT_REL_L2)
    token_agreements(torch, "vlm ", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k, prefill
    torch.cuda.empty_cache()
    # the round re-run through the plain versions at this d needs the
    # card's memory without the 14 GiB model beside it
    at_d = round_kernels_at(torch, dev, server, round_data)
    del round_data

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               batch, gen, new, SEED + 18, label="vlm ")
    del server
    torch.cuda.empty_cache()
    return dict(launches=launches, generate_ms=gen_ms,
                tokens_per_s=b * new / gen_ms * 1e3, peak_gib=peak,
                cache_bytes=cache_bytes, round_ms=round_ms,
                prefill_ms=pre_ms, decode_step_ms=statistics.median(step_ms),
                prefill_busy_ms=pre_busy, prefill_wall_ms=pre_wall,
                decode4_busy_ms=dec_busy, decode4_wall_ms=dec_wall,
                mrope_rel_l2=rel_m, bf16_rel_l2=rel, at_d=at_d,
                modulated_matmul_layer={"decode": mm_dec, "prefill": mm_pre})


# -- deepseek phase: multi-tenant deepseek-v2-236b at full width ------------

DS_ARCH = "deepseek-v2-236b"
# the published widths, cut in depth to 2 of its 60 layers: 8,992,814,080
# parameters, 16.75 GiB in bf16 (all 60 would be 445.9 GiB)
DS_LAYERS = 2
DS_D = 1_163_270               # its LoRA task-vector size at rank 16, 2 layers
DS_FINGERPRINT = "aa8b21849ef6989e"
# 640-token prompts: one full 512-row query chunk at prefill and one
# padded by 384 rows
DS_B, DS_PROMPT, DS_NEW = 8, 640, 32
# a layer's kernel-9 launches: the a-factors of mixer/wq_a (5120, 16),
# mixer/wo (16384, 16) and ffn/shared/down (3072, 16); the b-factors of
# wq_a (16, 1536) and of wo and shared/down (16, 5120)
DS_LAYER_MIX = {(5120, 16): 1, (16384, 16): 1, (3072, 16): 1,
                (16, 1536): 1, (16, 5120): 2}
# fp32, layer 0's MLA alone: one absorbed decode step against the naive
# call at that row, ||y_abs - y_naive|| / ||y_naive|| at most this (the
# two forms sum their products in other orders; on the CPU the reduced
# deepseek's decode logits differ from the forward's by ~1e-6 of scale)
DS_MLA_REL_L2 = 1e-4


def mla_decode_check(torch, label, model, params, lora, prompts,
                     bound=None):
    """Layer 0's ``MLAttention`` alone, on the normed embeddings of
    ``prompts`` (B, S) with the routed ``lora``: a prefill of positions
    0..S-2 into a fresh latent cache, then one absorbed decode step at
    S-1, against the naive call over all S at row S-1.  Returns the rel
    L2; raises beyond ``bound`` if one is given."""
    lm = model.model
    b, s = prompts.shape
    _, blk, p, l, _ = next(lm._layers(params, lora))[0]
    mla, pm, lr = blk.mixer, p["mixer"], l.get("mixer")
    x = blk.norm1(p["norm1"], lm._embed_in(params, prompts))
    naive = mla(pm, x, lora=lr)[:, -1]
    cache = mla.init_cache(b, s, device=x.device)
    mla.prefill(pm, x[:, :-1], cache, lora=lr)
    absorbed = mla.decode_step(pm, x[:, -1:], cache, s - 1, lora=lr)[0][:, 0]
    rel = _rel_l2(torch, absorbed, naive)
    log(f"{label}MLA layer 0 ({x.dtype}), absorbed decode at position "
        f"{s - 1} after a {s - 1}-token prefill against the naive call: rel "
        f"L2 {rel:.3e}, max|err| {max_abs(torch, absorbed, naive)}"
        + (f" (bound {bound})" if bound is not None else " (printed)"))
    if not torch.isfinite(absorbed).all():
        raise AssertionError(f"{label}MLA absorbed decode not finite")
    if bound is not None and not rel <= bound:
        raise AssertionError(f"{label}MLA absorbed decode rel L2 {rel} "
                             f"beyond {bound}")
    return rel


def deepseek_phase(torch, dev, cfg=None):
    """Multi-tenant serving of deepseek-v2-236b at full width, 2 of its 60
    layers (see the module docstring).  Returns a dict of its numbers:
    launches, walls, memory, drops, the cache, MLA's absorbed decode
    against its naive form and kernels 1–3 at the round's d."""
    from dataclasses import replace
    from repro_torch.configs.base import load_arch

    full = cfg is None
    cfg = cfg or replace(load_arch(DS_ARCH), n_layers=DS_LAYERS)
    b, s, new = DS_B, DS_PROMPT, DS_NEW
    per = serve_kernel_checks(torch, dev, [(kn, (1, s), True)
                                           for kn in DS_LAYER_MIX])
    mm_dec = mm_row(per, 1, DS_LAYER_MIX)
    mm_pre = mm_row(per, s, DS_LAYER_MIX)
    log(f"modulated_matmul per deepseek layer (6 launches, bf16 tau): "
        f"decode (S=1) {mm_dec['ms']:.4f} ms of calls (device "
        f"{mm_dec['device_ms']:.4f} ms), plain {mm_dec['plain_ms']:.4f} ms, "
        f"bound {mm_dec['bound_ms']:.5f} ms; prefill (S={s}) "
        f"{mm_pre['ms']:.4f} ms (device {mm_pre['device_ms']:.4f} ms), plain "
        f"{mm_pre['plain_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
    torch.cuda.empty_cache()
    model, g, params, lora0, space = build_served(
        torch, dev, cfg, SEED + 19,
        (DS_D, DS_FINGERPRINT) if full else None,
        shape=f", {cfg.n_layers} of 60 layers, {cfg.n_experts} experts "
        f"top-{cfg.top_k} + {cfg.n_shared_experts} shared, MLA kv_lora "
        f"{cfg.kv_lora_rank} / q_lora {cfg.q_lora_rank}")
    ids, prompts = serve_requests(torch, dev, cfg, g, b, s)
    batch = {"tokens": prompts}
    gen = decoder_generate(prompts, ids, new)
    per_fwd = launches_per_forward(cfg)

    # -- the main path: round -> serving downlink -> store -> generate ------
    server, round_data, store, round_ms = round_to_store(
        torch, dev, "deepseek ", space, lora0)
    (out, launches, gen_ms, peak), caches = keeping_caches(
        model, lambda: counted_generate(
            torch, "deepseek ", cfg, prompts, ids,
            lambda: gen(model, params, store),
            {"modulated_matmul": per_fwd * new, "mlstm_chunkwise": 0}, new))
    at_d = round_kernels_at(torch, dev, server, round_data)
    del round_data
    cache_bytes = cache_check(torch, "deepseek ", caches, s + new - 2)
    del caches

    # -- step times, the layer split, drops, profiled windows ---------------
    prefill = served_prefill(model, params, batch, new)
    lora, _, cache, tok, pre_ms, step_ms = step_walls(
        torch, "deepseek ", model, params, store, ids, prefill, s)
    del cache
    attn_ms, moe_ms = layer_split(torch, model, params, lora, prompts)
    log(f"deepseek layer 0's prefill: MLA {attn_ms:.3f} ms, MoE "
        f"{moe_ms:.3f} ms (median of 3; x {cfg.n_layers} layers)")
    tr_k, logits_k, kept, routed = traced_prefill(
        torch, "deepseek ", model, prefill, lora, b * s)
    pre_wall, pre_busy, pre_ops = profile_window(
        torch, "deepseek prefill", lambda: prefill(lora))
    mm_decode_summary("deepseek prefill", pre_ops, per_fwd, pre_wall,
                      pre_busy)
    dec_wall, dec_busy = decode_window(torch, "deepseek ", model, params,
                                       lora, tok, prefill(lora)[1], s,
                                       per_fwd)

    # -- the same routed tree through the plain versions --------------------
    with RoutingTrace(torch, model) as tr_p:
        logits_p, _ = prefill(lora, mode="ref")
    flip = routing_diff(torch, tr_k, tr_p, cfg.n_layers)
    log("deepseek bf16 prefill routing, kernels vs plain versions: "
        + (flip_text(flip) if flip else "identical in every layer"))
    rel = bf16_gate(torch, "deepseek ", logits_k, logits_p,
                    BF16_LOGIT_REL_L2, flip)
    mla_bf16 = mla_decode_check(torch, "deepseek ", model, params, lora,
                                prompts)
    token_agreements(torch, "deepseek ", gen, model, params, store, out, s)
    del model, params, lora0, store, lora, logits_k, logits_p, prefill
    torch.cuda.empty_cache()

    def mla_fp32(model, params, store):
        from repro_torch.serve.router import route_batch
        return mla_decode_check(torch, "deepseek fp32 ", model, params,
                                route_batch(store, ids, fused=True), prompts,
                                DS_MLA_REL_L2)

    mla_fp32_rel = fp32_check(torch, dev, replace(cfg, dtype=torch.float32),
                              server, ids, batch, gen, new, SEED + 20,
                              label="deepseek ", then=mla_fp32)
    del server
    torch.cuda.empty_cache()
    return dict(launches=launches, generate_ms=gen_ms,
                tokens_per_s=b * new / gen_ms * 1e3, peak_gib=peak,
                cache_bytes=cache_bytes, round_ms=round_ms,
                prefill_ms=pre_ms, decode_step_ms=statistics.median(step_ms),
                layer0_mla_ms=attn_ms, layer0_moe_ms=moe_ms,
                prefill_kept=kept, prefill_routed=routed,
                prefill_busy_ms=pre_busy, prefill_wall_ms=pre_wall,
                decode4_busy_ms=dec_busy, decode4_wall_ms=dec_wall,
                bf16_rel_l2=rel, mla_bf16_rel_l2=mla_bf16,
                mla_fp32_rel_l2=mla_fp32_rel, at_d=at_d,
                modulated_matmul_layer={"decode": mm_dec, "prefill": mm_pre})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    setup(torch)
    if sys.argv[1:] == ["--only", "round"]:
        # kernels 1-3 at the full-width round and the whole-round gates
        # alone: a quick loop for a round-kernel change; no summary, no
        # "ok" line
        log("== kernel phase alone ==")
        rows = kernel_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(rows), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "bool"]:
        # the bool/fp32 layout's kernels and its round alone: a quick
        # loop for a change to kernels 4-7; no summary, no "ok" line
        log("== bool phase alone ==")
        rows, counts = bool_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"rows": rows, "launches": counts}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "devtime"]:
        # kernels 3-8 timed alone, fills and conversions apart (runs on
        # an earlier checkout too); no summary, no "ok" line
        log("== kernels 3-8 alone ==")
        out = devtime_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "mlstm"]:
        # kernel 10's checks and timings alone: a quick loop for a
        # kernel-10 change; no summary, no "ok" line
        from repro_torch.configs.base import load_arch
        log("== kernel 10 alone ==")
        row = mlstm_kernel_checks(torch, dev, load_arch(XLSTM_ARCH))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"mlstm_chunkwise": row}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "granite"]:
        # the granite phase alone: a quick loop for the MoE family's
        # serving path; no summary, no "ok" line
        log("== granite phase alone ==")
        out = granite_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "whisper"]:
        # the whisper phase alone: a quick loop for the audio family's
        # serving path; no summary, no "ok" line
        log("== whisper phase alone ==")
        out = whisper_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "hymba"]:
        # the hymba phase alone: a quick loop for the hybrid family's
        # serving path; no summary, no "ok" line
        log("== hymba phase alone ==")
        out = hymba_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "vlm"]:
        # the vlm phase alone: a quick loop for the vlm family's serving
        # path; no summary, no "ok" line
        log("== vlm phase alone ==")
        out = vlm_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "deepseek"]:
        # the deepseek phase alone: a quick loop for MLA's serving path; no
        # summary, no "ok" line
        log("== deepseek phase alone ==")
        out = deepseek_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "vit"]:
        # the vit phase alone: a quick loop for the federated training
        # path; no summary, no "ok" line
        log("== vit phase alone ==")
        out = vit_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "baselines"]:
        # the baselines phase alone: a quick loop for the strategies and
        # the coded wire; no summary, no "ok" line
        log("== baselines phase alone ==")
        out = baselines_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "lmtrain"]:
        # the lmtrain phase alone: a quick loop for the LM training path;
        # no summary, no "ok" line
        log("== lmtrain phase alone ==")
        out = lmtrain_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; takes none, "
              f"--only round, --only bool, --only devtime, --only mlstm, "
              f"--only granite, --only whisper, --only hymba, --only vlm, "
              f"--only deepseek, --only vit, --only baselines or --only "
              f"lmtrain",
              file=sys.stderr)
        return 2
    def phase(name):
        log(f"== {name} phase == (at {time.perf_counter() - t_start:.1f} s)")

    phase("kernel")
    rows = kernel_phase(torch, dev)
    phase("round")
    round_counts = round_phase(torch, dev)
    phase("bool")
    bool_rows, bool_counts = bool_phase(torch, dev)
    phase("app")
    app_counts = app_phase(torch, dev)
    phase("serve")
    serve_rows, serve_counts = serve_phase(torch, dev)
    phase("vit")
    vit = vit_phase(torch, dev)
    phase("baselines")
    base = baselines_phase(torch, dev)
    phase("lmtrain")
    lmtrain = lmtrain_phase(torch, dev)
    # granite before xlstm: after the xlstm phase's profiled prefill
    # (~322,000 device kernels in one window) the profiler returned no
    # device event for granite's kernel-9 windows, six in a row
    phase("granite")
    granite = granite_phase(torch, dev)
    phase("whisper")
    whisper = whisper_phase(torch, dev)
    phase("hymba")
    hymba = hymba_phase(torch, dev)
    phase("vlm")
    vlm = vlm_phase(torch, dev)
    phase("deepseek")
    deepseek = deepseek_phase(torch, dev)
    phase("xlstm")
    xlstm_row, xlstm_counts, sim_wide = xlstm_phase(torch, dev)
    rows["sign_sim_packed"]["at_xlstm_round_d"] = {
        k: sim_wide[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "library_ms", "first_design_ms",
                                 "first_design_device_ms")}
    serve_rows["mlstm_chunkwise"] = xlstm_row
    serve_counts["mlstm_chunkwise"] = xlstm_counts["mlstm_chunkwise"]
    for name, at_d in vit.pop("at_d").items():
        rows[name]["at_vit_round_d"] = dict(
            at_d, vit_launches=vit["launches"][name],
            lmtrain_launches=lmtrain["launches"][name],
            baselines_launches=base["launches"][name])
    for name, at_d in base.pop("at_d").items():
        rows[name]["at_baselines_round_d"] = at_d
    for name, at_d in granite.pop("at_d").items():
        rows[name]["at_granite_round_d"] = at_d
    for name, at_d in whisper.pop("at_d").items():
        rows[name]["at_whisper_round_d"] = at_d
    for name, at_d in hymba.pop("at_d").items():
        rows[name]["at_hymba_round_d"] = at_d
    for name, at_d in vlm.pop("at_d").items():
        rows[name]["at_vlm_round_d"] = at_d
    for name, at_d in deepseek.pop("at_d").items():
        rows[name]["at_deepseek_round_d"] = at_d
    serve_rows["modulated_matmul"]["granite"] = granite
    serve_rows["modulated_matmul"]["whisper"] = whisper
    serve_rows["modulated_matmul"]["hymba"] = hymba
    serve_rows["modulated_matmul"]["vlm"] = vlm
    serve_rows["modulated_matmul"]["deepseek"] = deepseek
    log(f"== host cost of every wrapper == (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    host = host_costs(torch, dev)
    kernels, checks = [], {}
    paths = {"unify": "ops.unify, once",
             "masked_agg": "ops.masked_agg, once (serve phase)",
             "modulated_matmul": "one full-width bf16 qwen2-0.5b generate "
                                 "(serve phase; "
                                 f"{xlstm_counts['modulated_matmul']} more in "
                                 "the xlstm generate, "
                                 f"{granite['launches']['modulated_matmul']}"
                                 " in the granite generate, "
                                 f"{whisper['launches']['modulated_matmul']}"
                                 " in the whisper generate, "
                                 f"{hymba['launches']['modulated_matmul']}"
                                 " in the hymba generate, "
                                 f"{vlm['launches']['modulated_matmul']}"
                                 " in the vlm generate, "
                                 f"{deepseek['launches']['modulated_matmul']}"
                                 " in the deepseek generate)",
             "mlstm_chunkwise": "one full-width bf16 xlstm-1.3b generate "
                                "(xlstm phase)"}
    for name, row in (list(rows.items()) + list(bool_rows.items())
                      + list(serve_rows.items())):
        checks[name] = row.pop("check")
        row["host_us"] = host[name]
        counts = (round_counts if name in rows else
                  serve_counts if name in serve_rows else bool_counts)
        kernels.append(dict(
            name=name, launches=counts[name],
            path=paths.get(name, "packed round (round phase, 3 rounds)"
                           if name in rows else
                           "bool round (bool phase, 1 round)"),
            app_launches=app_counts["matu"][name], **row))
    def fmt(x):
        return "none" if x is None else f"{x:.4f}"
    log("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} ({k['path']}; app "
        f"{k['app_launches']}) check=pass ms={fmt(k['ms'])} "
        f"device_ms={fmt(k['device_ms'])} host_us={k['host_us']:.2f} "
        f"bound_ms={fmt(k['bound_ms'])} plain_ms={fmt(k['plain_ms'])} "
        f"library_ms={fmt(k['library_ms'])} [{checks[k['name']]}]"
        for k in kernels))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
