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
5. app     — the quickstart through ``examples/quickstart_torch.py::run``
             (6 tasks in 3 groups, 9 clients, ``MLPBackbone(32,
             hidden=64, lora_rank=8)``) for 3 rounds evaluated every
             round: the individual baseline, then MaTU and FedAvg
             through ``FedSimulator``, each run's launches exact (MaTU
             kernel 1 twice a round, 2 and 3 once; FedAvg and the
             baseline none).
6. serve   — multi-tenant serving of qwen2-0.5b at full width (24 layers,
             d_model 896, vocab 151,936; random weights from a seed).
             Kernel checks: ``modulated_matmul`` at B = 8 on the three
             LoRA factor shapes (896, 16), (4864, 16), (16, 896) at S = 1,
             16 and 128, and on xlstm-1.3b's five at S = 1, 16 and 512
             (S <= 16 takes the split-K decode route; above it a b-factor
             the narrow-K kernel, an a-factor the narrow-N kernel), τ in
             fp32 and bf16, against its plain version, bitwise with x = I
             and with one-hot rows at decode and at prefill, bitwise run
             to run and B = 1 against B = 8 at S = 1 and each prefill S,
             timed with the device functions a call runs beside its plain
             version, its bound and the product alone (``torch.bmm`` on
             pre-built weights), and a misaligned
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
             ``make_local_trainer`` (2 AdamW steps at B = 32 a slot) →
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
             samples each, 2 AdamW steps at B = 32, 2 rounds for MaTU
             and 1 for each baseline; the paper's 16 clients and 40
             rounds cut for chip time): the
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
9b. examples — the two examples that run a zoo model, at full width
             (:func:`examples_phase`, no profiling):
             ``examples/fed_finetune_lm_torch.py`` ``--rounds 1
             --local-steps 2`` on codeqwen1.5-7b as published (bf16, 32
             layers, d_model 4,096, vocab 92,416; LoRA d 17,367,136
             held), its round's launches exact (kernels 1–3 once), step
             and round walls, peak memory, its checkpoint reloaded
             bitwise the server's task vectors; then
             ``examples/serve_decode_torch.py --quick`` on qwen2.5-3b in
             fp32 (36 layers, d_model 2,048; LoRA d 12,238,956 held): the
             round's launches, kernel 9 exactly 1,728 times a fused
             generate (216 a forward, 8 forwards) and never on the dense
             decoder, fused ≡ dense tokens on all three mixes, one routed
             tree across mixes, req/s and peak memory.  After each
             example, outside the count: its round re-run on its uploads
             through kernels 1–3 and through their plain versions,
             bitwise; for the serving example, kernel 9 on each of its
             LoRA factor shapes (K up to 11,008) at S = 1 and the
             prompt's 16 against its plain version, and each mix's fused
             prefill logits against the dense-routed ones at the fp32
             bar, with a changed task moving a request's logits past
             it.  ``--only examples`` runs it alone.
10. async  — async and pipelined MaTU rounds, on the baselines phase's
             setting (ViT-B/32 at full width, 8 clients × 2 of 8 tasks)
             and at the full-width round: (a) 2 rounds each of sync
             ``MaTUStrategy``, the deferred drain (``FedConfig.pipeline``)
             and ``AsyncMaTUStrategy`` under ``ClientSystems.ideal``,
             identical bit for bit (accuracies, bits a round, task
             vectors, every last upload and downlink), kernels 1–3
             launched 2 / 1 / 1 a round; (b) ``AsyncMaTUStrategy
             (code_masks=True)`` for 4 ticks of a fault trace (seed 9:
             dropouts, crashes, stragglers, one client 2 rounds late
             against a staleness cap of 1, corrupted coded streams, a
             tick every client drops): the History's fault counters equal
             the trace's replay every tick, the skipped tick 0 bits,
             launches exact a tick (none skipped, kernel 1 once when all
             are quarantined); the first tick that keeps a stale upload
             re-run card vs CPU (the baselines' merge bar; quarantine
             set, ages, streams exact) and its weighted round through
             kernels 1–3 against the plain versions bitwise, weights of
             ones bitwise none; (c) ``RoundEngine.round_stream`` over 3
             replayed full-width rounds (host uploads, pinned stages),
             pipelined against sequential bit for bit, packed raw,
             packed coded and bool (kernels 4–6); the coded uplink with
             and without the deferred drain byte for byte, and whether
             its encode starts with the round in flight.  Walls, mean
             phases, each streamed round's phases, the fault counters,
             accuracies, coded/raw shares and the implicit host syncs
             while a round is in flight (``set_sync_debug_mode("warn")``)
             are printed.
11. population — the chunked population round: (a) one full-width
             round (uploads from kernel 1) through
             ``RoundEngine.round_chunked`` at chunks of 1, 5, 8 and 64 in
             both layouts, then with staleness and with a coded downlink
             at 8: bit for bit the monolithic ``RoundEngine.round`` (task
             vectors, τ̂, alpha_num / m̂, n_held, S, every downlink, the
             wire bits) and the same chunked call with the plain
             versions, kernel 1 (packed) or 4 (bool) once a chunk and 3 or
             6 once, kernels 2 and 5 never; the wall and peak device
             memory a call beside the monolithic round's; (b)
             ``MaTUStrategy(chunk_clients=8)`` against ``MaTUStrategy()``
             on the same uploads, bitwise; (c) ``PopulationSimulator`` at
             full width (``PopulationSplit`` of 10^6 clients over 30
             tasks, 64 a round in chunks of 16, dropout 0.1, 2 rounds)
             under ``torch.profiler``: the History, host µs deriving
             uploads against device busy ms, peak memory, launches exact;
             then the same run at d = 4,096 on the card and on the CPU:
             counters and bits equal, alignment within rtol 1e-5.
12. shard  — the taskvec-sharded round on 4 gloo ranks sharing the card
             (spawned once; the ranks load the kernels setup built), at
             the round's shapes seeded alike on every rank: the packed
             round on ``make_round_mesh(4)`` and ``make_debug_mesh((2,
             2))`` (kernels 1-3 once a rank, exactly two psums — the int32
             (T, T) dots and the λ roots — and no other collective inside
             ``run_packed``; each rank's kernels bitwise their plain
             versions on its shard; rank 0 holds the whole round,
             gathered at the wire boundary, to its unsharded round:
             bitwise, λ bitwise or within rtol 1e-5 as reported),
             ``round_chunked`` (chunk 8, 2 + 1 psum a chunk) on
             ``make_population_mesh(slots=2)``, ``MaTUStrategy(mesh=)``
             from client unify to the downlinks, the bool layout at d =
             4,096 (kernels 4, 5 and 3 a shard) and a 2-round
             ``FedSimulator(mesh=)`` on ``MLPBackbone``; d_pad, launches,
             psums, bytes all-reduced and gathered, walls and peaks by
             rank.  The ranks share one card: no wall is a scaling
             figure.
12b. tp    — model-parallel LoRA training on a (data, model) mesh
             (:func:`tp_phase`): granite-moe-3b-a800m at full width cut to
             2 of 32 layers, bf16, on 4 gloo ranks sharing the card on
             ``make_debug_mesh((2, 2))`` (expert-parallel, 20 experts a
             rank): 2 AdamW steps with every leaf a DTensor on cuda:0,
             loss and step 1's LoRA gradients against the unsharded
             model on each data half (the sharded step's function),
             layer 0's routing, walls, peaks and the collectives by
             kind and bytes; the same steps in fp32, each leaf's
             step-1 gradients and its LoRA change held tight; then
             ``launch.train`` ``fed`` (kernels 1-3 counted) and
             ``lm``.  ``--only tp`` runs it alone.
13. granite — multi-tenant serving of granite-moe-3b-a800m at full width
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
14. whisper — multi-tenant serving of whisper-large-v3 at full width (32
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
15. hymba  — multi-tenant serving of hymba-1.5b at full width (32
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
16. vlm    — multi-tenant serving of qwen2-vl-7b at full width (28
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
17. deepseek — multi-tenant serving of deepseek-v2-236b at full width,
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
18. xlstm  — multi-tenant serving of xlstm-1.3b at full width (24
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
             per-block times; profiled prefill and decode windows on the
             prompts' first 32 tokens (``XLSTM_PROFILE_PROMPT``; kernel
             10's device time read from the prefill's); then, on their
             first 128 (``XLSTM_CHECK_PROMPT``), the bf16 token
             agreements (printed) and fp32, where fused and dense-routed
             decode must agree token for token.
19. summary — the host µs a call of every kernel wrapper and of the
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
for a kernel-10 change); ``--only mm`` kernel 9's checks and timings
alone at every served model's factor shapes, S = 1 and the prompt S,
with each model's prefill layer summed (a quick loop for a kernel-9
change); ``--only granite``, ``--only whisper``, ``--only
hymba``, ``--only vlm`` and ``--only deepseek`` run setup and the granite,
whisper, hymba, vlm or deepseek phase alone; ``--only vit``, ``--only
baselines``, ``--only lmtrain``, ``--only examples``, ``--only async``,
``--only population``, ``--only shard`` and ``--only tp`` the vit,
baselines, lmtrain, examples, async, population, shard or tp phase; ``--only xlstm`` the xlstm
phase (kernel 10's checks included); ``--only mix`` times Eq. 7's
product as one GEMM and in ``ref._mix``'s blocks at the round's,
whisper's and the vlm's widths, and the round phase under each
(:func:`mix_phase`).  None of them prints the summary or the "ok" line.
"""

from __future__ import annotations

import contextlib
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


def make_round_inputs(torch, dev, seed: int = SEED, d=None):
    """Full-width round inputs from a seeded generator on the card:
    (task_vectors (N, K, d) fp32 zero-padded, valid, slot_tasks,
    slot_sizes, ks); ``d`` defaults to :data:`D`."""
    d = d or D
    g = torch.Generator(device=dev).manual_seed(seed)
    ks = 3 + (torch.rand(N, generator=g, device=dev) < 0.5).long()
    valid = torch.arange(K_MAX, device=dev)[None, :] < ks[:, None]
    tv = torch.randn((N, K_MAX, d), generator=g, device=dev) \
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


# Eq. 7's product at the widths of the full-width round, whisper's round
# and the vlm's round (T 30)
MIX_WIDTHS = (("round", D), ("whisper", 14_418_176), ("vlm", 16_515_156))


def mix_phase(torch, dev):
    """Eq. 6 + 7 (``ref.cross_task_combine_ref``, T 30) with Eq. 7's
    product in two forms: one ``@`` over the whole width, as before the
    blocks, and ``ref._mix`` (:data:`ref.MIX_BLOCK`-wide blocks, so its
    bits do not depend on the width a shard holds).  At each of
    :data:`MIX_WIDTHS`, in the order one, blocks, blocks, one: device ms
    (``torch.profiler``), wall ms and the peak device bytes above the
    inputs, and whether the two forms' bits agree.  Then the round phase
    under each form, in the same order (its printed peak and profiled
    device busy).  Returns the numbers."""
    from repro_torch.kernels import ref
    blocked = ref._mix

    def one(norm_w, x):
        return norm_w @ x

    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    w = torch.rand((T, T), generator=g, device=dev)
    w = w * (w > 0.5)
    w[T - 1] = 0.0                        # a task with no cross-task mix
    res = {"widths": {}, "round": []}
    try:
        for label, d in MIX_WIDTHS:
            tau = torch.randn((T, d), generator=g, device=dev)
            m = (torch.rand((T, d), generator=g, device=dev) < 0.5).float()
            outs, rows = {}, []
            for name, fn in (("one", one), ("blocks", blocked),
                             ("blocks", blocked), ("one", one)):
                ref._mix = fn
                call = lambda: ref.cross_task_combine_ref(tau, m, w)  # noqa
                call()                                        # warm-up
                out, wall, peak = measured(torch, call)
                outs[name] = out[0]
                del out
                busy = device_busy_ms(torch, call)[1]
                rows.append(dict(form=name, device_ms=busy, wall_ms=wall,
                                 peak_bytes=peak))
                log(f"mix {label} d {d:,} {name}: device {busy:.4f} ms, "
                    f"wall {wall:.3f} ms, peak above inputs "
                    f"{peak / 2**30:.3f} GiB")
            same = bool(torch.equal(exact(torch, outs["one"]),
                                    exact(torch, outs["blocks"])))
            err = float((outs["one"] - outs["blocks"]).abs().max())
            log(f"mix {label}: the forms' task vectors bitwise {same} "
                f"(max |diff| {err:.3e})")
            res["widths"][label] = dict(d=d, runs=rows, bitwise=same,
                                        max_abs_diff=err)
            del tau, m, outs
            torch.cuda.empty_cache()
        for name, fn in (("one", one), ("blocks", blocked),
                         ("blocks", blocked), ("one", one)):
            ref._mix = fn
            log(f"== round phase, Eq. 7 as {name} ==")
            round_phase(torch, dev)
            res["round"].append(name)
    finally:
        ref._mix = blocked
    return res


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


@contextlib.contextmanager
def wrap_method(cls, method: str, after, before=lambda obj: None):
    """Within the block, every call of ``cls.method`` runs as it is,
    between ``state = before(obj)`` and ``after(obj, state)``."""
    orig = getattr(cls, method)

    def wrapped(self, *args, **kw):
        state = before(self)
        out = orig(self, *args, **kw)
        after(self, state)
        return out

    setattr(cls, method, wrapped)
    try:
        yield
    finally:
        setattr(cls, method, orig)


def counted_calls(cls, method: str, calls: list, key=lambda obj: None):
    """Within the block, every call of ``cls.method`` appends (``key(obj)``,
    the launch counts it added) to ``calls``.  The examples' entry points
    run whole, and this reads which of their calls launched what."""
    from repro_torch.kernels import ops

    def record(obj, before):
        after = ops.launch_counts()
        calls.append((key(obj), {k: after[k] - before[k] for k in after}))
    return wrap_method(cls, method, record,
                       before=lambda obj: ops.launch_counts())


def peak_after(torch, cls, method: str, peaks: list):
    """Within the block, every call of ``cls.method`` appends the peak
    device memory (GiB) up to its end to ``peaks`` and resets the peak:
    the peak read after the block is then that of what came after the
    last such call."""
    def mark(obj, _):
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
    return wrap_method(cls, method, mark)


def examples_module(name: str):
    """``examples/<name>.py`` of this checkout, imported (the examples are
    scripts; their directory goes on the path, as running one puts it)."""
    import importlib
    ex = os.path.join(ROOT, "examples")
    if ex not in sys.path:
        sys.path.insert(0, ex)
    return importlib.import_module(name)


def nonzero_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


# the quickstart's MaTU rounds: kernel 1 at both ends of the wire (the
# clients' unify and the downlinks' re-unify), kernels 2 and 3 once
APP_MATU_A_ROUND = {"fused_unify_packed": 2, "masked_agg_batched_packed": 1,
                    "sign_sim_packed": 1}


def app_phase(torch, dev):
    """The quickstart through ``examples/quickstart_torch.py::run`` (6
    tasks in 3 groups, 9 clients, ``MLPBackbone(32, hidden=64,
    lora_rank=8)``) for 3 rounds, evaluated every round: the individual
    baseline, then MaTU and FedAvg through ``FedSimulator``, each run's
    launches held exact.  Returns each run's launch counts."""
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.kernels import ops
    quickstart = examples_module("quickstart_torch")
    cfg = FedConfig(rounds=3, local_steps=25, lr=1e-2, eval_every=1, seed=0)
    ops.reset_launch_counts()
    runs = []
    t0 = time.perf_counter()
    with counted_calls(FedSimulator, "run", runs,
                       key=lambda sim: sim.strategy.name):
        res = quickstart.run(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(runs)
    total = ops.launch_counts()
    want = {"matu": {k: cfg.rounds * n for k, n in APP_MATU_A_ROUND.items()},
            "fedavg": {}}
    ind = float(sum(res["individual"].values()) / len(res["individual"]))
    log(f"app individual: mean acc {ind:.4f} (6 tasks, "
        f"{10 * cfg.local_steps} steps each)")
    for name in ("matu", "fedavg"):
        hist, _strat = res[name]
        for r, acc in zip(hist.rounds, hist.mean_acc):
            log(f"app {name} round {r}: mean acc {acc:.4f}")
        if hist.rounds != list(range(1, cfg.rounds + 1)) or \
                not all(0.0 <= a <= 1.0 for a in hist.mean_acc):
            raise AssertionError(f"app {name}: rounds {hist.rounds} or an "
                                 f"accuracy out of range {hist.mean_acc}")
        log(f"app {name}: uplink {hist.uplink_bits_per_round} bits, "
            f"launches {nonzero_counts(counts[name])}")
        if nonzero_counts(counts[name]) != want[name]:
            raise AssertionError(f"app {name}: launched "
                                 f"{nonzero_counts(counts[name])}, expected "
                                 f"{want[name]}")
    if nonzero_counts(total) != want["matu"]:
        raise AssertionError(f"app: the run launched {nonzero_counts(total)}"
                             f" in all (the individual baseline none), "
                             f"expected {want['matu']}")
    log(f"app: {wall:.2f} s for the individual baseline and {cfg.rounds} "
        f"rounds each of MaTU and FedAvg; within-group S "
        f"{res['within']:.4f}, cross-group S {res['cross']:.4f}")
    if not res["within"] > res["cross"]:
        raise AssertionError("app matu: within-group S is not above "
                             "cross-group S")
    return {name: counts[name] for name in ("matu", "fedavg")}

# -- vit phase: federated LoRA training of ViT-B/32 at full width -----------

VIT_D = 1_327_140              # ViT-B/32's LoRA task-vector size at rank 16
VIT_FINGERPRINT = "8193ac2a083e3e4f"
VIT_GROUPS, VIT_CLASSES, VIT_TASKS_PER_CLIENT = 6, 8, 3
VIT_FED = dict(rounds=2, local_steps=2, batch_size=32, local_data=128,
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
# the six baseline runs' rounds: 1, the named time cut, taken when the
# whole script passed 1,050 s (the two MaTU runs keep 2: round 2 starts
# from the coded downlink)
BASE_BASELINE_ROUNDS = 1
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


def base_setting(torch, dev, reduced: bool = False):
    """Table 2's setting on ViT-B/32 (:data:`BASE_TASKS` tasks in
    :data:`BASE_GROUPS` groups, :data:`BASE_CLIENTS` clients of
    :data:`BASE_TASKS_PER_CLIENT` tasks): the backbone, constellation and
    split, built once for the baselines and async phases.  Returns
    (backbone, constellation, split, {what: seconds})."""
    from repro_torch.fed.testbed import ViTBackbone
    bb = ViTBackbone(seed=SEED, reduced=reduced, device=dev)
    if not reduced and (bb.d, bb.fingerprint) != (VIT_D, VIT_FINGERPRINT):
        raise AssertionError(f"vit LoRA d {bb.d} / layout {bb.fingerprint} "
                             f"!= {VIT_D} / {VIT_FINGERPRINT}")
    con, split, data_s = vit_data(
        torch, dev, bb.cfg.patch_dim, n_tasks=BASE_TASKS,
        n_groups=BASE_GROUPS, n_clients=BASE_CLIENTS,
        tasks_per_client=BASE_TASKS_PER_CLIENT, conflict_pairs=BASE_CONFLICT)
    return bb, con, split, data_s


def baselines_phase(torch, dev, reduced: bool = False, setting=None):
    """The paper's baselines and MaTU's coded wire in Table 2's setting on
    ViT-B/32 at full width (8 clients × 2 tasks of 8, 2 rounds for MaTU
    and :data:`BASE_BASELINE_ROUNDS` for each baseline; the paper's 16
    clients and 40 rounds cut for chip time): eight runs
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
    baseline's round-1 merge card vs CPU.  ``setting`` is
    :func:`base_setting`'s, built here when not given.  Returns its
    numbers."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.data.synthetic import sample_task_batch
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import STRATEGIES
    from repro_torch.kernels import ops
    from repro_torch.serve.store import ModulatorStore

    t_phase = time.perf_counter()
    bb, con, split, data_s = setting or base_setting(torch, dev, reduced)
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


# -- async phase: async and pipelined MaTU rounds ----------------------------

# the baselines phase's setting, evaluated every round so that each
# round's accuracies and bits are kept
ASYNC_FED = dict(BASE_FED, eval_every=1)
# the fault run: its ticks (4, the named time cut, taken when the whole
# script passed 1,050 s after the baselines' cut), the staleness cap and
# the trace.  At this seed, over 5 ticks and over 4 the trace drops,
# crashes, straggles and corrupts, admits an uncorrupted upload of
# staleness 1 (weight 0.5 into kernel 2), and skips a tick: every client
# is forced to drop at ASYNC_SKIP_TICK and no late upload lands there.
# Client ASYNC_SLOW_CLIENT's base delay of 2 rounds outruns the cap, so
# its upload goes stale
ASYNC_TICKS = 4
ASYNC_MAX_STALENESS = 1
ASYNC_SLOW_CLIENT, ASYNC_SKIP_TICK = 3, 2
ASYNC_FAULTS = dict(dropout=0.25, straggler_frac=0.25, straggler_delay=1,
                    crash_prob=0.1, crash_rounds=2, corrupt_prob=0.25, seed=9)
# replayed rounds a configuration of the host pipeline streams (3, the
# named time cut with ASYNC_TICKS)
ASYNC_STREAM_ROUNDS = 3


def async_systems(n_clients: int):
    """The fault run's ``ClientSystems``: :data:`ASYNC_FAULTS`, client
    :data:`ASYNC_SLOW_CLIENT` 2 rounds late on every upload, every client
    dropped at :data:`ASYNC_SKIP_TICK`."""
    from repro_torch.fed.systems import ClientSystems, FaultModel
    base = [0] * n_clients
    base[ASYNC_SLOW_CLIENT] = 2
    return ClientSystems(n_clients, FaultModel(**ASYNC_FAULTS), base_delay=base,
                         forced_dropouts={(c, ASYNC_SKIP_TICK)
                                          for c in range(n_clients)})


def replay_trace(systems, rounds: int, max_staleness: int):
    """What an event-clock run at participation 1 must record, from the
    trace alone: per tick the fault counters (``quarantined`` = the
    admitted uploads whose (client, dispatch round) draw ``corrupt``) and
    the admitted (client, dispatch round, staleness)."""
    from repro_torch.fed.systems import AdmissionQueue, blank_fault_counters
    queue, ticks = AdmissionQueue(), []
    for r in range(rounds):
        c = blank_fault_counters()
        avail = [k for k in range(systems.n_clients)
                 if systems.available(k, r)]
        c["crashed"] = systems.n_clients - len(avail)
        c["sampled"] = len(avail)
        for k in avail:
            if systems.dropout(k, r):
                c["dropped"] += 1
                continue
            delay = systems.delay(k, r)
            c["stragglers"] += int(delay > 0)
            queue.push(r + delay, r, k)
        admitted = []
        for item in queue.pop_ready(r):
            s = r - item.dispatch
            if s > max_staleness:
                c["stale"] += 1
            else:
                admitted.append((item.payload, item.dispatch, s))
        c["buffered"] = len(queue)
        c["admitted"] = len(admitted)
        c["skipped"] = int(not admitted)
        c["quarantined"] = sum(int(systems.corrupt(k, q))
                               for k, q, _ in admitted)
        ticks.append((c, admitted))
    return ticks


def tick_trace(strat):
    """Wrap ``strat``'s server step (``aggregate_admitted`` where it has
    one, else ``aggregate_batch``) and ``skip_round``: per call its name,
    arguments, result and the packed-round kernels' launches in it (no
    synchronisation: launches are counted on the host).  Returns the
    list it fills, one entry a round."""
    from repro_torch.kernels import ops
    calls = []
    step = ("aggregate_admitted" if hasattr(strat, "aggregate_admitted")
            else "aggregate_batch")
    for name in (step, "skip_round"):
        def wrapped(*args, fn=getattr(strat, name), name=name):
            before = ops.launch_counts()
            ret = fn(*args)
            after = ops.launch_counts()
            calls.append(dict(name=name, args=args, ret=ret, rose={
                k: after[k] - before[k] for k in ops.PACKED_ROUND_KERNELS}))
            return ret
        setattr(strat, name, wrapped)
    return calls


class SyncProbe:
    """The implicit host syncs made while a round is in flight (from the
    entry of its dispatch to the entry of its drain), caught through
    ``torch.cuda.set_sync_debug_mode("warn")`` and named by the line that
    made them.  ``hook(dispatch_owner, dispatch, drain_owner, drain)``
    wraps the two calls that open and close a round's window."""

    def __init__(self, torch):
        self.torch = torch
        self.in_flight = 0
        self.seen = {}

    def hook(self, start_obj, start, drain_obj, drain, pending=None):
        fn_start, fn_drain = getattr(start_obj, start), getattr(drain_obj,
                                                                drain)

        def opened(*a, **k):
            self.in_flight += 1
            return fn_start(*a, **k)

        def closed(*a, **k):
            if pending is None or pending():
                self.in_flight -= 1
            return fn_drain(*a, **k)

        setattr(start_obj, start, opened)
        setattr(drain_obj, drain, closed)

    def __enter__(self):
        import warnings
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._caught
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._ctx.__exit__(*exc)

    def _caught(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchroniz" not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        if self.in_flight > 0:
            import linecache
            where = (f"{os.path.relpath(filename, ROOT)}:{lineno} "
                     f"`{linecache.getline(filename, lineno).strip()}`")
            self.seen[where] = self.seen.get(where, 0) + 1


def wire_state(torch, strat):
    """A MaTU strategy's wire after its run, as exact bit tensors: every
    client's last upload and every downlink (bf16 as int16 bits, words or
    streams, λ)."""
    bits = lambda x: (x.view(torch.int16) if x.dtype == torch.bfloat16  # noqa
                      else x)
    strat._drain()
    return ({u.client_id: [bits(u.unified), u.masks, u.lams]
             for u in strat._last_uploads},
            {c: [bits(dl.unified), dl.masks, dl.lams]
             for c, dl in strat.downlinks.items()})


def same_wire(torch, label, a, b):
    for way, x, y in (("upload", a[0], b[0]), ("downlink", a[1], b[1])):
        if x.keys() != y.keys():
            raise AssertionError(f"{label}: {way} clients {sorted(x)} vs "
                                 f"{sorted(y)}")
        for c in x:
            for what, p, q in zip(("unified", "masks", "lambda"), x[c], y[c]):
                # a sharded uplink record whose content no accounting
                # reads is a meta tensor: its dtype and shape
                if p.dtype != q.dtype or p.shape != q.shape or not (
                        q.is_meta or torch.equal(p, q.to(p.device))):
                    raise AssertionError(f"{label}: client {c}'s {way} "
                                         f"{what} differ")


def stream_rounds(torch, dev, n_rounds: int):
    """``n_rounds`` replayed rounds at the full-width round's shapes, each
    from its own seed: per client a host ``ClientUpload`` (bf16 unified,
    word rows, λ, sizes) built by kernel 1 on the card
    (:func:`round_uploads`), and the same uploads with their word rows
    Golomb-Rice coded (one batched encode a round)."""
    import numpy as np
    from repro_torch.core.client import ClientUpload
    from repro_torch.core.engine import split_streams
    from repro_torch.fed.compression import encode_mask_rows_with_sizes
    from repro_torch.kernels import bitpack
    raw, coded = [], []
    for r in range(n_rounds):
        ups = round_uploads(torch, dev, SEED + 20 + r)
        ks = [len(u.task_ids) for u in ups]
        rows = np.concatenate([bitpack.words_to_numpy(u.masks) for u in ups])
        streams = split_streams(*encode_mask_rows_with_sizes(rows, D), ks)
        raw.append(ups)
        coded.append([ClientUpload(u.client_id, u.task_ids, u.unified,
                                   streams[i], u.lams, u.data_sizes)
                      for i, u in enumerate(ups)])
    return raw, coded


def async_phase(torch, dev, reduced: bool = False, setting=None):
    """Async and pipelined MaTU rounds on the card, on the baselines
    phase's setting (:func:`base_setting`: ViT-B/32 at full width, 8
    clients × 2 of 8 tasks) and at the full-width round:

    (a) three runs of :data:`ASYNC_FED`: S = ``MaTUStrategy`` sync, P =
        the deferred drain (``FedConfig.pipeline``), A =
        ``AsyncMaTUStrategy`` under ``ClientSystems.ideal`` with the
        deferred drain; they must agree bit for bit (accuracies, bits a
        round, the task vectors, every last upload and downlink), A's
        counters clean, kernels 1–3 launched 2 / 1 / 1 a round;
    (b) ``AsyncMaTUStrategy(code_masks=True)`` under :func:`async_systems`
        for :data:`ASYNC_TICKS` ticks: the History's counters equal
        :func:`replay_trace`'s, the skipped tick 0 bits, launches exact a
        tick; the first tick admitting a stale upload re-run card vs CPU
        (vectors within the baselines' merge bar; quarantine set, ages,
        streams exact), its weighted round through kernels 1–3 against
        the plain versions bitwise and weights of ones bitwise none;
    (c) ``RoundEngine.round_stream`` over :data:`ASYNC_STREAM_ROUNDS`
        replayed full-width rounds (:func:`stream_rounds`), pipelined
        against sequential bit for bit, packed raw, packed coded and
        bool; and ``MaTUStrategy(code_masks=True)`` with and without the
        deferred drain on one full-width round: its coded uplink
        identical, and whether its encode starts with the round in
        flight.

    Reported, not gated: walls, ``History.mean_phase_us``, each streamed
    round's phases, the fault run's counters, accuracies and coded/raw
    shares, and the implicit host syncs while a round is in flight (P's
    rounds and the coded stream's, :class:`SyncProbe`).  Returns its
    numbers."""
    import dataclasses
    from repro_torch.core.engine import (EngineConfig, RoundEngine,
                                         batched_client_unify)
    from repro_torch.fed import compression
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import (AsyncMaTUStrategy, MaTUStrategy,
                                            RoundBatch, Upload)
    from repro_torch.fed.systems import ClientSystems
    from repro_torch.kernels import bitpack, ops

    t_phase = time.perf_counter()
    bb, con, split, _ = setting or base_setting(torch, dev, reduced)
    n_clients = len(split.tasks)
    per_round = {"fused_unify_packed": 2, "masked_agg_batched_packed": 1,
                 "sign_sim_packed": 1}
    ops.reset_launch_counts()

    # (a) sync, the deferred drain and async under the ideal trace
    runs, wires, syncs = {}, {}, {}
    for label, cls, pipeline, systems in (
            ("S", MaTUStrategy, False, None),
            ("P", MaTUStrategy, True, None),
            ("A", AsyncMaTUStrategy, True, ClientSystems.ideal(n_clients))):
        strat = cls(BASE_TASKS, bb.d, device=dev)
        sim = FedSimulator(FedConfig(seed=SEED, pipeline=pipeline,
                                     **ASYNC_FED),
                           con, split, bb, strat, systems=systems, device=dev)
        calls = tick_trace(strat)
        probe = SyncProbe(torch)
        if label == "P":
            probe.hook(strat.server, "start_round", strat, "_drain",
                       pending=lambda s=strat: s._pending is not None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with probe if label == "P" else contextlib.nullcontext():
            hist = sim.run()
        wires[label] = wire_state(torch, strat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for r, call in enumerate(calls):
            if call["rose"] != per_round:
                raise AssertionError(f"async run {label} round {r + 1}: "
                                     f"launches {call['rose']}")
        if label == "A" and any(
                row["sampled"] != row["admitted"] or row["dropped"]
                or row["stale"] or row["quarantined"] or row["skipped"]
                for row in hist.fault_counts):
            raise AssertionError(f"async run A: counters {hist.fault_counts}")
        runs[label] = dict(wall_s=wall, mean_acc=hist.mean_acc,
                           task_acc=hist.task_acc,
                           up_bits=hist.uplink_bits_per_round,
                           down_bits=hist.downlink_bits_per_round,
                           mean_phase_us=hist.mean_phase_us,
                           phase_us=hist.phase_us,
                           tv=strat.server.last_task_vectors)
        if label == "P":
            syncs["deferred drain"] = dict(probe.seen)
        log(f"async run {label}: {len(calls)} rounds in {wall:.2f} s, mean "
            f"acc {hist.mean_acc}, uplink {hist.uplink_bits_per_round} and "
            f"downlink {hist.downlink_bits_per_round} bits a round, mean "
            f"phases (us) " + ", ".join(
                f"{k} {v:.1f}" for k, v in hist.mean_phase_us.items()))
        del sim, strat, calls
    for label in ("P", "A"):
        a, s_ = runs[label], runs["S"]
        for key in ("task_acc", "up_bits", "down_bits"):
            if a[key] != s_[key]:
                raise AssertionError(f"async run {label} vs S {key}: "
                                     f"{a[key]} vs {s_[key]}")
        check_equal(torch, f"async run {label} vs S task vectors", a["tv"],
                    s_["tv"])
        same_wire(torch, f"async run {label} vs S", wires[label], wires["S"])
    for r in runs.values():
        r.pop("tv")
    del wires
    log(f"async S = P = A bitwise ({ASYNC_FED['rounds']} rounds: "
        f"accuracies, bits a round, task vectors, every last upload and "
        f"downlink); implicit syncs while P's rounds were in flight: "
        f"{syncs['deferred drain'] or 'none'}")

    # (b) the fault trace
    systems = async_systems(n_clients)
    want = replay_trace(systems, ASYNC_TICKS, ASYNC_MAX_STALENESS)
    tot = {k: sum(c[k] for c, _ in want) for k in want[0][0]}
    fresh_stale = [r for r, (_, adm) in enumerate(want)
                   if any(s == 1 and not systems.corrupt(k, q)
                          for k, q, s in adm)]
    if (min(tot[k] for k in ("dropped", "crashed", "stragglers", "stale",
                             "quarantined", "skipped")) < 1
            or not fresh_stale):
        raise AssertionError(f"async fault trace misses a fault: {tot}, "
                             f"staleness-1 uploads kept at {fresh_stale}")
    strat = AsyncMaTUStrategy(BASE_TASKS, bb.d, code_masks=True, device=dev)
    cfg = FedConfig(seed=SEED, pipeline=True,
                    max_staleness=ASYNC_MAX_STALENESS,
                    **dict(ASYNC_FED, rounds=ASYNC_TICKS))
    sim = FedSimulator(cfg, con, split, bb, strat, systems=systems,
                       device=dev)
    calls = tick_trace(strat)
    raw_bits = []
    step = strat.aggregate_admitted

    def with_raw_bits(*args):
        ret = step(*args)
        served = [u for u in strat._last_uploads
                  if u.client_id not in strat.last_quarantined]
        raw_bits.append((sum(bitpack.wire_bits(bb.d, len(u.task_ids))
                             for u in strat._last_uploads),
                         sum(bitpack.wire_bits(bb.d, len(u.task_ids))
                             for u in served)))
        return ret

    strat.aggregate_admitted = with_raw_bits
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = sim.run()
    strat._drain()
    torch.cuda.synchronize()
    fault_wall = time.perf_counter() - t
    got = hist.fault_counts
    if got != [c for c, _ in want]:
        raise AssertionError(f"async fault run counters {got} != the "
                             f"trace's {[c for c, _ in want]}")
    ups, downs, shares = [], [], []
    for r, (row, call) in enumerate(zip(got, calls)):
        up, down = hist.uplink_bits_per_round[r], hist.downlink_bits_per_round[r]
        if row["skipped"]:
            rose_want = dict.fromkeys(per_round, 0)
            if call["name"] != "skip_round" or up or down:
                raise AssertionError(f"async tick {r}: skipped, but "
                                     f"{call['name']}, {up} / {down} bits")
        elif call["ret"] == 0:
            rose_want = dict(dict.fromkeys(per_round, 0),
                             fused_unify_packed=1)
        else:
            rose_want = per_round
        if call["rose"] != rose_want:
            raise AssertionError(f"async tick {r}: launches {call['rose']}, "
                                 f"want {rose_want}")
        ups.append(up)
        downs.append(down)
    it = iter(raw_bits)
    for r, row in enumerate(got):
        if not row["skipped"]:
            raw_up, raw_down = next(it)
            shares.append(dict(tick=r, up=ups[r] / raw_up,
                               down=downs[r] / raw_down if raw_down else None))
    fault = dict(wall_s=fault_wall, counts=got,
                 total=hist.total_fault_counts, mean_acc=hist.mean_acc,
                 up_bits=ups, down_bits=downs, coded_share=shares,
                 mean_phase_us=hist.mean_phase_us,
                 task_age=strat.task_age.tolist(),
                 trace=dict(faults=ASYNC_FAULTS,
                            slow_client=ASYNC_SLOW_CLIENT,
                            skip_tick=ASYNC_SKIP_TICK,
                            max_staleness=ASYNC_MAX_STALENESS))
    log(f"async fault run: seed {ASYNC_FAULTS['seed']}, client "
        f"{ASYNC_SLOW_CLIENT} base delay 2, every client dropped at tick "
        f"{ASYNC_SKIP_TICK}, max staleness {ASYNC_MAX_STALENESS}; "
        f"{ASYNC_TICKS} ticks in {fault_wall:.2f} s; counters = the "
        f"trace's every tick: {got}; totals {hist.total_fault_counts}; "
        f"mean acc {hist.mean_acc}; uplink {ups} / downlink {downs} bits; "
        f"coded/raw {shares}; task ages {strat.task_age.tolist()}; mean "
        f"phases (us) " + ", ".join(
            f"{k} {v:.1f}" for k, v in hist.mean_phase_us.items()))
    stale_call = calls[fresh_stale[0]]
    del sim, strat, calls

    # (c) the host pipeline over replayed full-width rounds
    raw, coded = stream_rounds(torch, dev, ASYNC_STREAM_ROUNDS)
    eng = RoundEngine(EngineConfig(n_tasks=T), device=dev)
    streams = {}
    for label, rounds, kw in (("packed", raw, dict(packed=True)),
                              ("coded", coded, dict(packed=True,
                                                    code_masks=True)),
                              ("bool", raw, dict(packed=False))):
        out = {}
        for way in ("sequential", "pipelined"):
            probed = label == "coded" and way == "pipelined"
            probe = SyncProbe(torch)
            if probed:
                probe.hook(eng, "run_packed", eng, "_drain_round")
            torch.cuda.synchronize()
            t = time.perf_counter()
            with probe if probed else contextlib.nullcontext():
                got_rounds = list(eng.round_stream(
                    rounds, pipeline=way == "pipelined", **kw))
            torch.cuda.synchronize()
            out[way] = (time.perf_counter() - t, got_rounds)
            if probed:
                syncs["round_stream"] = dict(probe.seen)
                del eng.run_packed, eng._drain_round
        (seq_s, seq), (pipe_s, pipe) = out["sequential"], out["pipelined"]
        for r, ((da, oa, _), (db, ob, _)) in enumerate(zip(seq, pipe)):
            for f in ("task_vectors", "tau_hats", "similarity",
                      "down_unified", "down_masks", "down_lams", "alpha_num",
                      "n_held", "m_hats_dense"):
                x, y = getattr(oa, f), getattr(ob, f)
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(
                            bf16_bits(torch, x) if x.dtype == torch.bfloat16
                            else x,
                            bf16_bits(torch, y) if y.dtype == torch.bfloat16
                            else y)):
                    raise AssertionError(f"round_stream {label} round {r}: "
                                         f"{f} pipelined != sequential")
            same_wire(torch, f"round_stream {label} round {r}",
                      ({}, {c: [bf16_bits(torch, x.unified), x.masks, x.lams]
                            for c, x in da.items()}),
                      ({}, {c: [bf16_bits(torch, x.unified), x.masks, x.lams]
                            for c, x in db.items()}))
        streams[label] = dict(
            sequential_s=seq_s, pipelined_s=pipe_s, ratio=pipe_s / seq_s,
            sequential_phase_us=[ph for _, _, ph in seq],
            pipelined_phase_us=[ph for _, _, ph in pipe])
        log(f"round_stream {label} ({ASYNC_STREAM_ROUNDS} rounds, N {N}, T "
            f"{T}, d {D}): pipelined = sequential bitwise; sequential "
            f"{seq_s:.3f} s, pipelined {pipe_s:.3f} s "
            f"({pipe_s / seq_s:.3f}x); phases (us) a round, sequential "
            + "; ".join(", ".join(f"{k} {v:.0f}" for k, v in ph.items())
                        for _, _, ph in seq) + " | pipelined "
            + "; ".join(", ".join(f"{k} {v:.0f}" for k, v in ph.items())
                        for _, _, ph in pipe))
        del seq, pipe, out
        torch.cuda.empty_cache()
    log(f"implicit syncs while a streamed round was in flight (coded, "
        f"pipelined): {syncs['round_stream'] or 'none'}")

    # the deferred drain's coded uplink at the full-width round: its words
    # go to the host before the round's launches; does its encode start
    # with the round still in flight?
    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev,
                                                    seed=SEED + 30)
    batch = RoundBatch.from_uploads(
        [Upload(i, tasks[i, :k].tolist(), tv[i, :k], sizes[i, :k].tolist())
         for i, k in enumerate(ks)], T)
    encode, in_flight, coded_up = (compression.encode_mask_rows_with_sizes,
                                   [], {})

    def probed(*a, **k):
        in_flight.append(not torch.cuda.current_stream().query())
        return encode(*a, **k)

    compression.encode_mask_rows_with_sizes = probed
    try:
        for pipeline in (False, True):
            s_ = MaTUStrategy(T, D, code_masks=True, pipeline=pipeline,
                              device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            s_.aggregate_batch(batch)
            s_._drain()
            torch.cuda.synchronize()
            coded_up[pipeline] = ([u.masks for u in s_._last_uploads],
                                  1e3 * (time.perf_counter() - t),
                                  s_.last_phase_us)
    finally:
        compression.encode_mask_rows_with_sizes = encode
    for a, b in zip(coded_up[False][0], coded_up[True][0]):
        check_equal(torch, "deferred vs undeferred coded uplink", b, a)
    uplink = dict(in_flight_at_encode=in_flight[0::2],
                  ms={str(p): v[1] for p, v in coded_up.items()},
                  phase_us={str(p): v[2] for p, v in coded_up.items()})
    log(f"coded uplink at the full-width round ({sum(ks)} rows): deferred = "
        f"undeferred byte for byte; the uplink encode started with the round"
        f" in flight: {uplink['in_flight_at_encode']} (undeferred, "
        f"deferred); aggregate + drain {coded_up[False][1]:.1f} / "
        f"{coded_up[True][1]:.1f} ms; phases (us) {uplink['phase_us']}")
    del tv, batch, coded_up
    launches = ops.launch_counts()

    # the first tick that admitted a kept stale upload, card vs CPU, and
    # its weighted round through kernels 1-3 against the plain versions
    batch, staleness, sysm, dispatch = stale_call["args"]
    card = AsyncMaTUStrategy(BASE_TASKS, bb.d, code_masks=True, device=dev)
    host = AsyncMaTUStrategy(BASE_TASKS, bb.d, code_masks=True, device="cpu")
    packed = []
    start = card.server.start_round

    def keep(p):
        packed.append(p)
        return start(p)

    card.server.start_round = keep
    n_card = card.aggregate_admitted(batch, staleness, sysm, dispatch)
    n_host = host.aggregate_admitted(RoundBatch.from_uploads(
        [Upload(u.client_id, list(u.task_ids), u.task_vectors.cpu(),
                list(u.data_sizes)) for u in batch.uploads], BASE_TASKS),
        staleness, sysm, dispatch)
    if (n_card, card.last_quarantined, card.task_age.tolist()) != (
            n_host, host.last_quarantined, host.task_age.tolist()):
        raise AssertionError(f"async stale tick card vs CPU: kept {n_card} "
                             f"vs {n_host}, quarantined "
                             f"{sorted(card.last_quarantined)} vs "
                             f"{sorted(host.last_quarantined)}")
    for a, b in zip(card._last_uploads, host._last_uploads):
        check_equal(torch, f"client {a.client_id}'s uplink stream", a.masks,
                    b.masks)
        check_equal(torch, f"client {a.client_id}'s bf16 unified",
                    bf16_bits(torch, a.unified).cpu(),
                    bf16_bits(torch, b.unified))
    errs = [merge_check(torch, "async stale tick task vectors",
                        card.server.last_task_vectors,
                        host.server.last_task_vectors),
            merge_check(torch, "async stale tick carried vectors",
                        card._task_vecs, host._task_vecs)]
    up = batched_client_unify(batch.task_vectors, batch.valid, device=dev)
    up_ref = batched_client_unify(batch.task_vectors, batch.valid, device=dev,
                                  mode="ref")
    for name, x, y in zip(("unified", "words", "lambda"), up, up_ref):
        check_equal(torch, f"stale tick uploads' {name}",
                    bf16_bits(torch, x) if x.dtype == torch.bfloat16 else x,
                    bf16_bits(torch, y) if y.dtype == torch.bfloat16 else y)
    p = packed[0]
    w = p.slot_weights
    if w is None or not bool((w == 0.5).any()):
        raise AssertionError(f"async stale tick: slot weights {w}")
    fields = ("task_vectors", "tau_hats", "alpha_num", "n_held", "similarity",
              "down_unified", "down_masks", "down_lams")
    eng = card.server.engine

    def outputs(pr, mode=None):
        o = eng.run_packed(pr, mode=mode)
        return {f: (bf16_bits(torch, getattr(o, f))
                    if getattr(o, f).dtype == torch.bfloat16
                    else getattr(o, f)) for f in fields}

    kern, plain = outputs(p), outputs(p, "ref")
    ones = outputs(dataclasses.replace(p, slot_weights=torch.ones_like(w)))
    none = outputs(dataclasses.replace(p, slot_weights=None))
    for f in fields:
        check_equal(torch, f"weighted round {f}, kernels vs plain", kern[f],
                    plain[f])
        check_equal(torch, f"round {f}, weights of ones vs none", ones[f],
                    none[f])
    log(f"async stale tick {fresh_stale[0]} (staleness {staleness}, "
        f"dispatched {dispatch}): card = CPU (kept {n_card}, quarantined "
        f"{sorted(card.last_quarantined)}, ages {card.task_age.tolist()}, "
        f"streams bitwise; task vectors max|err| {errs[0]:.3e}, carried "
        f"{errs[1]:.3e}); its weighted round (weights "
        f"{sorted(set(w.flatten().tolist()))}) through kernels 1-3 = the "
        f"plain versions bitwise, weights of ones = none bitwise")
    del card, host, packed, p, kern, plain, ones, none, stale_call
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"async phase: {phase_s:.1f} s, launches {launches}")
    return dict(launches=launches, runs=runs, fault=fault, streams=streams,
                syncs=syncs, coded_uplink=uplink,
                stale_tick=dict(tick=fresh_stale[0], task_vectors_err=errs[0],
                                carried_err=errs[1]),
                phase_s=phase_s)


# -- population phase: the chunked round and the population simulator -------

POP_CHUNKS = (1, 5, 8, 64)     # 1, a non-divisor of N, a divisor, more than N
POP_ASIDE_CHUNK = 8            # the staleness and coded calls
POP_STRAT_CHUNK = 8
POP_SPLIT = dict(n_clients=1_000_000, n_tasks=T, seed=SEED)
POP_FED = dict(rounds=2, eval_every=1, seed=SEED)
POP_PER_ROUND = 64
POP_CHUNK = 16
POP_DROPOUT = 0.1
POP_SMALL_D = 4096
POP_ALIGN_RTOL = 1e-5
OUT_FIELDS = ("task_vectors", "tau_hats", "similarity", "alpha_num", "n_held",
              "m_hats_dense")
ROUND_KERNELS = ("fused_unify_packed", "masked_agg_batched_packed",
                 "sign_sim_packed", "fused_unify", "masked_agg_batched",
                 "sign_sim")


def exact(torch, x):
    """A tensor as its bit pattern (fp32 as int32, bf16 as int16)."""
    return x.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}.get(x.dtype, x.dtype))


def same_round(torch, label, a, b):
    """Two rounds' (EngineOutput, downlinks) bit for bit; names the first
    output that differs."""
    (out_a, downs_a), (out_b, downs_b) = a, b
    pairs = [(f, getattr(out_a, f), getattr(out_b, f)) for f in OUT_FIELDS]
    if downs_a.keys() != downs_b.keys():
        raise AssertionError(f"{label}: downlink clients differ")
    for c in downs_a:
        pairs += [(f"client {c}'s downlink {f}", getattr(downs_a[c], f),
                   getattr(downs_b[c], f)) for f in ("unified", "masks",
                                                     "lams")]
    for name, x, y in pairs:
        if (x is None) != (y is None) or x is not None and (
                x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(exact(torch, x), exact(torch, y))):
            raise AssertionError(f"{label}: {name} differs")


def round_uploads(torch, dev, seed: int, d=None):
    """One full-width round's host ``ClientUpload``s (bf16 unified, word
    rows, λ, sizes), built by kernel 1 on the card from
    :func:`make_round_inputs` (at width ``d``)."""
    from repro_torch.core.client import ClientUpload
    from repro_torch.core.engine import batched_client_unify
    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev, seed=seed,
                                                    d=d)
    uni, words, lams = (x.cpu() for x in batched_client_unify(
        tv, valid, device=dev))
    del tv
    tasks, sizes = tasks.cpu(), sizes.cpu()
    return [ClientUpload(i, tasks[i, :k].tolist(), uni[i], words[i, :k],
                         lams[i, :k], sizes[i, :k].tolist())
            for i, k in enumerate(ks)]


def measured(torch, fn):
    """(result, wall ms, peak device bytes above the start) of ``fn``,
    synchronised, from an emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    return out, wall, torch.cuda.max_memory_allocated() - base


def device_busy_ms(torch, fn):
    """(result, summed device ms of ``fn``'s kernels and copies) under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, busy / 1e3


def chunked_against_monolithic(torch, dev, ups):
    """Part (a): ``RoundEngine.round_chunked`` at every chunk size of
    :data:`POP_CHUNKS` in both layouts, then with staleness and with a
    coded downlink at :data:`POP_ASIDE_CHUNK`: bit for bit the
    monolithic round and the same chunked call with ``mode="ref"``,
    launches exact; warm walls and peaks beside the monolithic
    round's."""
    from repro_torch.core.client import paper_link_bits
    from repro_torch.core.engine import EngineConfig, RoundEngine
    from repro_torch.kernels import bitpack, ops
    eng = RoundEngine(EngineConfig(n_tasks=T), device=dev)
    ks = [len(u.task_ids) for u in ups]
    table = {}
    for packed in (True, False):
        lay = "packed" if packed else "bool"
        unify, sim = (("fused_unify_packed", "sign_sim_packed") if packed
                      else ("fused_unify", "sign_sim"))
        up_bits = sum(bitpack.wire_bits(D, k) if packed
                      else paper_link_bits(D, k) for k in ks)
        calls = [(f"chunk {c}", c, {}) for c in POP_CHUNKS] + [
            (f"chunk {POP_ASIDE_CHUNK} stale", POP_ASIDE_CHUNK,
             dict(staleness=[i % 3 for i in range(len(ups))])),
            (f"chunk {POP_ASIDE_CHUNK} coded", POP_ASIDE_CHUNK,
             dict(code_masks=True))]
        # one untimed call of each path first: the walls below are warm
        eng.round(ups, packed=packed)
        eng.round_chunked(ups, chunk_clients=POP_ASIDE_CHUNK, packed=packed)
        refs, rows = {}, {}
        for label, chunk, kw in calls:
            key = tuple(sorted(kw))
            if key not in refs:
                ops.reset_launch_counts()
                mono, wall, peak = measured(torch, lambda: eng.round(
                    ups, packed=packed, **kw))
                refs[key] = (mono[1], mono[0])
                if not key:
                    rows["monolithic"] = dict(wall_ms=wall, peak_bytes=peak,
                                              launches=ops.launch_counts())
            ops.reset_launch_counts()
            (downs, out, stats), wall, peak = measured(
                torch, lambda: eng.round_chunked(ups, chunk_clients=chunk,
                                                 packed=packed, **kw))
            counts = ops.launch_counts()
            want = {k: 0 for k in ROUND_KERNELS}
            want[unify], want[sim] = stats["n_chunks"], 1
            if {k: counts[k] for k in ROUND_KERNELS} != want:
                raise AssertionError(f"population {lay} {label}: launches "
                                     f"{counts}, want {want}")
            tag = f"population {lay} {label}"
            same_round(torch, f"{tag} vs monolithic", refs[key],
                       (out, downs))
            down_bits = sum(dl.downlink_bits()
                            for dl in refs[key][1].values())
            if (stats["uplink_bits"], stats["downlink_bits"]) != (up_bits,
                                                                  down_bits):
                raise AssertionError(f"{tag}: bits {stats} against "
                                     f"{up_bits} up, {down_bits} down")
            ref_downs, ref_out, _ = eng.round_chunked(
                ups, chunk_clients=chunk, packed=packed, mode="ref", **kw)
            same_round(torch, f"{tag} vs its plain versions",
                       (ref_out, ref_downs), (out, downs))
            rows[label] = dict(wall_ms=wall, peak_bytes=peak,
                               n_chunks=stats["n_chunks"],
                               launches={k: counts[k] for k in (unify, sim)})
            del downs, out, ref_downs, ref_out
            log(f"{tag}: bitwise the monolithic round and the plain "
                f"versions, bits {stats['uplink_bits']} up / "
                f"{stats['downlink_bits']} down, launches "
                f"{rows[label]['launches']}, wall {wall:.2f} ms, peak "
                f"{peak / 2**30:.3f} GiB")
        mono = rows["monolithic"]
        log(f"population {lay} monolithic round: wall {mono['wall_ms']:.2f} "
            f"ms, peak {mono['peak_bytes'] / 2**30:.3f} GiB, launches "
            f"{ {k: v for k, v in mono['launches'].items() if v} }")
        log(f"population {lay} peak GiB by chunk: " + ", ".join(
            f"{c} {rows[f'chunk {c}']['peak_bytes'] / 2**30:.3f}"
            for c in POP_CHUNKS) + f" (monolithic "
            f"{mono['peak_bytes'] / 2**30:.3f})")
        table[lay] = rows
        del refs
    return table


def strategy_chunked_check(torch, dev):
    """Part (b): ``MaTUStrategy(chunk_clients=)`` against the batched
    strategy on the same uploads: every task's vector, the downlinks and
    the wire bits, bitwise; the chunked strategy's launches exact."""
    from repro_torch.fed.strategies import MaTUStrategy, Upload
    from repro_torch.kernels import ops
    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev,
                                                    seed=SEED + 41)
    uploads = [Upload(i, tasks[i, :k].tolist(), tv[i, :k].clone(),
                      sizes[i, :k].tolist()) for i, k in enumerate(ks)]
    del tv
    mono = MaTUStrategy(T, D, device=dev)
    chun = MaTUStrategy(T, D, chunk_clients=POP_STRAT_CHUNK, device=dev)
    mono.aggregate(uploads)
    ops.reset_launch_counts()
    chun.aggregate(uploads)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"fused_unify_packed": 1 + -(-len(uploads) // POP_STRAT_CHUNK),
            "sign_sim_packed": 1}
    if counts != want:
        raise AssertionError(f"chunked strategy launches {counts}, want "
                             f"{want}")
    for t in range(T):
        a, b = mono.eval_vectors(t)[0], chun.eval_vectors(t)[0]
        if not torch.equal(exact(torch, a), exact(torch, b)):
            raise AssertionError(f"chunked strategy: task {t}'s vector "
                                 f"differs")
    same_wire(torch, "chunked strategy", wire_state(torch, mono),
              wire_state(torch, chun))
    bits = (mono.uplink_bits(uploads), mono.downlink_bits())
    got = (chun.uplink_bits(uploads), chun.downlink_bits())
    if bits != got:
        raise AssertionError(f"chunked strategy: bits {bits} against {got}")
    log(f"population strategy: MaTUStrategy(chunk_clients="
        f"{POP_STRAT_CHUNK}) = MaTUStrategy() bitwise (every task's vector, "
        f"every upload and downlink, bits {bits[0]} up / {bits[1]} down), "
        f"launches {counts}")
    del mono, chun, uploads
    return counts


def population_run(torch, dev, d: int, profiled: bool = False):
    """One ``PopulationSimulator`` run (:data:`POP_SPLIT`,
    :data:`POP_FED`) at width ``d`` on ``dev``: (simulator, History, wall
    s, device busy ms or None)."""
    from repro_torch.data.dirichlet import PopulationSplit
    from repro_torch.fed.simulator import FedConfig, PopulationSimulator
    sim = PopulationSimulator(FedConfig(**POP_FED),
                              PopulationSplit(**POP_SPLIT), d=d,
                              clients_per_round=POP_PER_ROUND,
                              chunk_clients=POP_CHUNK,
                              dropout_prob=POP_DROPOUT, device=dev)
    t0 = time.perf_counter()
    if profiled:
        hist, busy = device_busy_ms(torch, sim.run)
    else:
        hist, busy = sim.run(), None
    return sim, hist, time.perf_counter() - t0, busy


def population_phase(torch, dev):
    """The chunked population round on the card:

    (a) :func:`chunked_against_monolithic` on one full-width round (N 32,
        K 4, T 30, d 1,327,140; uploads from kernel 1);
    (b) :func:`strategy_chunked_check` on another;
    (c) one ``PopulationSimulator`` run at full width (10^6 clients, 64 a
        round in chunks of 16, dropout 0.1, 2 rounds, evaluated each
        round) under ``torch.profiler``: its History, host µs deriving
        uploads against device busy ms, peak memory, launches exact a
        round; then the same run at d = 4,096 on the card and on the CPU:
        counters and bits equal, alignment within rtol 1e-5.

    Returns its numbers, ``launches`` those of the whole phase."""
    import numpy as np
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    launches = dict.fromkeys(ROUND_KERNELS, 0)

    def add(counts):
        for k in ROUND_KERNELS:
            launches[k] += counts[k]

    ups = round_uploads(torch, dev, SEED + 40)
    table = chunked_against_monolithic(torch, dev, ups)
    for rows in table.values():
        for label, row in rows.items():
            if label != "monolithic":
                add(dict.fromkeys(ROUND_KERNELS, 0) | row["launches"])
    del ups
    add(dict.fromkeys(ROUND_KERNELS, 0) | strategy_chunked_check(torch, dev))

    ops.reset_launch_counts()
    (sim, hist, wall, busy), _, peak = measured(
        torch, lambda: population_run(torch, dev, D, profiled=True))
    counts = ops.launch_counts()
    add(counts)
    chunks = [-(-fc["admitted"] // POP_CHUNK) for fc in hist.fault_counts]
    want = dict.fromkeys(ROUND_KERNELS, 0)
    want["fused_unify_packed"] = sum(chunks)
    want["sign_sim_packed"] = sum(1 for c in chunks if c)
    if {k: counts[k] for k in ROUND_KERNELS} != want:
        raise AssertionError(f"population run: launches {counts}, want {want}")
    if sim._tv_host.shape != (T, D) or not np.isfinite(sim._tv_host).all():
        raise AssertionError("population run: bad task vectors")
    derive_us = sum(ph.get("derive", 0.0) for ph in hist.phase_us)
    log(f"population run (d {D}, {POP_SPLIT['n_clients']} clients, "
        f"{POP_PER_ROUND} a round in chunks of {POP_CHUNK}, dropout "
        f"{POP_DROPOUT}): wall {wall:.2f} s, device busy {busy:.1f} ms, host "
        f"deriving uploads {derive_us / 1e3:.1f} ms, peak "
        f"{peak / 2**30:.3f} GiB, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for r, acc, up, down, fc, ph in zip(
            hist.rounds, hist.mean_acc, hist.uplink_bits_per_round,
            hist.downlink_bits_per_round, hist.fault_counts, hist.phase_us):
        log(f"  round {r}: alignment {acc:.6f}, bits {up} up / {down} down, "
            f"counters { {k: v for k, v in fc.items() if v} }, phases (us) "
            + ", ".join(f"{k} {v:.0f}" for k, v in ph.items()))
    full = dict(wall_s=wall, busy_ms=busy, derive_us=derive_us,
                peak_bytes=peak, mean_acc=hist.mean_acc,
                up_bits=hist.uplink_bits_per_round,
                down_bits=hist.downlink_bits_per_round,
                fault_counts=hist.fault_counts, phase_us=hist.phase_us)
    del sim, hist

    ops.reset_launch_counts()
    _, h_card, _, _ = population_run(torch, dev, POP_SMALL_D)
    add(ops.launch_counts())
    _, h_cpu, _, _ = population_run(torch, torch.device("cpu"), POP_SMALL_D)
    for key in ("rounds", "fault_counts", "uplink_bits_per_round",
                "downlink_bits_per_round"):
        if getattr(h_card, key) != getattr(h_cpu, key):
            raise AssertionError(f"population d {POP_SMALL_D} card vs CPU: "
                                 f"{key} {getattr(h_card, key)} vs "
                                 f"{getattr(h_cpu, key)}")
    acc_card = np.asarray([[a[t] for t in sorted(a)] for a in h_card.task_acc])
    acc_cpu = np.asarray([[a[t] for t in sorted(a)] for a in h_cpu.task_acc])
    if not np.allclose(acc_card, acc_cpu, rtol=POP_ALIGN_RTOL, atol=0):
        raise AssertionError(f"population d {POP_SMALL_D} card vs CPU: "
                             f"alignment {h_card.mean_acc} vs "
                             f"{h_cpu.mean_acc}")
    align_err = float(np.abs(acc_card - acc_cpu).max())
    log(f"population d {POP_SMALL_D}: card = CPU (counters, bits "
        f"{h_card.uplink_bits_per_round}), alignment {h_card.mean_acc} "
        f"(max |card - CPU| {align_err:.3e})")
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"population phase: {phase_s:.1f} s, launches {launches}")
    return dict(launches=launches, chunked=table, run=full,
                small_align_err=align_err, phase_s=phase_s)


# -- shard phase: the taskvec-sharded round on gloo ranks sharing the card --

SHARD_RANKS = 4                # gloo ranks, all on cuda:0 (one card)
SHARD_CHUNK = 8                # round_chunked's chunk on the population mesh
SHARD_SMALL_D = 4096           # the bool layout's width (kernels 4, 5, 3)
SHARD_SEED = SEED + 50
SHARD_FED = dict(rounds=2, local_steps=4, eval_every=2, seed=SEED,
                 batch_size=16, local_data=64)
# the fp32 bar λ is held to where it is not bitwise (the JAX package's
# promise on its kernel path); whether it is bitwise is reported
SHARD_LAM_RTOL = 1e-5
PACKED_ONCE = {"fused_unify_packed": 1, "masked_agg_batched_packed": 1,
               "sign_sim_packed": 1}
BOOL_ONCE = {"fused_unify": 1, "masked_agg_batched": 1, "sign_sim_packed": 1}
SHARD_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                     "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                     "all_to_all_single", "broadcast", "reduce", "gather",
                     "scatter", "send", "recv")


class Traffic:
    """While active, counts the calls of every ``torch.distributed``
    collective, the bytes all-reduced (with each all-reduce's dtype and
    shape) and the bytes an all-gather hands back."""

    def __init__(self, dist):
        self.dist = dist
        self.calls, self.reduced = {}, []
        self.reduce_bytes = self.gather_bytes = 0
        self._saved = {}

    def __enter__(self):
        for name in SHARD_COLLECTIVES:
            fn = getattr(self.dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrap(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if _name == "all_reduce":
                    t = a[0]
                    self.reduced.append([str(t.dtype), list(t.shape)])
                    self.reduce_bytes += t.numel() * t.element_size()
                if _name == "all_gather":
                    self.gather_bytes += sum(p.numel() * p.element_size()
                                             for p in a[0])
                return _fn(*a, **kw)

            setattr(self.dist, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.dist, name, fn)
        return False


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def local_same(torch, label, a, b):
    """Two rounds' outputs on one rank's shard (kernels against their
    plain versions) bit for bit; names the first field that differs."""
    for f in OUT_FIELDS + ("down_unified", "down_masks", "down_lams"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or x is not None and (
                x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(exact(torch, x), exact(torch, y))):
            raise AssertionError(f"{label}: {f} differs")


def held_to(torch, label, ref, got):
    """A sharded round's whole (EngineOutput, downlinks) against the
    unsharded round's: every output, downlink vector and mask bitwise, λ
    bitwise or within :data:`SHARD_LAM_RTOL`.  Returns (λ bitwise, λ's
    max relative difference)."""
    (out_r, downs_r), (out_g, downs_g) = ref, got
    for f in OUT_FIELDS:
        x, y = getattr(out_r, f), getattr(out_g, f)
        if (x is None) != (y is None) or x is not None and (
                x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(exact(torch, x), exact(torch, y))):
            raise AssertionError(f"{label}: {f} differs")
    if downs_r.keys() != downs_g.keys():
        raise AssertionError(f"{label}: downlink clients differ")
    lam_bitwise, lam_err = True, 0.0
    for c in downs_r:
        for f in ("unified", "masks"):
            x, y = getattr(downs_r[c], f), getattr(downs_g[c], f)
            if x.dtype != y.dtype or not torch.equal(exact(torch, x),
                                                     exact(torch, y)):
                raise AssertionError(f"{label}: client {c}'s downlink {f} "
                                     f"differs")
        x, y = downs_r[c].lams, downs_g[c].lams
        lam_bitwise &= bool(torch.equal(exact(torch, x), exact(torch, y)))
        lam_err = max(lam_err, float(((x - y).abs()
                                      / x.abs().clamp_min(1e-30)).max()))
    if lam_err > SHARD_LAM_RTOL:
        raise AssertionError(f"{label}: λ differs by {lam_err:.3e} relative "
                             f"(bar {SHARD_LAM_RTOL})")
    return lam_bitwise, lam_err


def shard_packed_run(torch, dist, dev, rank, eng, ups, ref, label):
    """One packed round on ``eng``'s mesh: launches and collectives
    counted over ``run_packed`` alone, the kernels held against their
    plain versions on this rank's shard, the downlinks gathered at the
    wire boundary, and on rank 0 the whole round held to the unsharded
    ``ref``."""
    from repro_torch.core.engine import pack_uploads
    from repro_torch.kernels import ops
    from repro_torch.nn import sharding
    batch = pack_uploads(ups, T, device=dev, mesh=eng.mesh)
    eng.run_packed(batch)                    # first call, untimed
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sharding.reset_collective_counts()
    with Traffic(dist) as tr:
        out, wall, peak = measured(torch, lambda: eng.run_packed(batch))
    launches = nonzero(ops.launch_counts())
    coll = sharding.collective_counts()
    if launches != PACKED_ONCE:
        raise AssertionError(f"{label} rank {rank}: launches {launches}")
    if coll != {"psum": 2, "gather": 0} or tr.calls != {"all_reduce": 2} \
            or tr.reduced[0] != ["torch.int32", [T, T]]:
        raise AssertionError(f"{label} rank {rank}: collectives {coll}, "
                             f"{tr.calls}, {tr.reduced}")
    local_same(torch, f"{label} rank {rank}: kernels vs plain on the shard",
               out, eng.run_packed(batch, mode="ref"))
    with Traffic(dist) as tg:
        downs = eng.downlinks(batch, out)
    whole = eng.gather_output(out._replace(down_unified=None,
                                           down_masks=None), D)
    run = dict(launches=launches, psum=coll["psum"],
               reduce_bytes=tr.reduce_bytes, reduced=tr.reduced,
               gather_bytes=tg.gather_bytes, wall_ms=wall, peak_bytes=peak,
               d_pad=batch.d_pad, width=int(batch.unified.shape[-1]))
    if rank == 0:
        run["lams_bitwise"], run["lams_max_rel"] = held_to(
            torch, f"{label} vs unsharded", ref, (whole, downs))
    return run


def shard_checks(torch, dev, rank: int) -> dict:
    """One rank's part of the shard phase (see :func:`shard_phase`);
    returns its numbers.  Rank 0 also runs every unsharded reference."""
    import torch.distributed as dist
    from repro_torch.core.engine import EngineConfig, RoundEngine, pack_uploads
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.simulator import FedConfig, FedSimulator
    from repro_torch.fed.strategies import MaTUStrategy, Upload
    from repro_torch.fed.testbed import MLPBackbone
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_population_mesh,
                                         make_round_mesh)
    from repro_torch.nn import sharding
    meshes = {"round4": make_round_mesh(SHARD_RANKS),
              "debug2x2": make_debug_mesh((2, 2)),
              "pop_s2": make_population_mesh(slots=2)}
    cfg = EngineConfig(n_tasks=T)
    rep = {"rank": rank, "runs": {}}
    ups = round_uploads(torch, dev, SHARD_SEED)
    single = RoundEngine(cfg, device=dev)
    ref = None
    if rank == 0:
        single.round(ups)                    # first call, untimed
        (downs, out), wall, peak = measured(torch, lambda: single.round(ups))
        ref = (out, downs)
        rep["unsharded"] = dict(wall_ms=wall, peak_bytes=peak)

    # (a) the packed round on the round mesh and the (2, 2) debug mesh
    for mname in ("round4", "debug2x2"):
        eng = RoundEngine(cfg, device=dev, mesh=meshes[mname])
        rep["runs"][mname] = shard_packed_run(torch, dist, dev, rank, eng,
                                              ups, ref, f"shard {mname}")

    # (b) round_chunked on the population mesh
    eng = RoundEngine(cfg, device=dev, mesh=meshes["pop_s2"])
    ops.reset_launch_counts()
    sharding.reset_collective_counts()
    (downs, out, stats), wall, peak = measured(
        torch, lambda: eng.round_chunked(ups, chunk_clients=SHARD_CHUNK))
    launches, coll = nonzero(ops.launch_counts()), \
        sharding.collective_counts()
    want = {"fused_unify_packed": stats["n_chunks"], "sign_sim_packed": 1}
    if launches != want or coll["psum"] != 2 + stats["n_chunks"]:
        raise AssertionError(f"shard chunked rank {rank}: launches "
                             f"{launches}, collectives {coll}")
    run = dict(launches=launches, psum=coll["psum"], gathers=coll["gather"],
               n_chunks=stats["n_chunks"], wall_ms=wall, peak_bytes=peak)
    downs_p, out_p, _ = eng.round_chunked(ups, chunk_clients=SHARD_CHUNK,
                                          mode="ref")
    same_round(torch, f"shard chunked rank {rank}: kernels vs plain on the "
               f"mesh", (out, downs), (out_p, downs_p))
    del downs_p, out_p
    if rank == 0:
        run["lams_bitwise"], run["lams_max_rel"] = held_to(
            torch, "shard chunked vs unsharded monolithic", ref,
            (out, downs))
    rep["runs"]["pop_s2_chunked"] = run
    del downs, out, ref, ups

    # (c) MaTUStrategy(mesh=) from client unify to the downlinks
    tv, valid, tasks, sizes, ks = make_round_inputs(torch, dev,
                                                    seed=SHARD_SEED + 1)
    uploads = [Upload(i, tasks[i, :k].tolist(), tv[i, :k].clone(),
                      sizes[i, :k].tolist()) for i, k in enumerate(ks)]
    del tv, valid
    strat = MaTUStrategy(T, D, device=dev, mesh=meshes["round4"])
    ops.reset_launch_counts()
    sharding.reset_collective_counts()
    _, wall, peak = measured(torch, lambda: strat.aggregate(uploads))
    launches, coll = nonzero(ops.launch_counts()), \
        sharding.collective_counts()
    want = dict(PACKED_ONCE, fused_unify_packed=2)
    # gathers: the downlink vectors and words and the task vectors, at
    # the drain; the raw uplink record is worked out from shapes
    if launches != want or coll != {"psum": 3, "gather": 3}:
        raise AssertionError(f"shard strategy rank {rank}: launches "
                             f"{launches}, collectives {coll}")
    run = dict(launches=launches, psum=coll["psum"], gathers=coll["gather"],
               wall_ms=wall, peak_bytes=peak)
    if rank == 0:
        mono = MaTUStrategy(T, D, device=dev)
        mono.aggregate(uploads)
        tv_bitwise = all(torch.equal(
            exact(torch, mono.eval_vectors(t)[0]),
            exact(torch, strat.eval_vectors(t)[0])) for t in range(T))
        err = float((mono.server.last_task_vectors
                     - strat.server.last_task_vectors).abs().max())
        if not torch.allclose(mono.server.last_task_vectors,
                              strat.server.last_task_vectors, rtol=1e-4,
                              atol=1e-5):
            raise AssertionError(f"shard strategy: task vectors differ by "
                                 f"{err:.3e}")
        if tv_bitwise:
            same_wire(torch, "shard strategy", wire_state(torch, mono),
                      wire_state(torch, strat))
        bits = (mono.uplink_bits(uploads), mono.downlink_bits())
        got = (strat.uplink_bits(uploads), strat.downlink_bits())
        if bits != got:
            raise AssertionError(f"shard strategy: bits {got} vs {bits}")
        run.update(tv_bitwise=tv_bitwise, tv_max_err=err, bits=list(bits))
        del mono
    rep["runs"]["strategy"] = run
    del strat, uploads

    # (d) the bool layout at small d: kernels 4, 5 and 3 on each shard
    ups = round_uploads(torch, dev, SHARD_SEED + 2, d=SHARD_SMALL_D)
    eng = RoundEngine(cfg, device=dev, mesh=meshes["round4"])
    batch = pack_uploads(ups, T, packed=False, device=dev, mesh=eng.mesh)
    ops.reset_launch_counts()
    sharding.reset_collective_counts()
    out = eng.run_packed(batch)
    torch.cuda.synchronize()
    launches, coll = nonzero(ops.launch_counts()), \
        sharding.collective_counts()
    if launches != BOOL_ONCE or coll["psum"] != 2:
        raise AssertionError(f"shard bool rank {rank}: launches {launches}, "
                             f"collectives {coll}")
    local_same(torch, f"shard bool rank {rank}: kernels vs plain on the "
               f"shard", out, eng.run_packed(batch, mode="ref"))
    whole = eng.gather_output(out, SHARD_SMALL_D)
    run = dict(launches=launches, psum=coll["psum"])
    if rank == 0:
        downs, out = single.round(ups, packed=False)
        run["lams_bitwise"], run["lams_max_rel"] = held_to(
            torch, "shard bool vs unsharded", (out, downs),
            (whole, eng.downlinks(batch, whole)))
    rep["runs"]["bool_small_d"] = run

    # (e) a 2-round FedSimulator(mesh=) on MLPBackbone
    con = make_constellation(n_tasks=4, n_groups=2, feat_dim=16, n_classes=4,
                             conflict_pairs=[(0, 1)], seed=SEED)
    split = dirichlet_split(n_clients=5, n_tasks=4, n_classes=4, zeta_t=0.0,
                            seed=SEED)

    def fed(mesh):
        bb = MLPBackbone(16, hidden=24, lora_rank=4)
        strat = MaTUStrategy(4, bb.d, device=dev)
        hist = FedSimulator(FedConfig(**SHARD_FED), con, split, bb, strat,
                            device=dev, mesh=mesh).run()
        return hist, strat.server.last_task_vectors

    ops.reset_launch_counts()
    h_s, tv_s = fed(meshes["round4"])
    launches = nonzero(ops.launch_counts())
    # a round: kernel 1 in client unify and in the downlink, 2 and 3 once
    want = {k: v * SHARD_FED["rounds"] for k, v in
            dict(PACKED_ONCE, fused_unify_packed=2).items()}
    if launches != want:
        raise AssertionError(f"shard FedSimulator rank {rank}: launches "
                             f"{launches}, want {want}")
    run = dict(launches=launches, mean_acc=h_s.mean_acc)
    if rank == 0:
        h_u, tv_u = fed(None)
        if (h_u.uplink_bits_per_round, h_u.downlink_bits_per_round) != (
                h_s.uplink_bits_per_round, h_s.downlink_bits_per_round):
            raise AssertionError("shard FedSimulator: bits differ")
        if not torch.allclose(tv_u, tv_s, rtol=1e-4, atol=1e-5):
            raise AssertionError("shard FedSimulator: task vectors differ")
        run.update(bitwise=bool(h_u.task_acc == h_s.task_acc
                                and torch.equal(exact(torch, tv_u),
                                                exact(torch, tv_s))),
                   bits=[h_s.uplink_bits_per_round,
                         h_s.downlink_bits_per_round])
    rep["runs"]["fedsim"] = run
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    return rep


def shard_rank(rank: int, work: str) -> None:
    """A spawned rank of the shard phase: gloo on the shared card, the
    file store in ``work``; writes ``work/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, 'store')}",
        rank=rank, world_size=SHARD_RANKS)
    try:
        rep = shard_checks(torch, torch.device("cuda", 0), rank)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def shard_phase(torch, dev):
    """The taskvec-sharded round on :data:`SHARD_RANKS` gloo ranks that
    share the one card (the kernels were built by :func:`setup`, so the
    ranks only load them).  No wall here is a scaling figure: the ranks
    share one card's HBM and SMs.  Every rank, at the round phase's
    shapes (N 32, K 4, T 30, D 1,327,140, seeded alike on each rank):

    (a) the packed round on ``make_round_mesh(4)`` and on
        ``make_debug_mesh((2, 2))``: kernels 1-3 launched once each and
        exactly two psums (the int32 (T, T) dots, the λ roots) and no
        other collective inside ``run_packed``; each rank's kernels
        bitwise their plain versions on its shard; rank 0 holds the whole
        round (gathered at the wire boundary) to its unsharded round:
        masks, words, alpha_num, S, task vectors bitwise, λ bitwise or
        within rtol 1e-5 (reported);
    (b) ``round_chunked`` (chunk 8) on ``make_population_mesh(slots=2)``:
        2 + 1 psum a chunk; each rank's round bitwise the same mesh's
        ``round_chunked(mode="ref")`` (its kernels against their plain
        versions); rank 0's against the unsharded monolithic round;
    (c) ``MaTUStrategy(mesh=)`` from client unify to the downlinks
        against ``MaTUStrategy()``: 3 psums and 3 gathers, all at the
        drain (downlink vectors and words, task vectors);
    (d) the bool layout at d = 4,096: kernels 4, 5 and 3 on each shard;
    (e) a 2-round ``FedSimulator(mesh=)`` on ``MLPBackbone``: kernel 1
        twice and kernels 2, 3 once a round on each rank.

    A rank that raises fails the phase (``torch.multiprocessing.spawn``
    re-raises it).  Returns the numbers; ``launches`` are every rank's
    counted main-path launches, summed."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core.engine import pad_d_for_shards
    t_phase = time.perf_counter()
    for s in (2, 4, 8):
        dp = pad_d_for_shards(D, s)
        log(f"shard d_pad at {s} shards: {dp:,} ({100 * (dp / D - 1):.1f} % "
            f"above d = {D:,}; {dp // s:,} a shard)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        t0 = time.perf_counter()
        mp.spawn(shard_rank, args=(work,), nprocs=SHARD_RANKS)
        spawn_s = time.perf_counter() - t0
        reps = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict.fromkeys(ROUND_KERNELS, 0)
    for rep in reps:
        for run in rep["runs"].values():
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    r0 = reps[0]["runs"]
    log(f"shard unsharded round (rank 0): wall "
        f"{reps[0]['unsharded']['wall_ms']:.2f} ms, peak "
        f"{reps[0]['unsharded']['peak_bytes'] / 2**30:.3f} GiB")
    for mname in ("round4", "debug2x2"):
        for rep in reps:
            run = rep["runs"][mname]
            log(f"shard {mname} rank {rep['rank']}: launches "
                f"{run['launches']}, psums {run['psum']} (all-reduced "
                f"{run['reduce_bytes']:,} B: {run['reduced']}), downlink "
                f"gather {run['gather_bytes'] / 1e6:.1f} MB, width "
                f"{run['width']:,} of d_pad {run['d_pad']:,}, run_packed "
                f"wall {run['wall_ms']:.2f} ms, peak "
                f"{run['peak_bytes'] / 2**30:.3f} GiB")
        log(f"shard {mname}: whole round = unsharded bitwise (masks, words, "
            f"alpha_num, S, task vectors); λ bitwise "
            f"{r0[mname]['lams_bitwise']} (max rel "
            f"{r0[mname]['lams_max_rel']:.3e})")
    for rep in reps:
        run = rep["runs"]["pop_s2_chunked"]
        log(f"shard chunked (pop_s2, chunk {SHARD_CHUNK}) rank {rep['rank']}: "
            f"{run['n_chunks']} chunks, launches {run['launches']}, psums "
            f"{run['psum']}, gathers {run['gathers']}, wall "
            f"{run['wall_ms']:.2f} ms, peak {run['peak_bytes'] / 2**30:.3f} "
            f"GiB")
    log(f"shard chunked: = unsharded monolithic bitwise, λ bitwise "
        f"{r0['pop_s2_chunked']['lams_bitwise']}")
    for rep in reps:
        run = rep["runs"]["strategy"]
        log(f"shard strategy rank {rep['rank']}: launches {run['launches']}, "
            f"psums {run['psum']}, gathers {run['gathers']}, wall "
            f"{run['wall_ms']:.2f} ms, peak {run['peak_bytes'] / 2**30:.3f} "
            f"GiB")
    log(f"shard strategy: task vectors bitwise {r0['strategy']['tv_bitwise']}"
        f" (max |err| {r0['strategy']['tv_max_err']:.3e}), bits "
        f"{r0['strategy']['bits']} equal")
    log(f"shard bool d {SHARD_SMALL_D}: launches a rank "
        f"{r0['bool_small_d']['launches']}, psums "
        f"{r0['bool_small_d']['psum']}, = unsharded, λ bitwise "
        f"{r0['bool_small_d']['lams_bitwise']}")
    log(f"shard FedSimulator: bits {r0['fedsim']['bits']} equal, bitwise "
        f"{r0['fedsim']['bitwise']}, mean acc {r0['fedsim']['mean_acc']}")
    log("shard peak GiB by rank: " + ", ".join(
        f"{rep['rank']} {rep['peak_bytes'] / 2**30:.3f}" for rep in reps))
    phase_s = time.perf_counter() - t_phase
    log(f"shard phase: {phase_s:.1f} s (spawned ranks {spawn_s:.1f} s), "
        f"launches {launches}")
    return dict(launches=launches, ranks=reps, phase_s=phase_s)


# -- tp phase: model-parallel LoRA training on a (data, model) mesh ----------

TP_ARCH = "granite-moe-3b-a800m"
TP_LAYERS = 2                  # of granite's 32: the phase's depth cut
TP_MESH = (2, 2)               # (data, model): 20 experts a rank
TP_RANKS = 4                   # gloo ranks, all on cuda:0 (one card)
TP_STEPS = 2
TP_LR = 5e-3                   # AdamW, clip 1.0: the lmtrain phase's rate
# bars, sharded against unsharded on the same parameters and batches.
# "grad" is step 1's LoRA gradients before the clip (a gradient of the
# wrong size, or none, reads ~1); "flips" the share of a leaf's elements
# whose change over the steps (new - initial) is off the reference's by
# more than TP_LR / 2 -- AdamW's first steps move an element ~lr·sign(g),
# so such an element took the other sign in a step (an unmoved LoRA, a
# wrong rate or a misplaced optimizer state reads ~1)
TP_LOSS_RTOL = 1e-2            # bf16
TP_GRAD_REL_L2 = 5e-2          # bf16, whole tree: the port's bf16 logits bar
TP_FP32_LOSS_RTOL = 1e-5       # the fp32 witness: the same steps in fp32
TP_FP32_GRAD_REL_L2 = 1e-3     # fp32, every leaf
TP_FP32_FLIPS = 1e-3           # fp32, every leaf
TP_FED = ["fed", "--rounds", "2", "--local-steps", "5"]
TP_LM = ["lm", "--arch", TP_ARCH, "--steps", "2"]
TP_FED_ONCE = {"fused_unify_packed": 2, "masked_agg_batched_packed": 1,
               "sign_sim_packed": 1}    # a MaTU round of the fed mode


def collective_bytes_mode(torch):
    """A dispatch mode that counts every collective a rank issues, by kind,
    with the bytes of its input tensors: DTensor's moves (the
    ``_c10d_functional`` ops) and the counted ``sharding.psum`` calls
    (``c10d.allreduce_``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.bytes = {}, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns = func.namespace
            if ns in ("_c10d_functional", "c10d"):
                kind = func._overloadpacket.__name__
                n = 0
                for a in args:
                    for t in (a if isinstance(a, (list, tuple)) else (a,)):
                        if isinstance(t, torch.Tensor):
                            n += t.numel() * t.element_size()
                if kind not in ("wait_tensor", "_wrap_tensor_autograd"):
                    self.calls[kind] = self.calls.get(kind, 0) + 1
                    self.bytes[kind] = self.bytes.get(kind, 0) + n
            return func(*args, **(kwargs or {}))

    return Collectives()


def tp_batch(torch, dev, cfg, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (LMTRAIN_B, LMTRAIN_S), generator=g,
                        device=dev)
    return {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}


def tp_rel_l2(torch, got: dict, want: dict) -> tuple:
    """(whole-tree rel L2, worst leaf's rel L2, its name) of two trees
    flattened by path; a leaf that is zero in ``want`` is measured
    against the whole tree's norm."""
    num = {k: float((got[k].double() - want[k].double()).pow(2).sum())
           for k in want}
    den = {k: float(want[k].double().pow(2).sum()) for k in want}
    whole = math.sqrt(sum(num.values()) / max(sum(den.values()), 1e-300))
    leaf = {k: math.sqrt(num[k] / (den[k] if den[k] > 0
                                   else max(sum(den.values()), 1e-300)))
            for k in want}
    worst = max(leaf, key=leaf.get)
    return whole, leaf[worst], worst


def tp_steps(torch, dev, cfg, mesh, rules, rank: int, timed: bool) -> dict:
    """:data:`TP_STEPS` AdamW steps (clip 1.0, :data:`TP_LR`) of ``cfg``'s
    LoRA, sharded on ``mesh``: parameters, LoRA, AdamW state and batch
    placed as DTensors by ``logical_to_sharding`` / ``batch_shardings`` /
    ``opt_state_shardings``.  Rank 0 then runs the same function
    unsharded: the sharded MoE's capacity is a data shard's and its aux
    the mean of the shards' (expert-parallel: every ``model`` rank of a
    data shard routes the same tokens), so the sharded step's loss and
    gradients are the means over the batch's ``data`` halves of the
    unsharded model's, which the reference takes before the same
    update.  The reference routes each half's tokens to the experts the
    sharded ranks chose for them: a near-tie that the two sides round
    apart swaps an expert and, through the capacity positions, the
    drops of later tokens, which no rounding bar can hold; the routing
    itself is held apart (:func:`tp_compare`).  Each step's LoRA
    gradients are recorded before the clip.  ``timed``:
    each sharded step timed, the first under a collective-counting mode,
    the second under ``CommDebugMode``.  Returns the numbers and, on rank
    0, both sides' losses, gradients, initial and final LoRA (whole) and
    layer 0's first routing."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.common.tree import (tree_leaves, tree_leaves_with_path,
                                         tree_like)
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import batch_shardings, opt_state_shardings
    from repro_torch.nn import sharding
    from repro_torch.optim import (Optimizer, adamw, chain,
                                   clip_by_global_norm)
    from repro_torch.train.trainer import make_train_step

    with sharding.mesh_context(mesh, rules):
        model = cfg.build(SHAPES["train_4k"], device=dev)
    params = model.init(SEED + 70)
    lora = model.lora_init(SEED + 71)
    batch = tp_batch(torch, dev, cfg, SEED + 72)
    moe = model.model.unit_blocks[0][1].ffn
    if moe.forms(*batch["tokens"].shape, mesh)["form"] != "expert_parallel":
        raise AssertionError("tp: the reference assumes the expert-parallel "
                             "form")
    # the trainer's default step (clip 1.0, then AdamW) at TP_LR, with the
    # gradients recorded before the clip
    inner, seen = chain(clip_by_global_norm(1.0), adamw(TP_LR)), []

    def update(grads, state, lora_):
        seen.append(grads)
        return inner.update(grads, state, lora_)
    step, opt = make_train_step(model, Optimizer(inner.init, update),
                                grad_clip=None)

    def by_path(tree):
        return {"/".join(p): (t.full_tensor() if isinstance(t, DTensor)
                              else t).detach()
                for p, t in tree_leaves_with_path(tree)}

    def recording(calls):
        """Records every routing call's expert ids (layer 0's first with
        its gate probabilities)."""
        route = moe.route

        def rec(router_w, xt, cap):
            r = route(router_w, xt, cap)
            calls.append(r[2] if calls else (r[0].detach().float(), r[2]))
            return r
        moe.route = rec
        return route

    def forced(feed, own):
        """The routing of the ids ``feed`` gives, one call after another:
        gate values and capacity positions as ``MoE.route`` forms them
        from those ids; ``own`` records the first call's own routing."""
        route = moe.route

        def rec(router_w, xt, cap):
            probs, _, ids_own, _, _ = route(router_w, xt, cap)
            if not own:
                own.append((probs.detach().float(), ids_own))
            ids = feed.pop(0).to(xt.device)
            vals = probs.gather(-1, ids)
            vals = (vals / vals.sum(-1, keepdim=True)).to(xt.dtype)
            flat_e = ids.reshape(-1)
            onehot = torch.nn.functional.one_hot(flat_e, moe.n_experts)
            count = onehot.t().contiguous().cumsum(1)
            pos = (count.gather(0, flat_e[None])[0] - 1).view_as(ids)
            return probs, vals, ids, pos, pos < cap
        moe.route = rec
        return route

    out = {"failures": []}
    ref_params = params if rank == 0 else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with sharding.mesh_context(mesh, rules):
        p_sh = sharding.logical_to_sharding(model.axes(), params)
        l_sh = sharding.logical_to_sharding(model.lora_axes(), lora)
        state = opt.init(lora)
        pd = sharding.distribute_tree(params, p_sh, mesh)
        ld = sharding.distribute_tree(lora, l_sh, mesh)
        sd = sharding.distribute_tree(
            state, opt_state_shardings(state, l_sh, mesh), mesh)
        bd = sharding.distribute_tree(batch, batch_shardings(batch, mesh),
                                      mesh)
        del params, state
        for t in tree_leaves(pd) + tree_leaves(ld) + tree_leaves(bd):
            if not isinstance(t, DTensor) or t.to_local().device != dev:
                raise AssertionError(f"tp: a leaf is not a DTensor on {dev}")
        out["local_param_bytes"] = sum(
            t.to_local().numel() * t.to_local().element_size()
            for t in tree_leaves(pd))
        calls = []
        keep = recording(calls)
        losses, walls = [], []
        coll = collective_bytes_mode(torch)
        comm = CommDebugMode()
        for i in range(TP_STEPS):
            sharding.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (coll if i == 0 else comm) if timed else (
                    contextlib.nullcontext()):
                ld, sd, met = step(pd, ld, sd, bd)
            loss = float(met["loss"].full_tensor())
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss)
        moe.route = keep
        out.update(losses=losses, route=calls[0],
                   psums_a_step=sharding.collective_counts()["psum"],
                   peak_bytes=torch.cuda.max_memory_allocated())
        if timed:
            out.update(step_ms=walls, collectives=coll.calls,
                       collective_bytes=coll.bytes,
                       comm_debug={str(k).split(".")[-1]: v for k, v in
                                   comm.get_comm_counts().items()})
        # every rank takes part in the gathers
        out.update(grads=[by_path(g) for g in seen], lora=by_path(ld))
        del pd, ld, sd, bd
    # every rank's routing ids, call by call (host copies, for the check)
    ids = [calls[0][1]] + calls[1:]
    seqs = [None] * dist.get_world_size()
    dist.all_gather_object(seqs, [t.cpu() for t in ids])
    if rank == 0:
        # the unsharded steps of the same function: each data half of the
        # batch through the unsharded model, routed as the sharded ranks
        # of that data coordinate routed it (each rank of a data shard
        # routes its tokens over all experts), losses and gradients
        # averaged, then the same update
        n_data = sharding.mesh_axis_sizes(mesh)["data"]
        b_loc = batch["tokens"].shape[0] // n_data
        halves = [{k: v[i * b_loc:(i + 1) * b_loc] for k, v in batch.items()}
                  for i in range(n_data)]
        per_step = len(seqs[0]) // TP_STEPS
        src = [int(mesh.mesh[i, 0]) for i in range(n_data)]
        if any(len(seqs[r]) != per_step * TP_STEPS for r in src):
            raise AssertionError(f"tp: routing calls a rank "
                                 f"{[len(q) for q in seqs]}")
        own = []
        st, lr_ = opt.init(lora), lora
        ref_losses, ref_grads = [], []
        for k in range(TP_STEPS):
            losses_, grads_ = [], []
            for i, half in enumerate(halves):
                feed = list(seqs[src[i]][k * per_step:(k + 1) * per_step])
                keep = forced(feed, own)
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(lr_)]
                loss = model.loss(ref_params, tree_like(lr_, leaves), half)
                grads_.append(torch.autograd.grad(
                    loss, leaves, allow_unused=True, materialize_grads=True))
                losses_.append(loss.detach())
                moe.route = keep
                if feed:
                    raise AssertionError(f"tp: {len(feed)} routing calls "
                                         f"left unread")
            grads = tree_like(lr_, [sum(gs) / n_data for gs in zip(*grads_)])
            ref_grads.append(by_path(grads))
            lr_, st = inner.update(grads, st, lr_)
            ref_losses.append(float(sum(losses_) / n_data))
        out.update(ref_losses=ref_losses, ref_route=own[0],
                   ref_grads=ref_grads, ref_lora=by_path(lr_),
                   init_lora=by_path(lora))
        del st, lr_
    if not all(math.isfinite(v) for v in losses):
        out["failures"].append(f"tp rank {rank}: a non-finite loss {losses}")
    return out


def tp_flips(torch, o: dict) -> tuple:
    """The LoRA elements whose change over the steps is off the
    reference's by more than ``TP_LR / 2``: (the worst leaf's share of
    them, that leaf, how many in all, and the largest over them of the
    smaller over the steps of the reference gradient's size there
    against its leaf's RMS -- near 0 where a rounding flipped a sign)."""
    share, n_all, near = {}, 0, 0.0
    for k in o["init_lora"]:
        bad = (o["lora"][k].double() - o["ref_lora"][k].double()).abs() \
            > TP_LR / 2
        share[k] = float(bad.double().mean())
        if not bad.any():
            continue
        n_all += int(bad.sum())
        size = []
        for g in o["ref_grads"]:
            gk = g[k].double()
            rms = float(gk.pow(2).mean().sqrt())
            size.append(gk.abs()[bad] / rms if rms > 0
                        else torch.full_like(gk[bad], math.inf))
        near = max(near, float(torch.stack(size).min(0).values.max()))
    worst = max(share, key=share.get)
    return share[worst], worst, n_all, near


def tp_compare(torch, moe_k: int, o: dict, tag: str) -> dict:
    """Rank 0's comparison of one :func:`tp_steps` run with its unsharded
    steps: loss rel a step, gradients (whole tree and worst leaf) a step,
    the LoRA's change over the steps (rel L2, whole and worst leaf, and
    :func:`tp_flips`), and layer
    0's first routing: this rank's rows are the batch's first B / 2
    (data coordinate 0); as the router inputs round apart a row's ids
    may differ only where two of its first k + 1 sorted gate values lie
    within twice the largest gate change."""
    loss_rel = [abs(a - b) / abs(b)
                for a, b in zip(o["losses"], o["ref_losses"])]
    grad = [tp_rel_l2(torch, g, w)
            for g, w in zip(o["grads"], o["ref_grads"])]
    init = o["init_lora"]
    change = tp_rel_l2(
        torch, {k: o["lora"][k].double() - init[k].double() for k in init},
        {k: o["ref_lora"][k].double() - init[k].double() for k in init})
    flips = tp_flips(torch, o)
    probs_r, ids_r = o["ref_route"]
    probs_s, ids_s = o["route"]
    n = ids_s.shape[0]
    probs_r, ids_r = probs_r[:n], ids_r[:n]
    delta = float((probs_s - probs_r).abs().max())
    diff = (ids_s != ids_r).any(-1).nonzero().flatten().tolist()
    gaps = []
    for r in diff:
        top = torch.sort(probs_r[r], descending=True).values
        gaps.append(float((top[:moe_k] - top[1:moe_k + 1]).min()))
    log(f"tp {tag} routing (layer 0, first step, {n} tokens): {len(diff)} "
        f"rows differ from the unsharded call; largest gate change "
        f"{delta:.3e}; their smallest gaps among the first k + 1 gates "
        f"{[f'{g:.2e}' for g in sorted(gaps)[-8:]]} (largest 8)")
    log(f"tp {tag} sharded against unsharded: loss rel "
        f"{[f'{v:.2e}' for v in loss_rel]}; gradients rel L2 a step "
        f"(whole / worst leaf) {[f'{w:.3e} / {l:.3e} {k}' for w, l, k in grad]}"
        f"; LoRA change rel L2 {change[0]:.3e} / {change[1]:.3e} "
        f"{change[2]}; flipped elements {flips[2]}, worst leaf's share "
        f"{flips[0]:.3e} {flips[1]}, their largest smaller reference "
        f"gradient / RMS {flips[3]:.3e}")
    failures = []
    if any(g > 2 * delta for g in gaps):
        failures.append(f"tp {tag}: routing differs away from a tie: gaps "
                        f"{gaps}, gate change {delta}")
    return dict(loss_rel=loss_rel, grad_rel_l2=[g[:2] for g in grad],
                grad_worst=[g[2] for g in grad], change_rel_l2=change[:2],
                change_worst=change[2], flip_share=flips[0],
                flip_worst=flips[1], flips=flips[2], flip_grad=flips[3],
                route_diff_rows=len(diff),
                route_tokens=n, route_gaps=gaps, route_gate_change=delta,
                failures=failures)


def tp_checks(torch, dev, rank: int) -> dict:
    """One rank of the tp phase: granite at full width cut to
    :data:`TP_LAYERS` layers, LoRA rank 16, on ``make_debug_mesh(
    TP_MESH)``, :func:`tp_steps` in bf16 (timed) and then in fp32 (the
    witness that the bf16 gaps are rounding).  Returns the numbers
    (rank 0: against the unsharded steps, and the bars' verdicts)."""
    import dataclasses
    from repro_torch.configs.base import load_arch
    from repro_torch.launch.mesh import arch_rules, make_debug_mesh

    cfg = dataclasses.replace(load_arch(TP_ARCH), n_layers=TP_LAYERS)
    mesh = make_debug_mesh(TP_MESH)
    rules = arch_rules(cfg, mesh)
    top_k = cfg.top_k
    bf = tp_steps(torch, dev, cfg, mesh, rules, rank, timed=True)
    rep = {"rules": {k: str(v) for k, v in rules.items()},
           "coord": list(mesh.get_coordinate()),
           "failures": bf.pop("failures")}
    rep.update({k: bf[k] for k in ("losses", "step_ms", "psums_a_step",
                                   "collectives", "collective_bytes",
                                   "comm_debug", "local_param_bytes",
                                   "peak_bytes")})
    if rank == 0:
        c = tp_compare(torch, top_k, bf, "bf16")
        rep["failures"] += c.pop("failures")
        rep.update(ref_losses=bf["ref_losses"], bf16=c)
        if (max(c["loss_rel"]) > TP_LOSS_RTOL
                or c["grad_rel_l2"][0][0] > TP_GRAD_REL_L2):
            rep["failures"].append(
                f"tp bf16: loss rel {c['loss_rel']} (bar {TP_LOSS_RTOL}), "
                f"step 1's gradients rel L2 {c['grad_rel_l2'][0][0]} (bar "
                f"{TP_GRAD_REL_L2})")
    del bf
    torch.cuda.empty_cache()
    f32 = tp_steps(torch, dev, dataclasses.replace(cfg, dtype=torch.float32),
                   mesh, rules, rank, timed=False)
    rep["failures"] += f32.pop("failures")
    rep["fp32_losses"] = f32["losses"]
    if rank == 0:
        c = tp_compare(torch, top_k, f32, "fp32")
        rep["failures"] += c.pop("failures")
        rep["fp32"] = c
        worst_grad = c["grad_rel_l2"][0][1]
        if (max(c["loss_rel"]) > TP_FP32_LOSS_RTOL
                or worst_grad > TP_FP32_GRAD_REL_L2
                or c["flip_share"] > TP_FP32_FLIPS):
            rep["failures"].append(
                f"tp fp32: loss rel {c['loss_rel']} (bar "
                f"{TP_FP32_LOSS_RTOL}), step 1's worst leaf's gradient rel "
                f"L2 {worst_grad} (bar {TP_FP32_GRAD_REL_L2}), worst "
                f"leaf's share of flipped elements {c['flip_share']} (bar "
                f"{TP_FP32_FLIPS})")
    return rep


def tp_rank(rank: int, work: str) -> None:
    """A spawned rank of the tp phase: gloo on the shared card, the file
    store in ``work``; writes ``work/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, 'store')}",
        rank=rank, world_size=TP_RANKS)
    try:
        rep = tp_checks(torch, torch.device("cuda", 0), rank)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def tp_phase(torch, dev):
    """Model-parallel LoRA training on a (data, model) mesh, then the
    training launcher.  :data:`TP_RANKS` gloo ranks share the card (no
    wall here is a scaling figure): granite-moe-3b-a800m at full width
    (d_model 1,536, 24 heads, kv 8, 40 experts of d_ff 512, top-8, vocab
    49,155), bf16, LoRA rank 16, cut to :data:`TP_LAYERS` layers, on
    ``make_debug_mesh(TP_MESH)``: expert-parallel, 20 experts a rank,
    ``kv_heads`` over ``model`` by ``arch_rules``; :data:`TP_STEPS` AdamW
    steps (:data:`TP_LR`) at B ``LMTRAIN_B`` × S ``LMTRAIN_S``, every
    leaf a DTensor on cuda:0.  Rank 0 holds them to the unsharded model
    on each ``data`` half of the batch, averaged (:func:`tp_steps`): the
    losses within rel :data:`TP_LOSS_RTOL` and step 1's LoRA gradients
    within rel L2 :data:`TP_GRAD_REL_L2`, and layer 0's first routing
    ids to the unsharded call's, a difference only at a printed
    near-tie.  The same steps then run in fp32, the witness that the
    bf16 gaps are rounding: losses within rel :data:`TP_FP32_LOSS_RTOL`,
    each leaf's step-1 gradients within :data:`TP_FP32_GRAD_REL_L2`, and
    in each leaf at most a share :data:`TP_FP32_FLIPS` of elements whose
    change over the steps took the other sign (:func:`tp_flips`).
    Each rank's bf16 step walls, peak memory and the first step's
    collectives by kind and bytes are printed.  Then, in this process, the launcher:
    ``launch.train`` ``fed`` (:data:`TP_FED`, the MLP backbone), kernels
    1-3 counted (:data:`TP_FED_ONCE` a round), and ``lm``
    (:data:`TP_LM`, the reduced granite).  Returns the numbers."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(work,), nprocs=TP_RANKS)
        spawn_s = time.perf_counter() - t0
        reps = []
        for r in range(TP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0 = reps[0]
    log(f"tp {TP_ARCH} cut to {TP_LAYERS} layers, mesh {TP_MESH}, rules "
        f"{r0['rules']}, B={LMTRAIN_B} x S={LMTRAIN_S}, AdamW {TP_LR}: "
        f"bf16 losses {r0['losses']} (unsharded {r0['ref_losses']}); "
        f"fp32 losses {r0['fp32_losses']}")
    for r, rep in enumerate(reps):
        log(f"tp rank {r} {rep['coord']}: step walls "
            f"{[f'{v:.1f}' for v in rep['step_ms']]} ms, peak "
            f"{rep['peak_bytes'] / 2**30:.3f} GiB, local parameters "
            f"{rep['local_param_bytes'] / 2**20:.1f} MiB, psums a step "
            f"{rep['psums_a_step']}")
    log("tp first step's collectives (rank 0): " + ", ".join(
        f"{k} {n} calls {r0['collective_bytes'][k] / 2**20:.1f} MiB in"
        for k, n in sorted(r0["collectives"].items())))
    log(f"tp second step's collectives (rank 0, CommDebugMode): "
        f"{r0['comm_debug']}")
    failures = [f for rep in reps for f in rep["failures"]]
    if failures:
        raise AssertionError("; ".join(failures))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.main(TP_FED)
    fed_s = time.perf_counter() - t0
    fed_launches = {k: v for k, v in ops.launch_counts().items()
                    if k in TP_FED_ONCE}
    want = {k: v * len(hist.rounds) for k, v in TP_FED_ONCE.items()}
    if fed_launches != want:
        raise AssertionError(f"tp fed: launches {fed_launches}, want {want}")
    t0 = time.perf_counter()
    lm_losses = train.main(TP_LM)
    lm_s = time.perf_counter() - t0
    if len(lm_losses) != 2 or not all(math.isfinite(v) for v in lm_losses):
        raise AssertionError(f"tp lm: losses {lm_losses}")
    phase_s = time.perf_counter() - t_phase
    log(f"tp launcher: fed {fed_s:.1f} s, final mean acc "
        f"{hist.final_mean_acc:.3f}, launches {fed_launches}; lm {lm_s:.1f} "
        f"s, losses {lm_losses}; tp phase {phase_s:.1f} s (spawned ranks "
        f"{spawn_s:.1f} s)")
    return dict(launches=fed_launches, ranks=reps, phase_s=phase_s,
                spawn_s=spawn_s, fed_acc=hist.final_mean_acc,
                lm_losses=lm_losses)


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


# -- examples phase: the federated-LM and serving examples at full width ----

EX_LM_ARCH = "codeqwen1.5-7b"  # as published, bf16
EX_LM_D = 17_367_136           # rank 16 on mixer/wq, mixer/wo, ffn/down + alphas
EX_LM_ARGS = ["--rounds", "1", "--local-steps", "2"]
EX_SERVE_ARCH = "qwen2.5-3b"   # at full width, in fp32 (the example's dtype)
EX_SERVE_D = 12_238_956
EX_SERVE_ARGS = ["--quick"]
# one MaTU round at the server: the downlinks' re-unify (kernel 1), Eq. 3
# + 4 (kernel 2) and Eq. 5 (kernel 3); the clients unify in plain torch
EX_ROUND = {"fused_unify_packed": 1, "masked_agg_batched_packed": 1,
            "sign_sim_packed": 1}
EX_SERVE_NEW = 8               # the serving example's new tokens a request
# qwen2.5-3b's LoRA factor shapes at rank 16: wq and wo a (2048, 16),
# down's a (11008, 16), every b (16, 2048)
EX_SERVE_LEAVES = [(2048, 16), (11008, 16), (16, 2048)]


def example_round_check(torch, server, uploads, label):
    """The example's round re-run on its uploads through kernels 1–3 and
    through their plain versions (:func:`round_against_plain`): the
    kernels at the model's d against the plain versions, bitwise."""
    from repro_torch.core.engine import pack_uploads
    packed = pack_uploads(uploads, server.cfg.n_tasks, device=server.device)
    tvs = round_against_plain(torch, server, packed, label)
    check_equal(torch, f"{label}round on the example's uploads, task vectors"
                " against the example's own round", tvs,
                server.last_task_vectors)
    del packed, tvs


def example_lm_part(torch, dev, card):
    """``fed_finetune_lm_torch.main`` on codeqwen1.5-7b as published
    (bf16, full width, depth uncut), launches counted from 0: the LoRA d,
    each local step's wall, the round's wall and launches (exact), peak
    memory; the round re-run on its uploads through the kernels and
    through their plain versions, bitwise; the saved checkpoint
    reloaded bitwise the server's task vectors.  Returns its numbers."""
    from repro_torch.ckpt.checkpoint import load
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels import ops
    from repro_torch.models.builders import ArchModel
    fed_lm = examples_module("fed_finetune_lm_torch")
    cfg = load_arch(EX_LM_ARCH)
    init_peak = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT), \
            peak_after(torch, ArchModel, "init", init_peak):
        out = fed_lm.main(EX_LM_ARGS, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_init = torch.cuda.max_memory_allocated() / 2**30
    peak = max(init_peak + [after_init])
    total = nonzero_counts(ops.launch_counts())
    space, server = out["space"], out["server"]
    if space.d != EX_LM_D:
        raise AssertionError(f"examples {EX_LM_ARCH}: LoRA d {space.d} != "
                             f"{EX_LM_D}")
    # the clients unify in plain torch: every launch is the round's
    if total != EX_ROUND or len(out["round_s"]) != 1:
        raise AssertionError(f"examples {EX_LM_ARCH}: {len(out['round_s'])}"
                             f" rounds launched {total}; expected one, "
                             f"{EX_ROUND}")
    losses = out["task_losses"][0]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"examples {EX_LM_ARCH}: losses {losses}")
    tv = server.last_task_vectors
    if tv.shape != (3, EX_LM_D) or not bool(torch.isfinite(tv).all()):
        raise AssertionError(f"examples {EX_LM_ARCH}: bad task vectors")
    example_round_check(torch, server, out["uploads"],
                        f"examples {EX_LM_ARCH} ")
    t1 = time.perf_counter()
    back, meta = load(os.path.join(ROOT, fed_lm.CKPT),
                      {"task_vectors": torch.empty_like(tv)})
    load_s = time.perf_counter() - t1
    if not torch.equal(back["task_vectors"], tv) or meta != {"rounds": 1}:
        raise AssertionError(f"examples {EX_LM_ARCH}: the reloaded "
                             f"checkpoint is not the server's task vectors")
    steps = [1e3 * x for x in out["step_s"]]
    log(f"examples {EX_LM_ARCH} ({cfg.dtype}, full width, {cfg.n_layers} "
        f"layers): LoRA d = {space.d} (held), layout {space.fingerprint}; "
        f"{len(steps)} local steps at B 4 x S 48, walls "
        + ", ".join(f"{x:.1f}" for x in steps)
        + f" ms (median {statistics.median(steps):.1f}); round "
        f"{1e3 * out['round_s'][0]:.2f} ms, launches {total}, kernels = "
        f"plain versions on its uploads (bitwise); losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; uplink {out['uplink_bits'][0]} bits; checkpoint reloaded "
        f"bitwise in {load_s:.2f} s; main {wall:.2f} s, peak device memory "
        f"{peak:.3f} GiB ({init_peak[0]:.3f} by the end of the random "
        f"init, {after_init:.3f} after it) ({card})")
    return dict(d=space.d, step_ms=steps, round_ms=1e3 * out["round_s"][0],
                launches=total, wall_s=wall, peak_gib=peak,
                init_peak_gib=init_peak[0], after_init_peak_gib=after_init,
                uplink_bits=out["uplink_bits"][0], losses=losses)


def example_serve_part(torch, dev, card):
    """``serve_decode_torch.main(["--quick"])`` on qwen2.5-3b at full
    width in fp32, launches counted from 0: the LoRA d, the round's
    launches and every generate's (kernel 9 exactly 216 a forward on the
    fused decoder, none on the dense one), fused ≡ dense tokens (the
    example asserts it on the timed mix; here on every mix, after the
    counted run), one routed tree across mixes on both decoders, req/s,
    peak memory.  Then, outside the count: the round re-run on its
    uploads through the kernels and through their plain versions,
    bitwise; kernel 9 on each LoRA leaf shape at S = 1 and the prompt's
    length against its plain version (:func:`serve_kernel_checks`);
    each mix's fused prefill logits against the dense-routed ones at the
    fp32 bar, and a changed task moving a request's logits past that
    bar (the check sees the modulated term).  Returns its numbers."""
    import dataclasses
    from repro_torch.configs.base import load_arch
    from repro_torch.kernels import ops
    from repro_torch.models.builders import ArchModel
    from repro_torch.serve import MultiTenantDecoder
    serve = examples_module("serve_decode_torch")
    cfg = dataclasses.replace(load_arch(EX_SERVE_ARCH), dtype=torch.float32)
    per_gen = launches_per_forward(cfg) * EX_SERVE_NEW
    gens, init_peak = [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_calls(MultiTenantDecoder, "generate", gens,
                          key=lambda dec: "fused" if dec.fused else "dense"), \
            peak_after(torch, ArchModel, "init", init_peak):
        out = serve.main(EX_SERVE_ARGS, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_init = torch.cuda.max_memory_allocated() / 2**30
    peak = max(init_peak + [after_init])
    total = nonzero_counts(ops.launch_counts())
    d = out["store"].space.d
    if d != EX_SERVE_D:
        raise AssertionError(f"examples {EX_SERVE_ARCH}: LoRA d {d} != "
                             f"{EX_SERVE_D}")
    want_gen = {"dense": {}, "fused": {"modulated_matmul": per_gen}}
    bad = [(k, nonzero_counts(c)) for k, c in gens
           if nonzero_counts(c) != want_gen[k]]
    n_fused = sum(k == "fused" for k, _ in gens)
    # the generates launch kernel 9 alone: kernels 1–3 are the one round's
    want_total = dict(EX_ROUND, modulated_matmul=n_fused * per_gen)
    if bad or n_fused != 3 or total != want_total:
        raise AssertionError(f"examples {EX_SERVE_ARCH}: generates off "
                             f"{bad} ({n_fused} fused), the run {total}; "
                             f"expected {per_gen} a fused generate, 3 "
                             f"fused, {want_total}")
    round_launches = {k: v for k, v in total.items() if k in EX_ROUND}
    if out["one_route"] != {"dense": True, "fused": True}:
        raise AssertionError(f"examples {EX_SERVE_ARCH}: routed trees "
                             f"differ across mixes {out['one_route']}")
    for mix, dense_tokens in zip(out["mixes"], out["mix_tokens"]):
        fused_tokens = out["fused"].generate(out["prompts"], mix)
        if not torch.equal(fused_tokens, dense_tokens):
            raise AssertionError(f"examples {EX_SERVE_ARCH}: fused tokens "
                                 f"differ from dense on mix {mix}")
    label = f"examples {EX_SERVE_ARCH} "
    example_round_check(torch, out["server"], out["uploads"], label)
    leaves = sorted({tuple(leaf.shape[-2:])
                     for leaf in out["store"].space.leaves
                     if len(leaf.shape) >= 2})
    if leaves != sorted(EX_SERVE_LEAVES):
        raise AssertionError(f"{label}LoRA factor shapes {leaves} != "
                             f"{EX_SERVE_LEAVES}")
    mm_per = serve_kernel_checks(torch, dev, [
        (kn, (1, out["prompts"].shape[1]), True) for kn in EX_SERVE_LEAVES])
    mm_rel = max(v["rel"] for v in mm_per.values())
    logit_err, mix_moves = example_logit_checks(torch, out, label)
    rep = out["report"]
    log(f"examples {EX_SERVE_ARCH} (fp32, full width, {cfg.n_layers} "
        f"layers): LoRA d = {d} (held); round launches {round_launches}, "
        f"kernels = plain versions on its uploads (bitwise); kernel 9 on "
        f"{EX_SERVE_LEAVES} at S 1 and {out['prompts'].shape[1]}: "
        f"|err|/(|x||w|) at most {mm_rel:.2e} (bar {MM_RTOL}); fused vs "
        f"dense prefill logits max|err| {logit_err:.3e} on every mix, a "
        f"changed task moves a request's logits by "
        f"{min(mix_moves):.3e} to {max(mix_moves):.3e}; "
        f"{len(gens)} generates (B {len(out['mixes'][0])}, prompt "
        f"{out['prompts'].shape[1]}, {EX_SERVE_NEW} new), kernel 9 "
        f"{per_gen} a fused generate, {n_fused * per_gen} in all, none "
        f"dense; store {rep['tasks']} tasks in {rep['resident_bytes']} B vs "
        f"{rep['checkpoint_bytes']} B ({rep['ratio']:.2f}x); dense "
        f"{out['dense_rps']:.2f} req/s, fused {out['fused_rps']:.2f} req/s; "
        f"fused = dense tokens on all {len(out['mixes'])} mixes; one routed "
        f"tree across mixes on both; main {wall:.2f} s, peak device memory "
        f"{peak:.3f} GiB ({init_peak[0]:.3f} by the end of the random "
        f"init, {after_init:.3f} after it) ({card})")
    return dict(d=d, launches=round_launches, per_fused_generate=per_gen,
                modulated_matmul=n_fused * per_gen,
                dense_rps=out["dense_rps"], fused_rps=out["fused_rps"],
                report=rep, wall_s=wall, peak_gib=peak,
                init_peak_gib=init_peak[0], after_init_peak_gib=after_init)


def example_logit_checks(torch, out, label):
    """The serving example's prompts prefilled through each mix's fused
    and dense-routed trees: fused against dense within FP32_RTOL /
    FP32_ATOL on every mix, and each request whose task differs between
    the first mix and the all-zeros one must move its dense logits past
    that bar, or the fused check could not see a wrong modulated term.
    Returns (max |fused - dense|, each such request's max logit move)."""
    from repro_torch.serve.router import route_batch
    dense, store, prompts = out["dense"], out["store"], out["prompts"]
    prefill = served_prefill(dense.model, dense.params, {"tokens": prompts},
                             EX_SERVE_NEW)
    logits, err = {}, 0.0
    for i, mix in enumerate(out["mixes"]):
        for fused in (True, False):
            logits[i, fused] = prefill(route_batch(store, mix,
                                                   fused=fused))[0]
        torch.cuda.synchronize()
        e = max_abs(torch, logits[i, True], logits[i, False])
        err = max(err, e)
        if not torch.allclose(logits[i, True], logits[i, False],
                              rtol=FP32_RTOL, atol=FP32_ATOL):
            raise AssertionError(f"{label}fused vs dense-routed prefill "
                                 f"logits beyond rtol {FP32_RTOL}, atol "
                                 f"{FP32_ATOL} on mix {mix} (max|err| {e})")
    first, zeros = out["mixes"][0], out["mixes"][2]
    moves = []
    for r, (a, z) in enumerate(zip(first, zeros)):
        if a == z:
            continue
        la, lz = logits[0, False][r], logits[2, False][r]
        moves.append(max_abs(torch, la, lz))
        if torch.allclose(la, lz, rtol=FP32_RTOL, atol=FP32_ATOL):
            raise AssertionError(f"{label}request {r}'s logits under task "
                                 f"{a} and task {z} agree within the fp32 "
                                 f"bar: the check cannot see the modulated "
                                 f"term")
    if not moves:
        raise AssertionError(f"{label}no request changes task across mixes")
    return err, moves


def examples_phase(torch, dev, card):
    """The federated-LM example on codeqwen1.5-7b (bf16) and the serving
    example on qwen2.5-3b (fp32), both at full width; no profiling.
    Returns both parts' numbers and the launches of kernels 1–3 and 9
    over the phase."""
    import gc
    t0 = time.perf_counter()
    lm = example_lm_part(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    serve = example_serve_part(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: lm["launches"].get(k, 0) + serve["launches"].get(k, 0)
                for k in EX_ROUND}
    launches["modulated_matmul"] = serve["modulated_matmul"]
    wall = time.perf_counter() - t0
    log(f"examples phase: {wall:.1f} s ({card})")
    return dict(lm=lm, serve=serve, launches=launches, wall_s=wall)


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
# in different orders.  The worst case, 2 K 2^-24, is 5.8e-4 at K = 4864
# and 1.3e-3 at K = 11,008 (qwen2.5-3b's ffn/down); rounding errors of
# random sign grow as sqrt(K) 2^-24, 6.3e-6 at K = 11,008, so the bar
# keeps a factor of ~16 over that at the largest K it meets.
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


# kernel 9's prefill routes (S > DECODE_MAX_S) by
# ``modulated_matmul.prefill_route``: the device function each launches
PREFILL_FUNCTIONS = {"narrow_k": "modulated_matmul_narrow_k_kernel",
                     "narrow_n": "modulated_matmul_narrow_n_kernel",
                     "tile": "modulated_matmul_kernel<"}


def serve_kernel_checks(torch, dev, leaves=None):
    """Kernel 9 at B = SERVE_B on each qwen2 leaf shape at S = 1, the
    decode route's largest S and the prompt length, and on each xlstm
    leaf shape at S = 1, the decode route's largest S and xlstm's prompt
    length (or on ``leaves``: [((k, n), sequence lengths, x = I
    check)]), τ in fp32 and bf16: against its plain version within
    MM_RTOL, bitwise with x = I (qwen2 leaves) and with one-hot rows at
    decode and at prefill; at S = 1 and at each prefill S bitwise
    deterministic and batch-invariant; a misaligned leaf refused; timed
    beside its plain version, its bound and the product alone
    (``torch.bmm`` on the pre-built weights, which the port never
    calls), with the device functions each call runs.  Returns
    {(k, n, s, tau): numbers}."""
    from repro_torch.kernels import bitpack, ops, ref
    from repro_torch.kernels import modulated_matmul as mm
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    b = SERVE_B
    per = {}
    dmax = mm.DECODE_MAX_S
    if leaves is None:
        leaves = ([(kn, (1, dmax, SERVE_PROMPT), True) for kn in SERVE_LEAVES]
                  + [(kn, (1, dmax, XLSTM_PROMPT), False)
                     for kn in XLSTM_UNIT_MIX])
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
            # one-hot rows at prefill: on a b-factor row s = e_(s mod K)
            # at S 64; on an a-factor 20 rows at the start of K, across
            # the narrow-N kernel's first 64-row stage boundary and at
            # the end of K
            if mm.prefill_route(k, n) == "narrow_k":
                hot_rows = [torch.arange(64, device=dev) % k]
            elif mm.prefill_route(k, n) == "narrow_n":
                hot_rows = [torch.arange(k0, k0 + 20, device=dev)
                            for k0 in sorted({0, 54, max(0, k - 20)})]
            else:
                hot_rows = []
            for rows in hot_rows:
                rows = rows[rows < k]
                hot = torch.eye(k, device=dev)[rows].expand(
                    b, len(rows), k).contiguous()
                got = mm.modulated_matmul_cuda(hot, base, tau, words, lam)
                torch.cuda.synchronize()
                check_equal(torch, f"modulated_matmul one-hot prefill rows "
                            f"from {int(rows[0])} ({k}, {n}) {tau_dt}", got,
                            w_eff[:, rows])
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
                if s == 1 or s > dmax:
                    again = mm.modulated_matmul_cuda(x, base, tau, words, lam)
                    alone = [mm.modulated_matmul_cuda(
                        x[i:i + 1].contiguous(), base, tau,
                        words[i:i + 1].contiguous(), lam[i:i + 1].contiguous())
                        for i in range(b)]
                    torch.cuda.synchronize()
                    check_equal(torch, f"modulated_matmul ({k}, {n}) S={s} "
                                f"{tau_dt} run to run", again, got)
                    check_equal(torch, f"modulated_matmul ({k}, {n}) S={s} "
                                f"{tau_dt} B=1 calls against B={b}",
                                torch.cat(alone), got)
                    del again, alone
                ms = time_ms(torch, lambda: mm.modulated_matmul_cuda(
                    x, base, tau, words, lam))
                plain_ms = time_ms(torch, lambda: mm.plain(
                    x, base, tau, words, lam))
                product_ms = time_ms(torch, lambda: torch.bmm(x, w_eff))
                same = torch.equal(got, torch.bmm(x, w_eff))
                n_bytes = (x.numel() * 4 + k * n * 4 + k * n
                           * tau.element_size() + words.numel() * 4 + b * 4
                           + b * s * n * 4)
                b_ms, b_by = bound(n_bytes, 2 * b * s * k * n + 3 * b * k * n)
                err = max_abs(torch, got, want)
                dev_ms, fns, _ = device_ms(torch, "modulated_matmul_",
                                        lambda: mm.modulated_matmul_cuda(
                                            x, base, tau, words, lam))
                route = ("modulated_matmul_splitk_kernel" if s <= dmax
                         else PREFILL_FUNCTIONS[mm.prefill_route(k, n)])
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
                    product_ms=product_ms, max_abs_err=err, rel=ratio,
                    product_bitwise=same, device_ms=dev_ms,
                    device_functions=fns)
                log(f"modulated_matmul B={b} S={s} (K, N)=({k}, {n}) tau "
                    f"{str(tau_dt)[6:]}: {ms:.4f} ms a call (device "
                    f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, product "
                    f"alone {product_ms:.4f} ms (bitwise: {same}), bound "
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
           for f in ("ms", "plain_ms", "bound_ms", "device_ms", "product_ms")}
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
    # once: over a long window (an xlstm prefill's ~10^6 events) each
    # call takes tens of seconds on the host
    averages = prof.key_averages()
    on_card = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    log(f"profiled {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}")
    ops_ = {}
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total):
        ops_[e.key] = (e.self_device_time_total / 1e3, e.count)
    for key, (ms, calls) in list(ops_.items())[:top]:
        log(f"  {ms:8.3f} ms  x{calls:<5d} {key[:90]}")
    on_host = [e for e in averages
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
    unit_pre = mm_row(per, XLSTM_PROMPT, XLSTM_UNIT_MIX)
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
        xlstm_prefill_unit_device_ms=unit_pre["device_ms"],
        xlstm_prefill_unit_plain_ms=unit_pre["plain_ms"],
        xlstm_prefill_unit_bound_ms=unit_pre["bound_ms"],
        per_shape={f"{k}x{n} S={s} tau={t[6:]}": v
                   for (k, n, s, t), v in per.items()},
        check=f"|err| <= {MM_RTOL} (|x| @ |w|) against the plain version; "
        f"x = I and one-hot decode and prefill rows bitwise; S = 1 and each "
        f"prefill S run to run and B = 1 against B = {SERVE_B} bitwise; "
        f"misaligned refused (ms / plain / "
        f"bound: one decode "
        f"layer's six launches, S=1, bf16 tau)")
    log(f"modulated_matmul per decode layer (6 launches, S=1): {dec['ms']:.4f}"
        f" ms of calls (device {dec['device_ms']:.4f} ms), plain "
        f"{dec['plain_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; per "
        f"prefill layer (S={SERVE_PROMPT}): {pre['ms']:.4f} ms (device "
        f"{pre['device_ms']:.4f} ms), plain {pre['plain_ms']:.4f} ms, product "
        f"alone {pre['product_ms']:.4f} ms, bound "
        f"{pre['bound_ms']:.5f} ms; per xlstm decode unit (8 launches, S=1): "
        f"{unit['ms']:.4f} ms (device {unit['device_ms']:.4f} ms), plain "
        f"{unit['plain_ms']:.4f} ms, bound {unit['bound_ms']:.5f} ms; per "
        f"xlstm prefill unit (8 launches, S={XLSTM_PROMPT}): "
        f"{unit_pre['ms']:.4f} ms (device {unit_pre['device_ms']:.4f} ms), "
        f"plain {unit_pre['plain_ms']:.4f} ms, product alone "
        f"{unit_pre['product_ms']:.4f} ms, bound "
        f"{unit_pre['bound_ms']:.5f} ms")
    return rows, serve_counts


# -- xlstm phase: multi-tenant xlstm-1.3b at full width -----------------------

XLSTM_ARCH = "xlstm-1.3b"
XLSTM_D = 12_058_464           # its LoRA task-vector size at rank 16
XLSTM_FINGERPRINT = "03df97f531d3589f"
XLSTM_B, XLSTM_PROMPT, XLSTM_NEW = 8, 512, 32
XLSTM_RAGGED = 500             # a prompt length that pads the last chunk
XLSTM_RAGGED3 = 700            # three chunks of 256, the last one ragged
# the prompt length of the bf16 token agreements and the fp32
# fused-vs-dense check (a time cut, as hymba's HYMBA_CHECK_PROMPT: the
# sLSTM loop's prefill grows with the prompt); the counted generate, the
# walls and the bf16 logit gate keep XLSTM_PROMPT
XLSTM_CHECK_PROMPT = 128
# the prompt length of the profiled prefill and decode windows (a time
# cut: the profiler's post-processing grows with the sLSTM loop's ~1,800
# ops a token, ~250 s for a 512-token prefill and ~54 s for a 128-token
# one on the card's host)
XLSTM_PROFILE_PROMPT = 32
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
    s_prof = min(XLSTM_PROFILE_PROMPT, s)
    prefill_prof = served_prefill(
        model, params, {"tokens": prompts[:, :s_prof].contiguous()}, new)
    _, _, pre_ops = profile_window(
        torch, f"xlstm prefill ({s_prof}-token prompts)",
        lambda: prefill_prof(lora))
    # the launch counts above show that the prefill ran kernel 10; this
    # window only reads its device time (none if the profiler saw none)
    k10 = {k: v for k, v in pre_ops.items() if K10_FUNCS.search(k)}
    k10_ms = sum(ms for ms, _ in k10.values())
    log(f"xlstm prefill ({s_prof}-token prompts): kernel 10 {k10_ms:.3f} ms "
        f"of device time over its "
        f"{len(k10)} device functions: " + ", ".join(
            f"{ms:.3f} ms x{calls} {re.search(r'mlstm_\w*', k).group(0)}"
            for k, (ms, calls) in k10.items()))
    decode_window(torch, f"xlstm ({s_prof}-token prompts) ", model, params,
                  lora, tok, prefill_prof(lora)[1], s_prof, 8 * n_units)

    # -- the same routed tree through the plain versions --------------------
    bf16_gate(torch, "xlstm ", logits_k, prefill(lora, mode="ref")[0],
              XLSTM_BF16_LOGIT_REL_L2)
    s_chk = min(XLSTM_CHECK_PROMPT, s)
    gen_chk = decoder_generate(prompts[:, :s_chk].contiguous(), ids, new)
    token_agreements(torch, f"xlstm ({s_chk}-token prompts) ", gen_chk,
                     model, params, store, gen_chk(model, params, store),
                     s_chk)
    del model, params, lora0, store, lora, logits_k
    torch.cuda.empty_cache()

    fp32_check(torch, dev, replace(cfg, dtype=torch.float32), server, ids,
               {"tokens": prompts[:, :s_chk].contiguous()}, gen_chk, new,
               SEED + 11, label=f"xlstm ({s_chk}-token prompts) ",
               root=("units",))
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


def round_against_plain(torch, server, packed, label=""):
    """A packed round re-run through the kernels and through their plain
    versions: τ̂, α_num, S, task vectors, downlink bits and λ equal.
    Returns the kernels' task vectors."""
    d = packed.d
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
        check_equal(torch, f"{label}round at d={d} {f}", got[f], want[f])
    on_host = packed.slot_valid.cpu()
    check_equal(torch, f"{label}round at d={d} downlink words",
                got["down_masks"][on_host], want["down_masks"][on_host])
    check_equal(torch, f"{label}round at d={d} downlink lambda",
                got["down_lams"][on_host], want["down_lams"][on_host])
    check_equal(torch, f"{label}round at d={d} downlink bf16 bits",
                bf16_bits(torch, got["down_unified"]),
                bf16_bits(torch, want["down_unified"]))
    return tvs


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
    tvs = round_against_plain(torch, server, packed)
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
        f"{mm_pre['plain_ms']:.4f} ms, product alone "
        f"{mm_pre['product_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
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
        f"product alone {mm_enc['product_ms']:.4f} ms, bound "
        f"{mm_enc['bound_ms']:.5f} ms; decoder decode (10 launches, "
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
        f"{mm_pre['plain_ms']:.4f} ms, product alone "
        f"{mm_pre['product_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
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
        f"{mm_pre['plain_ms']:.4f} ms, product alone "
        f"{mm_pre['product_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
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
        f"{mm_pre['plain_ms']:.4f} ms, product alone "
        f"{mm_pre['product_ms']:.4f} ms, bound {mm_pre['bound_ms']:.5f} ms")
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


def mm_prefill_layers(torch, dev):
    """Kernel 9 alone at every served model's factor shapes, S = 1 and
    the model's prompt S (``serve_kernel_checks``' checks), and each
    model's prefill layer summed from them: a quick loop for a kernel-9
    change.  Returns {model: that layer's numbers}."""
    from repro_torch.configs.base import load_arch
    frames = load_arch(WHISPER_ARCH).enc_frames
    layers = {"qwen2": (LAYER_MIX, SERVE_PROMPT),
              "xlstm": (XLSTM_UNIT_MIX, XLSTM_PROMPT),
              "granite": (GRANITE_LAYER_MIX, GRANITE_PROMPT),
              "whisper_encoder": (WHISPER_ENC_MIX, frames),
              "hymba": (HYMBA_LAYER_MIX, HYMBA_PROMPT),
              "vlm": (VLM_LAYER_MIX, VLM_GRID[0] * VLM_GRID[1] + VLM_PROMPT),
              "deepseek": (DS_LAYER_MIX, DS_PROMPT)}
    seqs = {}
    for mix, s in layers.values():
        for kn in mix:
            seqs.setdefault(kn, {1}).add(s)
    per = serve_kernel_checks(torch, dev, [(kn, tuple(sorted(ss)), True)
                                           for kn, ss in sorted(seqs.items())])
    out = {}
    for name, (mix, s) in layers.items():
        out[name] = row = mm_row(per, s, mix)
        log(f"modulated_matmul per {name} prefill layer ({sum(mix.values())}"
            f" launches, S={s}, bf16 tau): device {row['device_ms']:.4f} ms "
            f"({row['ms']:.4f} ms of calls), plain {row['plain_ms']:.4f} ms, "
            f"product alone {row['product_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms")
    return out


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
    card = setup(torch)
    if sys.argv[1:] == ["--only", "round"]:
        # kernels 1-3 at the full-width round and the whole-round gates
        # alone: a quick loop for a round-kernel change; no summary, no
        # "ok" line
        log("== kernel phase alone ==")
        rows = kernel_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(rows), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "mix"]:
        # Eq. 7's product as one GEMM against MIX_BLOCK-wide blocks, and
        # the round phase under each; no summary, no "ok" line
        log("== Eq. 7's product: one GEMM against blocks ==")
        out = mix_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
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
    if sys.argv[1:] == ["--only", "mm"]:
        # kernel 9's checks and timings alone at every served shape: a
        # quick loop for a kernel-9 change; no summary, no "ok" line
        log("== kernel 9 alone ==")
        out = mm_prefill_layers(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "xlstm"]:
        # the xlstm phase alone (kernel 10's checks, then serving
        # xlstm-1.3b at full width); no summary, no "ok" line
        log("== xlstm phase alone ==")
        row, counts, wide = xlstm_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"row": row, "launches": counts, "wide": wide},
                         default=str), flush=True)
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
    if sys.argv[1:] == ["--only", "async"]:
        # the async phase alone: a quick loop for the async rounds, the
        # deferred drain and the host pipeline; no summary, no "ok" line
        log("== async phase alone ==")
        out = async_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "population"]:
        # the population phase alone: a quick loop for the chunked round,
        # the chunked strategy and the population simulator; no summary,
        # no "ok" line
        log("== population phase alone ==")
        out = population_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "shard"]:
        # the shard phase alone: a quick loop for the taskvec-sharded
        # round; no summary, no "ok" line
        log("== shard phase alone ==")
        out = shard_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({k: v for k, v in out.items() if k != "ranks"}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--only", "tp"]:
        # the tp phase alone: a quick loop for model-parallel training and
        # the launcher; no summary, no "ok" line
        log("== tp phase alone ==")
        out = tp_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({k: v for k, v in out.items() if k != "ranks"}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--only", "lmtrain"]:
        # the lmtrain phase alone: a quick loop for the LM training path;
        # no summary, no "ok" line
        log("== lmtrain phase alone ==")
        out = lmtrain_phase(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "examples"]:
        # the examples phase alone: the federated-LM and serving examples
        # at full width; no summary, no "ok" line
        log("== examples phase alone ==")
        out = examples_phase(torch, dev, card)
        log(f"total {time.perf_counter() - t_start:.1f} s ({card})")
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; takes none, "
              f"--only round, --only bool, --only devtime, --only mlstm, "
              f"--only granite, --only whisper, --only hymba, --only vlm, "
              f"--only deepseek, --only vit, --only baselines, --only "
              f"lmtrain, --only examples, --only async, --only population, "
              f"--only shard, --only tp, --only xlstm or --only mix",
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
    setting = base_setting(torch, dev)
    base = baselines_phase(torch, dev, setting=setting)
    phase("lmtrain")
    lmtrain = lmtrain_phase(torch, dev)
    phase("examples")
    ex = examples_phase(torch, dev, card)
    phase("async")
    asy = async_phase(torch, dev, setting=setting)
    del setting
    phase("population")
    pop = population_phase(torch, dev)
    phase("shard")
    shard = shard_phase(torch, dev)
    phase("tp")
    tp = tp_phase(torch, dev)
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
            baselines_launches=base["launches"][name],
            async_launches=asy["launches"][name])
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
                                 " in the deepseek generate, "
                                 f"{ex['launches']['modulated_matmul']} in "
                                 "the examples phase's three fused "
                                 "qwen2.5-3b fp32 generates)",
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
            path=paths.get(name, "packed round (round phase, 3 rounds; "
                           f"{asy['launches'][name]} more in the async "
                           "phase's rounds, "
                           f"{pop['launches'].get(name, 0)} in the "
                           "population phase's, "
                           f"{shard['launches'].get(name, 0)} in the shard "
                           f"phase's {SHARD_RANKS} ranks, "
                           f"{tp['launches'].get(name, 0)} in the tp "
                           "phase's launcher fed run, "
                           f"{ex['launches'].get(name, 0)} in the examples "
                           "phase's codeqwen1.5-7b and qwen2.5-3b rounds)"
                           if name in rows else
                           "bool round (bool phase, 1 round; "
                           f"{asy['launches'][name]} more in the async "
                           "phase's bool stream, "
                           f"{pop['launches'].get(name, 0)} in the "
                           "population phase's chunked rounds, "
                           f"{shard['launches'].get(name, 0)} in the shard "
                           f"phase's {SHARD_RANKS} ranks)"),
            shard_launches=shard["launches"].get(name, 0),
            tp_launches=tp["launches"].get(name, 0),
            examples_launches=ex["launches"].get(name, 0),
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
    log(f"total {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
