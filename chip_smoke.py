#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

Phases, each of which fails the script on error:
  1. build: nvcc compiles ``src/repro_torch/csrc/*.cu`` (``qsgd.cu``,
     ``fused_encode.cu``, ``flash_decode.cu`` and ``elias.cu``) for sm_90a
     into ``build/`` (one nvcc per source, all started together);
  2. kernels vs plain: every QSGD kernel against its plain PyTorch version
     on the card.  K1-K3 at the main paths' shapes (10 and 1 rows of
     D = 101,770 for GenQSGD, of d' = 2^17 for GQFedWAvg) and at a
     streaming size (n = 2^24), for s in {7, 127, 16384}: K2 bitwise given
     the same inv, K1's norm within rtol 1e-6, K3 bitwise, on its vector
     branch and, for row 1 of a (10, 101,770) level matrix (8 bytes off
     x's alignment in int32, 2 in int8), on its scalar branch.  K4 at rows
     {1, 10} x n in K4_NS (1 .. 2^22, odd and ragged lengths and every
     length the payload path gives it) and K5 at rows {1, 10} x d in K5_DS
     (2 .. 2^15, over every change of its cluster size) x seeds
     {0, 5, 2^32-1}, each at s = 7 packed and s = 127 unpacked: the norm
     within rtol 1e-6, the payload byte-identical to the plain quantize
     (+ pack) fed the kernel's own norm, K1's norm bitwise K4's, K5's
     rotated rows bitwise the plain rotate; K4's two routes (one
     cooperative launch, two launches) bitwise each other at (10, D) and
     (1, 2^17) and on row 1 of a (10, D + 1) matrix (an odd head) with u
     in y's phase and in another, a captured K4 replayed twice with the
     same bytes and a fresh exchange generation each; K5 through
     ``encode_payload`` with u 4 bytes past a 16-byte boundary; launches
     the card refuses (K5 at d = 2^16 asks for a cluster of 16 blocks,
     above the portable 8; K4 in one cooperative launch of more blocks
     than the card holds at once) raise and leave no error behind.  Then
     each kernel's time
     beside its plain version's, its byte bound and a one-call PyTorch
     yardstick where one exists (device times from CUDA-graph replay,
     beside the eager call's time with its host work).  For QSGD
     bucketing: K1/K2 on bucket rows (250 x 4096 and 25 x 4096, the
     bucketed quickstart's worker and server rows; 127,220 x 8, above one
     grid: two launches each), K2 bitwise and K1's norm within rtol 1e-6;
     K3b (one norm per bucket) at D for q in {8, 4095, 4096, D, 2^20}
     bitwise its plain version on both branches and bitwise K3 at q >= D;
     K4 over the bucket rows of ten deltas at q in {8, 4095, 4096}, the
     flat int4 payload byte-identical to the plain quantize + flat pack
     given the kernel's norms.  ``elias_decode`` (three launches: a
     parallel split-point decode) on ELIAS_CASES: QSGD streams at d in
     {1,000, D} x s in {7, 127} and (10, D) at s = 127, streams built to
     stress it (every level +-127, a run of +1s to the end, d = 1, a gap
     of 2^20 + 2, patterns), random words and a cut stream: the levels
     bitwise the host's plain walk (and the input), its malformed-row
     counter 0 on encoder streams and above 0 on the random words.  Each
     timed beside its bytes bound;
  3. main path: the README quickstart loop on the card (the task on
     ``cuda:0``, the run on the default ``"cuda"``; and the converse for
     one round) —
     ``MNISTTask.estimate_constants`` -> ``Scenario.optimize()`` ->
     ``Scenario.run(plan, max_rounds=400)`` at full width (D = 101,770,
     N = 10, s0 = sn = 2^14) — with the kernels' launch counters set to 0
     just before the run and read just after; one round on the card is
     also held against the same round on the CPU (plain versions) with the
     same draws, and 20 rounds are profiled (device time by kernel, the
     device's busy share); then the bucketed quickstart, the same loop on
     the system with ``q_dim = 4096`` (25 buckets of D), counters read
     around ``run(plan, max_rounds=400)`` (K1/K2 800, K3b 400, K3 and every
     plain version 0), comm bits ``rounds * (sum M_sn + M_s0)`` at the
     bucketed wire's bits, one round on the card against the CPU, the
     bucketed and the whole-message round timed in turns (6 pairs of 40
     rounds on the same draws), 20 rounds profiled;
  4. the batched and fused GIA solver (``phase_sweep``) at phase 3's
     constants and system (N = 10, D = 101,770), with every kernel's
     launch counter read as 0 around it: opt_bench.py's 1,024-point
     one-signature grid (Gen-C, 32 C_max over linspace(0.2, 0.6) x 32
     gamma over geomspace(0.004, 0.02)) through ``sweep_scenarios(...,
     backend="torch-fused")`` cold and warm — exactly one CUDA-graph
     capture for the signature over both passes, warm rows equal to the
     cold ones, warm solves/s, chunks replayed and host syncs — a 16-point
     evenly spaced subsample against ``backend="numpy"`` (s a point) by
     the Plan targets of ``tests/test_torch_solver.py``; the baseline
     table of table_baselines.py (its column list and -fix presets
     copied here): the 13 -opt columns as one heterogeneous sweep with
     ``parallel=True``, equal to a serial sweep's rows and to the NumPy
     sweep's, the 9 -fix columns through ``min_feasible_K0``, and its 9
     claims, all passing; 5 rows padded to 8 bitwise the unpadded rows,
     and the same rows through ``backend="torch"`` (the batched GP solve
     a GIA iteration) within the Plan targets of the NumPy solver.  Then
     PlanServer (``phase_planserver``) at the same constants and system:
     serve_bench.py's full trace (its build_trace copied here: Gen-C,
     Gen-E, Gen-D, Gen-O x 8 budgets over linspace(0.22, 0.45), 480
     requests, the tail half exact repeats and half budgets jittered by
     up to 0.2 %, Poisson arrivals at 400/s, open-loop with a barrier
     after the 32 cold requests) through ``PlanServer(max_batch=16,
     window_s=0.02)`` on the card — at most one capture a signature
     (m=J's companion program counted apart), every handle resolved,
     each hit's Plan equal to its filler's, the 32 cold rows within the
     Plan targets of the NumPy server's rows and 16 evenly spaced warm
     rows (converged) of their own NumPy solve from the same seed, the
     stats' counts; solves/s, the hit rate, per-source p50/p99/mean
     latency, queue waits, batches, a cold and a warm batch's chunks and
     device ms a replayed chunk — then the first 128 requests through
     ``PlanServer(backend="numpy")``; a wrong-shape warm seed in a queued
     batch of three healthy rows (bisected, quarantined, poisoned; the
     healthy Plans equal their solo solves; no capture added; a
     synchronize raises nothing); an error and a host read inside a
     capture, each leaving the caller's stream, no shape, no count and
     free locks, the next call capturing afresh, bitwise; a program
     captured on this thread and
     replayed by the dispatcher, rows bitwise; a first capture (FA-C-opt)
     in the dispatcher while this thread runs 50 quickstart rounds, the
     rounds bitwise a solo run.  Kernel counters read 0 around the
     server's work;
  5. sampling and faults on the same task and constants:
     ``Scenario(..., T_max=2e5, sampling=uniform(8), faults=edge_faults(
     stragglers 0.3 x 4, crashes 0.05 for 3 rounds, corruption 0.01,
     slack 1.5, adaptive deadline)).optimize()`` -> ``run(plan,
     max_rounds=400, seed=0)`` with the counters read around it (K1/K2 800,
     K3 400: all N workers still train and encode); comm bits the sum of
     ``cohort_round_bits`` over the cohorts; the cohorts and the
     ``FaultTrace`` equal to a host replay of the seed (fresh
     ``default_rng(0)`` and ``FaultDriver`` on ``fault_rng(0)``), some round
     degraded, the adaptive deadline moving; a model that learned; a
     400-row ``report.drift()``.  One sampled and faulted round (the
     replay's weights of the round that drops the most workers) on the card
     against the CPU; 50 rounds with obs on against obs off (equal traces,
     bits and costs; the model bitwise equal where the card repeats runs
     bitwise, else within two server levels; the ledger written only with
     obs on); a 20-round ``run`` profiled;
  6. the GQFedWAvg closed loop at the same width:
     ``Scenario(..., family="gqfedwavg").optimize()`` (rotated codec,
     d' = 2^17) -> ``run(plan, max_rounds=100)``, counters read as in 3;
     one round with unequal weights and beta = 0.9 on the card against the
     CPU; 20 rounds profiled;
  7. the payload entry point: ``make_codec(s, wire, kind, backend="cuda")
     .encode_payload`` -> ``decode_payload`` for kind {qsgd, rotated} x
     (wire, s) {(int4, 7), (int8, 127)} over the 10 worker deltas of a
     phase-5 round and 1-D messages of 1,000 .. 2^22 coordinates, with the
     counters read around the payload calls alone; each payload is held
     against the plain versions on the same y and u (the norm within
     rtol 1e-6, the bytes identical given the kernel's norm) and against
     ``decode(*encode(y, u))``; K4's calls by route are logged, at least
     one of them in one launch.  Then bucket 4096 on the int4, int8 and
     packed wires, and wire "elias" at s in {7, 127} with and without
     buckets (the elias streams decoded by ``elias_decode``), each held
     against the plain versions and ``decode(*encode(y, u))``;
  8. flash decode (K6) against its plain version on the card, within
     rtol/atol 1e-5 (both accumulate in f32; a bf16 output within one bf16
     ulp), at qwen3-1.7b's serving shape (8 slots x 4096 positions, 8 kv
     heads, G = 2, dh = 128) over bf16 and f32 caches, a gemma3-width
     shape (dh 256, 4 kv heads) under a 1024-token window mask, G in
     {1, 7, 16}, dh 64, ragged C (1000, 777, 3001), C in {1, 5, 9} (fewer
     positions than splits of the cache), one valid token, an all-masked
     row and a row valid only inside one block's range; olmoe-1b-7b's
     serving shape (16 kv heads, G = 1) and zamba2-2.7b's (32 kv heads,
     G = 1, dh 80), and at dh 80 bf16 and f32 caches, ragged C, one valid
     token, an all-masked row, C in {5, 9}, one split, G = 8 and 16;
     qwen2-vl-7b's serving shape (4 kv heads, G = 7) and G = 3 at dh 64
     (mistral-large-smoke's grouping); whisper-tiny's two decode shapes
     (6 kv heads, G = 1, dh 64, 1,500 positions): its self-attention over
     the bf16 cache and its cross-attention over f32 K/V of the encoder
     frames, every frame valid; each shape called twice, the
     outputs bitwise equal; q (serving shape) and q, k, v (G = 7 ragged)
     one element past a 16-byte boundary, bitwise the aligned call.  Then
     its time at the serving, the gemma3-width, the G = 16, the olmoe, the
     zamba2, the qwen2-vl and both whisper shapes beside its byte bound,
     its plain version and ``scaled_dot_product_attention`` (no mask where
     every entry is valid), with the blocks the card keeps resident; each
     timed over input sets taken in turn that together span 4 x L2;
  9. the LM serving path: ``ServeEngine(params, qwen3-1.7b, slots=8,
     max_len=4096)`` at full width (28 layers, d_model 2048, vocab
     151,936; f32 weights from ``lm.init_params`` with a seeded generator,
     bf16 cache) serves 16 requests (prompts of 256-2048 tokens, 32 new
     tokens each, greedy) through ``run``, with the counters set to 0 just
     before and read just after: K6 launches once per layer per decode
     step, nothing else launches; prints prefill ms per request, ms per
     decode step, tokens/s and, over 10 profiled decode steps, K6's share
     of device time (one K6 kernel, launched 28 times a step, and no
     combine kernel) and the device's busy share.  The same model cut to 2
     layers then prefills a 64-token prompt and decodes 4 tokens on the
     card and on the CPU (plain versions) with the same weights: logits
     within 1e-3 and equal greedy tokens over an f32 cache, logits within
     3e-2 over the bf16 cache.  Then the same protocol for olmoe-1b-7b
     (16 layers, 64 experts top-8, 6,816,073,728 parameters; K6 16
     launches a step; the profile adds the router's, the dispatch's, the
     expert products' and the combine's device time; its 2-layer cut
     also holds the routing equal over the f32 cache) and zamba2-2.7b
     (54 layers: 45 mamba2 and 9 shared_attn, dh 80; K6 9 launches a
     step, the profile adds the mamba2 decodes' device time; its cut is
     6 layers, 5 mamba2 and 1 shared_attn), qwen2-vl-7b (28 layers, 28
     query heads over 4 kv heads, 7,070,490,112 parameters; requests
     admitted with zero patch embeddings over a quarter of the prompt and
     equal M-RoPE streams; K6 28 launches a step at G = 7; its 2-layer
     cut checks a prompt with random patch embeddings and unequal
     streams) and xlstm-1.3b (48 layers: 42 mLSTM and 6 sLSTM,
     3,468,498,944 parameters, an f32 state of 5.64 GB at 8 slots; K6
     never launches; the profile adds the mLSTM and sLSTM decodes' device
     time; one mLSTM and one sLSTM layer timed on a 2,047-token prefill;
     its cut is 8 layers, 7 mLSTM and 1 sLSTM, and also checks a
     512-token prompt, whose mLSTM layers run the chunked form) and
     whisper-tiny (4 encoder and 4 decoder layers, d_model 384, vocab
     51,865, 41,158,272 parameters; its own shape, within its 448-token
     decoder context: max_len 1,500 = max_source_positions, prompts of
     4-224 tokens, 32 new; requests admitted with zero frames (1, 1500,
     384) as ``repro``'s engine admits them; K6 8 launches a
     step, the self-attention over the bf16 cache and the cross-attention
     over f32 K/V recomputed from the encoder states each step, two
     kernel instances; the profile adds the cross K/V products' device
     time, ``whisper.cross_kv``; its check runs the whole model, random
     frames from the seed), each with its peak device memory;
 10. LM training through the federated GenQSGD round (``phase_spmd``):
     (a) ``loss_train`` and its gradients at qwen3-smoke and gemma3-smoke
     (window mask), olmoe-smoke and phi35-moe-smoke (the MoE MLP and its
     aux loss), zamba2-smoke, xlstm-smoke, qwen2-vl-smoke (patch
     embeddings, unequal M-RoPE streams) and whisper-smoke (bf16 frames
     of min(F, S) rows, as ``repro``'s launcher declares them: at f32
     they promote to f32) on the card against
     the same
     code on the CPU, f32 with TF32 off (loss and every gradient leaf
     within 1e-5, 5e-5 for zamba2's SSM sums, 1e-4 for xlstm's, routing
     equal) and under the bf16 view
     (loss 1e-3, leaves 4e-2 normwise; the tokens whose routing moved are
     printed); (b) qwen3-1.7b as
     published (28 layers, 1,720,574,976 parameters in 13 leaves, random
     f32 weights from a seed), fl = 2 workers with Kn = (1, 2) on B = 2 x
     S = 1,024 uniform tokens drawn on the card (two loss chunks), s0 =
     sn = 7, 2 rounds: each round's workers trained once (``local_train``,
     bf16 view) and that one set of params aggregated through the f32,
     int8, int4 and rs_ag wires (``aggregate_apply``), x_hat' bitwise
     across the wires; counters read around the rounds (K1/K2 26 and K3
     13 an aggregate, every plain version 0), comm bits exactly rounds x
     ``round_comm_bits`` = rounds x (fl + 1) messages of the wire's
     format; then K1/K2/K3 and ``uniform_like`` on the largest leaf
     against their plain versions and the CPU, ms a round split into
     local train and aggregate, peak device memory, one more round
     profiled (busy share); (c) qwen3-smoke, one round aggregated through
     f32 and elias (s0 = 7, sn = (5, 7)) and bucketed f32 and int8
     (bucket 4096): elias bitwise f32 (``elias_decode`` twice), bucketed
     int8 within 1e-6 (K3b), each aggregate within 1 level flip in 10^4
     of the CPU's from the same trained params; (d)
     ``Scenario.run(plan, task=SpmdTask(...), backend="spmd",
     wire="int8")`` for genqsgd and gqfedwavg (comm bits, measured E and
     T as ``tests/integration/test_spmd_report.py``) and a sampled (S = 1
     of 2) and faulted run whose FaultTrace and cohort bits equal the
     CPU's; (e) one round at olmoe-smoke, zamba2-smoke, xlstm-smoke and
     qwen2-vl-smoke (``microbatch`` 2: positions3 split on its batch axis
     on the card) and whisper-smoke, trained once and aggregated through
     the f32 and int8 wires (s0 = sn = 7): x̂' bitwise across the wires,
     K1/K2 2 and K3 1 launches a leaf an aggregate and no plain version,
     comm bits = ``round_comm_bits``;
 11. whisper-tiny as published (41,158,272 parameters in 26 leaves)
     through 10 (b)'s protocol, with bf16 frames (2, 1024, 384) a step
     from the seed (min(F, S) rows, as ``repro``'s launcher declares
     them), one round through the f32 and the int8 wire: x̂' bitwise
     across them, K1/K2 104 and K3 52 launches, ms a round, busy share,
     peak memory;
 12. the command lines (``phase_launch``): (a) the training launcher,
     ``repro_torch.launch.train.main`` in-process with LAUNCH_ARGV
     (qwen3-1.7b as published, 1,720,574,976 parameters in 13 leaves, fl
     = 2, Kn = (1, 1), B 2 x S 1,024 of the Markov tokens, the int8 wire
     at s = 64, 2 rounds) and ``--device cuda``, the counters read around
     it: K1/K2 2 and K3 1 launches a leaf a round, exactly (as 10 (b)
     reckons the int8 wire), no plain version, every loss finite and
     ``[train] done`` printed; the wall per round, peak device memory and
     the f32 parameter bytes ``abstract_params`` reckons; (b) the four
     ``examples/torch`` twins in-process (``runpy``, ``sys.argv`` set) at
     their defaults on the card, each final line checked and the
     counters read around each: serve_decode launches K6 once per
     attention layer per decode step and nothing else, quickstart K1-K3
     (400 rounds), train_lm_federated K1/K2 2 and K3 1 a leaf a round
     (20 rounds), optimize_parameters solves through the fused engine on
     the card (the step-program cache consulted) and launches no kernel;
     no plain version anywhere.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
MAIN_D = 784 * 128 + 128 + 128 * 10 + 10
STREAM_N = 1 << 24
S_VALUES = (7, 127, 16384)
FP32_OPS_PER_SM = FP32_OPS_PER_S / 132
#: K1-K3's check shapes (rows, n): GenQSGD's (10 worker deltas and the
#: server's), GQFedWAvg's at d' = 2^17, and the streaming size
K1_SHAPES = ((10, MAIN_D), (1, MAIN_D), (10, 1 << 17), (1, 1 << 17),
             (1, STREAM_N))
#: K1-K3's timed shapes
K1_TIMED = ((10, MAIN_D), (1, MAIN_D), (1, STREAM_N))
PAYLOAD_NS = (1000, 1 << 15, (1 << 15) + 1, 1 << 16, 1 << 20, 1 << 22)
#: K4's check lengths: odd and ragged ones, D, the rotated worker deltas'
#: 2^17 and every length the payload phase gives K4 (its messages and
#: their pow2 pads above K5's 2^15)
K4_NS = tuple(sorted({1, 2, 127, 2049, MAIN_D, (1 << 16) + 3, 1 << 17,
                      *PAYLOAD_NS, 1 << 16}))
K5_DS = (2, 64, 1024, 1 << 12, 1 << 13, 1 << 14, 1 << 15)
K5_SEEDS = (0, 5, 2**32 - 1)
FUSED_S = ((7, True), (127, False))          # (s, pack)
#: GQFedWAvg with unequal aggregation weights and heavy momentum, for the
#: card-vs-CPU round of phase 5
SMOKE_WEIGHTS = (4, 4, 2, 2, 1, 1, 1, 1, 1, 1)
SMOKE_MOMENTUM = 0.9
#: phase 4's sampled and faulted loop: a cohort of 8 of the 10 workers a
#: round and an edge fleet behind an adaptive deadline (T_max = 2e5 s)
SAMPLED_S = 8
SAMPLED_FAULTS = dict(straggler_prob=0.3, straggler_factor=4.0,
                      crash_prob=0.05, crash_rounds=3, corrupt_prob=0.01,
                      deadline_slack=1.5, deadline="adaptive")
SAMPLED_ROUNDS = 400
#: phase 5's GQFedWAvg rounds, short enough to keep the whole script near
#: its time budget
WAVG_ROUNDS = 100
#: QSGD bucketing: the quickstart system with q_dim = 4096 (25 buckets of
#: D, the last holding 3,466 coordinates)
BUCKET = 4096
#: K1/K2 on bucket rows (rows, q): the bucketed quickstart's worker and
#: server rows, and q = 8 over ten deltas (127,220 rows, above one grid)
BUCKET_K1_SHAPES = ((10 * 25, BUCKET), (25, BUCKET), (10 * 12722, 8))
#: K3b's bucket lengths at D (q >= D is one bucket: K3's bytes) and K4's
#: over bucket rows of ten deltas (odd, even, and 127,220 rows)
K3B_QS = (8, 4095, BUCKET, MAIN_D, 1 << 20)
K4_BUCKET_QS = (8, 4095, BUCKET)
BUCKETED_ROUNDS = 400
#: elias_decode's check streams (kind, shape, s): QSGD levels from the
#: quantizer at s; the CPU test's adversarial streams: every level +-127 (a
#: triple a coordinate, triples across every chunk edge; also at 850,000,
#: whose last word is read by the table block's last, partial warp), a run
#: of +1s to the end (the closed-form tail) and one in the middle (zero
#: bits, where walks from offsets 3 apart never meet), d = 1, one level at
#: d - 1 of 2^20 + 3 (a 2^20 + 2 gap codeword), its PATTERNS at D; eight
#: rows of random words (malformed: the sequential walk) and a QSGD stream
#: cut inside the stream (decoded as the walk decodes it).  The host's
#: plain walk checks each.
ELIAS_CASES = (("qsgd", (1000,), 7), ("qsgd", (1000,), 127),
               ("qsgd", (MAIN_D,), 7), ("qsgd", (MAIN_D,), 127),
               ("qsgd", (10, MAIN_D), 127), ("all-127", (MAIN_D,), None),
               ("all-127", (850_000,), None), ("ones-tail", (MAIN_D,), None),
               ("ones-run", (MAIN_D,), None), ("d=1", (2, 1), None),
               ("long-gap", ((1 << 20) + 3,), None),
               ("zeros", (MAIN_D,), None), ("dense", (MAIN_D,), None),
               ("sparse", (MAIN_D,), None), ("ends", (MAIN_D,), None),
               ("boundary", (MAIN_D,), None), ("random", (8, MAIN_D), None),
               ("truncated", (MAIN_D,), 127))
#: elias_decode's timed streams, (D,) at s = 127 the JSON line's row
ELIAS_TIMED = (((MAIN_D,), 7), ((MAIN_D,), 127), ((10, MAIN_D), 127))
ELIAS_NS = (1000, (1 << 15) + 1, MAIN_D)
#: the serving run of phase 8: qwen3-1.7b at full width, 8 slots of 4096
#: positions, 16 requests of 256-2048 prompt tokens and 32 new tokens
#: phase_sweep: opt_bench.py's one-signature grid (Gen-C over C_max in
#: linspace(0.2, 0.6, 32) x gamma in geomspace(0.004, 0.02, 32)), a subsample
#: of it against the NumPy solver, and table_baselines.py's columns (the
#: Sec.-VII step rules and I_n of benchmarks/common.py, copied here: the
#: script imports nothing from benchmarks/)
SWEEP_CMAX = (0.2, 0.6, 32)
SWEEP_GAMMA = (0.004, 0.02, 32)
SWEEP_SUBSAMPLE = 16
TABLE_STEPS = {"C": dict(gamma=0.01), "E": dict(gamma=0.02, rho=0.9995),
               "D": dict(gamma=0.02, rho=600.0)}
TABLE_I_N = 6000.0
TABLE_FAMILY = {"Gen": "genqsgd", "PM": "pm", "FA": "fa", "PR": "pr"}
TABLE_ALGOS = (["Gen-C", "Gen-E", "Gen-D", "Gen-O"]
               + [f"{a}-{m}-{x}" for a in ("PM", "FA", "PR")
                  for m in ("C", "E", "D") for x in ("opt", "fix")])
#: the -fix columns' preset (Kn, B): PM Kn=1 B=32, FA l=1 (Kn=I_n/B) B=600,
#: PR Kn=4 B=1, each on the free-variable Gen problem of its m
TABLE_FIX = {"PM": (1, 32), "FA": (TABLE_I_N / 600.0, 600), "PR": (4, 1)}
PAD_ROWS, PAD_TO = 5, 8
#: phase_planserver: serve_bench.py's FULL request trace (its build_trace is
#: copied into plan_trace; the script imports nothing from benchmarks/):
#: four signatures, 8 budgets each over linspace(0.22, 0.45) (32 cold
#: requests), 480 requests in all, Poisson arrivals at 400/s, PlanServer(
#: max_batch=16, window_s=0.02)
PLAN_TRACE = dict(algos=("Gen-C", "Gen-E", "Gen-D", "Gen-O"), n_unique=8,
                  n_total=480, rate_per_s=400.0, max_batch=16,
                  window_s=0.02)
#: the NumPy server's share of the trace (its first requests), where the
#: whole trace would take it more than ~60 s
PLAN_NUMPY_REQUESTS = 128
#: sampled warm rows held against their own NumPy solve; training rounds
#: run beside a first capture; rows solved across threads
PLAN_WARM_CHECKS = 16
PLAN_TRAIN_ROUNDS = 50
PLAN_THREAD_ROWS = 5
SERVE_ARCH = "qwen3-1.7b"
#: phase 10: the federated round at full width — fl workers with Kn local
#: steps (the shorter worker's second step virtual) on B x S tokens, s0 =
#: sn = SPMD_S_Q, every wire of SPMD_WIRES for SPMD_ROUNDS rounds
SPMD_ARCH = "qwen3-1.7b"
SPMD_FL, SPMD_KN, SPMD_B, SPMD_S, SPMD_S_Q = 2, (1, 2), 2, 1024, 7
SPMD_WIRES = ("f32", "int8", "int4", "rs_ag")
#: (a)'s smoke configs, and (e)'s: one round each through the f32 and
#: int8 wires
SPMD_LOSS_ARCHS = ("qwen3-1.7b", "gemma3-4b", "olmoe-1b-7b",
                   "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "xlstm-1.3b",
                   "qwen2-vl-7b", "whisper-tiny")
SPMD_FAMILY_ARCHS = ("olmoe-1b-7b", "zamba2-2.7b", "xlstm-1.3b",
                     "qwen2-vl-7b", "whisper-tiny")
#: phase 11: whisper-tiny at full width, one round through the f32 and the
#: int8 wire
SPMD_AUDIO_ARCH = "whisper-tiny"
#: (e)'s micro-batch splits a step, by arch (qwen2-vl's positions3 is then
#: split on its batch axis on the card)
SPMD_MICROBATCH = {"qwen2-vl-7b": 2}
SPMD_ROUNDS = 2
SPMD_GAMMA = 0.01
#: phase 12: the training launcher at qwen3-1.7b's full width, in-process
#: as ``python -m repro_torch.launch.train`` with these arguments and
#: ``--device``, then the example twins at their defaults
LAUNCH_ARGV = ("--arch", "qwen3-1.7b", "--rounds", "2", "--fl", "2",
               "--k-local", "1", "--batch", "2", "--seq", "1024",
               "--wire", "int8")
EXAMPLES = ("serve_decode", "quickstart", "train_lm_federated",
            "optimize_parameters")
#: the MoE, hybrid, VLM, xLSTM and audio serving paths (phase 9 again),
#: each with the depth of its card-against-CPU check (xlstm's 8: 7 mLSTM,
#: 1 sLSTM; whisper-tiny's 4, its whole decoder over its 4-layer encoder)
SERVE_FAMILIES = (("olmoe-1b-7b", 2), ("zamba2-2.7b", 6), ("qwen2-vl-7b", 2),
                  ("xlstm-1.3b", 8), ("whisper-tiny", 4))
#: the check's prompt lengths: 64 tokens; at a config with mLSTM layers
#: also 512 (two chunks of 256: the chunked form runs on the card), held
#: within SERVE_XLSTM_TOL and beside the same cut with float64 weights on
#: the card (the mixers' gates and states stay f32, as the reference casts
#: them): at the xlstm-1.3b cut the card and the CPU lay 1.8e-3 apart in
#: f32 (H100 80GB HBM3, 700 W), above the 1e-3 of the other checks
SERVE_CHECK_PROMPTS = (64, 512)
SERVE_XLSTM_TOL = 5e-3
SERVE_SLOTS, SERVE_MAX_LEN = 8, 4096
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 16, (256, 2048), 32
#: an arch's own (max_len, prompt lengths, new tokens) where the uniform
#: shape above does not fit the model.  whisper-tiny's decoder context is
#: n_text_ctx = 448 tokens (Whisper, arXiv:2212.04356, the released model
#: dimensions), and its decoder takes at most half of it as a prompt of
#: earlier text: prompts of 4-224 tokens and 32 new fit 448.  Its max_len
#: is max_source_positions, 1,500, the least an encoder-decoder engine
#: takes (the encoder leaf holds min(F, max_len) rows), so the
#: self-attention cache holds 1,500 positions
SERVE_SHAPES = {"whisper-tiny": (1500, (4, 224), 32)}
#: K6's check shapes (name, B, C, KV, G, dh, q type, cache type, mask):
#: the serving shape first; masks "prefix" (a random length valid per row,
#: as a cache filled from position 0), "prefix448" (the same, at most 448
#: valid: whisper's decoder context), "all" (every entry valid: whisper's
#: cross-attention over its encoder states), "window" (a 1024-token band
#: before a random query position), "one" (one valid entry a row),
#: "none-row0" (row 0 fully masked, the others prefixes), "one-split" (row
#: 0 valid only inside the range of one split of the cache, the others
#: prefixes)
K6_SHAPES = (
    ("serving", 8, 4096, 8, 2, 128, "f32", "bf16", "prefix"),
    ("serving f32 cache", 8, 4096, 8, 2, 128, "f32", "f32", "prefix"),
    ("serving bf16 q", 8, 4096, 8, 2, 128, "bf16", "bf16", "prefix"),
    ("gemma3 width", 8, 4096, 4, 2, 256, "f32", "bf16", "window"),
    ("G=16", 2, 4096, 8, 16, 128, "f32", "bf16", "prefix"),
    ("G=7 ragged", 3, 1000, 4, 7, 128, "f32", "bf16", "prefix"),
    ("G=1 dh=64 ragged f32", 4, 777, 16, 1, 64, "f32", "f32", "prefix"),
    ("one valid token", 8, 4096, 8, 2, 128, "f32", "bf16", "one"),
    ("all-masked row", 8, 4096, 8, 2, 128, "f32", "bf16", "none-row0"),
    ("C=1", 2, 1, 8, 2, 128, "f32", "bf16", "prefix"),
    ("C=5 bf16 q", 2, 5, 8, 2, 128, "bf16", "bf16", "prefix"),
    ("C=9 G=16 dh=256 f32", 3, 9, 2, 16, 256, "f32", "f32", "none-row0"),
    ("one split", 8, 4096, 8, 2, 128, "f32", "bf16", "one-split"),
    ("one split ragged dh=64", 4, 3001, 4, 4, 64, "bf16", "bf16",
     "one-split"),
    # olmoe-1b-7b's serving shape (16 kv heads, G = 1, dh 128) and
    # zamba2-2.7b's (32 kv heads, G = 1, dh 80: rows of 10 or 20 16-byte
    # vectors read by 16 or 32 lanes, tiles of 24 or 12 positions)
    ("olmoe", 8, 4096, 16, 1, 128, "f32", "bf16", "prefix"),
    ("zamba2 dh=80", 8, 4096, 32, 1, 80, "f32", "bf16", "prefix"),
    ("dh=80 f32 cache ragged", 3, 1000, 4, 1, 80, "f32", "f32", "prefix"),
    ("dh=80 bf16 q ragged", 2, 777, 8, 1, 80, "bf16", "bf16", "prefix"),
    ("dh=80 one valid token", 4, 777, 8, 1, 80, "f32", "bf16", "one"),
    ("dh=80 all-masked row", 4, 1000, 8, 1, 80, "f32", "f32", "none-row0"),
    ("dh=80 C=5", 2, 5, 8, 1, 80, "f32", "bf16", "prefix"),
    ("dh=80 C=9 f32", 3, 9, 4, 1, 80, "f32", "f32", "prefix"),
    ("dh=80 one split", 4, 3001, 4, 1, 80, "f32", "bf16", "one-split"),
    ("dh=80 G=8 q in smem", 2, 1000, 4, 8, 80, "f32", "bf16", "prefix"),
    ("dh=80 G=16 f32", 2, 300, 2, 16, 80, "f32", "f32", "none-row0"),
    # qwen2-vl-7b's serving shape (4 kv heads, G = 7: the GB = 8 instance
    # with one head slot idle) and mistral-large-smoke's grouping (G = 3,
    # the GB = 4 instance, dh 64)
    ("qwen2-vl", 8, 4096, 4, 7, 128, "f32", "bf16", "prefix"),
    ("G=3 dh=64", 3, 1000, 2, 3, 64, "f32", "bf16", "prefix"),
    # whisper-tiny's two decode shapes (6 kv heads, G = 1, dh 64, the
    # engine's 1,500 positions): the self-attention over its bf16 cache
    # (prompts and new tokens within 448: a short valid prefix) and the
    # cross-attention over f32 K/V of 1,500 encoder frames (tiles of 16
    # positions, 192 a split, a ragged last split of 156)
    ("whisper self", 8, 1500, 6, 1, 64, "f32", "bf16", "prefix448"),
    ("whisper cross", 8, 1500, 6, 1, 64, "f32", "f32", "all"),
)
#: K6's timed shapes: the serving shape (the JSON line's row), two other
#: widths and the other serving paths' shapes
K6_TIMED = ("serving", "gemma3 width", "G=16", "olmoe", "zamba2 dh=80",
            "qwen2-vl", "whisper self", "whisper cross")
K6_TOL = 1e-5
#: K6's timed input sets span this many times the card's L2 together
K6_L2_SPAN = 4
K6_WINDOW = 1024
REPLACES = {
    "qsgd_sumsq": "src/repro/kernels/qsgd.py:143",
    "qsgd_quantize": "src/repro/kernels/qsgd.py:82",
    "qsgd_dequant_apply": "src/repro/kernels/qsgd.py:109",
    "fused_encode": "src/repro/kernels/qsgd.py:213",
    "fused_rotate_encode": "src/repro/kernels/qsgd.py:280",
    "flash_decode": "src/repro/kernels/flash_decode.py:81",
    # port-only kernels: no pl.pallas_call; the jnp function each replaces
    "qsgd_dequant_apply_bucketed": "src/repro/compress/backends.py:224",
    "elias_decode": "src/repro/compress/elias.py:256",
}
SOURCES = {
    "qsgd_sumsq": "src/repro_torch/csrc/qsgd.cu",
    "qsgd_quantize": "src/repro_torch/csrc/qsgd.cu",
    "qsgd_dequant_apply": "src/repro_torch/csrc/qsgd.cu",
    "fused_encode": "src/repro_torch/csrc/fused_encode.cu",
    "fused_rotate_encode": "src/repro_torch/csrc/fused_encode.cu",
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
    "qsgd_dequant_apply_bucketed": "src/repro_torch/csrc/qsgd.cu",
    "elias_decode": "src/repro_torch/csrc/elias.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(fn, reps: int = 50, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    eager calls, by CUDA events: host work (Python, allocation, launch)
    included wherever it is slower than the device."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so no host work sits between the kernels; median over
    ``trials`` replays, by CUDA events, after a warm-up.  ``fn`` may be a
    list of calls, each on its own inputs: the graph then takes them in
    turn, so inputs larger together than L2 are read from HBM."""
    import torch
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            for f in fns:
                f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(out)


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def demangle(name: str) -> str:
    """A kernel's C++ name without its argument list, where ``c++filt`` is
    found; else the mangled name."""
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True,
                         check=True).stdout.strip()
    return re.sub(r"\(.*", "", out.replace("(anonymous namespace)::", ""))


def phase_build():
    from repro_torch.kernels import build
    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        results = list(ex.map(build.build, sources))
    for name, (path, secs, out) in zip(sources, results):
        log(f"[build] {name}: {os.path.relpath(path, ROOT)} "
            f"(nvcc {secs:.2f} s)")
        # ptxas -v: "Function properties for <kernel>", then its spills,
        # then "Used N registers"
        regs, spills, func = [], [], ""
        for line in out.splitlines():
            if "Function properties for" in line:
                func = line.split("for", 1)[1].strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append((func, m.group(0)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
        if regs:
            log(f"[build]   {len(regs)} kernels, {min(regs)}-{max(regs)} "
                f"registers, {len(spills)} with spills")
        for func, what in spills:
            log(f"[build]   spills: {demangle(func)} ({what})")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import qsgd as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {k: 0.0 for k in K.LAUNCHES}
    for rows, n in K1_SHAPES:
        y = torch.randn(rows, n, generator=gen, device=dev) * 3.0
        u = torch.rand(rows, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        for s in S_VALUES:
            ss, norm, inv = K.qsgd_sumsq(y, s)
            ss_p, norm_p, inv_p = K.sumsq_plain(y, s)
            lvl = K.qsgd_quantize(y, u, inv, s)
            lvl_p = K.quantize_plain(y, u, inv, s)
            out = K.qsgd_dequant_apply(x, lvl[0], norm[:1], s, 0.05)
            out_p = K.dequant_apply_plain(x, lvl[0], norm[:1], s, 0.05)
            # row 1: another alignment phase than x's at n = D
            r1 = min(1, rows - 1)
            out1 = K.qsgd_dequant_apply(x, lvl[r1], norm[:1], s, 0.05)
            out1_p = K.dequant_apply_plain(x, lvl[r1], norm[:1], s, 0.05)
            torch.cuda.synchronize()
            torch.testing.assert_close(norm, norm_p, rtol=1e-6, atol=0)
            if not torch.equal(lvl, lvl_p):
                bad = int((lvl != lvl_p).sum())
                raise AssertionError(f"K2 levels differ from the plain "
                                     f"version at {bad} of {lvl.numel()} "
                                     f"(rows={rows} n={n} s={s})")
            if int(lvl.abs().max()) > s:
                raise AssertionError(f"K2 level above s={s}")
            for o, o_p, row in ((out, out_p, 0), (out1, out1_p, r1)):
                if not torch.equal(o.view(torch.int32), o_p.view(torch.int32)):
                    bad = (o != o_p).nonzero()
                    raise AssertionError(
                        f"K3 differs from the plain version at {len(bad)} "
                        f"of {n} (rows={rows} n={n} s={s} level row {row}, "
                        f"{k3_branch(x, lvl[row], out)} branch; first at "
                        f"{bad[:4].flatten().tolist()})")
            if n == MAIN_D:
                worst["qsgd_sumsq"] = max(worst["qsgd_sumsq"], float(
                    (norm - norm_p).abs().max()))
                worst["qsgd_dequant_apply"] = max(
                    worst["qsgd_dequant_apply"],
                    float((out - out_p).abs().max()))
            log(f"[kernels] rows={rows} n={n} s={s}: K1 norm rel err "
                f"{float(((norm - norm_p).abs() / norm_p).max()):.3g}, "
                f"K2 bitwise, K3 bitwise on level rows 0 "
                f"({k3_branch(x, lvl[0], out)}) and {r1} "
                f"({k3_branch(x, lvl[r1], out1)})")
    log("[kernels] all kernels agree with their plain versions")

    # times at the main path's shapes (s = 2^14: int32 levels) and at the
    # streaming size
    s = 16384
    rows_main = []
    for rows, n in K1_TIMED:
        y = torch.randn(rows, n, generator=gen, device=dev)
        u = torch.rand(rows, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        _, norm, inv = K.qsgd_sumsq(y, s)
        lvl = K.qsgd_quantize(y, u, inv, s)
        lvl0, norm0 = lvl[0].contiguous(), norm[:1]
        scale0 = float(norm0) / s
        e = rows * n
        calls = {
            "qsgd_sumsq": (lambda: K.qsgd_sumsq(y, s),
                           lambda: K.sumsq_plain(y, s),
                           lambda: torch.linalg.vector_norm(y, dim=-1),
                           bound_ms(4 * e + 12 * rows, 2 * e)),
            "qsgd_quantize": (lambda: K.qsgd_quantize(y, u, inv, s),
                              lambda: K.quantize_plain(y, u, inv, s),
                              None,
                              bound_ms(12 * e + 4 * rows, 6 * e)),
            "qsgd_dequant_apply": (
                lambda: K.qsgd_dequant_apply(x, lvl0, norm0, s, 0.05),
                lambda: K.dequant_apply_plain(x, lvl0, norm0, s, 0.05),
                lambda: torch.add(x, lvl0, alpha=0.05 * scale0),
                bound_ms(12 * n + 4, 3 * n)),
        }
        t = {}
        for name, (kern, plain, lib, (bnd, by)) in calls.items():
            if name == "qsgd_dequant_apply" and rows != 1:
                continue
            t[name] = (device_ms(kern), device_ms(plain),
                       None if lib is None else device_ms(lib), (bnd, by))
            ms, pl, lb, _ = t[name]
            log(f"[time] {name} rows={rows} n={n}: kernel {ms * 1e3:.2f} us "
                f"(eager call {eager_ms(kern) * 1e3:.2f} us), plain "
                f"{pl * 1e3:.2f} us, library "
                f"{'n/a' if lb is None else f'{lb * 1e3:.2f} us'}, "
                f"bound {bnd * 1e3:.2f} us ({by})")
        if (rows, n) in ((10, MAIN_D), (1, MAIN_D)):
            rows_main.append(((rows, n), t))
    # the JSON line reports each kernel at its main-path shape: K1/K2 at the
    # batched worker encode (10 x D), K3 at the server apply (D,)
    main = {}
    for (rows, n), t in rows_main:
        for name, v in t.items():
            if (name == "qsgd_dequant_apply") == (rows == 1):
                main[name] = v
    return {"worst": worst, "main": main}


def k3_branch(x, lvl, out) -> str:
    """Which branch of K3 these pointers take (the kernel's own test):
    "vector" when out and the levels share x's 16-byte phase."""
    head = ((16 - x.data_ptr() % 16) % 16) // 4
    vec = (out.data_ptr() + 4 * head) % 16 == 0 and \
        (lvl.data_ptr() + lvl.element_size() * head) % (
            4 * lvl.element_size()) == 0
    return "vector" if vec else "scalar"


def reset_launches() -> None:
    from repro_torch.kernels import elias as KE
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K
    K.reset_launches()
    FE.reset_launches()
    FD.reset_launches()
    KE.reset_launches()


def read_launches() -> dict:
    from repro_torch.kernels import elias as KE
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K
    return {**K.LAUNCHES, **FE.LAUNCHES, **FD.LAUNCHES, **KE.LAUNCHES}


def expected_launches(**counts) -> dict:
    """Every kernel's launch count 0 but the ones given."""
    return {**dict.fromkeys(read_launches(), 0), **counts}


def payload_given_norm(y, u, s, norm, pack: bool):
    """The plain quantize (+ pack) of each row fed a given norm per row."""
    import torch
    from repro_torch.compress.wire import pack_int4
    from repro_torch.kernels import qsgd as K
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    lvl = K.quantize_plain(y, u, torch.full_like(safe, float(s)) / safe, s)
    return pack_int4(lvl) if pack else lvl


def k5_rotation(y, u, s, seed, pack: bool):
    """K5's rotated rows, through the kernel's nullable copy-out pointer
    (the wrapper passes null): a launch for the check, not counted."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_encode as FE
    rows, d = y.shape
    rot = torch.empty_like(y)
    norm = torch.empty(rows, device=y.device)
    out = torch.empty(rows, d // 2 if pack else d, dtype=torch.int8,
                      device=y.device)
    build.launch("fused_encode", "fused_rotate_encode",
                 FE._SIGS["fused_rotate_encode"], y.data_ptr(), u.data_ptr(),
                 *FE._k5_args(y, seed, s, pack), norm.data_ptr(),
                 out.data_ptr(), rot.data_ptr())
    return rot


def k4_forced(y, u, s, pack: bool, one_launch: bool):
    """K4 through its C entry point on a forced route (the test-only
    argument the wrapper never takes; it picks the route by ``k4_route``):
    a launch for the check, not counted.  -> (payload, norm)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K
    rows, n = y.shape
    P = K.sumsq_blocks(n)
    partials = torch.empty(rows * P, device=y.device)
    norm = torch.empty(rows, device=y.device)
    out = torch.empty(rows, (n + 1) // 2 if pack else n, dtype=torch.int8,
                      device=y.device)
    build.launch("fused_encode", "fused_encode", FE._SIGS["fused_encode"],
                 y.data_ptr(), u.data_ptr(), rows, n, P, float(s), int(pack),
                 int(one_launch), partials.data_ptr(),
                 FE._k4_scratch(y.device).data_ptr(), norm.data_ptr(),
                 out.data_ptr())
    return out, norm


def k4_bytes(n: int, rows: int, pack: bool, route: str) -> int:
    """The bytes K4 moves on ``route``: y and u read once and the payload
    written on the one-launch route (8.5n packed / 9n), y read twice on the
    two-launch route (12.5n / 13n); plus the norms."""
    e = rows * n
    out = rows * ((n + 1) // 2 if pack else n)
    return (8 if route == "one_launch" else 12) * e + out + 4 * rows


def phase_fused_kernels(dev) -> dict:
    """K4 and K5 against their plain versions: the norm within rtol 1e-6,
    the payload byte-identical given the kernel's norm, K5's rotation
    bitwise; on the card, then their times."""
    import torch
    from repro_torch.compress import make_codec
    from repro_torch.compress.rotation import rotate
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"fused_encode": 0.0, "fused_rotate_encode": 0.0}

    def check(name, out, norm, norm_p, want, what):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        torch.testing.assert_close(norm, norm_p, rtol=1e-6, atol=0)
        if out.shape != want.shape or not torch.equal(out, want):
            bad = int((out != want).sum()) if out.shape == want.shape else -1
            raise AssertionError(f"{name} payload differs from the plain "
                                 f"version at {bad} bytes ({what})")
        return float((norm - norm_p).abs().max())

    cap = FE._capacity(dev) if dev.type == "cuda" else 0
    for rows in (1, 10):
        routes = {}
        for n in K4_NS:
            y = torch.randn(rows, n, generator=gen, device=dev) * 3.0
            u = torch.rand(rows, n, generator=gen, device=dev)
            routes.setdefault(FE.k4_route(rows, n, cap), []).append(n)
            for s, pack in FUSED_S:
                out, norm = FE.fused_encode(y, u, s, pack)
                norm_p = K.sumsq_plain(y, s)[1]
                err = check("K4", out, norm, norm_p,
                            payload_given_norm(y, u, s, norm, pack),
                            f"rows={rows} n={n} s={s} pack={pack}")
                # K1 and K4 add the same partials in the same order
                if not torch.equal(K.qsgd_sumsq(y, s)[1].view(torch.int32),
                                   norm.view(torch.int32)):
                    raise AssertionError(f"K1's norm is not K4's bit for "
                                         f"bit (rows={rows} n={n})")
                if (rows, n) == (10, MAIN_D):
                    worst["fused_encode"] = max(worst["fused_encode"], err)
        log(f"[fused] K4 rows={rows}: n in {K4_NS}, s=7 packed and s=127 "
            f"unpacked agree with the plain version; K1's norm is K4's bit "
            f"for bit; routes (capacity {cap} blocks) {routes}")
    if dev.type == "cuda":
        k4_route_checks(dev, gen, check)
    for rows in (1, 10):
        for d in K5_DS:
            y = torch.randn(rows, d, generator=gen, device=dev) * 3.0
            u = torch.rand(rows, d, generator=gen, device=dev)
            for seed in K5_SEEDS:
                for s, pack in FUSED_S:
                    out, norm = FE.fused_rotate_encode(y, u, s, seed, pack)
                    r_p = rotate(y, seed)
                    rot = (k5_rotation(y, u, s, seed, pack)
                           if dev.type == "cuda" else r_p)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    if not torch.equal(rot.view(torch.int32),
                                       r_p.view(torch.int32)):
                        raise AssertionError(
                            f"K5 rotation differs from the plain rotate "
                            f"(rows={rows} d={d} seed={seed})")
                    err = check("K5", out, norm, K.sumsq_plain(r_p, s)[1],
                                payload_given_norm(r_p, u, s, norm, pack),
                                f"rows={rows} d={d} seed={seed} s={s}")
                    worst["fused_rotate_encode"] = max(
                        worst["fused_rotate_encode"], err)
        log(f"[fused] K5 rows={rows}: d in {K5_DS}, seeds {K5_SEEDS}: "
            f"rotation bitwise, payload byte-identical")
    if dev.type != "cuda":
        return {"worst": worst, "main": {}}

    # a launch the card refuses raises: at d = 2^16 K5 asks for a cluster
    # of 16 blocks, above the portable 8, without the non-portable
    # attribute (the wrapper itself refuses d > 2^15 earlier)
    big = torch.zeros(1, 1 << 16, device=dev)
    out = torch.empty(1, 1 << 15, dtype=torch.int8, device=dev)
    norm = torch.empty(1, device=dev)
    args = FE._k5_args(big, 0, 7, True)
    try:
        build.launch("fused_encode", "fused_rotate_encode",
                     FE._SIGS["fused_rotate_encode"], big.data_ptr(),
                     big.data_ptr(), *args, norm.data_ptr(), out.data_ptr(),
                     None)
    except RuntimeError as e:
        log(f"[fused] refused launch (d = 2^16, cluster of {args[2]}) "
            f"raised: {e}")
    else:
        raise AssertionError(f"a K5 launch with a cluster of {args[2]} "
                             f"blocks did not raise")
    y = torch.randn(1, 1024, device=dev)
    FE.fused_rotate_encode(y, torch.rand(1, 1024, device=dev), 7, 0, True)
    torch.cuda.synchronize()                 # the refusal left no error

    # K5 through encode_payload with u a view 4 bytes past a 16-byte
    # boundary (the wrapper hands the kernel an aligned copy)
    codec = make_codec(7, wire="int4", kind="rotated", backend="cuda")
    for d in (1000, 1 << 15):
        y = torch.randn(d, generator=gen, device=dev) * 3.0
        m = codec.padded_dim(d)
        u = torch.rand(m + 1, generator=gen, device=dev)[1:]
        before = FE.LAUNCHES["fused_rotate_encode"]
        payload, norm, _ = codec.encode_payload(y, u)
        msg = rotate(y, codec.seed).reshape(1, m)
        if u.data_ptr() % 16 == 0 or \
                FE.LAUNCHES["fused_rotate_encode"] != before + 1:
            raise AssertionError("K5 did not launch on an unaligned u")
        check("K5", payload.reshape(1, -1), norm.reshape(1),
              K.sumsq_plain(msg, 7)[1],
              payload_given_norm(msg, u.reshape(1, m), 7, norm.reshape(1),
                                 True), f"d={d}, u off a 16-byte boundary")
    log("[fused] K5 via encode_payload with u 4 bytes past a 16-byte "
        "boundary (d 1000, 2^15): agrees with the plain version")

    main = {}
    for name, rows, n, s, pack in (
            ("fused_encode", 10, MAIN_D, 7, True),
            ("fused_encode", 10, 1 << 17, 7, True),
            ("fused_encode", 1, 1 << 20, 7, True),
            ("fused_encode", 1, 1 << 22, 7, True),
            ("fused_encode", 1, 1 << 22, 127, False),
            ("fused_rotate_encode", 1, 1024, 7, True),
            ("fused_rotate_encode", 1, 1 << 15, 7, True),
            ("fused_rotate_encode", 10, 1 << 15, 7, True)):
        y = torch.randn(rows, n, generator=gen, device=dev)
        u = torch.rand(rows, n, generator=gen, device=dev)
        e = rows * n
        out_bytes = rows * ((n + 1) // 2 if pack else n)
        # each input read once, each output written once (the contract's
        # bound); K4's two-launch route reads y twice
        nbytes = 8 * e + out_bytes + 4 * rows
        if name == "fused_encode":
            kern = (lambda y=y, u=u, s=s, pack=pack:
                    FE.fused_encode(y, u, s, pack))
            plain = (lambda y=y, u=u, s=s, pack=pack:
                     FE.fused_encode_plain(y, u, s, pack))
            ops = 8 * e
            route = FE.k4_route(rows, n, FE._capacity(dev))
            model = (f"route {route}, {rows} x {K.sumsq_blocks(n)} blocks, "
                     f"traffic model {'8.5n/9n' if route == 'one_launch' else '12.5n/13n'}: "
                     f"{k4_bytes(n, rows, pack, route) / HBM_BYTES_PER_S * 1e6:.2f} us")
        else:
            kern = (lambda y=y, u=u, s=s, pack=pack:
                    FE.fused_rotate_encode(y, u, s, 5, pack))
            plain = (lambda y=y, u=u, s=s, pack=pack:
                     FE.fused_rotate_encode_plain(y, u, s, 5, pack))
            ops = e * (n.bit_length() - 1) + 20 * e
            c = FE.k5_cluster(n)
            model = (f"float32 bound per message on one SM "
                     f"{ops / rows / FP32_OPS_PER_SM * 1e6:.2f} us, on its "
                     f"{c} SM(s) {ops / rows / c / FP32_OPS_PER_SM * 1e6:.2f} "
                     f"us")
        bnd, by = bound_ms(nbytes, ops)
        ms, pl = device_ms(kern), device_ms(plain)
        log(f"[time] {name} rows={rows} n={n} s={s} pack={pack}: kernel "
            f"{ms * 1e3:.2f} us (eager call {eager_ms(kern) * 1e3:.2f} us), "
            f"plain {pl * 1e3:.2f} us, library n/a (no one PyTorch call "
            f"quantizes and packs), bound {bnd * 1e3:.2f} us ({by}); {model}")
        if (name, rows, n) in (("fused_encode", 10, MAIN_D),
                               ("fused_rotate_encode", 1, 1 << 15)):
            main[name] = (ms, pl, None, (bnd, by))
    return {"worst": worst, "main": main}


def k4_route_checks(dev, gen, check) -> None:
    """K4 on the card beyond the wrapper's own route: both routes bitwise
    each other; rows off y's 16-byte phase (odd heads) and u in another
    phase than y, on both routes; a captured K4 replayed twice with the
    same bytes and a fresh exchange generation each; a one-launch grid
    the card cannot hold at once refused with an error."""
    import torch
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K

    def both_routes(y, u, what):
        for s, pack in FUSED_S:
            (o1, n1), (o2, n2) = (k4_forced(y, u, s, pack, one)
                                  for one in (True, False))
            check("K4 one-launch", o1, n1, K.sumsq_plain(y, s)[1],
                  payload_given_norm(y, u, s, n1, pack), what)
            if not (torch.equal(o1, o2) and torch.equal(
                    n1.view(torch.int32), n2.view(torch.int32))):
                raise AssertionError(f"K4's routes differ ({what}, s={s})")
            out, norm = FE.fused_encode(y, u, s, pack)    # the wrapper's
            if not (torch.equal(out, o1) and torch.equal(norm, n1)):
                raise AssertionError(f"K4's wrapper differs from its "
                                     f"routes ({what}, s={s})")

    for rows, n in ((10, MAIN_D), (1, 1 << 17)):
        y = torch.randn(rows, n, generator=gen, device=dev) * 3.0
        both_routes(y, torch.rand(rows, n, generator=gen, device=dev),
                    f"({rows}, {n})")
    # row 1 of a (10, 101771) matrix starts 3 floats past a 16-byte
    # boundary (head 1); u once in y's phase, once 1 float past a boundary
    n = MAIN_D + 1
    y = torch.randn(10, n, generator=gen, device=dev)[1:2]
    u_same = torch.rand(10, n, generator=gen, device=dev)[1:2]
    u_other = torch.rand(n + 1, generator=gen, device=dev)[1:].view(1, n)
    for u, what in ((u_same, "u in y's phase"), (u_other, "u in another")):
        both_routes(y, u, f"row 1 of (10, {n}), head "
                    f"{(4 - y.data_ptr() // 4 % 4) % 4}, {what} phase")
    log(f"[fused] K4: one-launch and two-launch routes bitwise equal at "
        f"(10, {MAIN_D}), (1, 2^17) and row 1 of (10, {n}) with u in y's "
        f"phase and in another")

    # a captured K4 replayed twice: the same bytes, a new generation each
    y = torch.randn(10, MAIN_D, generator=gen, device=dev)
    u = torch.rand(10, MAIN_D, generator=gen, device=dev)
    eager, eager_norm = FE.fused_encode(y, u, 7, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FE.fused_encode(y, u, 7, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, norm = FE.fused_encode(y, u, 7, True)
    sync = FE._k4_scratch(dev)[:1].view(torch.int32)   # generation, count
    replays = []
    for _ in range(2):
        out.zero_()
        before = sync.clone()
        graph.replay()
        torch.cuda.synchronize()
        replays.append((out.clone(), norm.clone()))
        if int(sync[1]) != 0 or int(sync[0]) != int(before[0]) + 1:
            raise AssertionError(f"a replayed K4 left its exchange at "
                                 f"{sync.tolist()} (was {before.tolist()})")
    if not all(torch.equal(o, eager) and torch.equal(nm, eager_norm)
               for o, nm in replays):
        raise AssertionError("a replayed K4 differs from the eager call")
    del graph
    log(f"[fused] K4 ({FE.k4_route(10, MAIN_D, FE._capacity(dev))}) "
        f"captured in a CUDA graph: two replays bitwise the eager call, each "
        f"a new generation with its block count back to 0")

    # a one-launch grid the card cannot hold at once is refused (2^22:
    # 1,024 blocks, the most the kernel's thread map takes)
    n = 1 << 22
    blocks = K.sumsq_blocks(n)
    if blocks > FE._capacity(dev):
        y = torch.zeros(1, n, device=dev)
        try:
            k4_forced(y, y, 7, True, True)
        except RuntimeError as e:
            log(f"[fused] K4 one-launch at {blocks} blocks (capacity "
                f"{FE._capacity(dev)}) refused: {e}")
        else:
            raise AssertionError("a cooperative K4 launch above the card's "
                                 "resident blocks did not raise")
        FE.fused_encode(y, y, 7, True)
        torch.cuda.synchronize()             # the refusal left no error


def phase_bucket_kernels(dev) -> dict:
    """Phase 2 for QSGD bucketing, on ``dev``: K1/K2 on bucket rows (K2
    bitwise given inv, K1's norm within rtol 1e-6; 127,220 rows launch in
    two chunks of rows), K3b at D for q in K3B_QS bitwise its plain version
    on both branches and, at q >= D, bitwise K3; K4 over the bucket rows
    of ten deltas, its flat payload byte-identical to the plain quantize +
    flat pack fed the kernel's norms.  Then their times at the bucketed
    quickstart's shapes."""
    import torch
    from repro_torch.compress import backends as B
    from repro_torch.compress.wire import pack_int4
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K

    dev = torch.device(dev)
    card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)

    def sync():
        if card:
            torch.cuda.synchronize()

    worst = {"qsgd_dequant_apply_bucketed": 0.0}
    for rows, q in BUCKET_K1_SHAPES:
        y = torch.randn(rows, q, generator=gen, device=dev) * 3.0
        u = torch.rand(rows, q, generator=gen, device=dev)
        chunks = len(K.row_chunks(rows))
        for s in (127, 16384):
            before = dict(K.LAUNCHES)
            _, norm, inv = K.qsgd_sumsq(y, s)
            lvl = K.qsgd_quantize(y, u, inv, s)
            sync()
            torch.testing.assert_close(norm, K.sumsq_plain(y, s)[1],
                                       rtol=1e-6, atol=0)
            if not torch.equal(lvl, K.quantize_plain(y, u, inv, s)):
                raise AssertionError(f"K2 on bucket rows ({rows}, {q}) s={s} "
                                     f"differs from the plain version")
            got = [K.LAUNCHES[k] - before[k]
                   for k in ("qsgd_sumsq", "qsgd_quantize")]
            if card and got != [chunks, chunks]:
                raise AssertionError(f"K1/K2 on {rows} rows launched {got} "
                                     f"times, want {chunks} each")
        log(f"[bucket] K1/K2 on bucket rows ({rows}, {q}), s in (127, "
            f"16384): K1 norm within rtol 1e-6, K2 bitwise, {chunks} "
            f"launch(es) each")

    n = MAIN_D
    x = torch.randn(n, generator=gen, device=dev)
    for s in (127, 16384):
        mat = torch.randint(-s, s + 1, (10, n), generator=gen,
                            device=dev).to(K.level_dtype(s))
        for q in K3B_QS:
            norms = torch.rand(-(-n // q), generator=gen, device=dev) * 5.0
            for row in (0, 1):        # row 1: off x's 16-byte phase
                lvl = mat[row]
                out = K.qsgd_dequant_apply_bucketed(x, lvl, norms, s, 0.05, q)
                want = K.dequant_apply_bucketed_plain(x, lvl, norms, s,
                                                      0.05, q)
                sync()
                branch = k3_branch(x, lvl, out)
                if not torch.equal(out.view(torch.int32),
                                   want.view(torch.int32)):
                    bad = (out != want).nonzero()
                    raise AssertionError(
                        f"K3b differs from its plain version at {len(bad)} "
                        f"of {n} (q={q} s={s} level row {row}, {branch} "
                        f"branch; first at {bad[:4].flatten().tolist()})")
                if q >= n and not torch.equal(
                        out.view(torch.int32), K.qsgd_dequant_apply(
                            x, lvl, norms, s, 0.05).view(torch.int32)):
                    raise AssertionError(f"K3b at q={q} >= D is not K3 bit "
                                         f"for bit ({branch} branch)")
                worst["qsgd_dequant_apply_bucketed"] = max(
                    worst["qsgd_dequant_apply_bucketed"],
                    float((out - want).abs().max()))
        log(f"[bucket] K3b at n={n}, s={s}, q in {K3B_QS}: bitwise its plain "
            f"version on level rows 0 ({k3_branch(x, mat[0], x)}) and 1 "
            f"({k3_branch(x, mat[1], x)}); bitwise K3 at q >= D")

    y = torch.randn(10, n, generator=gen, device=dev) * 3.0
    u = torch.rand(10, n, generator=gen, device=dev)
    for q in K4_BUCKET_QS:
        before = FE.LAUNCHES["fused_encode"]
        packed, norms = B.encode_fused_bucketed(y, 7, u, q, pack=True)
        sync()
        yb, ub = (B.to_buckets(t, q).reshape(-1, q) for t in (y, u))
        torch.testing.assert_close(norms.reshape(-1), K.sumsq_plain(yb, 7)[1],
                                   rtol=1e-6, atol=0)
        flat = payload_given_norm(yb, ub, 7, norms.reshape(-1), False) \
            .reshape(10, -1)[:, :n]
        if not torch.equal(packed, pack_int4(flat)):
            raise AssertionError(f"K4 over bucket rows q={q}: the flat "
                                 f"payload differs from the plain pack")
        launches = FE.LAUNCHES["fused_encode"] - before
        if card and launches != len(K.row_chunks(yb.shape[0])):
            raise AssertionError(f"K4 on {yb.shape[0]} rows launched "
                                 f"{launches} times")
        log(f"[bucket] K4 over ({yb.shape[0]}, {q}) bucket rows of (10, {n})"
            f" ({'packed rows' if q % 2 == 0 else 'int8 rows, flat pack'}, "
            f"{launches} launch(es)): bytes equal to the plain quantize + "
            f"flat pack given the kernel's norms")
    if not card:
        return {"worst": worst, "main": {}}

    # times at the bucketed quickstart's shapes (s = 2^14: int32 levels)
    s = 16384
    main = {}
    for rows, q in BUCKET_K1_SHAPES:
        y = torch.randn(rows, q, generator=gen, device=dev)
        u = torch.rand(rows, q, generator=gen, device=dev)
        inv = K.qsgd_sumsq(y, s)[2]
        e = rows * q
        for name, kern, plain, lib, (bnd, by) in (
                ("qsgd_sumsq", lambda: K.qsgd_sumsq(y, s),
                 lambda: K.sumsq_plain(y, s),
                 lambda: torch.linalg.vector_norm(y, dim=-1),
                 bound_ms(4 * e + 12 * rows, 2 * e)),
                ("qsgd_quantize", lambda: K.qsgd_quantize(y, u, inv, s),
                 lambda: K.quantize_plain(y, u, inv, s), None,
                 bound_ms(12 * e + 4 * rows, 6 * e))):
            ms, pl = device_ms(kern), device_ms(plain)
            lb = None if lib is None else device_ms(lib)
            log(f"[time] {name} bucket rows=({rows}, {q}): kernel "
                f"{ms * 1e3:.2f} us, plain {pl * 1e3:.2f} us, library "
                f"{'n/a' if lb is None else f'{lb * 1e3:.2f} us'}, bound "
                f"{bnd * 1e3:.2f} us ({by}), {len(K.row_chunks(rows))} "
                f"launch(es)")
    y = torch.randn(250, BUCKET, generator=gen, device=dev)
    u = torch.rand(250, BUCKET, generator=gen, device=dev)
    e = y.numel()
    bnd, by = bound_ms(8 * e + e // 2 + 4 * 250, 8 * e)
    ms = device_ms(lambda: FE.fused_encode(y, u, 7, True))
    pl = device_ms(lambda: FE.fused_encode_plain(y, u, 7, True))
    log(f"[time] fused_encode bucket rows=(250, {BUCKET}) s=7 packed: kernel "
        f"{ms * 1e3:.2f} us, plain {pl * 1e3:.2f} us, library n/a, bound "
        f"{bnd * 1e3:.2f} us ({by}), route "
        f"{FE.k4_route(250, BUCKET, FE._capacity(dev))}")
    lvl = torch.randint(-s, s + 1, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    for q in (BUCKET, 8):
        norms = torch.rand(-(-n // q), generator=gen, device=dev)
        kern = (lambda norms=norms, q=q:
                K.qsgd_dequant_apply_bucketed(x, lvl, norms, s, 0.05, q))
        plain = (lambda norms=norms, q=q:
                 K.dequant_apply_bucketed_plain(x, lvl, norms, s, 0.05, q))
        bnd, by = bound_ms(12 * n + 4 * norms.numel(), 3 * n)
        ms, pl = device_ms(kern), device_ms(plain)
        log(f"[time] qsgd_dequant_apply_bucketed n={n} q={q}: kernel "
            f"{ms * 1e3:.2f} us (eager call {eager_ms(kern) * 1e3:.2f} us), "
            f"plain {pl * 1e3:.2f} us, library n/a (no one PyTorch call "
            f"scales by bucket), bound {bnd * 1e3:.2f} us ({by})")
        if q == BUCKET:
            main["qsgd_dequant_apply_bucketed"] = (ms, pl, None, (bnd, by))
    return {"worst": worst, "main": main}


def elias_stream(kind: str, shape: tuple, s, dev, gen, rng):
    """One check stream of ELIAS_CASES on ``dev`` -> (words, levels or
    None where the words come from no encoder)."""
    import numpy as np
    import torch
    from repro_torch.compress import elias as E
    from repro_torch.compress import make_codec

    d = shape[-1]
    if kind == "random":
        words = rng.integers(-2**31, 2**31, (*shape[:-1], E.word_capacity(d)))
        return torch.from_numpy(words.astype(np.int32)).to(dev), None
    if kind in ("qsgd", "truncated"):
        y = torch.randn(*shape, generator=gen, device=dev)
        u = torch.rand(*shape, generator=gen, device=dev)
        lvl = make_codec(s).encode(y, u)[0]
    else:
        lv = np.zeros(shape, np.int8)
        if kind in ("all-127", "dense"):
            lv = (rng.choice([-127, 127], shape) if kind == "all-127"
                  else rng.integers(-127, 128, shape)).astype(np.int8)
        elif kind in ("ones-tail", "ones-run", "sparse"):
            idx = rng.choice(d, d // 40, replace=False)
            lv[..., idx] = rng.integers(1, 8, idx.size) * rng.choice(
                [-1, 1], idx.size)
            if kind == "ones-tail":
                lv[..., d - d // 3:] = 1
            elif kind == "ones-run":
                lv[..., d // 3:2 * d // 3] = 1
        elif kind == "d=1":
            lv[-1] = -5
        elif kind in ("long-gap", "ends"):
            lv[..., -1] = -3
            if kind == "ends":
                lv[..., 0] = 7
        elif kind == "boundary":
            lv[..., :4] = [127, -127, 1, -1]
        lvl = torch.from_numpy(lv).to(dev)
    words, nbits = E.encode_levels(lvl)
    if kind != "truncated":
        return words, lvl
    cut = int(nbits.reshape(-1)[0]) // 2 + 3
    u32 = words.cpu().numpy().view(np.uint32).copy()
    u32[..., cut // 32] &= np.uint32((1 << (cut % 32)) - 1)
    u32[..., cut // 32 + 1:] = 0
    return torch.from_numpy(u32.view(np.int32)).to(dev), None


def phase_elias_kernel(dev) -> dict:
    """elias_decode against its plain version (the sequential walk on the
    host) on every stream of ELIAS_CASES: the levels bitwise the plain
    walk's, an encoder stream's also bitwise its levels, the kernel's
    malformed-row counter 0 on every encoder stream and above 0 on the
    random words.  On the card, then: the CUDA launches of one decode
    (torch.profiler: KERNELS_PER_CALL kernels, each an elias kernel, each
    once a call), and the device time of each ELIAS_TIMED stream beside its
    bytes bound and the host walk's time (plain_ms in the JSON line)."""
    import numpy as np
    import torch
    from repro_torch.kernels import elias as KE

    dev = torch.device(dev)
    card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    bad = (lambda: KE.malformed_rows(dev)) if card else (lambda: 0)
    streams = {}
    for kind, shape, s in ELIAS_CASES:
        words, lvl = elias_stream(kind, shape, s, dev, gen, rng)
        d = shape[-1]
        before = bad()
        out = KE.elias_decode(words, d)
        rows_bad = bad() - before
        t0 = time.perf_counter()
        plain = KE.elias_decode_plain(words.cpu(), d)
        host = time.perf_counter() - t0
        if not torch.equal(out.cpu(), plain) or (
                lvl is not None and not torch.equal(out, lvl)):
            raise AssertionError(f"elias_decode {kind} {shape}: differs from "
                                 f"the plain walk or the input")
        if card and (rows_bad != 0 if lvl is not None else
                     kind == "random" and rows_bad == 0):
            raise AssertionError(f"elias_decode {kind} {shape}: "
                                 f"{rows_bad} rows took the sequential walk")
        log(f"[elias] {kind} {shape} s={s}: {int((out != 0).sum())} nonzero "
            f"levels, {words.shape[-1]} words, bitwise the plain walk (host "
            f"{host * 1e3:.1f} ms)" + (" and the input" if lvl is not None
                                       else "") +
            f", {rows_bad} rows by the sequential walk")
        if kind == "qsgd":
            streams[(shape, s)] = (words, lvl, host)
    if not card:
        return {"worst": {"elias_decode": 0.0}, "main": {}}
    from repro_torch.compress import elias as E
    from torch.profiler import ProfilerActivity, profile
    words = streams[((MAIN_D,), 127)][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            KE.elias_decode(words, MAIN_D)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    names = {e.key: e.count for e in events}
    if (len(names) != KE.KERNELS_PER_CALL or
            any("elias" not in k or c != 5 for k, c in names.items())):
        raise AssertionError(f"elias_decode's device kernels over 5 calls: "
                             f"{names}")
    log(f"[elias] {KE.KERNELS_PER_CALL} CUDA launches a decode: " + ", ".join(
        f"{demangle(e.key)} {e.self_device_time_total / 5:.2f} us"
        for e in events) + " (profiler on, eager)")
    main = {}
    for shape, s in ELIAS_TIMED:
        words, lvl, host = streams[(shape, s)]
        d = shape[-1]
        kern = (lambda words=words, d=d: KE.elias_decode(words, d))
        ms = device_ms(kern)
        rows = words.numel() // words.shape[-1]
        bits = float(E.stream_bits(lvl).sum())
        bnd, by = bound_ms(bits / 8 + rows * d, 0)
        log(f"[time] elias_decode {shape} s={s}: kernel {ms * 1e3:.2f} us "
            f"(eager call {eager_ms(kern) * 1e3:.2f} us; {bits / rows:.0f} "
            f"stream bits a row, {KE.KERNELS_PER_CALL} launches), plain "
            f"(host walk) {host * 1e3:.2f} ms, library n/a, bound "
            f"{bnd * 1e3:.3f} us ({by})")
        if shape == (MAIN_D,) and s == 127:
            main["elias_decode"] = (ms, host * 1e3, None, (bnd, by))
    return {"worst": {"elias_decode": 0.0}, "main": main}


def phase_main_path() -> dict:
    import numpy as np
    import torch
    from repro_torch.api import EdgeSystem, MNISTTask, Scenario
    from repro_torch.core.genqsgd import GenQSGD, flatten_like

    t0 = time.perf_counter()
    # a task on cuda:0 under the run's default device="cuda" (and the
    # converse below): one card, whichever way it is named
    task = MNISTTask(device="cuda:0")
    consts = task.estimate_constants(N=10, n_iters=120)
    torch.cuda.synchronize()
    log(f"[main] constants L={consts.L:.4g} sigma={consts.sigma:.4g} "
        f"G={consts.G:.4g} f_gap={consts.f_gap:.4g} "
        f"({time.perf_counter() - t0:.2f} s with data)")
    system = EdgeSystem.paper_sec_vii(dim=task.dim)
    scenario = Scenario(system=system, consts=consts, T_max=1e5, C_max=0.25)
    t0 = time.perf_counter()
    plan = scenario.optimize()
    log(f"[main] optimize {time.perf_counter() - t0:.2f} s: "
        f"{plan.describe()}")
    if not plan.feasible:
        raise AssertionError("the optimizer returned an infeasible Plan")

    rounds = min(plan.K0, 400)
    scenario.run(plan, task=task, max_rounds=2)        # warm-up, not counted
    scenario.run(plan, task=MNISTTask(device="cuda"), max_rounds=1,
                 device="cuda:0")
    log("[main] Scenario.run takes a task on cuda:0 for device='cuda' and a "
        "task on 'cuda' for device='cuda:0'")
    reset_launches()
    report = scenario.run(plan, task=task, max_rounds=rounds)
    launches = read_launches()
    log(report.summary())
    ms_round = report.wall_time_s / report.rounds * 1e3
    log(f"[main] {report.rounds} rounds, {ms_round:.3f} ms/round, "
        f"test_acc {report.final_metrics['test_acc']:.4f}, "
        f"launches {launches}")

    # right answers: exact comm bits, a finite model that learned, kernels
    # launched as the design says, and a card round equal to the CPU one
    want_bits = report.rounds * (float(np.sum(system.M_sn)) + system.M_s0)
    if report.comm_bits != want_bits:
        raise AssertionError(f"comm bits {report.comm_bits} != "
                             f"rounds * (sum M_sn + M_s0) = {want_bits}")
    if report.comm_bits_match != (report.rounds == plan.K0):
        raise AssertionError("comm_bits_match disagrees with the round count")
    m = report.final_metrics
    if not (np.isfinite(m["eval_loss"]) and m["test_acc"] > 0.2):
        raise AssertionError(f"the run did not learn: {m}")
    workers = 1 if len(set(plan.sn)) == 1 else plan.N
    server = 0 if plan.s0 is None else 1
    want = expected_launches(qsgd_sumsq=rounds * (workers + server),
                             qsgd_quantize=rounds * (workers + server),
                             qsgd_dequant_apply=rounds * server)
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    for name in ("qsgd_sumsq", "qsgd_quantize", "qsgd_dequant_apply"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")

    cfg = plan.to_genqsgd_config(max_K0=1)
    cpu_task = MNISTTask(device="cpu")
    algs = {d: GenQSGD(t.loss, t.make_data(plan.N), t.shapes, cfg)
            for d, t in (("cuda", task), ("cpu", cpu_task))}
    gen = torch.Generator(device="cpu").manual_seed(7)
    x0 = flatten_like(cpu_task.init_params(gen))
    D = x0.shape[0]
    idx = torch.randint(0, algs["cpu"].n_local, (plan.N, plan.K_max, plan.B),
                        generator=gen)
    uw, us = torch.rand(plan.N, D, generator=gen), torch.rand(D, generator=gen)
    gamma = plan.gamma
    x_cpu, m_cpu = algs["cpu"].round(x0, idx, uw, us, gamma)
    x_gpu, _ = algs["cuda"].round(x0.cuda(), idx.cuda(), uw.cuda(), us.cuda(),
                                  gamma)
    diff = (x_gpu.cpu() - x_cpu).abs()
    # float32 gradients differ between the card and the CPU; where they move
    # a value across a level boundary the result moves by one level of the
    # server's (gamma * norm / s0) or 1/N of a worker's
    level = gamma * float(m_cpu["delta_norm"]) / plan.s0
    if float(diff.max()) > 2 * level + 1e-6 or \
            int((diff > 1e-6).sum()) > D // 1000:
        raise AssertionError(f"card round differs from the CPU round: max "
                             f"{float(diff.max()):.3g} (level {level:.3g}), "
                             f"{int((diff > 1e-6).sum())} coordinates")
    log(f"[main] one round card vs CPU: max abs diff {float(diff.max()):.3g} "
        f"(server level {level:.3g})")
    profile_rounds(algs["cuda"], x_gpu, (idx.cuda(), uw.cuda(), us.cuda()),
                   gamma)
    return {"launches": launches, "ms_round": ms_round, "task": task,
            "consts": consts, "plan": plan}


def table_scenario(name: str, system, consts, C_max: float = 0.25,
                   T_max: float = 1e5):
    """A baseline-table column ('Gen-O', 'PM-E-opt', 'FA-C-fix', ...) as a
    Scenario, as benchmarks/common.py's make_scenario builds it."""
    from repro_torch.api import Scenario, make_step_rule
    parts = name.split("-")
    m = "J" if parts[:2] == ["Gen", "O"] else parts[1]
    step = None if m == "J" else make_step_rule(m, **TABLE_STEPS[m])
    return Scenario(system=system, consts=consts, T_max=T_max, C_max=C_max,
                    family=TABLE_FAMILY[parts[0]], step=step,
                    samples_per_worker=TABLE_I_N)


def plan_target_failures(ref, got) -> list:
    """Where GIA results miss the Plan targets of the port's CPU tests
    (tests/test_torch_solver.py): feasibility, iterations, history length,
    integer recovery equal, E and history within rel 1e-9, z within 1e-5
    (1e-4 for a row with no feasible iteration: a stalled phase-I point)."""
    import numpy as np
    bad = []
    for i, (a, b) in enumerate(zip(ref, got)):
        atol = 1e-5 if a.iterations else 1e-4
        h = np.asarray(a.history)
        checks = {
            "feasible": a.feasible == b.feasible,
            "iterations": a.iterations == b.iterations,
            "integer point": (a.K0, a.B, tuple(a.Kn)) ==
                             (b.K0, b.B, tuple(b.Kn)),
            "E": abs(b.E - a.E) <= 1e-9 * abs(a.E),
            "history": len(a.history) == len(b.history) and bool(np.all(
                np.abs(np.asarray(b.history) - h) <= 1e-9 * np.abs(h))),
            "z": bool(np.all(np.abs(a.z - b.z) <= atol)),
        }
        bad += [(i, k) for k, ok in checks.items() if not ok]
    return bad


def chunk_device_ms(key, rows: int) -> float:
    """Device time of one replay of the captured chunk of the signature
    ``key`` at ``rows`` rows, by CUDA events (every row is finished by
    then, but a replay runs every kernel of the chunk all the same)."""
    import torch
    from repro_torch.opt import gia_fused
    shape, = [p.shapes[rows] for k, p in gia_fused._PROGRAMS.items()
              if k[0] == key and rows in p.shapes]
    out = []
    with torch.cuda.stream(shape.stream):
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            shape.graph.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
    return statistics.median(out)


def plan_trace(rng, system, consts, algos, n_unique, n_total):
    """serve_bench.py's seeded two-phase trace ``(populate, tail)``: every
    unique (algo, budget) scenario (all cold), then exact repeats of them
    (cache hits) and repeats with the budget jittered by up to 0.2 %
    (warm starts), 50/50."""
    import numpy as np
    pool = [table_scenario(a, system, consts, C_max=float(c))
            for a in algos for c in np.linspace(0.22, 0.45, n_unique)]
    rng.shuffle(pool)
    tail = []
    while len(pool) + len(tail) < n_total:
        base = pool[rng.integers(len(pool))]
        if rng.random() < 0.5:
            tail.append(base)                        # exact repeat: hit
        else:
            jitter = 1.0 + rng.uniform(-2e-3, 2e-3)
            tail.append(dataclasses.replace(         # near-duplicate: warm
                base, C_max=base.C_max * jitter))
    return pool, tail


def drive_trace(srv, phases, gaps):
    """Submit ``phases`` open-loop at the arrival ``gaps`` (s), with a
    barrier between the phases, as serve_bench.run does; returns the
    handles and the wall time."""
    handles = []
    t0 = time.perf_counter()
    for phase in phases:
        for scn in phase:
            time.sleep(gaps[len(handles)])
            handles.append(srv.submit(scn))
        for h in handles:
            h.result(timeout=900)
    return handles, time.perf_counter() - t0


def keep_results(srv) -> tuple:
    """Record, by ``id(handle)``, the GIA result each solved handle was
    resolved with (the handles carry only the frozen Plan) and whether its
    last dispatch ran m=J's restart (an all-warm m=J batch skips it); and
    the names of the threads that resolved them."""
    got, restarts, threads = {}, {}, set()
    finish, dispatch = srv._finish, srv._dispatch

    def on_finish(h, r, batch_size):
        got[id(h)] = r
        threads.add(threading.current_thread().name)
        finish(h, r, batch_size)

    def on_dispatch(rows, restart):
        restarts.update((id(h), restart) for h in rows)
        return dispatch(rows, restart)

    srv._finish, srv._dispatch = on_finish, on_dispatch
    return got, restarts, threads


def lat_line(st) -> str:
    """Per-source p50/p99/mean latency (ms) of ``PlanServer.stats()``."""
    return "; ".join(
        f"{k} n={v['count']} p50 {v['p50'] * 1e3:.3f} p99 "
        f"{v['p99'] * 1e3:.3f} mean {v['mean'] * 1e3:.3f}"
        for k, v in st["latency_s"].items())


def phase_sweep(consts, dev="cuda", n_cmax: int = SWEEP_CMAX[2],
                n_gamma: int = SWEEP_GAMMA[2],
                subsample: int = SWEEP_SUBSAMPLE) -> dict:
    """The batched and fused GIA on the card: the one-signature grid cold
    and warm (one capture over both), a subsample against the NumPy
    solver, the baseline table's 13 -opt columns as one heterogeneous
    sweep (parallel and serial, each row equal to the NumPy sweep's) with
    its 9 -fix columns and 9 claims, and a padded batch bitwise its rows;
    no QSGD kernel launches meanwhile."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.api import ConstantRule, EdgeSystem, sweep_scenarios
    from repro_torch.opt import (RefreshPlan, min_feasible_K0,
                                 solve_param_opt_batched)
    from repro_torch.opt import gia_fused

    system = EdgeSystem.paper_sec_vii(dim=MAIN_D)
    reset_launches()
    out = {}

    # (a) the 1,024-point grid of opt_bench.py, cold then warm
    base = table_scenario("Gen-C", system, consts)
    scns = [dataclasses.replace(base, C_max=float(c),
                                step=ConstantRule(float(g)))
            for c in np.linspace(*SWEEP_CMAX[:2], n_cmax)
            for g in np.geomspace(*SWEEP_GAMMA[:2], n_gamma)]
    n = len(scns)
    key = RefreshPlan.build([scns[0].problem()]).signature_key
    c0 = gia_fused.capture_count(key)
    t0 = time.perf_counter()
    cold = sweep_scenarios(scns, backend="torch-fused", parallel=False,
                           device=dev)
    t_cold = time.perf_counter() - t0
    obs.enable(reset=True)
    try:
        t0 = time.perf_counter()
        warm = sweep_scenarios(scns, backend="torch-fused", parallel=False,
                               device=dev)
        t_warm = time.perf_counter() - t0
        spans = [e["args"] for e in obs.TRACER.events()
                 if e["name"] == "gia.fused_dispatch"]
    finally:
        obs.disable()
        obs.TRACER.clear()
        obs.REGISTRY.reset()
    captures = gia_fused.capture_count(key) - c0
    if captures != 1 or warm.n_groups != 1:
        raise AssertionError(f"{captures} captures, {warm.n_groups} groups "
                             f"for one signature over two passes")
    if warm.rows != cold.rows:
        raise AssertionError("the warm pass's rows differ from the cold's")
    chunks = sum(a["chunks"] for a in spans)
    # one host read after each chunk and one for the results
    syncs = chunks + len(spans)
    chunk_ms = chunk_device_ms(key, n) if dev != "cpu" else float("nan")
    feasible = sum(r["feasible"] for r in warm.rows)
    idx = list(range(0, n, max(1, n // subsample)))[:subsample]
    probs = [scns[i].problem() for i in idx]
    t0 = time.perf_counter()
    ref = solve_param_opt_batched(probs, backend="numpy")
    s_numpy = (time.perf_counter() - t0) / len(idx)
    got = solve_param_opt_batched(probs, backend="torch-fused", device=dev)
    bad = plan_target_failures(ref, got)
    for i, r in zip(idx, ref):
        row = warm.rows[i]
        if (row["K0"], row["Kn"], row["B"], row["feasible"],
                row["iterations"]) != (r.K0, tuple(int(k) for k in r.Kn),
                                       r.B, r.feasible, r.iterations) \
                or abs(row["E"] - r.E) > 1e-9 * abs(r.E):
            bad.append((i, "grid row"))
    if bad:
        raise AssertionError(f"the fused sweep misses the Plan targets of "
                             f"the NumPy solver at (row, field) {bad}")
    out.update(points=n, captures=captures, cold_s=t_cold, warm_s=t_warm,
               warm_solves_per_s=n / t_warm, numpy_s_per_point=s_numpy,
               chunks=chunks, host_syncs=syncs, feasible_points=feasible,
               chunk_device_ms=chunk_ms)
    log(f"[sweep] {n}-point grid, one signature: cold {t_cold:.3f} s, warm "
        f"{t_warm:.3f} s = {n / t_warm:.1f} solves/s ({captures} capture "
        f"over both passes; warm: {chunks} chunks of {gia_fused._CHUNK} "
        f"steps replayed, {syncs} host syncs; a chunk {chunk_ms:.3f} ms of "
        f"device = {chunk_ms / gia_fused._CHUNK:.3f} ms a step, "
        f"{chunks * chunk_ms / 1e3:.3f} s of the warm pass); NumPy "
        f"{s_numpy:.4f} s/point over {len(idx)} points = "
        f"{s_numpy * n / t_warm:.1f}x the warm sweep's time a point; "
        f"{feasible} feasible; the {len(idx)}-point subsample meets the Plan "
        f"targets, fused rows equal the grid's")

    # (b) the baseline table: 13 -opt columns as one heterogeneous sweep
    opt_names = [a for a in TABLE_ALGOS if not a.endswith("-fix")]
    opt_scns = [table_scenario(a, system, consts) for a in opt_names]
    t0 = time.perf_counter()
    tab = sweep_scenarios(opt_scns, names=opt_names, backend="torch-fused",
                          parallel=True, device=dev)
    t_tab = time.perf_counter() - t0
    serial = sweep_scenarios(opt_scns, names=opt_names,
                             backend="torch-fused", parallel=False,
                             device=dev)
    t0 = time.perf_counter()
    tab_np = sweep_scenarios(opt_scns, names=opt_names, backend="numpy",
                             parallel=False)
    t_tab_np = time.perf_counter() - t0
    if serial.rows != tab.rows:
        raise AssertionError("parallel and serial fused sweeps differ")
    for r, q in zip(tab.rows, tab_np.rows):
        if r != q:
            raise AssertionError(f"{r['name']}: fused row {r} != NumPy {q}")
    by = {r["name"]: r for r in tab.rows}
    for name in TABLE_ALGOS:
        if not name.endswith("-fix"):
            continue
        algo, m, _ = name.split("-")
        prob = table_scenario(f"Gen-{m}", system, consts).problem()
        kn, B = TABLE_FIX[algo]
        Kn = np.full(system.N, max(1, int(round(kn))), dtype=np.int64)
        K0, ok = min_feasible_K0(prob, Kn, B, ctol=0.0, ttol=0.0)
        by[name] = {"name": name, "E": prob.evaluate(K0, Kn, B, None)["E"],
                    "feasible": bool(ok)}

    def feas(a):
        return by[a]["feasible"]

    def E(a):
        return by[a]["E"]

    def le(a, b):
        return E(a) <= E(b) * 1.001

    claims = {
        "Gen-O <= Gen-C": le("Gen-O", "Gen-C"),
        "Gen-O <= Gen-E": le("Gen-O", "Gen-E"),
        "Gen-O <= Gen-D": le("Gen-O", "Gen-D"),
        "Gen-C <= PM-C-opt": not feas("PM-C-opt") or le("Gen-C", "PM-C-opt"),
        "Gen-C <= PR-C-opt": not feas("PR-C-opt") or le("Gen-C", "PR-C-opt"),
        "Gen-E <= PM-E-opt": not feas("PM-E-opt") or le("Gen-E", "PM-E-opt"),
        "Gen-D <= PM-D-opt": not feas("PM-D-opt") or le("Gen-D", "PM-D-opt"),
        "PM-C-opt <= PM-C-fix": not (feas("PM-C-opt") and feas("PM-C-fix"))
        or le("PM-C-opt", "PM-C-fix"),
        "PR-C-opt <= PR-C-fix": not (feas("PR-C-opt") and feas("PR-C-fix"))
        or le("PR-C-opt", "PR-C-fix"),
    }
    for name in TABLE_ALGOS:
        log(f"[sweep]   {name:12s} E={E(name):.6g} feasible={feas(name)}")
    for k, v in claims.items():
        log(f"[sweep]   [{'PASS' if v else 'FAIL'}] {k}")
    n_pass = sum(claims.values())
    if n_pass != len(claims):
        raise AssertionError(f"baseline claims {n_pass}/{len(claims)}")
    out.update(table_s=t_tab, table_numpy_s=t_tab_np,
               table_groups=tab.n_groups, claims=f"{n_pass}/{len(claims)}")
    log(f"[sweep] baseline table: 13 -opt columns in {tab.n_groups} groups, "
        f"parallel {t_tab:.3f} s (NumPy sweep {t_tab_np:.3f} s), rows equal "
        f"to the NumPy sweep's and to a serial sweep's; claims "
        f"{n_pass}/{len(claims)} PASS")

    # (c) a 5-row batch padded to 8 rows: its rows bitwise unpadded
    probs = [table_scenario("Gen-C", system, consts, C_max=float(c)).problem()
             for c in np.linspace(0.22, 0.4, PAD_ROWS)]
    plain = solve_param_opt_batched(probs, backend="torch-fused", device=dev)
    padded = solve_param_opt_batched(probs, backend="torch-fused", device=dev,
                                     pad_to=PAD_TO)
    for a, b in zip(plain, padded):
        if not (np.array_equal(a.z, b.z) and a.history == b.history
                and (a.iterations, a.converged, a.K0, a.B, a.E)
                == (b.iterations, b.converged, b.K0, b.B, b.E)):
            raise AssertionError("a padded row differs from its unpadded "
                                 "solve")
    log(f"[sweep] {PAD_ROWS} rows padded to {PAD_TO}: bitwise the unpadded "
        f"rows")
    # the same rows through the "torch" backend (each GIA iteration's GP
    # solves batched on the card, the refresh on the host)
    t0 = time.perf_counter()
    rows = solve_param_opt_batched(probs, backend="torch", device=dev)
    t_torch = time.perf_counter() - t0
    ref = solve_param_opt_batched(probs, backend="numpy")
    bad = plan_target_failures(ref, rows)
    if bad:
        raise AssertionError(f"backend 'torch' misses the Plan targets of "
                             f"the NumPy solver at (row, field) {bad}")
    log(f"[sweep] backend 'torch' on the same {PAD_ROWS} rows: {t_torch:.3f}"
        f" s, within the Plan targets of the NumPy solver")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"QSGD kernels launched during the sweep: "
                             f"{launches}")
    out["launches"] = launches
    return out


def capture_failures(key, problems, dev, rows=(3, 4)) -> None:
    """A capture that fails ends cleanly: an error raised inside it, and a
    host read there (which invalidates it, so ending it raises too), each
    at a padded row count not captured before.  Afterwards the caller's
    stream is current again, nothing is capturing, no shape is kept or
    counted, both locks are free and a synchronize raises nothing; the
    next call captures afresh, its rows bitwise the 16-row dispatch's."""
    import numpy as np
    import torch
    from repro_torch.opt import solve_param_opt_batched
    from repro_torch.opt import gia_fused

    ref = solve_param_opt_batched(problems, backend="torch-fused",
                                  pad_to=PLAN_TRACE["max_batch"], device=dev)
    prog, = [p for k, p in gia_fused._PROGRAMS.items() if k[0] == key
             and k[1] == 60 and k[3] == str(torch.device(dev))]
    real = gia_fused._Program.step
    for how, b in zip(("an error", "a host read"), rows):
        if b in prog.shapes:
            raise AssertionError(f"{b} rows were captured before")
        calls = []

        def step(self, st, inp, how=how):
            if torch.cuda.is_current_stream_capturing():
                calls.append(how)
                if len(calls) == 2 and how == "an error":
                    raise RuntimeError("an error inside the capture")
                if len(calls) == 2:
                    float(st.t.sum())
            return real(self, st, inp)

        c0 = gia_fused.capture_count(key)
        gia_fused._Program.step = step
        try:
            solve_param_opt_batched(problems, backend="torch-fused",
                                    pad_to=b, device=dev)
            failed = None
        except Exception as e:                      # noqa: BLE001
            failed = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        finally:
            gia_fused._Program.step = real
        state = {
            "raised": failed is not None,
            "caller's stream current":
                torch.cuda.current_stream() == torch.cuda.default_stream(),
            "not capturing": not torch.cuda.is_current_stream_capturing(),
            "no shape kept": b not in prog.shapes,
            "no capture counted": gia_fused.capture_count(key) == c0,
            "locks free": not (prog.lock.locked()
                               or gia_fused._CAPTURE_LOCK.locked())}
        torch.cuda.synchronize()
        again = solve_param_opt_batched(problems, backend="torch-fused",
                                        pad_to=b, device=dev)
        state["next call captures"] = gia_fused.capture_count(key) == c0 + 1
        state["bitwise"] = all(np.array_equal(x.z, y.z)
                               and x.history == y.history
                               for x, y in zip(ref, again))
        if not all(state.values()):
            raise AssertionError(f"after {how} in a capture: {state}")
        log(f"[planserver] {how} inside a capture at {b} rows: raised "
            f"({failed}); the caller's stream current, no shape, no count, "
            f"locks free, a synchronize clean; the next call captured "
            f"afresh, rows bitwise")


def phase_planserver(consts, plan, task, dev="cuda",
                     n_total: int = PLAN_TRACE["n_total"],
                     n_unique: int = PLAN_TRACE["n_unique"],
                     numpy_requests: int = PLAN_NUMPY_REQUESTS,
                     train_rounds: int = PLAN_TRAIN_ROUNDS) -> dict:
    """PlanServer on the card at phase 3's constants and system: (1)
    serve_bench.py's full trace (at most one capture a signature, every
    handle resolved, hits equal to the solves that filled them, the cold
    and sampled warm rows within the Plan targets of the NumPy solver);
    (2) the same trace, or its first ``numpy_requests``, through the NumPy
    server; (3) a wrong-shape warm seed in a batch of healthy rows,
    isolated with no capture added; (4) a program captured on this thread
    replayed by the dispatcher, bitwise; (5) a first capture beside
    ``train_rounds`` quickstart rounds, which stay bitwise a solo run.  No
    QSGD kernel launches for the server (phases 1-4)."""
    import collections
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.api import EdgeSystem, Objective
    from repro_torch.core.genqsgd import GenQSGD, flatten_like
    from repro_torch.opt import (RefreshPlan, solve_param_opt_batched,
                                 structure_signature)
    from repro_torch.opt import gia_fused
    from repro_torch.opt.gia import _companion_constant
    from repro_torch.serve.planserver import (PlanHandle, PlanServer,
                                              fingerprint)

    system = EdgeSystem.paper_sec_vii(dim=MAIN_D)
    cfg = PLAN_TRACE
    mb, window = cfg["max_batch"], cfg["window_s"]
    reset_launches()
    out = {}

    def trace():
        rng = np.random.default_rng(0)
        pop, tail = plan_trace(rng, system, consts, cfg["algos"], n_unique,
                               n_total)
        gaps = rng.exponential(1.0 / cfg["rate_per_s"],
                               size=len(pop) + len(tail))
        return pop, tail, gaps

    def key_of(problem):
        return RefreshPlan.build([problem]).signature_key

    def same(a, b):
        return dataclasses.asdict(a) == dataclasses.asdict(b)

    # (1) the full trace on the card
    pop, tail, gaps = trace()
    joint = table_scenario("Gen-O", system, consts).problem()
    comp_key = key_of(_companion_constant(joint, 1e-3 / float(consts.L)))
    comp0 = gia_fused.capture_count(comp_key)
    with PlanServer(max_batch=mb, window_s=window, device=dev) as srv:
        got, restarts, _ = keep_results(srv)
        handles, wall = drive_trace(srv, (pop, tail), gaps)
    st = srv.stats()
    caps = srv.compile_counts()
    comp_caps = gia_fused.capture_count(comp_key) - comp0
    n = len(handles)
    src = collections.Counter(h.source for h in handles)
    # rows that did not converge (never cached: their repeats solve cold)
    non_conv = [(h.source, h.scenario.family, str(h.m.value),
                 round(h.scenario.C_max, 6))
                for h in handles if h.converged is False]
    lat = st["latency_s"]
    qw = st["queue_wait_s"]
    log(f"[planserver] trace: {n} requests in {wall:.3f} s = "
        f"{n / wall:.2f} solves/s; hit rate {st['hit_rate']:.4f} "
        f"(hit {src['hit']}, warm {src['warm']}, cold {src['cold']}: "
        f"{src['cold'] - len(pop)} of the tail); {st['batches']} batches, "
        f"mean {st['mean_batch']:.3f} rows; captures per signature "
        f"{list(caps.values())} (m=J's companion program {comp_caps}); "
        f"non_converged {st['non_converged']} {non_conv}")
    log(f"[planserver] latency ms: {lat_line(st)}; queue_wait ms p50 "
        f"{qw['p50'] * 1e3:.3f} p99 {qw['p99'] * 1e3:.3f}")
    failed = [h.error for h in handles if h.error is not None]
    if failed:
        raise AssertionError(f"{len(failed)} requests failed: {failed[:3]}")
    if len(caps) != len(cfg["algos"]) or any(c > 1 for c in caps.values()) \
            or comp_caps > 1:
        raise AssertionError(f"captures per signature {caps}, m=J's "
                             f"companion {comp_caps}")
    want = dict(submitted=n, queue_depth=0, inflight=0)
    if {k: st[k] for k in want} != want or \
            st["hits"] + st["warm"] + st["cold"] != n or \
            any(h.source != "cold" for h in handles[:len(pop)]):
        raise AssertionError(f"stats {st}")
    filled = {(h.sig, h.fp): h for h in handles
              if h.source != "hit" and h.converged}
    for h in handles:
        if h.source == "hit":
            f = filled.get((h.sig, h.fp))
            if f is None or not same(f.plan, h.plan):
                raise AssertionError("a hit's Plan differs from the solve "
                                     "that filled its cache entry")
    out.update(requests=n, wall_s=wall, solves_per_s=n / wall,
               hit_rate=st["hit_rate"], batches=st["batches"],
               mean_batch=st["mean_batch"], captures=list(caps.values()),
               companion_captures=comp_caps,
               latency_ms={k: {q: v[q] * 1e3 for q in ("p50", "p99", "mean")}
                           for k, v in lat.items()},
               queue_wait_ms={q: qw[q] * 1e3 for q in ("p50", "p99")},
               non_converged=st["non_converged"])

    # where a batch's time goes: one cold and one warm Gen-C batch again,
    # chunks counted, a replayed chunk timed on the device
    gen_c = structure_signature(table_scenario("Gen-C", system,
                                               consts).problem())
    cold_b = [h for h in handles[:len(pop)] if h.sig == gen_c][:mb]
    warm_b = [h for h in handles if h.source == "warm"
              and h.sig == gen_c][:mb]
    timed = {}
    obs.enable(reset=True)
    try:
        for name, rows in (("cold", cold_b), ("warm", warm_b)):
            obs.TRACER.clear()
            t0 = time.perf_counter()
            solve_param_opt_batched([h.problem for h in rows],
                                    z0s=[h.z0 for h in rows],
                                    backend="torch-fused", pad_to=mb,
                                    device=dev)
            t = time.perf_counter() - t0
            chunks = sum(e["args"]["chunks"] for e in obs.TRACER.events()
                         if e["name"] == "gia.fused_dispatch")
            timed[name] = (len(rows), chunks, t)
    finally:
        obs.disable()
        obs.TRACER.clear()
        obs.REGISTRY.reset()
    ckey = key_of(cold_b[0].problem)
    chunk_ms = chunk_device_ms(ckey, mb) if dev != "cpu" else float("nan")
    for name, (rows, chunks, t) in timed.items():
        log(f"[planserver] a {name} Gen-C batch of {rows} rows (padded to "
            f"{mb}): {chunks} chunks x {chunk_ms:.3f} ms of device a "
            f"replayed chunk = {chunks * chunk_ms:.3f} ms of device, "
            f"{t * 1e3:.3f} ms wall")
    chunk_all = {a: chunk_device_ms(
        key_of(table_scenario(a, system, consts).problem()), mb)
        for a in cfg["algos"]} if dev != "cpu" else {}
    log(f"[planserver] device ms a replayed chunk at {mb} rows: " + ", ".join(
        f"{a} {v:.3f}" for a, v in chunk_all.items()))
    out.update(batch_chunks={k: v[1] for k, v in timed.items()},
               batch_wall_ms={k: v[2] * 1e3 for k, v in timed.items()},
               chunk_device_ms=chunk_ms, chunk_device_ms_by_algo=chunk_all)

    # (2) the NumPy server on the same trace (or its first requests)
    pop, tail, gaps = trace()
    n_np = min(numpy_requests or n, n)
    with PlanServer(backend="numpy", max_batch=mb, window_s=window) as nsrv:
        ngot, _, _ = keep_results(nsrv)
        nhandles, nwall = drive_trace(nsrv, (pop, tail[:n_np - len(pop)]),
                                      gaps)
    nst = nsrv.stats()
    log(f"[planserver] NumPy server, "
        + ("the whole trace" if n_np == n else
           f"the trace's first {n_np} of {n} requests (the whole trace "
           f"would take it over ~60 s)")
        + f": {n_np} in {nwall:.3f} s = {n_np / nwall:.2f} solves/s; "
        f"latency ms: {lat_line(nst)}")
    pwall = wall
    if n_np < n:        # the card's server on the same requests, again
        with PlanServer(max_batch=mb, window_s=window, device=dev) as again:
            _, pwall = drive_trace(again, (pop, tail[:n_np - len(pop)]),
                                   gaps)
        log(f"[planserver] the card's server on the same {n_np} requests "
            f"(its programs already captured): {pwall:.3f} s = "
            f"{n_np / pwall:.2f} solves/s; latency ms: "
            f"{lat_line(again.stats())}")
    out.update(numpy_requests=n_np, numpy_wall_s=nwall,
               numpy_solves_per_s=n_np / nwall,
               card_solves_per_s_same_requests=n_np / pwall,
               numpy_latency_ms={k: {q: v[q] * 1e3 for q in
                                     ("p50", "p99", "mean")}
                                 for k, v in nst["latency_s"].items()})
    # the populate phase's cold rows against the NumPy server's (its
    # batched rows are the scalar solver's row for row), the sampled warm
    # rows against their own NumPy solve from the same seed, with the
    # restart as their batch ran it (an all-warm m=J batch skips it)
    bad = []
    for i in range(len(pop)):
        h, nh = handles[i], nhandles[i]
        if nh.scenario is not pop[i] or h.source != "cold":
            raise AssertionError("the two traces are not the same")
        bad += [("cold", i, k) for _, k in
                plan_target_failures([ngot[id(nh)]], [got[id(h)]])]
    warm = [h for h in handles if h.source == "warm"]
    pick = [warm[int(i)] for i in np.linspace(0, len(warm) - 1,
                                              PLAN_WARM_CHECKS).round()]
    for i, h in enumerate(pick):
        ref = solve_param_opt_batched([h.problem], z0s=[h.z0],
                                      backend="numpy",
                                      joint_restart=restarts[id(h)])
        bad += [("warm", i, k) for _, k in
                plan_target_failures(ref, [got[id(h)]])]
        if not h.converged:
            bad.append(("warm", i, "converged"))
    if bad:
        raise AssertionError(f"the card's rows miss the Plan targets of the "
                             f"NumPy solver at {bad}")
    log(f"[planserver] the {len(pop)} cold rows and {len(pick)} evenly "
        f"spaced warm rows (all converged) meet the Plan targets of the "
        f"NumPy solver; every hit's Plan equals its filler's")

    # (3) poison isolation: a wrong-shape warm seed inside a batch of three
    # healthy rows
    budgets = (0.22, 0.25, 0.3)
    healthy_s = [table_scenario("Gen-C", system, consts, C_max=c)
                 for c in budgets]
    bad_s = table_scenario("Gen-C", system, consts, C_max=0.27)
    prob = bad_s.problem(Objective.CONSTANT)
    poison = PlanHandle(bad_s, Objective.CONSTANT, prob,
                        structure_signature(prob), fingerprint(prob), b"x")
    poison.source, poison.z0 = "warm", np.zeros(3)
    key = key_of(prob)
    c0 = gia_fused.capture_count(key)
    psrv = PlanServer(max_batch=mb, window_s=0.2, retry_base_s=0.001,
                      retry_cap_s=0.01, start=False, device=dev)
    healthy = [psrv.submit(s) for s in healthy_s]
    with psrv._cond:
        psrv._queues[poison.sig].insert(1, poison)
    with psrv:
        plans = [h.result(timeout=600) for h in healthy]
        try:
            poison.result(timeout=600)
            raise AssertionError("the poison request resolved")
        except RuntimeError as e:
            err = str(e)
    if dev != "cpu":
        torch.cuda.synchronize()            # no error left on the card
    pst = psrv.stats()
    solo = [s._plan_from_result(Objective.CONSTANT, r) for s, r in zip(
        healthy_s, [solve_param_opt_batched([s.problem()],
                                            backend="torch-fused",
                                            pad_to=mb, device=dev)[0]
                    for s in healthy_s])]
    if not all(same(a, b) for a, b in zip(plans, solo)) or \
            pst["bisections"] < 1 or pst["quarantined"] != 1 or \
            pst["poisoned"] != 1 or gia_fused.capture_count(key) != c0:
        raise AssertionError(f"poison isolation: stats {pst}, captures "
                             f"{gia_fused.capture_count(key) - c0}")
    log(f"[planserver] poison: healthy Plans equal their solo solves; "
        f"bisections {pst['bisections']}, quarantined "
        f"{pst['quarantined']}, poisoned {pst['poisoned']} ({err}); "
        f"captures added 0; a synchronize afterwards raises nothing")
    if dev != "cpu":
        capture_failures(key, [s.problem() for s in healthy_s[:2]], dev)

    # (4) a program captured on this thread, replayed by the dispatcher
    scns = [table_scenario("PM-C-opt", system, consts, C_max=float(c))
            for c in np.linspace(0.22, 0.4, PLAN_THREAD_ROWS)]
    key = key_of(scns[0].problem())
    c0 = gia_fused.capture_count(key)
    main = solve_param_opt_batched([s.problem() for s in scns],
                                   backend="torch-fused", pad_to=mb,
                                   device=dev)
    c1 = gia_fused.capture_count(key)
    tsrv = PlanServer(max_batch=mb, window_s=window, start=False, device=dev)
    tgot, _, threads = keep_results(tsrv)
    ths = [tsrv.submit(s) for s in scns]
    with tsrv:
        for h in ths:
            h.result(timeout=600)
    for h, r in zip(ths, main):
        a = tgot[id(h)]
        if not (np.array_equal(a.z, r.z) and a.iterations == r.iterations
                and a.history == r.history and h.batch_size == len(scns)):
            raise AssertionError("a row replayed by the dispatcher differs "
                                 "from the main thread's")
    if c1 - c0 != 1 or gia_fused.capture_count(key) != c1 or \
            any(tsrv.compile_counts().values()) or \
            threads != {"planserver"}:
        raise AssertionError(f"captures: main thread {c1 - c0}, server "
                             f"{tsrv.compile_counts()} on {threads}")
    log(f"[planserver] across threads: PM-C-opt captured on the main thread"
        f" ({len(scns)} rows padded to {mb}), replayed by the dispatcher "
        f"with no new capture; z, iterations and history bitwise")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"QSGD kernels launched by the server: "
                             f"{launches}")
    out["launches"] = launches

    # (5) a first capture beside training rounds on the card
    def rounds(seed=0):
        gcfg = plan.to_genqsgd_config(max_K0=train_rounds, seed=seed)
        alg = GenQSGD(task.loss, task.make_data(plan.N), task.shapes, gcfg)
        g = torch.Generator(device=task.device)
        x0 = flatten_like(task.init_params(g.manual_seed(seed)))
        xf, _ = alg.run(x0, g.manual_seed(seed + 1),
                        eval_every=max(1, gcfg.K0))
        if xf.is_cuda:
            torch.cuda.synchronize()
        return xf

    solo_x = rounds()
    # a step program no earlier phase captured: gqfedwavg's m=C signature
    # shares Gen-C's program (one layout), which the trace captured
    gq = table_scenario("FA-C-opt", system, consts)
    key = key_of(gq.problem())
    c0 = gia_fused.capture_count(key)
    entered, spans = threading.Event(), []
    # the capture on the card (the first eager run on the CPU)
    hook = "_capture" if dev != "cpu" else "run"
    real = getattr(gia_fused._Program, hook)

    def capture(self, *args):
        entered.set()
        t0 = time.perf_counter()
        try:
            return real(self, *args)
        finally:
            spans.append((t0, time.perf_counter()))

    setattr(gia_fused._Program, hook, capture)
    try:
        with PlanServer(max_batch=mb, window_s=window, device=dev) as gsrv:
            h = gsrv.submit(gq)
            if not entered.wait(600):
                raise AssertionError("the server never began its capture")
            t0 = time.perf_counter()
            beside_x = rounds()
            t1 = time.perf_counter()
            gplan = h.result(timeout=600)
    finally:
        setattr(gia_fused._Program, hook, real)
    again_x = rounds()
    (s0, s1), = spans
    overlap = min(t1, s1) - max(t0, s0)
    gsolo = gq._plan_from_result(Objective.CONSTANT, solve_param_opt_batched(
        [gq.problem()], backend="torch-fused", pad_to=mb, device=dev)[0])
    added = gia_fused.capture_count(key) - c0
    if added != 1 or not same(gplan, gsolo):
        raise AssertionError(f"beside training: {added} captures; Plan "
                             f"{gplan} against its solo solve {gsolo}")
    workers = 1 if len(set(plan.sn)) == 1 else plan.N
    server = 0 if plan.s0 is None else 1
    r3 = 3 * train_rounds
    want = expected_launches(qsgd_sumsq=r3 * (workers + server),
                             qsgd_quantize=r3 * (workers + server),
                             qsgd_dequant_apply=r3 * server)
    if dev != "cpu" and read_launches() != want:   # plain versions: none
        raise AssertionError(f"launches {read_launches()} != {want}")
    diff = float((beside_x - solo_x).abs().max())
    repeat = float((again_x - solo_x).abs().max())
    log(f"[planserver] beside training: FA-C-opt's first capture "
        f"({s1 - s0:.3f} s) overlapped {train_rounds} quickstart rounds "
        f"({t1 - t0:.3f} s) by {overlap:.3f} s; its Plan equals its solo "
        f"solve; final x bitwise the solo run's: "
        f"{torch.equal(beside_x, solo_x)} (max abs diff {diff:.3g}; a "
        f"second solo run: {torch.equal(again_x, solo_x)}, {repeat:.3g})")
    if overlap <= 0:
        raise AssertionError("the capture did not overlap the rounds")
    if not torch.equal(again_x, solo_x):
        raise AssertionError("two solo runs of the rounds differ")
    if not torch.equal(beside_x, solo_x):
        raise AssertionError(f"the rounds beside a capture differ from a "
                             f"solo run by {diff:.3g}")
    out.update(train_overlap_s=overlap, train_bitwise=True,
               capture_s=s1 - s0)
    return out


def phase_sampled_faults(task, consts, rounds: int = SAMPLED_ROUNDS,
                         obs_rounds: int = 50, profile: bool = True) -> dict:
    """Phase 4: client sampling and fault injection through the closed
    loop at full width on ``task``'s device: a cohort of 8 of 10 a round
    and an edge fleet (stragglers, 3-round crashes, corruption) behind an
    adaptive deadline; the cohort and fault traces against a host replay
    of the seed, one sampled and faulted round against the CPU, obs on
    against off, and 20 profiled rounds."""
    import numpy as np
    import torch
    from repro_torch.api import (EdgeSystem, MNISTTask, Scenario,
                                 edge_faults, uniform)
    from repro_torch.core.genqsgd import GenQSGD, flatten_like
    from repro_torch.faults import FaultDriver, FaultSpec, fault_rng
    from repro_torch.sampling import draw_cohort

    dev = task.device
    scenario = Scenario(EdgeSystem.paper_sec_vii(dim=task.dim), consts,
                        T_max=2e5, C_max=0.25, sampling=uniform(SAMPLED_S),
                        faults=edge_faults(**SAMPLED_FAULTS))
    t0 = time.perf_counter()
    plan = scenario.optimize()
    log(f"[sampled] optimize {time.perf_counter() - t0:.2f} s: K0={plan.K0} "
        f"Kn={plan.Kn[0]} B={plan.B} S={plan.cohort_S} "
        f"tau={plan.faults.deadline:.4g} s: {plan.describe()}")
    if not (plan.feasible and plan.cohort_S == SAMPLED_S
            and isinstance(plan.faults, FaultSpec)):
        raise AssertionError(f"want a feasible Plan with cohort_S="
                             f"{SAMPLED_S} and a FaultSpec: {plan}")

    scenario.run(plan, task=task, max_rounds=2, device=dev)   # warm-up
    reset_launches()
    report = scenario.run(plan, task=task, max_rounds=rounds, seed=0,
                          device=dev)
    launches = read_launches()
    log(report.summary())
    ms_round = report.wall_time_s / report.rounds * 1e3
    ft = report.fault_trace
    log(f"[sampled] {report.rounds} rounds, {ms_round:.3f} ms/round, "
        f"test_acc {report.final_metrics['test_acc']:.4f}, launches "
        f"{launches}; {ft.rounds_degraded} rounds degraded, "
        f"{ft.workers_dropped} worker-rounds dropped, tau "
        f"{min(r.deadline for r in ft.records):.4g}.."
        f"{max(r.deadline for r in ft.records):.4g} s")
    want = expected_launches(qsgd_sumsq=2 * rounds,
                             qsgd_quantize=2 * rounds,
                             qsgd_dequant_apply=rounds)
    if len(set(plan.sn)) != 1 or launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")

    # the host replay of the seed: a fresh cohort stream and a fresh
    # FaultDriver on its salted stream, no training
    crng, frng = np.random.default_rng(0), fault_rng(0)
    drv = FaultDriver(plan.faults, plan.N, plan.agg_weights)
    cohorts, us = [], []
    for k in range(rounds):
        idx, pi = draw_cohort(crng, plan.N, plan.cohort_S, plan.sampling_p)
        cohorts.append(idx)
        us.append(drv.step(frng, k, idx, pi))
    if ft != drv.trace():
        raise AssertionError("the run's FaultTrace differs from the replay")
    if [r.cohort for r in ft.records] != \
            [tuple(sorted(int(i) for i in c)) for c in cohorts]:
        raise AssertionError("the run's cohorts differ from the replay")
    bits = tuple(plan.cohort_round_bits(c, dim=task.dim) for c in cohorts)
    if report.round_bits_trace != bits or report.comm_bits != sum(bits):
        raise AssertionError(f"comm bits {report.comm_bits} != the sum of "
                             f"cohort_round_bits {sum(bits)}")
    taus = {r.deadline for r in ft.records}
    if ft.rounds_degraded < 1 or len(taus) < 2:
        raise AssertionError(f"{ft.rounds_degraded} rounds degraded, "
                             f"{len(taus)} distinct deadlines")
    x0 = flatten_like(task.init_params(
        torch.Generator(device=dev).manual_seed(0)))
    loss0 = task.metrics(x0)["eval_loss"]
    m = report.final_metrics
    if not (np.isfinite(m["eval_loss"]) and np.isfinite(m["test_acc"])
            and m["eval_loss"] < loss0):
        raise AssertionError(f"the run did not learn: {m}, initial eval "
                             f"loss {loss0}")
    ledger = report.drift()
    cum = ledger.cumulative()
    if len(ledger) != rounds or not all(np.isfinite(v)
                                        for v in cum.values()):
        raise AssertionError(f"drift ledger of {len(ledger)} rows, "
                             f"cumulative {cum}")
    log(f"[sampled] eval loss {loss0:.4f} -> {m['eval_loss']:.4f}; "
        f"{ledger.summary()}")

    # one sampled and faulted round, card against CPU, with the replay's
    # weights of the round that drops the most workers
    u = max(us, key=lambda v: int(np.sum(v == 0)))
    if int(np.sum(u == 0)) < 2:
        raise AssertionError(f"no replayed round zeroes two workers: {u}")
    cfg = plan.to_genqsgd_config(max_K0=1, seed=0)
    cpu_task = task if dev.type == "cpu" else MNISTTask(device="cpu")
    algs = {"dev": GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                           cfg),
            "cpu": GenQSGD(cpu_task.loss, cpu_task.make_data(plan.N),
                           cpu_task.shapes, cfg)}
    gen = torch.Generator(device="cpu").manual_seed(13)
    x0 = flatten_like(cpu_task.init_params(gen))
    D = x0.shape[0]
    idx = torch.randint(0, algs["cpu"].n_local, (plan.N, plan.K_max, plan.B),
                        generator=gen)
    uw, us_ = torch.rand(plan.N, D, generator=gen), torch.rand(D,
                                                               generator=gen)
    u_t = torch.as_tensor(u, dtype=torch.float32)
    gamma = plan.gamma
    x_cpu, m_cpu = algs["cpu"].round(x0, idx, uw, us_, gamma, u_t)
    x_dev, _ = algs["dev"].round(x0.to(dev), idx.to(dev), uw.to(dev),
                                 us_.to(dev), gamma, u_t.to(dev))
    diff = (x_dev.cpu() - x_cpu).abs()
    level = gamma * float(m_cpu["delta_norm"]) / plan.s0
    if float(diff.max()) > 2 * level + 1e-6 or \
            int((diff > 1e-6).sum()) > D // 1000:
        raise AssertionError(f"device round differs from the CPU round: max "
                             f"{float(diff.max()):.3g} (level {level:.3g}), "
                             f"{int((diff > 1e-6).sum())} coordinates")
    log(f"[sampled] one round (u zeroes {int(np.sum(u == 0))} workers) "
        f"device vs CPU: max abs diff {float(diff.max()):.3g} (server level "
        f"{level:.3g})")

    obs_check(scenario, plan, task, obs_rounds, level)
    if profile:
        alg = GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                      plan.to_genqsgd_config(max_K0=20, seed=0))
        profile_run(alg, x0.to(dev), torch.Generator(device=dev))
    return {"launches": launches, "ms_round": ms_round}


def obs_check(scenario, plan, task, rounds: int, level: float) -> None:
    """``rounds`` sampled and faulted rounds with obs off and on: equal
    reports apart from wall time and the model, equal traces; the model
    bitwise equal where the card repeats a run bitwise (else within two
    server levels); the drift ledger written only with obs on."""
    import torch
    from repro_torch import obs
    from repro_torch.core.genqsgd import GenQSGD, flatten_like

    dev = task.device
    os.environ["REPRO_OBS_DIR"] = os.path.join(ROOT, "build", "obs")
    ledger_path = obs.artifact_path(
        f"ledger_{plan.family}_reference_seed0.jsonl")
    if os.path.exists(ledger_path):
        os.remove(ledger_path)
    alg = GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                  plan.to_genqsgd_config(max_K0=rounds, seed=0))
    x0 = flatten_like(task.init_params(
        torch.Generator(device=dev).manual_seed(0)))

    def run():
        x, _ = alg.run(x0, torch.Generator(device=dev).manual_seed(1))
        return x, list(alg.cohort_trace), alg.fault_trace

    off = scenario.run(plan, task=task, max_rounds=rounds, seed=0,
                       device=dev)
    x_off, c_off, f_off = run()
    if os.path.exists(ledger_path):
        raise AssertionError("obs off wrote a ledger")
    try:
        obs.enable(reset=True)
        on = scenario.run(plan, task=task, max_rounds=rounds, seed=0,
                          device=dev)
        x_on, c_on, f_on = run()
        n = obs.REGISTRY.counter("run.rounds", backend="reference").value
    finally:
        obs.disable()
        obs.REGISTRY.reset()
        obs.TRACER.clear()
    same = (on.comm_bits == off.comm_bits and on.measured_E == off.measured_E
            and on.measured_T == off.measured_T
            and on.round_bits_trace == off.round_bits_trace
            and on.fault_trace == off.fault_trace == f_on == f_off
            and on.drift() == off.drift()
            and all((a == b).all() for a, b in zip(c_on, c_off)))
    if not same or n != 2 * rounds:
        raise AssertionError(f"obs on changed the run (or counted {n} "
                             f"rounds, want {2 * rounds})")
    if obs.RunLedger.load_jsonl(ledger_path) != on.drift():
        raise AssertionError("the written ledger differs from drift()")
    if torch.equal(x_on, x_off) and on.final_metrics == off.final_metrics:
        log(f"[sampled] obs on vs off over {rounds} rounds: reports, traces "
            f"and the model bitwise equal; ledger {ledger_path}")
        return
    x_again, _, _ = run()
    diff = float((x_on - x_off).abs().max())
    if torch.equal(x_again, x_off) or diff > 2 * level + 1e-6:
        raise AssertionError(f"obs on moved the model by {diff:.3g} on a "
                             f"card that repeats runs bitwise")
    log(f"[sampled] obs on vs off over {rounds} rounds: reports and traces "
        f"equal; the card does not repeat a run bitwise, model within "
        f"{diff:.3g} (server level {level:.3g})")


def phase_gqfedwavg(task, consts, max_rounds: int = WAVG_ROUNDS,
                    profile: bool = True) -> dict:
    """Phase 5: the GQFedWAvg closed loop at full width on ``task``'s
    device, then one round on it against the same round on the CPU."""
    import numpy as np
    import torch
    from repro_torch.api import EdgeSystem, MNISTTask, Scenario
    from repro_torch.compress import make_codec
    from repro_torch.core.genqsgd import GenQSGD, flatten_like

    dev = task.device
    system = EdgeSystem.paper_sec_vii(dim=task.dim)
    scenario = Scenario(system=system, consts=consts, T_max=1e5, C_max=0.25,
                        family="gqfedwavg")
    t0 = time.perf_counter()
    plan = scenario.optimize()
    log(f"[gqfedwavg] optimize {time.perf_counter() - t0:.2f} s: "
        f"{plan.describe()}")
    if not plan.feasible or plan.codec_kind != "rotated":
        raise AssertionError(f"want a feasible rotated Plan, got feasible="
                             f"{plan.feasible} codec_kind={plan.codec_kind}")

    rounds = min(plan.K0, max_rounds)
    scenario.run(plan, task=task, max_rounds=2, device=dev)   # warm-up
    reset_launches()
    report = scenario.run(plan, task=task, max_rounds=rounds, device=dev)
    launches = read_launches()
    log(report.summary())
    ms_round = report.wall_time_s / report.rounds * 1e3
    log(f"[gqfedwavg] {report.rounds} rounds, {ms_round:.3f} ms/round, "
        f"test_acc {report.final_metrics['test_acc']:.4f}, "
        f"launches {launches}")

    priced = scenario._priced_system
    want_bits = report.rounds * (float(np.sum(priced.M_sn)) + priced.M_s0)
    msg = [make_codec(s_, kind="rotated").wire_bits(task.dim)
           for s_ in list(plan.sn) + [plan.s0]]
    if report.comm_bits != want_bits or \
            report.comm_bits != report.rounds * sum(msg):
        raise AssertionError(f"comm bits {report.comm_bits} != rounds * "
                             f"(sum M_sn + M_s0) = {want_bits} at the rotated "
                             f"pricing {msg[-1]} bits/message")
    workers = 1 if len(set(plan.sn)) == 1 else plan.N
    want = expected_launches(qsgd_sumsq=rounds * (workers + 1),
                             qsgd_quantize=rounds * (workers + 1))
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    x0 = flatten_like(task.init_params(
        torch.Generator(device=dev).manual_seed(0)))
    loss0 = task.metrics(x0)["eval_loss"]
    m = report.final_metrics
    if not (np.isfinite(m["eval_loss"]) and np.isfinite(m["test_acc"])
            and m["eval_loss"] < loss0):
        raise AssertionError(f"the run did not learn: {m}, initial eval "
                             f"loss {loss0}")
    log(f"[gqfedwavg] eval loss {loss0:.4f} -> {m['eval_loss']:.4f}")

    # one round, unequal weights and beta = 0.9, on the device vs the CPU
    w = np.asarray(SMOKE_WEIGHTS, np.float64)
    cfg = dataclasses.replace(plan.to_genqsgd_config(max_K0=1),
                              momentum=SMOKE_MOMENTUM,
                              agg_weights=tuple(float(x) for x in w / w.sum()))
    cpu_task = task if dev.type == "cpu" else MNISTTask(device="cpu")
    algs = {"dev": GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                           cfg),
            "cpu": GenQSGD(cpu_task.loss, cpu_task.make_data(plan.N),
                           cpu_task.shapes, cfg)}
    gen = torch.Generator(device="cpu").manual_seed(11)
    x0 = flatten_like(cpu_task.init_params(gen))
    D, M = x0.shape[0], algs["cpu"].msg_dim
    idx = torch.randint(0, algs["cpu"].n_local, (plan.N, plan.K_max, plan.B),
                        generator=gen)
    uw, us = torch.rand(plan.N, M, generator=gen), torch.rand(M, generator=gen)
    gamma = plan.gamma
    draws = tuple(t.to(dev) for t in (idx, uw, us))
    x_cpu, m_cpu = algs["cpu"].round(x0, idx, uw, us, gamma)
    x_dev, _ = algs["dev"].round(x0.to(dev), *draws, gamma)
    diff = (x_dev.cpu() - x_cpu).abs()
    level = gamma * float(m_cpu["delta_norm"]) / plan.s0
    if float(diff.max()) > 2 * level + 1e-6 or \
            int((diff > 1e-6).sum()) > D // 1000:
        raise AssertionError(f"device round differs from the CPU round: max "
                             f"{float(diff.max()):.3g} (level {level:.3g}), "
                             f"{int((diff > 1e-6).sum())} coordinates")
    log(f"[gqfedwavg] one round (weights {SMOKE_WEIGHTS}, beta "
        f"{SMOKE_MOMENTUM}) device vs CPU: max abs diff "
        f"{float(diff.max()):.3g} (server level {level:.3g})")
    deltas = algs["dev"].worker_deltas(x0.to(dev), draws[0],
                                       float(np.float32(gamma)))
    if profile:
        profile_rounds(algs["dev"], x_dev, draws, gamma)
    return {"launches": launches, "ms_round": ms_round, "deltas": deltas}


def phase_payload(deltas) -> dict:
    """Phase 6: ``encode_payload`` -> ``decode_payload`` on the device of
    ``deltas``, against ``decode(*encode(y, u))`` of the same codec."""
    import torch
    from repro_torch.compress import FUSED_ROTATE_MAX_DIM, make_codec
    from repro_torch.compress.rotation import rotate
    from repro_torch.compress.wire import unpack_int4
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K

    dev = deltas.device
    gen = torch.Generator(device=dev).manual_seed(2)
    msgs = [("10 worker deltas", deltas)] + [
        (f"n={n}", torch.randn(n, generator=gen, device=dev) * 3.0)
        for n in PAYLOAD_NS]
    cases = []
    want = dict.fromkeys(read_launches(), 0)
    for kind in ("qsgd", "rotated"):
        for wire, s in (("int4", 7), ("int8", 127)):
            codec = make_codec(s, wire=wire, kind=kind, backend="cuda")
            for name, y in msgs:
                m = codec.padded_dim(y.shape[-1])
                u = torch.rand(*y.shape[:-1], m, generator=gen, device=dev)
                cases.append((kind, wire, s, codec, name, y, u, m))
                # the reference's dispatch: int4 -> the fused encodes,
                # everything else -> encode (rotate +) K1/K2
                if wire != "int4":
                    want["qsgd_sumsq"] += 1
                    want["qsgd_quantize"] += 1
                elif kind == "rotated" and m <= FUSED_ROTATE_MAX_DIM:
                    want["fused_rotate_encode"] += 1
                else:
                    want["fused_encode"] += 1
    reset_launches()
    out = []
    for kind, wire, s, codec, name, y, u, m in cases:
        payload, norm, nbits = codec.encode_payload(y, u)
        out.append((payload, norm, nbits,
                    codec.decode_payload(payload, norm, m)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(FE.ROUTES)
    if launches != want:
        raise AssertionError(f"payload launches {launches} != expected "
                             f"{want}")
    for name in ("fused_encode", "fused_rotate_encode"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the payload path")
    if sum(routes.values()) != launches["fused_encode"] or \
            (dev.type == "cuda" and routes["one_launch"] == 0):
        raise AssertionError(f"K4's routes on the payload path: {routes}")
    log(f"[payload] {len(cases)} payloads, launches {launches}, K4 by route "
        f"{routes}")

    for (kind, wire, s, codec, name, y, u, m), (payload, norm, nbits, dec) \
            in zip(cases, out):
        rows = y.numel() // y.shape[-1]
        bits = 8 * ((m + 1) // 2) if wire == "int4" else 8 * m
        if nbits != rows * bits:
            raise AssertionError(f"{kind}/{wire} {name}: nbits {nbits} != "
                                 f"{rows} x {bits}")
        # the kernels that made this payload against their plain versions
        # on the same message and u: K1's (or K4's, K5's) norm within
        # rtol 1e-6, and the bytes identical to the plain quantize (+ pack)
        # fed the kernel's norm
        msg = (rotate(y, codec.seed) if kind == "rotated" else y)
        msg, u2 = msg.reshape(rows, m), u.reshape(rows, m)
        norm2 = norm.reshape(rows)
        torch.testing.assert_close(norm2, K.sumsq_plain(msg, s)[1],
                                   rtol=1e-6, atol=0)
        if not torch.equal(payload.reshape(rows, -1), payload_given_norm(
                msg, u2, s, norm2, wire == "int4")):
            raise AssertionError(f"{kind}/{wire} {name}: payload differs "
                                 f"from the plain versions' given the "
                                 f"kernel's norm")
        lvl_e, norm_e = codec.encode(y, u)
        lvl = unpack_int4(payload, m) if wire == "int4" else payload
        k5 = wire == "int4" and kind == "rotated" and \
            m <= FUSED_ROTATE_MAX_DIM
        flips = (lvl.to(torch.int32) - lvl_e.to(torch.int32)).abs()
        nflip = int((flips > 0).sum())
        if not k5:
            # K4's norm is K1's bit for bit, and int8 payloads are encode's
            if not (torch.equal(norm, norm_e) and nflip == 0
                    and torch.equal(dec, codec.decode(lvl_e, norm_e))):
                raise AssertionError(f"{kind}/{wire} {name}: payload differs "
                                     f"from encode ({nflip} levels)")
        else:
            # K5 sums the norm in another order than K1: within 2 ulp, and
            # a level may flip where u falls within that ulp of its fraction
            torch.testing.assert_close(norm, norm_e, rtol=2.4e-7, atol=0)
            if int(flips.max()) > 1 or nflip > max(1, m // 10000):
                raise AssertionError(f"{kind}/{wire} {name}: {nflip} levels "
                                     f"differ from encode's")
            # the same levels decoded with encode's norm: the norm's ulp,
            # carried through the unrotation's butterflies, whose rounding
            # scales with the message's largest value
            ref = codec.decode(lvl, norm_e)
            torch.testing.assert_close(dec, ref, rtol=1e-6,
                                       atol=1e-6 * float(ref.abs().max()))
        if dec.shape[-1] != m or not bool(torch.isfinite(dec).all()):
            raise AssertionError(f"{kind}/{wire} {name}: bad decode "
                                 f"{tuple(dec.shape)}")
        log(f"[payload] {kind}/{wire} s={s} {name}: m={m} nbits={nbits} "
            f"{'K5' if k5 else 'K4' if wire == 'int4' else 'K1/K2'}, "
            f"{nflip} level flips")
    return {"launches": launches}


def count_plain_calls():
    """Wrap every kernel's plain version in its module with a counter: ->
    (counts, undo).  The wrappers look their plain versions up in their
    own module, so a plain version that runs on the path shows here."""
    from repro_torch.kernels import elias as KE
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K
    counts, saved = {}, []
    for mod, name in ((K, "sumsq_plain"), (K, "quantize_plain"),
                      (K, "dequant_apply_plain"),
                      (K, "dequant_apply_bucketed_plain"),
                      (FE, "fused_encode_plain"),
                      (FE, "fused_rotate_encode_plain"),
                      (KE, "elias_decode_plain")):
        fn = getattr(mod, name)
        counts[name] = 0

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return counts, undo


def phase_bucketed(task, consts, rounds: int = BUCKETED_ROUNDS,
                   profile: bool = True) -> dict:
    """The bucketed quickstart at full width on ``task``'s device: the
    README system with q_dim = 4096, ``optimize()`` -> ``run(plan,
    max_rounds=400)`` with the counters read around the run (K1/K2 over the
    workers' 250 and the server's 25 bucket rows, K3b the apply; K3 and
    every plain version never), comm bits rounds * (sum M_sn + M_s0) at
    the bucketed wire's bits, one round on the device against the CPU with
    the same draws, 20 rounds profiled."""
    import numpy as np
    import torch
    from repro_torch.api import EdgeSystem, MNISTTask, Scenario
    from repro_torch.core.genqsgd import GenQSGD, flatten_like

    dev = task.device
    system = dataclasses.replace(EdgeSystem.paper_sec_vii(dim=task.dim),
                                 q_dim=BUCKET)
    scenario = Scenario(system=system, consts=consts, T_max=1e5, C_max=0.25)
    t0 = time.perf_counter()
    plan = scenario.optimize()
    log(f"[bucketed] optimize {time.perf_counter() - t0:.2f} s: "
        f"{plan.describe()}")
    if not (plan.feasible and plan.q_dim == BUCKET
            and len(set(plan.sn)) == 1 and plan.s0 is not None):
        raise AssertionError(f"want a feasible Plan with q_dim={BUCKET} and "
                             f"one quantizer: {plan}")
    rounds = min(plan.K0, rounds)
    scenario.run(plan, task=task, max_rounds=2, device=dev)   # warm-up
    reset_launches()
    plain, undo = count_plain_calls()
    try:
        report = scenario.run(plan, task=task, max_rounds=rounds, device=dev)
    finally:
        undo()
    launches = read_launches()
    log(report.summary())
    ms_round = report.wall_time_s / report.rounds * 1e3
    log(f"[bucketed] {report.rounds} rounds, {ms_round:.3f} ms/round, "
        f"test_acc {report.final_metrics['test_acc']:.4f}, launches "
        f"{launches}, plain versions {plain}")
    want = expected_launches(qsgd_sumsq=2 * rounds, qsgd_quantize=2 * rounds,
                             qsgd_dequant_apply_bucketed=rounds)
    on_card = dev.type == "cuda"
    if on_card and (launches != want or any(plain.values())):
        raise AssertionError(f"launches {launches} != expected {want}, or a "
                             f"plain version ran: {plain}")
    want_bits = report.rounds * (float(np.sum(system.M_sn)) + system.M_s0)
    whole = EdgeSystem.paper_sec_vii(dim=task.dim)
    if report.comm_bits != want_bits or \
            want_bits == report.rounds * (float(np.sum(whole.M_sn))
                                          + whole.M_s0):
        raise AssertionError(f"comm bits {report.comm_bits} != rounds * "
                             f"(sum M_sn + M_s0) = {want_bits} at the "
                             f"bucketed pricing")
    x0 = flatten_like(task.init_params(
        torch.Generator(device=dev).manual_seed(0)))
    loss0 = task.metrics(x0)["eval_loss"]
    m = report.final_metrics
    if not (np.isfinite(m["eval_loss"]) and m["eval_loss"] < loss0
            and (rounds < 100 or m["test_acc"] > 0.2)):
        raise AssertionError(f"the run did not learn: {m}, initial eval "
                             f"loss {loss0}")
    log(f"[bucketed] eval loss {loss0:.4f} -> {m['eval_loss']:.4f}; "
        f"comm bits {report.comm_bits:.6g} = rounds x (sum M_sn "
        f"+ M_s0) at {system.M_s0:.6g} bits a message ({whole.M_s0:.6g} "
        f"unbucketed)")

    cfg = plan.to_genqsgd_config(max_K0=1)
    cpu_task = task if dev.type == "cpu" else MNISTTask(device="cpu")
    algs = {"dev": GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                           cfg),
            "cpu": GenQSGD(cpu_task.loss, cpu_task.make_data(plan.N),
                           cpu_task.shapes, cfg)}
    gen = torch.Generator(device="cpu").manual_seed(17)
    x0 = flatten_like(cpu_task.init_params(gen))
    D = x0.shape[0]
    idx = torch.randint(0, algs["cpu"].n_local, (plan.N, plan.K_max, plan.B),
                        generator=gen)
    uw, us = torch.rand(plan.N, D, generator=gen), torch.rand(D, generator=gen)
    gamma = plan.gamma
    draws = tuple(t.to(dev) for t in (idx, uw, us))
    x_cpu, m_cpu = algs["cpu"].round(x0, idx, uw, us, gamma)
    x_dev, _ = algs["dev"].round(x0.to(dev), *draws, gamma)
    diff = (x_dev.cpu() - x_cpu).abs()
    # a bucket's server level gamma * norm_b / s0 is at most the whole
    # delta's
    level = gamma * float(m_cpu["delta_norm"]) / plan.s0
    if float(diff.max()) > 2 * level + 1e-6 or \
            int((diff > 1e-6).sum()) > D // 1000:
        raise AssertionError(f"device round differs from the CPU round: max "
                             f"{float(diff.max()):.3g} (level {level:.3g}), "
                             f"{int((diff > 1e-6).sum())} coordinates")
    log(f"[bucketed] one round device vs CPU: max abs diff "
        f"{float(diff.max()):.3g} (server level {level:.3g})")
    if profile:
        # the host varies between phases by as much as bucketing could
        # cost: time the bucketed and the whole-message round in turns
        whole_alg = GenQSGD(task.loss, task.make_data(plan.N), task.shapes,
                            dataclasses.replace(cfg, bucket=None))
        paired_rounds({"bucketed": algs["dev"], "whole": whole_alg}, x_dev,
                      draws, gamma)
        profile_rounds(algs["dev"], x_dev, draws, gamma)
    return {"launches": launches, "ms_round": ms_round}


def paired_rounds(algs: dict, x, draws, gamma, pairs: int = 6,
                  rounds: int = 40) -> dict:
    """ms per round of each of two round functions on the same draws,
    timed in turns (a, b, b, a, ...) in blocks of ``rounds`` rounds that
    each end in a synchronize; -> the per-block times of each."""
    import torch
    names = list(algs)
    out = {n: [] for n in names}
    for alg in algs.values():                     # warm-up
        alg.round(x, *draws, gamma)
    torch.cuda.synchronize()
    for p in range(pairs):
        for n in (names if p % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            xx = x
            for _ in range(rounds):
                xx, _ = algs[n].round(xx, *draws, gamma)
            torch.cuda.synchronize()
            out[n].append((time.perf_counter() - t0) / rounds * 1e3)
    a, b = names
    wins = sum(ta < tb for ta, tb in zip(out[a], out[b]))
    log(f"[paired] {pairs} pairs of {rounds} rounds in turns: {a} median "
        f"{statistics.median(out[a]):.3f} ms/round ({', '.join(f'{t:.3f}' for t in out[a])}), "
        f"{b} median {statistics.median(out[b]):.3f} "
        f"({', '.join(f'{t:.3f}' for t in out[b])}); {a} faster in "
        f"{wins} of {pairs}")
    return out


def phase_payload_buckets(deltas) -> dict:
    """Phase 6, continued: bucket 4096 on the int4, int8 and packed wires
    over the 10 worker deltas and the 1-D messages of PAYLOAD_NS, and wire
    "elias" at s in {7, 127}, unbucketed and bucketed, over the deltas and
    ELIAS_NS: ``encode_payload`` on the device, then ``decode_payload``,
    with the counters read around them; each payload held against the
    plain versions (the norms within rtol 1e-6, the bytes or words
    identical given the kernels' norms, elias streams decoded by the host's
    plain walk) and against ``decode(*encode(y, u))``."""
    import torch
    from repro_torch.compress import backends as B
    from repro_torch.compress import elias as E
    from repro_torch.compress import make_codec
    from repro_torch.compress.wire import level_bits, pack_int4, unpack_int4
    from repro_torch.kernels import elias as KE
    from repro_torch.kernels import qsgd as K

    dev = deltas.device
    gen = torch.Generator(device=dev).manual_seed(4)
    msgs = [("10 worker deltas", deltas)] + [
        (f"n={n}", torch.randn(n, generator=gen, device=dev) * 3.0)
        for n in sorted(set(PAYLOAD_NS) | set(ELIAS_NS))]
    cases = []
    want = expected_launches()
    for wire, s, q in (("int4", 7, BUCKET), ("int8", 127, BUCKET),
                       ("packed", 127, BUCKET), ("elias", 7, None),
                       ("elias", 127, None), ("elias", 7, BUCKET),
                       ("elias", 127, BUCKET)):
        codec = make_codec(s, wire=wire, bucket=q, backend="cuda")
        for name, y in msgs:
            n = y.shape[-1]
            if wire == "elias" and name != msgs[0][0] and n not in ELIAS_NS:
                continue
            u = torch.rand(y.shape, generator=gen, device=dev)
            cases.append((wire, s, q, codec, name, y, u))
            rows = y.numel() // n * (1 if q is None else -(-n // q))
            chunks = len(K.row_chunks(rows))
            if wire == "int4":
                want["fused_encode"] += chunks
            else:
                want["qsgd_sumsq"] += chunks
                want["qsgd_quantize"] += chunks
            if wire == "elias":
                want["elias_decode"] += 1
    reset_launches()
    out = []
    for wire, s, q, codec, name, y, u in cases:
        payload, norm, nbits = codec.encode_payload(y, u)
        out.append((payload, norm, nbits,
                    codec.decode_payload(payload, norm, y.shape[-1])))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"bucketed and elias payload launches "
                             f"{launches} != expected {want}")
    log(f"[payload] {len(cases)} bucketed and elias payloads, launches "
        f"{launches}")

    for (wire, s, q, codec, name, y, u), (payload, norm, nbits, dec) \
            in zip(cases, out):
        n = y.shape[-1]
        lvl_e, norm_e = codec.encode(y, u)
        # the plain versions on the same rows: bucket rows (or whole
        # messages) through K1's and K2's plain versions given the
        # kernels' norms
        qq = n if q is None else q
        yb, ub = (B.to_buckets(t, qq).reshape(-1, qq) for t in (y, u))
        nrm = norm.reshape(-1)
        torch.testing.assert_close(nrm, K.sumsq_plain(yb, s)[1], rtol=1e-6,
                                   atol=0)
        flat = payload_given_norm(yb, ub, s, nrm, False) \
            .reshape(*y.shape[:-1], -1)[..., :n]
        if wire == "int4":
            lvl, ok = unpack_int4(payload, n), torch.equal(payload,
                                                           pack_int4(flat))
            bits = 8 * payload.numel()
        elif wire == "elias":
            lvl = KE.elias_decode_plain(payload.cpu(), n).to(dev)
            words, stream = E.encode_levels(flat.to(torch.int8))
            ok = torch.equal(payload, words)
            bits = int(stream.sum())
        else:
            lvl, ok = payload, torch.equal(payload, flat)
            bits = int(level_bits(s, wire) * payload.numel())
        if not ok or int(nbits) != bits:
            raise AssertionError(f"{wire} s={s} bucket={q} {name}: payload "
                                 f"differs from the plain versions' given the "
                                 f"kernels' norms (nbits {nbits}, {bits})")
        if not (torch.equal(norm, norm_e) and torch.equal(
                lvl.to(torch.int32), lvl_e.to(torch.int32))
                and torch.equal(dec, codec.decode(lvl_e, norm_e))):
            raise AssertionError(f"{wire} s={s} bucket={q} {name}: differs "
                                 f"from decode(*encode(y, u))")
        if dec.shape != y.shape or not bool(torch.isfinite(dec).all()):
            raise AssertionError(f"{wire} {name}: bad decode "
                                 f"{tuple(dec.shape)}")
        log(f"[payload] {wire} s={s} bucket={q} {name}: {tuple(norm.shape)} "
            f"norms, nbits={int(nbits)}, equal to the plain versions and to "
            f"decode(*encode)")
    return {"launches": launches}


def k6_inputs(B, C, KV, G, dh, q_type, kv_type, mask, dev, gen):
    """Phase 7's inputs on ``dev`` from ``gen``: q (B, KV, G, dh), k/v
    (B, C, KV, dh), a bool (B, C) mask of the named kind."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    q = (torch.randn(B, KV, G, dh, generator=gen, device=dev) * 2).to(
        types[q_type])
    k = torch.randn(B, C, KV, dh, generator=gen, device=dev).to(
        types[kv_type])
    v = torch.randn(B, C, KV, dh, generator=gen, device=dev).to(
        types[kv_type])
    cpos = torch.arange(C, device=dev).expand(B, C)
    lens = torch.randint(1, (448 if mask == "prefix448" else C) + 1, (B, 1),
                         generator=gen, device=dev)
    if mask == "window":
        q_pos = torch.randint(0, C, (B, 1), generator=gen, device=dev)
        valid = (cpos <= q_pos) & (cpos > q_pos - K6_WINDOW)
    elif mask == "one":
        valid = cpos == lens - 1
    elif mask == "all":
        valid = torch.ones(B, C, dtype=torch.bool, device=dev)
    else:
        valid = cpos < lens
        if mask == "none-row0":
            valid[0] = False
        if mask == "one-split":
            tile = FD.stage_positions(dh, k.element_size())
            lo, hi = FD.split_ranges(C, tile)[1][FD.SPLITS // 2 - 1]
            valid[0] = False
            valid[0, lo:hi] = torch.rand(hi - lo, generator=gen,
                                         device=dev) < 0.5
            valid[0, (lo + hi) // 2] = True
    return q, k, v, valid


def k6_sdpa(q, k, v, valid):
    """The yardstick: one ``scaled_dot_product_attention`` call, (B, heads,
    1, dh) against (B, KV, C, dh) views of the cache with a boolean mask,
    or with no mask where every entry is valid (the same function, and
    SDPA's fused backends take it); ``enable_gqa`` only where G > 1 (at
    G = 1 the heads already pair up).  SDPA takes one type for q, k, v, so
    q is cast to the cache's type beforehand.  -> (call, what)."""
    import torch.nn.functional as F
    B, KV, G, dh = q.shape
    qs = q.to(k.dtype).reshape(B, KV * G, 1, dh)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    ms4 = None if bool(valid.all()) else valid[:, None, None, :]
    what = ("no mask" if ms4 is None else "a boolean mask") \
        + ", q in the cache's type"
    if G == 1:
        return (lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       attn_mask=ms4),
                f"sdpa, {what}")
    try:
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms4,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=ms4, enable_gqa=True),
            f"sdpa(enable_gqa=True), {what}")
    except TypeError:              # no enable_gqa: kv heads expanded first
        ke = ks.repeat_interleave(G, dim=1)
        ve = vs.repeat_interleave(G, dim=1)
        return (lambda: F.scaled_dot_product_attention(qs, ke, ve,
                                                       attn_mask=ms4),
                f"sdpa on kv heads expanded G times, {what}")


def k6_query(what: str, q, k) -> int:
    """A number the K6 library reports of its instantiation for these types
    and widths: ``flash_decode_blocks_per_sm`` (the blocks one SM holds at
    once, cudaOccupancyMaxActiveBlocksPerMultiprocessor) or
    ``flash_decode_tile`` (the positions of a stage tile)."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    fn = getattr(build.load("flash_decode"), what)
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(q.shape[2], q.shape[3], int(q.dtype == torch.bfloat16),
             int(k.dtype == torch.bfloat16), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
    return n.value


def phase_flash_decode(dev) -> dict:
    """Phase 7: K6 against its plain version on ``dev`` at every shape of
    K6_SHAPES, twice (the two outputs bitwise equal), then (on the card) its
    times at K6_TIMED beside its plain version's and SDPA's."""
    import torch
    from repro_torch.kernels import flash_decode as FD

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    for name, B, C, KV, G, dh, qt, kvt, mask in K6_SHAPES:
        q, k, v, valid = k6_inputs(B, C, KV, G, dh, qt, kvt, mask, dev, gen)
        out = FD.flash_decode(q, k, v, valid)
        again = FD.flash_decode(q, k, v, valid)
        ref = FD.flash_decode_plain(q, k, v, valid)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if out.dtype != q.dtype or out.shape != q.shape:
            raise AssertionError(f"K6 {name}: output {out.dtype} "
                                 f"{tuple(out.shape)}")
        if not torch.equal(out.view(torch.int16 if qt == "bf16" else
                                    torch.int32),
                           again.view(torch.int16 if qt == "bf16" else
                                      torch.int32)):
            raise AssertionError(f"K6 {name}: two calls on the same inputs "
                                 f"differ")
        # f32 accumulation on both sides, in another order; a bf16 output
        # is the f32 result rounded, so one bf16 ulp apart at most
        rtol = K6_TOL if qt == "f32" else 2.0 ** -7
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=K6_TOL)
        err = float((out.float() - ref.float()).abs().max())
        if mask == "one":          # the one valid v row
            idx = valid.float().argmax(1)
            want = v[torch.arange(B, device=dev), idx].float()[:, :, None]
            torch.testing.assert_close(out.float(), want.expand_as(out),
                                       rtol=K6_TOL, atol=K6_TOL)
        if mask == "none-row0":    # uniform weights: the mean of v
            want = v[0].float().mean(0)[:, None].expand_as(out[0])
            torch.testing.assert_close(out[0].float(), want,
                                       rtol=rtol, atol=K6_TOL)
        if name == "serving":
            worst = err
        tile = ""
        if dev.type == "cuda":
            # the CPU model's tile (the tests' merge model and the
            # one-split mask use it) must be the kernel's own
            t = k6_query("flash_decode_tile", q, k)
            model = FD.stage_positions(dh, k.element_size())
            if t != model:
                raise AssertionError(f"K6 {name}: the library's tile {t} != "
                                     f"stage_positions {model}")
            tile = f", tile {t} = stage_positions"
        log(f"[k6] {name}: B={B} C={C} KV={KV} G={G} dh={dh} q {qt} cache "
            f"{kvt} mask {mask}: max abs err {err:.3g}, repeat bitwise{tile}")
    log("[k6] flash decode agrees with its plain version at every shape")
    if dev.type != "cuda":
        return {"worst": {"flash_decode": worst}, "main": {}}

    # inputs one element past a 16-byte boundary: q at the serving shape,
    # q, k and v at a ragged one; the kernel runs on aligned copies, so the
    # result is bitwise the aligned call's
    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:] \
            .view(t.shape).copy_(t)

    for (name, B, C, KV, G, dh, qt, kvt, mask), which in (
            (K6_SHAPES[0], "q"), (K6_SHAPES[5], "qkv")):
        q, k, v, valid = k6_inputs(B, C, KV, G, dh, qt, kvt, mask, dev, gen)
        args = [off(t) if c in which else t for t, c in zip((q, k, v), "qkv")]
        before = FD.LAUNCHES["flash_decode"]
        out = FD.flash_decode(*args, valid)
        want = FD.flash_decode(q, k, v, valid)
        torch.cuda.synchronize()
        if FD.LAUNCHES["flash_decode"] != before + 2 or not all(
                t.data_ptr() % 16 for t, c in zip(args, "qkv") if c in which):
            raise AssertionError("K6 did not launch on the unaligned views")
        if not torch.equal(out.float().view(torch.int32),
                           want.float().view(torch.int32)):
            raise AssertionError(f"K6 {name}: unaligned {which} differs from "
                                 f"the aligned call")
        rtol = K6_TOL if qt == "f32" else 2.0 ** -7
        torch.testing.assert_close(out.float(), FD.flash_decode_plain(
            q, k, v, valid).float(), rtol=rtol, atol=K6_TOL)
        log(f"[k6] {name}: {which} one element past a 16-byte boundary: "
            f"bitwise the aligned call, agrees with the plain version")

    main = {}
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2**20)
    for name, B, C, KV, G, dh, qt, kvt, mask in K6_SHAPES:
        if name not in K6_TIMED:
            continue
        q, k, v, valid = k6_inputs(B, C, KV, G, dh, qt, kvt, mask, dev, gen)
        kv_bytes = 2 * k.numel() * k.element_size()
        nbytes = kv_bytes + 2 * q.numel() * q.element_size() + valid.numel()
        bnd, by = bound_ms(nbytes, 4 * B * KV * G * C * dh)
        # sets of inputs taken in turn, K6_L2_SPAN times L2 together, so
        # that no call finds its inputs in L2 from the call before
        n_sets = max(2, -(-K6_L2_SPAN * l2 // nbytes))
        sets = [(q, k, v, valid)] + [
            k6_inputs(B, C, KV, G, dh, qt, kvt, mask, dev, gen)
            for _ in range(n_sets - 1)]
        kern = [lambda a=a: FD.flash_decode(*a) for a in sets]
        plain = [lambda a=a: FD.flash_decode_plain(*a) for a in sets]
        libs = [k6_sdpa(*a) for a in sets]
        lib, lib_what = [c for c, _ in libs], libs[0][1]
        ms, pl, lb = device_ms(kern), device_ms(plain), device_ms(lib)
        blocks = FD.SPLITS * KV * B
        slots = k6_query("flash_decode_blocks_per_sm", q, k) \
            * torch.cuda.get_device_properties(0).multi_processor_count
        log(f"[time] flash_decode {name} B={B} C={C} KV={KV} G={G} dh={dh} "
            f"q {qt} cache {kvt}: kernel {ms * 1e3:.2f} us (eager call "
            f"{eager_ms(kern[0]) * 1e3:.2f} us), plain {pl * 1e3:.2f} us, "
            f"library {lb * 1e3:.2f} us ({lib_what}), bound "
            f"{bnd * 1e3:.2f} us ({by}; K/V alone "
            f"{kv_bytes / HBM_BYTES_PER_S * 1e6:.2f} us), "
            f"{bnd / ms * 100:.1f}% of the bound; {blocks} blocks, {slots} "
            f"resident at once ({-(-blocks // max(slots, 1))} wave(s)); "
            f"{n_sets} input sets in turn ({n_sets * nbytes / 2**20:.0f} "
            f"MiB, L2 {l2 / 2**20:.0f} MiB)")
        del sets, kern, plain, libs, lib
        if name == "serving":
            main["flash_decode"] = (ms, pl, lb, (bnd, by))
    return {"worst": {"flash_decode": worst}, "main": main}


def vlm_leaves(cfg, gen, lead: tuple, B: int, S: int,
               offset: int = 0) -> dict:
    """A VLM batch's extra leaves on the generator's device ({} for other
    families): patch embeddings (*lead, B, S // 4, D) and the M-RoPE
    streams (*lead, 3, B, S) = (t, t // 4, t % 4), t = arange(S) plus a
    random offset up to ``offset`` a row."""
    import torch
    if cfg.family != "vlm":
        return {}
    dev = gen.device
    t = torch.arange(S, device=dev) + torch.randint(
        0, offset + 1, (*lead, B, 1), generator=gen, device=dev)
    return {"patch_embeds": torch.randn(
                *lead, B, int(S * cfg.vision_patches_frac), cfg.d_model,
                generator=gen, device=dev),
            "positions3": torch.stack([t, t // 4, t % 4], dim=len(lead))}


def frame_leaves(cfg, gen, lead: tuple, B: int, S: int = 0) -> dict:
    """An encoder-decoder's frames on the generator's device ({} for other
    families), from N(0, 1), the stub conv frontend's output: with ``S``
    those of a training batch of S tokens as the JAX package's launcher
    declares them (``src/repro/launch/specs.py``), (*lead, B, min(F, S),
    D) bf16; else a served request's, (*lead, B, F, D) f32, F =
    max_source_positions."""
    import torch
    if not cfg.encdec:
        return {}
    F = min(cfg.max_source_positions, S) if S else cfg.max_source_positions
    x = torch.randn(*lead, B, F, cfg.d_model, generator=gen,
                    device=gen.device)
    return {"frames": x.to(torch.bfloat16) if S else x}


def tree_cast(tree, dtype):
    """Every floating leaf of ``tree`` in ``dtype`` (a copy)."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def tree_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def param_tree_count(cfg) -> int:
    """The parameters of ``model_api(cfg).init_params(cfg)``, counted from
    the config alone: ``ArchConfig.param_count`` plus the final norm and
    the qk norms, with mamba2's conv, A_log, D, dt_bias and out_norm added,
    zamba2's shared block counted once (param_count counts it at every
    ``shared_attn`` layer), an xLSTM layer's tree for param_count's
    estimate of it (which takes q, k, v as block-diagonal and has no gate,
    bias or sLSTM feed-forward leaves), and for an encoder-decoder
    (whisper, where param_count counts the decoder's self-attention
    layers alone) the encoder's layers and norm and each decoder layer's
    cross-attention and its norm."""
    D, dh = cfg.d_model, cfg.d_head
    qk = 2 * dh * cfg.qk_norm
    n = cfg.param_count() + D
    if cfg.encdec:
        attn = D * cfg.n_heads * dh + 2 * D * cfg.n_kv * dh \
            + cfg.n_heads * dh * D + qk
        n += cfg.enc_layers * (attn + 2 * D + 3 * D * cfg.d_ff) + D \
            + cfg.n_layers * (attn + D + qk)
    for t in cfg.layer_types:
        if t == "mamba2":
            di = cfg.ssm_expand * D
            H, N = di // cfg.ssm_head_dim, cfg.ssm_state
            n += (cfg.ssm_conv + 1) * (di + 2 * N) + 3 * H + di - D
        elif t in ("mlstm", "slstm"):
            H = cfg.n_heads
            di = 2 * D if t == "mlstm" else D
            hd = di // H
            n -= D * 2 * di + 3 * di * hd + di * D + 2 * D
            if t == "mlstm":    # ln1, w_up, wq/wk/wv, w_if, out_norm, w_down
                n += D + D * 2 * di + 3 * di * di + di * 2 * H + di + di * D
            else:     # ln1, w_gates, r_gates, b_gates, out_norm, ff_up/down
                f_ff = max(1, int(4 * D / 3) // 8 * 8)
                n += D + D * 4 * di + H * hd * 4 * hd + 4 * di + di \
                    + 2 * di * f_ff
        elif t == "shared_attn":
            n -= (D * cfg.n_heads * dh + 2 * D * cfg.n_kv * dh
                  + cfg.n_heads * dh * D + 3 * D * cfg.d_ff)
        else:
            n += qk
    if "shared_attn" in cfg.layer_types:
        n += (D * cfg.n_heads * dh + 2 * D * cfg.n_kv * dh
              + cfg.n_heads * dh * D + 3 * D * cfg.d_ff + qk)
    return n


def k6_layers(cfg) -> int:
    """K6 launches a decode step: one per attention layer (none for the
    recurrent mamba2, mlstm and slstm layers), two per decoder layer of an
    encoder-decoder (its self- and cross-attention)."""
    n = sum(c for t, c in cfg.segments
            if t not in ("mamba2", "mlstm", "slstm"))
    return 2 * n if cfg.encdec else n


def k6_instances(cfg) -> int:
    """K6 kernels (template instances) a decode step launches over a bf16
    cache: one, two for an encoder-decoder, whose cross-attention reads
    f32 K/V."""
    return 2 if cfg.encdec and k6_layers(cfg) else 1


def span_device_us(prof, label: str) -> float:
    """Device time (us) of the kernels launched inside the ``label``
    ranges: each range's host event sums its children's kernels."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == label
               and not str(getattr(e, "device_type", "")).endswith("CUDA"))


def n_moe_layers(cfg) -> int:
    """MoE layers (``attn_moe``): routings a forward or decode step."""
    return sum(c for t, c in cfg.segments if t == "attn_moe")


def routing_diff(r_card, r_cpu, want: int, what: str):
    """The routings recorded on the card and on the CPU: ``want`` of each,
    of equal shapes -> (token-layers routed differently, token-layers)."""
    if not len(r_card) == len(r_cpu) == want or any(
            x.shape != y.shape for x, y in zip(r_card, r_cpu)):
        raise AssertionError(
            f"{what}: {len(r_card)} routings recorded on the card, "
            f"{len(r_cpu)} on the CPU, want {want}; shapes "
            f"{[tuple(x.shape) for x in r_card]} vs "
            f"{[tuple(y.shape) for y in r_cpu]}")
    moved = sum(int((x.cpu() != y.cpu()).any(-1).sum())
                for x, y in zip(r_card, r_cpu))
    n_tok = sum(x.shape[0] for x in r_cpu)
    if want and n_tok == 0:
        raise AssertionError(f"{what}: the routings hold no token")
    return moved, n_tok


def phase_serve(dev, cfg, slots: int, max_len: int, n_requests: int,
                prompt: tuple, new_tokens: int, check_cfg) -> dict:
    """Phase 8: ``ServeEngine(...).run(requests)`` for ``cfg`` on ``dev``,
    counters read around the run; then ``check_cfg`` on ``dev`` against
    the CPU (a prompt of 64 tokens and 4 decode steps over an f32 and a
    bf16 cache; with mLSTM layers also one of 512 tokens over f32; a VLM
    prompt with random patch embeddings and unequal M-RoPE streams; an
    encoder-decoder's random frames)."""
    import numpy as np
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import model_api
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    api = model_api(cfg)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sync()
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != param_tree_count(cfg):
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{param_tree_count(cfg)}")
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {n_params} parameters (f32) built in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(params, cfg, slots=slots, max_len=max_len, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(prompt[0], prompt[1] + 1, n_requests)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=new_tokens) for n in lens]
    # warm-up (cuBLAS handles, the kernels' first load), not counted
    eng.run([Request(prompt=rng.integers(0, cfg.vocab, 64).astype(np.int32),
                     max_new_tokens=3)])
    eng.stats.update(prefills=0, prefill_s=0.0, decode_steps=0,
                     decode_s=0.0)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    st = eng.stats
    n_attn = k6_layers(cfg)
    want = dict.fromkeys(launches, 0)
    want["flash_decode"] = st["decode_steps"] * n_attn
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want} "
                             f"({st['decode_steps']} decode steps x "
                             f"{n_attn} attention layers x 1 a call)")
    if n_attn and launches["flash_decode"] == 0:
        raise AssertionError("flash_decode never launched on the serving "
                             "path")
    for r in reqs:
        if not r.done or r.failed or len(r.output) != new_tokens or \
                not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request not served: done={r.done} "
                                 f"failed={r.failed} output={r.output}")
    tokens = sum(len(r.output) for r in reqs)
    ms_step = st["decode_s"] / st["decode_steps"] * 1e3
    ms_prefill = st["prefill_s"] / st["prefills"] * 1e3
    log(f"[serve] {n_requests} requests (prompts {int(lens.min())}-"
        f"{int(lens.max())}, {int(lens.sum())} tokens) on {slots} slots x "
        f"{max_len}: {st['prefills']} prefills, {st['decode_steps']} decode "
        f"steps, launches {launches}")
    log(f"[serve] prefill {ms_prefill:.3f} ms per request "
        f"({st['prefill_s'] / lens.sum() * 1e6:.2f} us per prompt token), "
        f"decode {ms_step:.3f} ms per step, {tokens} tokens in {wall:.3f} s "
        f"= {tokens / wall:.1f} tokens/s (decode alone "
        f"{st['decode_steps'] * slots / st['decode_s']:.1f} tokens/s at "
        f"{slots} slots); K6 {n_attn} launches a step; peak device memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    busy = None
    if dev.type == "cuda":
        busy = profile_decode(eng, cfg, rng, slots)
        if "mlstm" in cfg.layer_types:
            # the longest served prompt that takes the quadratic form
            xlstm_prefill_split(params, cfg, dev, prompt[1] - 1)
    del eng, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the same model cut in depth, on the card against the CPU
    cparams = api.init_params(check_cfg,
                              torch.Generator(device=dev).manual_seed(1))
    sides = (("card", dev, cparams),
             ("cpu", torch.device("cpu"), tree_to(cparams, "cpu")))
    runs = [(64, torch.float32, 1e-3), (64, torch.bfloat16, 3e-2)]
    if "mlstm" in check_cfg.layer_types:
        runs += [(n, torch.float32, SERVE_XLSTM_TOL)
                 for n in SERVE_CHECK_PROMPTS[1:]]
    prompts = {}
    for P, cache, tol in runs:
        # the long xLSTM prompt also runs with float64 weights on the card:
        # how far each f32 side lies from it
        oracle = P > SERVE_CHECK_PROMPTS[0]
        run_sides = sides + ((("f64", dev, tree_cast(cparams, torch.float64)),)
                             if oracle else ())
        if P not in prompts:
            prompts[P] = torch.as_tensor(rng.integers(0, check_cfg.vocab,
                                                      (1, P)))
        batch = {"tokens": prompts[P],
                 **vlm_leaves(check_cfg, torch.Generator().manual_seed(P),
                              (), 1, P),
                 **frame_leaves(check_cfg, torch.Generator().manual_seed(P),
                                (), 1)}
        logits = {name: [] for name, _, _ in run_sides}
        routes = {name: [] for name, _, _ in run_sides}
        caches = {}
        for name, where, p in run_sides:
            with MOE.recording_routes() as got:
                lg, caches[name] = api.prefill(
                    p, check_cfg, {k: v.to(where) for k, v in batch.items()},
                    cache_len=P + 64, cache_dtype=cache)
            routes[name] += got
            logits[name].append(lg.float().cpu())
        for i in range(4):
            # both sides decode the card's greedy token
            tok = logits["card"][-1].argmax(-1)[:, None]
            pos = torch.full((1, 1), P + i)
            for name, where, p in run_sides:
                with MOE.recording_routes() as got:
                    lg, _ = api.decode_step(p, check_cfg, tok.to(where),
                                           caches[name], pos.to(where))
                routes[name] += got
                logits[name].append(lg.float().cpu())
        a, b = torch.stack(logits["card"]), torch.stack(logits["cpu"])
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite logits on the card")
        if oracle:
            c = torch.stack(logits["f64"])
            gaps = [float((x - c).abs().max()) for x in (a, b)]
            log(f"[serve] {check_cfg.name} {P}-token prompt: f32 logits "
                f"against float64 weights on the card: card {gaps[0]:.3g}, "
                f"CPU {gaps[1]:.3g} max abs")
            for x, where in ((a, "card"), (b, "CPU")):
                torch.testing.assert_close(x, c, rtol=tol, atol=tol,
                                           msg=f"f32 on the {where} against "
                                               f"float64")
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        if cache == torch.float32 and not same:
            raise AssertionError("greedy tokens differ between the card and "
                                 "the CPU")
        # one routing a MoE layer at the prefill and at each of 4 steps
        moved, n_tok = routing_diff(routes["card"], routes["cpu"],
                                    5 * n_moe_layers(check_cfg),
                                    f"[serve] {check_cfg.name}")
        if cache == torch.float32 and moved:
            raise AssertionError(f"routing differs between the card and the "
                                 f"CPU at {moved} of {n_tok} tokens")
        log(f"[serve] {check_cfg.n_layers}-layer {check_cfg.name} ({P}-token "
            f"prompt, {cache} cache): card vs CPU logits max abs diff "
            f"{float((a - b).abs().max()):.3g} (tolerance {tol}, |logits| <= "
            f"{float(b.abs().max()):.3g}), greedy tokens "
            f"{'equal' if same else 'differ'}"
            + (f", routing differs at {moved} of {n_tok} token-layers"
               if n_tok else ""))
    return {"launches": launches, "ms_step": ms_step,
            "ms_prefill": ms_prefill, "tokens_s": tokens / wall,
            "peak": peak, "busy": busy}


def xlstm_prefill_split(params, cfg, dev, S: int) -> None:
    """Where an xLSTM prefill of S tokens goes: one mLSTM and one sLSTM
    layer of ``params`` applied to (1, S, D) activations with their state
    (as prefill runs them), each timed by the host clock around a
    synchronized call after a warm-up, times the layers of each type."""
    import torch
    from repro_torch.models import xlstm as XL

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=dev) * 0.5
    counts = {t: sum(c for u, c in cfg.segments if u == t)
              for t in ("mlstm", "slstm")}
    times = {}
    with torch.no_grad():
        for t, apply in (("mlstm", XL.mlstm_apply), ("slstm", XL.slstm_apply)):
            j = [u for u, _ in cfg.segments].index(t)
            p = {k: v[0] for k, v in params["segments"][j][t].items()}
            apply(p, x[:, :64], cfg, return_state=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply(p, x, cfg, return_state=True)
            torch.cuda.synchronize()
            times[t] = time.perf_counter() - t0
    log(f"[serve] {cfg.name} prefill of {S} tokens by layer type: mLSTM "
        f"{times['mlstm'] * 1e3:.3f} ms a layer x {counts['mlstm']} = "
        f"{times['mlstm'] * counts['mlstm']:.3f} s (the quadratic form and "
        f"its closed-form state), sLSTM {times['slstm'] * 1e3:.3f} ms a "
        f"layer x {counts['slstm']} = {times['slstm'] * counts['slstm']:.3f} "
        f"s (a loop of {S} eager steps)")


def profile_decode(eng, cfg, rng, slots: int, steps: int = 10,
                   attempts: int = 3) -> float:
    """Where a decode step's time goes: ``slots`` requests in flight, then
    torch.profiler over ``steps`` steps: K6's share of device time, under
    MoE the router's, the dispatch's, the expert products' and the
    combine's, for a hybrid the mamba2 layers', for xLSTM the mLSTM and
    sLSTM layers' (and no K6), for whisper the cross-attention's K/V
    products, and the device's busy share of the wall time (returned).

    K6's wrapper must count exactly ``k6_layers`` launches a step over the
    profiled steps, and the profile must show exactly those launches under
    ``k6_instances`` kernel names (whisper's self- and cross-attention
    read a bf16 cache and f32 K/V: two instances). The profiler can lose a
    kernel's
    activity record (a run of olmoe-1b-7b once recorded 159 of the 160
    launches its wrapper counted): when it records fewer launches than
    the wrapper counted, the steps are profiled again, ``attempts`` times
    at most."""
    n_attn, n_names = k6_layers(cfg), k6_instances(cfg)
    for attempt in range(1, attempts + 1):
        prof, wall, labels, launches = _profile_decode_steps(
            eng, cfg, rng, slots, steps)
        want = expected_launches(flash_decode=n_attn * steps)
        if launches != want:
            raise AssertionError(f"launches over the {steps} profiled "
                                 f"decode steps {launches} != expected "
                                 f"{want}")
        # K6 is one kernel a (q, cache) type pair, launched once an
        # attention a step (never on a stack without attention), with no
        # combine
        k6 = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and "flash_decode" in e.key]
        if n_attn == 0:
            if k6:
                raise AssertionError(f"K6 ran on a decode path with no "
                                     f"attention layer: "
                                     f"{[e.key for e in k6]}")
            break
        seen = sum(e.count for e in k6)
        if len(k6) != n_names or seen > n_attn * steps:
            raise AssertionError(f"K6 kernels in the decode profile: "
                                 f"{[(e.key, e.count) for e in k6]}, want "
                                 f"{n_names} name(s) launched {n_attn} "
                                 f"times a step")
        if seen == n_attn * steps:
            break
        log(f"[profile] attempt {attempt}: the profiler recorded "
            f"{seen} of the {n_attn * steps} K6 launches its "
            f"wrapper counted")
        if attempt == attempts:
            raise AssertionError(
                f"K6 kernels in the decode profile: "
                f"{[(e.key, e.count) for e in k6]} in each of {attempts} "
                f"profiles, want {n_names} name(s) launched {n_attn} times "
                f"a step")
    events = log_device_time(prof, wall, steps, "step", exclude=labels)
    busy = sum(e.self_device_time_total for e in events)
    for label in labels:
        t = span_device_us(prof, label)
        if t <= 0:
            raise AssertionError(f"the profile shows no device time inside "
                                 f"the range {label}")
        log(f"[profile] {label}"
            f"{' (the expert products)' if label == 'moe.experts' else ''}: "
            f"{t / steps / 1e3:.3f} ms/step = "
            f"{t / max(busy, 1e-9) * 100:.1f}% of device time")
    # K6 merges its splits in-kernel: no kernel named "combine" runs on
    # any decode path (the ranges' own rows, moe.combine among them, are
    # left out of ``events``)
    if any("combine" in e.key for e in events):
        raise AssertionError("a combine kernel ran on the decode path")
    if n_attn == 0:
        return busy / 1e6 / wall
    k6 = [e for e in events if "flash_decode" in e.key]
    t6 = sum(e.self_device_time_total for e in k6)
    n6 = sum(e.count for e in k6)
    log(f"[profile] flash_decode {t6 / steps / 1e3:.3f} ms/step = "
        f"{t6 / max(busy, 1e-9) * 100:.1f}% of device time, "
        f"{n6 / steps:.0f} launches/step of {len(k6)} kernel(s), "
        f"{t6 / n6:.2f} us a launch")
    for e in k6:
        log(f"[profile]   {e.count / steps:.0f} launches/step, "
            f"{e.self_device_time_total / e.count:.2f} us a launch: "
            f"{e.key[:90]}")
    return busy / 1e6 / wall


def _profile_decode_steps(eng, cfg, rng, slots: int, steps: int):
    """``slots`` new requests and 3 steps to fill the slots, then ``steps``
    decode steps under torch.profiler, the launch counters set to 0 just
    before them and read just after; the engine is drained after -> (the
    profile, the wall seconds of the profiled steps, the package's
    profiler ranges that this config runs, the launches)."""
    import numpy as np
    import torch
    from repro_torch.serve import Request
    from torch.profiler import ProfilerActivity, profile

    for _ in range(slots):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 512).astype(
            np.int32), max_new_tokens=steps + 5))
    for _ in range(3):
        eng.step()
    # the package's profiler ranges (models/moe.py, models/lm.py)
    labels = []
    if "attn_moe" in cfg.layer_types:
        labels = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    if "mamba2" in cfg.layer_types:
        labels = ["mamba2.decode"]
    if "mlstm" in cfg.layer_types:
        labels = ["xlstm.mlstm_decode", "xlstm.slstm_decode"]
    if cfg.encdec:
        labels = ["whisper.cross_kv"]
    torch.cuda.synchronize()
    reset_launches()
    with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    while eng.step():
        pass
    return prof, wall, labels, launches


def profile_rounds(alg, x, draws, gamma, rounds: int = 20) -> None:
    """Where a round's time goes: torch.profiler over ``rounds`` rounds,
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        x, _ = alg.round(x, *draws, gamma)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            x, _ = alg.round(x, *draws, gamma)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_device_time(prof, wall, rounds, "round", top=12)


def profile_run(alg, x0, gen) -> None:
    """Where a sampled round's time goes: torch.profiler over a whole
    ``alg.run`` (the host's cohort and fault draws included), device time
    by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    alg.run(x0, gen.manual_seed(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        alg.run(x0, gen.manual_seed(2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_device_time(prof, wall, alg.cfg.K0, "round", top=12)


def log_device_time(prof, wall: float, n: int, unit: str, top: int = 10,
                    exclude=()):
    """Log the device's busy share of ``wall`` over ``n`` units (rounds,
    steps) and the busiest kernels; -> the device-side events."""
    # device-side events only: an operator's own row also carries the time
    # of the kernels it launched, so summing both would count them twice;
    # so would a record_function range's device-side row (``exclude``)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0 and e.key not in exclude]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] {n} {unit}s: wall {wall / n * 1e3:.3f} ms/{unit} "
        f"(profiler on), device busy {busy_us / n / 1e3:.3f} ms/{unit} = "
        f"{busy_us / 1e6 / wall * 100:.1f}% of wall")
    if not events:
        log("[profile] the profiler recorded no device time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / n:9.1f} us/{unit} "
            f"{e.count / n:6.1f} launches/{unit}  {e.key[:90]}")
    return events



# ---------------------------------------------------------------------------
# phase 10: LM training through the federated round
# ---------------------------------------------------------------------------
def spmd_grads(api, cfg, params, batch, dtype):
    """loss_train and its gradients at ``params`` cast to ``dtype``."""
    import torch
    from repro_torch.fed import tree_leaves, tree_unflatten
    xs = [w.to(dtype).detach().requires_grad_(True)
          for w in tree_leaves(params)]
    loss = api.loss_train(tree_unflatten(params, xs), cfg, batch)
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), [g.to(torch.float32).cpu() for g in grads]


def spmd_loss_checks(dev) -> None:
    """(a) loss_train and its backward on ``dev`` against the same port
    code on the CPU at the smoke configs (qwen3: full attention, gemma3:
    the window mask, olmoe and phi3.5-moe: the MoE MLP and its aux loss,
    zamba2: mamba2 and the shared block, xlstm: mLSTM and sLSTM, qwen2-vl:
    patch embeddings and M-RoPE, whisper: the encoder over bf16 frames, as
    the JAX package's launcher declares them, and the cross-attention;
    at f32 the frames' products promote to f32), f32 with TF32 off and
    under the bf16 view; the tokens
    whose routing differs between the two are counted (none at f32)."""
    import numpy as np
    import torch
    from repro_torch.fed import tree_leaves
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import get_config, model_api

    for arch in SPMD_LOSS_ARCHS:
        cfg = get_config(arch, smoke=True)
        api = model_api(cfg)
        params = api.init_params(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65))
                               .astype(np.int32))
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
                 **vlm_leaves(cfg, torch.Generator().manual_seed(1), (), 2,
                              64, offset=50),
                 **frame_leaves(cfg, torch.Generator().manual_seed(1), (),
                                2, 64)}
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        p_dev = tree_to(params, dev)
        # the SSM's gradients are sums of terms of both signs over every
        # token (A_log's over every position pair): at f32 zamba2-smoke's
        # leaves lie up to 1.7e-5 from a float64 evaluation on the CPU
        # alone (tests/test_torch_arch.py), so f32 holds a hybrid's at 5e-5;
        # xlstm-smoke's f32 gradients of wq, wk and w_up lie up to 2.1e-5
        # from a float64 evaluation of the same code on the CPU (casts to
        # f32 lifted) and the card's 5.0e-5 from the CPU's (H100 80GB HBM3,
        # 700 W), so f32 holds an xLSTM stack's at 1e-4
        f32_tol = 1e-4 if "mlstm" in cfg.layer_types else \
            5e-5 if "mamba2" in cfg.layer_types else 1e-5
        for name, dtype, l_tol, g_tol in (
                ("f32", torch.float32, 1e-5, f32_tol),
                ("bf16", torch.bfloat16, 1e-3, 4e-2)):
            with MOE.recording_routes() as r_cpu:
                l_cpu, g_cpu = spmd_grads(api, cfg, params, batch, dtype)
            with MOE.recording_routes() as r_dev:
                l_dev, g_dev = spmd_grads(api, cfg, p_dev, on_dev, dtype)
            # one routing a MoE layer (one forward; the backward routes
            # nothing)
            moved, n_tok = routing_diff(r_dev, r_cpu, n_moe_layers(cfg),
                                        f"[spmd] {arch} {name}")
            rel = [float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))
                   for a, b in zip(g_dev, g_cpu)]
            worst = max(rel)
            if not (abs(l_dev - l_cpu) <= l_tol * abs(l_cpu)
                    and worst <= g_tol and len(g_dev) == len(
                        tree_leaves(params))
                    and (moved == 0 or dtype != torch.float32)):
                raise AssertionError(
                    f"[spmd] {arch} {name}: loss {l_dev} on the device, "
                    f"{l_cpu} on the CPU; worst gradient leaf "
                    f"{rel.index(worst)} {worst:.3g} normwise (tolerances "
                    f"{l_tol}, {g_tol}); routing "
                    f"differs at {moved} of {n_tok} token-layers")
            log(f"[spmd] loss_train {arch} smoke {name}: loss {l_dev:.6f} "
                f"(CPU {l_cpu:.6f}), worst gradient leaf {worst:.3g} "
                f"normwise of the CPU's (leaf {rel.index(worst)} of "
                f"{len(g_dev)}, tolerance {g_tol})"
                + (f"; routing differs at {moved} of {n_tok} token-layers"
                   if n_tok else ""))


def wire_message_bits(s, dim: int, wire: str) -> float:
    """One whole-message upload's bits at s on a level wire, from the
    wire's format alone: f32 values, or a 32-bit norm and 8 or 4 bits a
    coordinate."""
    return {"f32": 32.0 * dim, "rs_ag": 32.0 * dim,
            "int8": 32.0 + 8.0 * dim, "int4": 32.0 + 4.0 * dim}[wire]


def spmd_kernel_checks(fed, x0, pw, words, i: int, gamma) -> dict:
    """K1/K2/K3 and the noise on leaf i of the full-width round (x̂'s leaf
    ``x0``, the workers' trained leaves ``pw``), against their plain
    versions on the same inputs (row by row, to bound the plain versions'
    temporaries): -> worst errors."""
    import torch
    from repro_torch.fed import uniform_like
    from repro_torch.fed.runtime import _seed_from
    from repro_torch.kernels import qsgd as K

    s = fed.sn_tuple()[0]
    d = torch.stack([(p - x0).reshape(-1) for p in pw]).div_(torch.tensor(
        gamma, dtype=torch.float32, device=x0.device))
    u = torch.empty_like(d)
    for w in range(d.shape[0]):
        u[w] = uniform_like(d[w], _seed_from(words[w], i))
    # the noise on the card against the CPU's, across a piece boundary
    n = d.shape[1]
    a = max(0, min(n, (1 << 25) + (1 << 20)) - (1 << 21))
    b = min(n, a + (1 << 21))
    u_cpu = uniform_like(torch.zeros(b), _seed_from(words[0], i))[a:]
    if not torch.equal(u[0, a:b].cpu().view(torch.int32),
                       u_cpu.view(torch.int32)):
        raise AssertionError("[spmd] uniform_like on the card differs from "
                             "the CPU")
    _, norm, inv = K.qsgd_sumsq(d, s)
    lvl = K.qsgd_quantize(d, u, inv, s)
    _, norm_p, _ = K.sumsq_plain(d, s)
    same = all(torch.equal(lvl[r:r + 1], K.quantize_plain(
        d[r:r + 1], u[r:r + 1], inv[r:r + 1], s)) for r in range(d.shape[0]))
    x0 = x0.reshape(-1)
    out = K.qsgd_dequant_apply(x0, lvl[0].contiguous(), norm[:1], s, gamma)
    out_p = K.dequant_apply_plain(x0, lvl[0], norm[:1], s, gamma)
    torch.cuda.synchronize()
    torch.testing.assert_close(norm, norm_p, rtol=1e-6, atol=0)
    if not same or not torch.equal(out.view(torch.int32),
                                   out_p.view(torch.int32)):
        raise AssertionError(f"[spmd] K2 or K3 differs from its plain "
                             f"version at leaf {i} ({tuple(d.shape)})")
    log(f"[spmd] leaf {i} {tuple(d.shape)}: K1 norm rel err "
        f"{float(((norm - norm_p).abs() / norm_p).max()):.3g}, K2 levels "
        f"and K3 bitwise their plain versions, uniform_like bitwise the "
        f"CPU's over [{a}, {b})")
    # their times at this shape (eager: a call moves gigabytes, so the
    # launch is noise), beside the byte bound, plain and library calls
    e, rows, lv0 = d.numel(), d.shape[0], lvl[0].contiguous()
    scale0 = float(norm[0]) / s
    for name, kern, plain, lib, (bnd, by) in (
            ("qsgd_sumsq", lambda: K.qsgd_sumsq(d, s),
             lambda: K.sumsq_plain(d, s),
             lambda: torch.linalg.vector_norm(d, dim=-1),
             bound_ms(4 * e + 12 * rows, 2 * e)),
            ("qsgd_quantize", lambda: K.qsgd_quantize(d, u, inv, s),
             lambda: K.quantize_plain(d, u, inv, s), None,
             bound_ms(9 * e + 4 * rows, 6 * e)),
            ("qsgd_dequant_apply",
             lambda: K.qsgd_dequant_apply(x0, lv0, norm[:1], s, gamma),
             lambda: K.dequant_apply_plain(x0, lv0, norm[:1], s, gamma),
             lambda: torch.add(x0, lv0, alpha=gamma * scale0),
             bound_ms(9 * n + 4, 3 * n))):
        ms, pl = eager_ms(kern, reps=5, trials=3), eager_ms(plain, 2, 3)
        lb = None if lib is None else eager_ms(lib, reps=5, trials=3)
        log(f"[time] {name} spmd leaf {i} "
            f"{tuple(d.shape) if name != 'qsgd_dequant_apply' else (n,)}: "
            f"kernel {ms * 1e3:.2f} us, plain {pl * 1e3:.2f} us, library "
            f"{'n/a' if lb is None else f'{lb * 1e3:.2f} us'}, bound "
            f"{bnd * 1e3:.2f} us ({by})")
    return {"qsgd_sumsq": float((norm - norm_p).abs().max()),
            "qsgd_dequant_apply": float((out - out_p).abs().max())}


def spmd_full_width(dev, cfg, wires=SPMD_WIRES,
                    rounds: int = SPMD_ROUNDS) -> dict:
    """(b) ``cfg`` at full width: fl = 2 workers (Kn = (1, 2)), B x S of
    uniform tokens on the device (and an encoder-decoder's bf16 frames),
    s0 = sn = 7; each of ``rounds`` rounds' workers trained once
    (``local_train``) and that one set of params aggregated through every
    wire of ``wires`` (``aggregate_apply``), x̂' bitwise across wires;
    launches read around the rounds; comm bits and memory."""
    import numpy as np
    import torch
    from repro_torch.data import uniform_lm_batch
    from repro_torch.fed import (FedConfig, LocalTransport, aggregate_apply,
                                 local_train, tree_leaves)
    from repro_torch.models.registry import model_api
    from repro_torch.train import round_comm_bits
    from repro_torch.train.trainer import round_keys

    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    api = model_api(cfg)
    fl, Kn, gamma = SPMD_FL, SPMD_KN, SPMD_GAMMA
    feds = {w: FedConfig(n_workers=fl, Kn=Kn, s0=SPMD_S_Q, sn=SPMD_S_Q,
                         wire=w) for w in wires}
    transport = LocalTransport(fl)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = api.init_params(cfg, gen)
    sizes = [t.numel() for t in tree_leaves(x)]
    dim = sum(sizes)
    log(f"[spmd] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {dim} parameters in {len(sizes)} leaves, "
        f"fl = {fl}, Kn = {Kn}, B = {SPMD_B}, S = {SPMD_S}, s0 = sn = "
        f"{SPMD_S_Q}, wires {wires}")
    keys = np.random.default_rng(0)
    bits = {w: 0.0 for w in wires}
    times = {"train": [], **{w: [] for w in wires}}
    loss0 = None
    reset_launches()
    plain, undo = count_plain_calls()
    try:
        for r in range(rounds):
            batch = {**uniform_lm_batch(gen, (fl, max(Kn), SPMD_B, SPMD_S),
                                        cfg.vocab),
                     **frame_leaves(cfg, gen, (fl, max(Kn)), SPMD_B,
                                    SPMD_S)}
            words = round_keys(keys, fl)
            sync()
            t0 = time.perf_counter()
            trained, losses = [], []
            for w in transport.workers:
                p, loss = local_train(api, cfg, feds[wires[0]], x,
                                      {k: v[w] for k, v in batch.items()},
                                      Kn[w], gamma)
                trained.append(p)
                losses.append(loss)
            sync()
            times["train"].append(time.perf_counter() - t0)
            ref = None
            for w in wires:
                t0 = time.perf_counter()
                x_new, m = aggregate_apply(feds[w], transport, x, trained,
                                           words[:-1], words[-1], gamma)
                sync()
                times[w].append(time.perf_counter() - t0)
                bits[w] += round_comm_bits(feds[w], dim)
                if ref is None:
                    ref = (x_new, float(m["delta_norm"]))
                    continue
                for a, b in zip(tree_leaves(ref[0]), tree_leaves(x_new)):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(
                            f"[spmd] round {r}: wire {w}'s x_hat' differs "
                            f"from wire {wires[0]}'s")
                del x_new
            loss = float(torch.stack(losses).mean())
            loss0 = loss if loss0 is None else loss0
            log(f"[spmd] round {r}: loss {loss:.4f}, delta_norm "
                f"{ref[1]:.4g}, train {times['train'][-1] * 1e3:.1f} ms, "
                f"aggregate " + ", ".join(f"{w} {times[w][-1] * 1e3:.1f} ms"
                                          for w in wires)
                + f"; x_hat' bitwise across {len(wires)} wires")
            if not np.isfinite(loss):
                raise AssertionError(f"[spmd] round {r}: loss {loss}")
            if r == rounds - 1:     # the kernel checks read this round
                last = (x, trained, words)
            x = ref[0]
            del trained, ref
    finally:
        undo()
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)
    L = len(sizes)
    # the largest leaf's inputs only, the rest freed before the checks
    x_last, trained, words = last
    i = max(range(L), key=sizes.__getitem__)
    inputs = (tree_leaves(x_last)[i], [tree_leaves(p)[i] for p in trained],
              words, i)
    del last, x_last, trained
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worst = (spmd_kernel_checks(feds[wires[0]], *inputs, gamma)
             if dev.type == "cuda" else {})
    del inputs
    n_agg = rounds * len(wires)
    want = expected_launches(qsgd_sumsq=2 * L * n_agg,
                             qsgd_quantize=2 * L * n_agg,
                             qsgd_dequant_apply=L * n_agg)
    if dev.type == "cuda" and (launches != want or any(plain.values())):
        raise AssertionError(f"[spmd] launches {launches} != expected "
                             f"{want}, or a plain version ran: {plain}")
    for w in wires:
        per = (fl + 1) * wire_message_bits(SPMD_S_Q, dim, w)
        if bits[w] != rounds * round_comm_bits(feds[w], dim) or \
                bits[w] != rounds * per:
            raise AssertionError(f"[spmd] {w}: comm bits {bits[w]} != "
                                 f"rounds x {per}")
    train_ms = 1e3 * statistics.median(times["train"])
    agg_ms = {w: 1e3 * statistics.median(times[w]) for w in wires}
    log(f"[spmd] launches {launches} (K1/K2 {2 * L} and K3 {L} an "
        f"aggregate), no plain version; comm bits a round " + ", ".join(
            f"{w} {bits[w] / rounds:.6g}" for w in wires))
    log(f"[spmd] full width: local train {train_ms:.1f} ms a round (both "
        f"workers, {fl * max(Kn)} forward/backward passes), "
        f"aggregate " + ", ".join(f"{w} {v:.1f} ms" for w, v in
                                  agg_ms.items())
        + "; ms a round " + ", ".join(f"{w} {train_ms + v:.1f}"
                                      for w, v in agg_ms.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    busy = None
    if dev.type == "cuda":
        busy = profile_spmd_round(api, cfg, feds[wires[1]], transport, x,
                                  gen, keys, gamma)
    del x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "train_ms": train_ms, "agg_ms": agg_ms,
            "peak": peak, "busy": busy, "worst": worst, "dim": dim}


def profile_spmd_round(api, cfg, fed, transport, x, gen, keys,
                       gamma) -> float:
    """One more full-width round under torch.profiler, its local training
    and its aggregate (``fed``'s wire) profiled apart: device time by
    kernel and the device's busy share of each -> the round's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import uniform_lm_batch
    from repro_torch.fed import aggregate_apply, local_train
    from repro_torch.train.trainer import round_keys

    batch = {**uniform_lm_batch(gen, (fed.n_workers, fed.K_max, SPMD_B,
                                      SPMD_S), cfg.vocab),
             **frame_leaves(cfg, gen, (fed.n_workers, fed.K_max), SPMD_B,
                            SPMD_S)}
    words = round_keys(keys, fed.n_workers)
    busy = wall = 0.0
    trained = []
    for part in ("local train", f"aggregate {fed.wire}"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if not trained:
                trained = [local_train(api, cfg, fed, x,
                                       {k: v[w] for k, v in batch.items()},
                                       fed.Kn[w], gamma)[0]
                           for w in transport.workers]
            else:
                aggregate_apply(fed, transport, x, trained, words[:-1],
                                words[-1], gamma)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        log(f"[profile] full-width round, {part}:")
        events = log_device_time(prof, dt, 1, "round", top=12)
        busy += sum(e.self_device_time_total for e in events) / 1e6
        wall += dt
    log(f"[profile] full-width round: device busy {busy / wall * 100:.1f}% "
        f"of {wall * 1e3:.1f} ms (profiler on)")
    return busy / wall


def spmd_smoke_wires(dev, cfg, gamma: float) -> dict:
    """(c) ``cfg`` (a smoke config): one round's workers trained once on
    ``dev``, aggregated through f32 and elias (s0 = 7, sn = (5, 7)) and
    through bucketed f32 and int8 (bucket 4096): elias bitwise f32 with its
    stream bits, bucketed int8 within 1e-6 of bucketed f32; launches read
    around the aggregates; every aggregate on the CPU (plain versions) from
    the same trained params, level flips at most 1 in 10^4."""
    import numpy as np
    import torch
    from repro_torch.data import uniform_lm_batch
    from repro_torch.fed import (FedConfig, LocalTransport, aggregate_apply,
                                 local_train, tree_leaves)
    from repro_torch.models.registry import model_api
    from repro_torch.train.trainer import round_keys

    dev = torch.device(dev)
    api = model_api(cfg)
    fl, Kn = SPMD_FL, SPMD_KN
    cases = {"f32": dict(wire="f32"), "elias": dict(wire="elias"),
             "f32 b4096": dict(wire="f32", bucket=BUCKET),
             "int8 b4096": dict(wire="int8", bucket=BUCKET)}
    feds = {k: FedConfig(n_workers=fl, Kn=Kn, s0=7, sn=(5, 7), **kw)
            for k, kw in cases.items()}
    transport = LocalTransport(fl)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = api.init_params(cfg, gen)
    batch = uniform_lm_batch(gen, (fl, max(Kn), 4, 64), cfg.vocab)
    words = round_keys(np.random.default_rng(1), fl)
    trained = [local_train(api, cfg, feds["f32"], x,
                           {k: v[w] for k, v in batch.items()}, Kn[w],
                           gamma)[0] for w in transport.workers]
    reset_launches()
    plain, undo = count_plain_calls()
    try:
        outs = {k: aggregate_apply(f, transport, x, trained, words[:-1],
                                   words[-1], gamma)
                for k, f in feds.items()}
    finally:
        undo()
    launches = read_launches()
    flat = {k: torch.cat([t.reshape(-1) for t in tree_leaves(o[0])])
            for k, o in outs.items()}
    sizes = [t.numel() for t in tree_leaves(x)]
    L = len(sizes)
    k3b = sum(1 for n in sizes if -(-n // BUCKET) > 1)
    # sn = (5, 7): one K1/K2 launch a worker and one for the server a leaf
    want = expected_launches(qsgd_sumsq=3 * L * 4, qsgd_quantize=3 * L * 4,
                             qsgd_dequant_apply=2 * L + (L - k3b) * 2,
                             qsgd_dequant_apply_bucketed=2 * k3b,
                             elias_decode=2)
    if dev.type == "cuda" and (launches != want or any(plain.values())):
        raise AssertionError(f"[spmd] smoke wires: launches {launches} != "
                             f"{want}, or a plain version ran: {plain}")
    if not torch.equal(flat["f32"].view(torch.int32),
                       flat["elias"].view(torch.int32)):
        raise AssertionError("[spmd] elias wire differs from f32")
    bdiff = float((flat["int8 b4096"] - flat["f32 b4096"]).abs().max())
    if bdiff > 1e-6:
        raise AssertionError(f"[spmd] bucketed int8 {bdiff} from f32")
    bits = int(outs["elias"][1]["elias_bits"])
    dim = sum(sizes)
    if not 0 < bits < 3 * (dim * 15 + 36):
        raise AssertionError(f"[spmd] elias bits {bits}")
    # the same aggregates on the CPU (plain versions), same trained params
    x_cpu = tree_to(x, "cpu")
    t_cpu = [tree_to(p, "cpu") for p in trained]
    flips = {}
    for k, f in feds.items():
        o, m = aggregate_apply(f, transport, x_cpu, t_cpu, words[:-1],
                               words[-1], gamma)
        c = torch.cat([t.reshape(-1) for t in tree_leaves(o)])
        far = ~torch.isclose(flat[k].cpu(), c, rtol=1e-6, atol=1e-6)
        flips[k] = int(far.sum())
        if flips[k] > c.numel() // 10**4 or (
                "elias_bits" in m and int(m["elias_bits"]) != bits):
            raise AssertionError(f"[spmd] {k}: {flips[k]} coordinates of "
                                 f"{c.numel()} differ from the CPU")
    log(f"[spmd] {cfg.name} ({dim} parameters): elias bitwise f32 "
        f"({bits} stream bits, = the CPU's), bucketed int8 within {bdiff:.3g} "
        f"of bucketed f32, launches {launches}; device vs CPU aggregate "
        f"flips {flips}")
    return {"launches": launches}


def spmd_scenario(dev, cfg) -> dict:
    """(d) ``Scenario.run(plan, task=SpmdTask(...), backend="spmd",
    wire="int8")`` at ``cfg`` on ``dev`` for genqsgd and gqfedwavg
    (``tests/integration/test_spmd_report.py``'s Plans and checks), then a
    sampled and faulted run on f32 whose cohorts and FaultTrace equal the
    CPU's; launches read around the three runs."""
    import dataclasses as dc
    import math
    import numpy as np
    import torch
    from repro_torch.api import (ConstantRule, EdgeSystem,
                                 MLProblemConstants, Plan, Scenario,
                                 SpmdTask)
    from repro_torch.core.cost import energy_cost, time_cost
    from repro_torch.data import uniform_lm_batch
    from repro_torch.faults import FaultSpec, edge_faults
    from repro_torch.models.registry import model_api

    fl, Kn, B, S = SPMD_FL, SPMD_KN, 4, 32

    def batches(d, seed=0):
        gen = torch.Generator(device=d).manual_seed(seed)
        while True:
            yield uniform_lm_batch(gen, (fl, max(Kn), B, S), cfg.vocab)

    def task(d):
        return SpmdTask(api=model_api(cfg), arch=cfg, batches=batches(d),
                        device=d)
    system = EdgeSystem.paper_sec_vii(dim=4096, N=fl)
    consts = MLProblemConstants(L=0.084, sigma=33.18, G=33.63, f_gap=2.3,
                                N=fl)
    plans = {
        "genqsgd": Plan.manual(K0=3, Kn=Kn, B=B,
                               step_rule=ConstantRule(0.01), s0=64, sn=16,
                               dim=4096),
        "gqfedwavg": Plan.manual(K0=3, Kn=Kn, B=B,
                                 step_rule=ConstantRule(0.01), s0=64,
                                 sn=16, dim=4096, family="gqfedwavg",
                                 agg_weights=(0.7, 0.3), momentum=0.5,
                                 normalize=True)}
    fm = edge_faults(straggler_prob=0.5, straggler_factor=4.0,
                     crash_prob=0.3, crash_rounds=1, corrupt_prob=0.1,
                     deadline_slack=1.5)
    wt = (0.8, 1.0)
    spec = FaultSpec(model=fm, worker_times=wt, deadline=1.5,
                     deliver_p=tuple(fm.deliver_prob(np.asarray(wt), 1.5)))
    faulty = dc.replace(Plan.manual(K0=4, Kn=Kn, B=B,
                                    step_rule=ConstantRule(0.01), s0=64,
                                    sn=16, dim=4096, faults=spec),
                        cohort_S=1)
    reset_launches()
    plain, undo = count_plain_calls()
    reps = {}
    try:
        for fam, plan in plans.items():
            scn = Scenario(system=system, consts=consts, T_max=1e5,
                           C_max=0.25, family=fam)
            reps[fam] = (scn, scn.run(plan, task=task(dev), backend="spmd",
                                      wire="int8", log_every=1, device=dev))
        scn = Scenario(system=system, consts=consts, T_max=1e5, C_max=0.25)
        reps["faulty"] = (scn, scn.run(faulty, task=task(dev),
                                       backend="spmd", wire="f32", seed=11,
                                       log_every=1, device=dev))
    finally:
        undo()
    launches = read_launches()
    on_card = torch.device(dev).type == "cuda"
    if on_card and (any(plain.values())
                    or min(launches[k] for k in ("qsgd_sumsq",
                                                 "qsgd_quantize",
                                                 "qsgd_dequant_apply")) == 0):
        raise AssertionError(f"[spmd] scenario launches {launches}, plain "
                             f"versions {plain}")
    for fam, plan in plans.items():
        scn, rep = reps[fam]
        psys = scn._priced_system
        ok = (rep.backend == "spmd" and rep.rounds == plan.K0
              and rep.comm_bits == rep.rounds * plan.round_bits(
                  dim=rep.model_dim, wire="int8")
              and rep.measured_E == energy_cost(psys, rep.rounds,
                                                np.asarray(plan.Kn), plan.B)
              and rep.measured_T == time_cost(psys, rep.rounds,
                                              np.asarray(plan.Kn), plan.B)
              and math.isfinite(rep.history[-1]["loss"]))
        if not ok:
            raise AssertionError(f"[spmd] {fam}: {rep.summary()}")
        log(f"[spmd] Scenario.run(spmd, int8) {fam}: {rep.rounds} rounds, "
            f"comm bits {rep.comm_bits:.6g} = rounds x round_bits, loss "
            f"{rep.history[-1]['loss']:.4f}, {rep.wall_time_s:.2f} s")
    _, rep = reps["faulty"]
    cpu = Scenario(system=system, consts=consts, T_max=1e5,
                   C_max=0.25).run(faulty, task=task("cpu"), backend="spmd",
                                   wire="f32", seed=11, log_every=1,
                                   device="cpu")
    if not (rep.fault_trace == cpu.fault_trace
            and rep.round_bits_trace == cpu.round_bits_trace
            and rep.comm_bits == cpu.comm_bits
            and rep.fault_trace.workers_dropped > 0):
        raise AssertionError("[spmd] sampled and faulted run: the device's "
                             "traces differ from the CPU's")
    log(f"[spmd] sampled (S = 1 of 2) and faulted run: "
        f"{rep.fault_trace.workers_dropped} worker-rounds dropped, "
        f"round bits {rep.round_bits_trace}, FaultTrace and cohort bits "
        f"equal the CPU's; launches {launches}")
    return {"launches": launches}


def spmd_family_rounds(dev, archs=SPMD_FAMILY_ARCHS) -> dict:
    """(e) one round at each smoke config of ``archs`` (MoE, hybrid, xLSTM,
    VLM, audio): fl = 2 workers (Kn = (1, 2)) trained once on ``dev`` (the
    router's aux term in the loss; a VLM batch with patch embeddings and
    M-RoPE streams, at ``SPMD_MICROBATCH``; whisper's with bf16 frames),
    that one set of params
    aggregated through the f32 and the int8 wire at s0 = sn = 7: x̂'
    bitwise across the wires, K1/K2 two launches and K3 one a leaf an
    aggregate and no plain version, comm bits exactly ``round_comm_bits``
    = (fl + 1) messages of the wire's format."""
    import numpy as np
    import torch
    from repro_torch.data import uniform_lm_batch
    from repro_torch.fed import (FedConfig, LocalTransport, aggregate_apply,
                                 local_train, tree_leaves)
    from repro_torch.models.registry import get_config, model_api
    from repro_torch.train import round_comm_bits
    from repro_torch.train.trainer import round_keys

    dev = torch.device(dev)
    fl, Kn, wires = SPMD_FL, SPMD_KN, ("f32", "int8")
    total = None
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        api = model_api(cfg)
        micro = SPMD_MICROBATCH.get(arch, 1)
        feds = {w: FedConfig(n_workers=fl, Kn=Kn, s0=SPMD_S_Q, sn=SPMD_S_Q,
                             wire=w, microbatch=micro) for w in wires}
        transport = LocalTransport(fl)
        gen = torch.Generator(device=dev).manual_seed(2)
        x = api.init_params(cfg, gen)
        batch = {**uniform_lm_batch(gen, (fl, max(Kn), 4, 64), cfg.vocab),
                 **vlm_leaves(cfg, gen, (fl, max(Kn)), 4, 64, offset=50),
                 **frame_leaves(cfg, gen, (fl, max(Kn)), 4, 64)}
        words = round_keys(np.random.default_rng(2), fl)
        trained, losses = [], []
        for w in transport.workers:
            p, loss = local_train(api, cfg, feds["f32"], x,
                                  {k: v[w] for k, v in batch.items()},
                                  Kn[w], SPMD_GAMMA)
            trained.append(p)
            losses.append(float(loss))
        sizes = [t.numel() for t in tree_leaves(x)]
        L, dim = len(sizes), sum(sizes)
        reset_launches()
        plain, undo = count_plain_calls()
        try:
            outs = {w: aggregate_apply(f, transport, x, trained, words[:-1],
                                       words[-1], SPMD_GAMMA)
                    for w, f in feds.items()}
        finally:
            undo()
        launches = read_launches()
        want = expected_launches(qsgd_sumsq=2 * L * len(wires),
                                 qsgd_quantize=2 * L * len(wires),
                                 qsgd_dequant_apply=L * len(wires))
        if dev.type == "cuda" and (launches != want or any(plain.values())):
            raise AssertionError(f"[spmd] {arch}: launches {launches} != "
                                 f"{want}, or a plain version ran: {plain}")
        a, b = (torch.cat([t.reshape(-1) for t in tree_leaves(outs[w][0])])
                for w in wires)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)) or \
                not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[spmd] {arch}: x_hat' differs across the "
                                 f"wires, or is not finite")
        for w in wires:
            per = (fl + 1) * wire_message_bits(SPMD_S_Q, dim, w)
            if round_comm_bits(feds[w], dim) != per:
                raise AssertionError(f"[spmd] {arch} {w}: comm bits "
                                     f"{round_comm_bits(feds[w], dim)} != "
                                     f"{per}")
        log(f"[spmd] {cfg.name} ({dim} parameters in {L} leaves, "
            f"microbatch {micro}): one round "
            f"(losses {losses}), x_hat' bitwise across {wires}, launches "
            f"{launches}{', no plain version' if dev.type == 'cuda' else ''}"
            f"; comm bits a round "
            + ", ".join(f"{w} {round_comm_bits(feds[w], dim):.6g}"
                        for w in wires))
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    return {"launches": total}


def phase_spmd(dev="cuda", full_cfg=None, smoke_cfg=None) -> dict:
    """Phase 10: LM training through the federated GenQSGD round —
    (a) loss and gradients, (b) ``full_cfg`` at full width on four wires,
    (c) elias and bucketed int8 at ``smoke_cfg``, (d) Scenario.run(spmd),
    (e) one round at the MoE, hybrid, xLSTM, VLM and audio smoke configs.
    The launches of (b) to (e), each read around its own runs."""
    from repro_torch.models.registry import get_config
    full_cfg = full_cfg or get_config(SPMD_ARCH)
    smoke_cfg = smoke_cfg or get_config(SPMD_ARCH, smoke=True)
    spmd_loss_checks(dev)
    full = spmd_full_width(dev, full_cfg)
    smoke = spmd_smoke_wires(dev, smoke_cfg, SPMD_GAMMA)
    scen = spmd_scenario(dev, smoke_cfg)
    fam = spmd_family_rounds(dev)
    launches = {k: full["launches"][k] + smoke["launches"][k]
                + scen["launches"][k] + fam["launches"][k]
                for k in full["launches"]}
    return {**full, "launches": launches}


def launch_train(dev="cuda", argv=LAUNCH_ARGV) -> dict:
    """12 (a): ``repro_torch.launch.train.main(argv + --device dev)``
    in-process, the launch counters and the plain versions' counters read
    around it: K1/K2 2 and K3 1 launches a leaf a round (the int8 wire, the
    fl workers sharing s: one K1/K2 launch over their rows, one for the
    server), no plain version on the card, every loss finite and ``[train]
    done`` printed; wall per round, peak device memory, and the f32
    parameter bytes that ``abstract_params`` reckons beside them."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.fed import tree_leaves
    from repro_torch.launch import train as LT
    from repro_torch.launch.specs import tree_bytes
    from repro_torch.models.registry import get_config, model_api

    argv = list(argv) + ["--device", dev]
    args = LT.parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    abstract = tree_leaves(model_api(cfg).abstract_params(
        cfg, dtype=torch.float32))
    L, n = len(abstract), sum(t.numel() for t in abstract)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    plain, undo = count_plain_calls()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            state = LT.main(argv)
        if cuda:
            torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = read_launches()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[launch] {line.strip()}")
    got_n = sum(t.numel() for t in tree_leaves(state.params))
    losses = [h["loss"] for h in state.history]
    if "[train] done" not in out or got_n != n or \
            len(losses) != args.rounds or not np.all(np.isfinite(losses)):
        raise AssertionError(f"[launch] the launcher's run: {got_n} "
                             f"parameters (abstract {n}), losses {losses}")
    want = expected_launches(qsgd_sumsq=2 * L * args.rounds,
                             qsgd_quantize=2 * L * args.rounds,
                             qsgd_dequant_apply=L * args.rounds)
    if cuda and (launches != want or any(plain.values())):
        raise AssertionError(f"[launch] launches {launches} != expected "
                             f"{want}, or a plain version ran: {plain}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    total = torch.cuda.get_device_properties(0).total_memory if cuda else 0
    dts = [h["dt"] for h in state.history]
    log(f"[launch] {cfg.name} at full width: {n} parameters in {L} leaves, "
        f"{tree_bytes(abstract)} f32 parameter bytes reckoned by "
        f"abstract_params; fl = {args.fl}, B {args.batch} x S {args.seq}, "
        f"wire {args.wire}; wall {wall:.1f} s for {args.rounds} rounds "
        f"(init and data included), a round " + ", ".join(
            f"{d * 1e3:.1f} ms" for d in dts)
        + f"; peak device memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) of {total} bytes "
          f"(get_device_properties(0).total_memory); launches K1 "
          f"{launches['qsgd_sumsq']}, K2 {launches['qsgd_quantize']}, K3 "
          f"{launches['qsgd_dequant_apply']} (exact), no plain version")
    del state
    if cuda:
        torch.cuda.empty_cache()
    return {"launches": launches, "wall": wall, "round_s": dts,
            "peak": peak}


def _flag(argv, flag: str, default: int) -> int:
    """The int value of ``flag`` in ``argv``, else its default."""
    return int(argv[argv.index(flag) + 1]) if flag in argv else default


def launch_examples(dev="cuda", extra=None) -> dict:
    """12 (b): each ``examples/torch/*.py`` in-process (``runpy`` with
    ``sys.argv`` set) at its defaults and ``--device dev`` (``extra``:
    more arguments by example, for a rehearsal), its output's final line
    checked and the launch counters read around it: serve_decode launches
    K6 once per attention layer per decode step and nothing else;
    quickstart and train_lm_federated launch K1-K3 (the latter exactly,
    K1/K2 2 and K3 1 a leaf a round) and no K6; optimize_parameters solves
    through the fused engine on ``dev`` and launches no kernel.  No plain
    version runs on the card."""
    import contextlib
    import io
    import runpy

    import torch
    from repro_torch.models.registry import get_config
    from repro_torch.opt import gia_fused

    extra = extra or {}
    cuda = torch.device(dev).type == "cuda"
    total = None
    for name in EXAMPLES:
        path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
        argv = ["--device", dev] + list(extra.get(name, ()))
        info0 = gia_fused.compile_cache_info()
        reset_launches()
        plain, undo = count_plain_calls()
        buf, saved = io.StringIO(), sys.argv
        t0 = time.perf_counter()
        sys.argv = [path] + argv
        try:
            with contextlib.redirect_stdout(buf):
                mod = runpy.run_path(path, run_name="__main__")
            if cuda:
                torch.cuda.synchronize()
        finally:
            sys.argv = saved
            undo()
        dt = time.perf_counter() - t0
        launches = read_launches()
        lines = buf.getvalue().strip().splitlines()
        last = lines[-1] if lines else ""
        k13 = [launches[k] for k in ("qsgd_sumsq", "qsgd_quantize",
                                     "qsgd_dequant_apply")]
        if name == "serve_decode":
            cfg = get_config("qwen3-1.7b", smoke=True)
            steps = _flag(argv, "--steps", 16)  # the first token is greedy
            want = expected_launches(flash_decode=(steps - 1)
                                     * k6_layers(cfg))
            ok = last.startswith(f"decoded {steps} tokens") and (
                not cuda or launches == want)
        elif name == "quickstart":
            ok = last.startswith("== done: final accuracy") and (
                not cuda or (min(k13) > 0 and launches["flash_decode"] == 0))
        elif name == "train_lm_federated":
            from repro_torch.fed import tree_leaves
            from repro_torch.models import lm
            L = len(tree_leaves(lm.abstract_params(mod["small_cfg"](False))))
            rounds = _flag(argv, "--rounds", 20)
            want = expected_launches(qsgd_sumsq=2 * L * rounds,
                                     qsgd_quantize=2 * L * rounds,
                                     qsgd_dequant_apply=L * rounds)
            ok = last.startswith("loss: ") and (not cuda or launches == want)
        else:
            info = gia_fused.compile_cache_info()
            solved = (info.hits + info.misses) - (info0.hits + info0.misses)
            fused = "--backend" not in argv   # its default: the fused GIA
            ok = (last.startswith("FedAvg") and bool(lines) and (
                not fused or ("torch-fused backend" in lines[0]
                              and solved > 0))
                and launches == expected_launches())
        log(f"[examples] {name} on {dev}: {dt:.1f} s, final line "
            f"{last.strip()!r}; launches " + ", ".join(
                f"{k} {v}" for k, v in launches.items() if v)
            + ("" if any(launches.values()) else "none"))
        if not ok or (cuda and any(plain.values())):
            raise AssertionError(f"[examples] {name}: final line {last!r}, "
                                 f"launches {launches}, plain {plain}")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    return {"launches": total}


def phase_launch(dev="cuda", argv=LAUNCH_ARGV, extra=None) -> dict:
    """Phase 12: the training launcher at full width (``launch_train``),
    then the four example twins (``launch_examples``)."""
    train = launch_train(dev, argv)
    ex = launch_examples(dev, extra)
    return {"train": train, "examples": ex}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_all = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    bkern = timed("bucket_kernels", phase_bucket_kernels, "cuda")
    elias = timed("elias", phase_elias_kernel, "cuda")
    fused = timed("fused", phase_fused_kernels, "cuda")
    path = timed("main", phase_main_path)
    bucketed = timed("bucketed", phase_bucketed, path["task"],
                     path["consts"])
    sweep = timed("sweep", phase_sweep, path["consts"])
    plans = timed("planserver", phase_planserver, path["consts"],
                  path["plan"], path["task"])
    samp = timed("sampled", phase_sampled_faults, path["task"],
                 path["consts"])
    wavg = timed("gqfedwavg", phase_gqfedwavg, path["task"], path["consts"])
    pay = timed("payload", phase_payload, wavg["deltas"])
    pay_b = timed("payload_buckets", phase_payload_buckets, wavg["deltas"])
    k6 = timed("flash_decode", phase_flash_decode, "cuda")
    from repro_torch.models.registry import get_config
    cfg = get_config(SERVE_ARCH)
    serve = timed("serve", phase_serve, "cuda", cfg, SERVE_SLOTS,
                  SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
                  dataclasses.replace(cfg, n_layers=2))
    fam_serve = {}
    for arch, depth in SERVE_FAMILIES:
        fcfg = get_config(arch)
        max_len, prompt, new = SERVE_SHAPES.get(
            arch, (SERVE_MAX_LEN, SERVE_PROMPT, SERVE_NEW))
        fam_serve[arch] = timed(
            f"serve {arch}", phase_serve, "cuda", fcfg, SERVE_SLOTS,
            max_len, SERVE_REQUESTS, prompt, new,
            dataclasses.replace(fcfg, n_layers=depth))
    spmd = timed("spmd", phase_spmd, "cuda")
    audio = timed("spmd whisper", spmd_full_width, "cuda",
                  get_config(SPMD_AUDIO_ARCH), ("f32", "int8"), 1)
    launch = timed("launch", phase_launch, "cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # launches: each kernel's count on the path that carries it (K1-K3 the
    # quickstart run, K3b the bucketed quickstart, K4/K5 the payload path,
    # elias_decode the bucketed and elias payloads, K6 the serving run),
    # every path beside it (spmd: the federated LM round's three runs;
    # launch train: the launcher's run; examples: the four twins' sum)
    by_path = {"genqsgd": path["launches"], "bucketed": bucketed["launches"],
               "sweep": sweep["launches"], "planserver": plans["launches"],
               "sampled": samp["launches"],
               "gqfedwavg": wavg["launches"], "payload": pay["launches"],
               "payload_buckets": pay_b["launches"],
               "serve": serve["launches"],
               **{f"serve {a}": v["launches"] for a, v in fam_serve.items()},
               "spmd": spmd["launches"], "spmd whisper": audio["launches"],
               "launch train": launch["train"]["launches"],
               "examples": launch["examples"]["launches"]}
    home = {"fused_encode": "payload", "fused_rotate_encode": "payload",
            "flash_decode": "serve",
            "qsgd_dequant_apply_bucketed": "bucketed",
            "elias_decode": "payload_buckets"}
    timed = {**kern["main"], **fused["main"], **k6["main"],
             **bkern["main"], **elias["main"]}
    worst = {**kern["worst"], **fused["worst"], **k6["worst"],
             **bkern["worst"], **elias["worst"]}
    for part in (spmd, audio):          # the training paths' shapes
        for name, err in part["worst"].items():
            worst[name] = max(worst[name], err)
    kernels = []
    for name, (ms, plain, lib, (bnd, by)) in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": by_path[home.get(name, "genqsgd")][name],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            "max_abs_err": worst[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib})
        if name == "elias_decode":     # a sequential walk: no card version
            kernels[-1]["plain_on"] = "host"
    log(f"[done] {time.perf_counter() - t_all:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
