#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one GPU: RAQO planning, model
serving and training, the join operators, the streaming planner service,
the sharded plan scan and the sharding planner through the port's
hand-written CUDA kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero; there is no CPU path):

1. device  — the card's name and power limit from nvidia-smi;
2. build   — compile every source in src/repro_torch/kernels/csrc/
             (plan_scan.cu, flash_attention.cu, mamba_scan.cu,
             hash_join.cu, merge_join.cu) with nvcc, one process per
             source, all started together; once plan_scan and
             flash_attention are built, phase 13's launcher runs start
             in the background (they need no other kernel) and phase 3
             starts while the other three still build; phase 6 runs
             after phase 3, then the float32 checks of phases 7 and 13
             that no timed run follows (``untimed_checks``: padded_gemma,
             the padded smollm and Mamba1 hybrid train checks), and the
             launcher and phase 17's examples, started with it, are
             joined after them: they run beside the build and untimed
             work only;
3. parity  — each CUDA kernel against its plain torch version on the card:
             scan_argmin at both launch geometries over every shipped DB
             surface x objective, the 10M-row scaled_cluster(100_000, 100)
             grid (Q in {1, 8, 65}) and grids whose container sizes (7,
             100, 10 explicit values) do not divide the scan's tiles and
             whose last tile is ragged (Q in {1, 8, 63, 64, 65}), an
             all-OOM case and a tie plateau across tile boundaries;
             neighbor_step with 26 starts; ensemble_climb (Q requests x 26
             starts in one launch) over every surface on the ragged grid
             (max_iters 200), on the 10M-row grid (Q=2, max_iters 2000: its
             plain climb takes ~1e5 host steps a request to converge there),
             to convergence on the ensemble grid and on a 3-D table.  Flat
             ids and indices equal, costs bit-equal;
4. main    — RAQO.plan_queries on the §VII-C scale workload (8 random
             5-relation queries, simulator models, 100K containers x 100 GB)
             through the scan kernel ("batched") and the ensemble-climb
             kernel ("ensemble", on 1K containers x 100 GB, where the plain
             version's host climb still runs), then the four TPC-H queries
             (SF 100, the paper's published models, 100K x 100); the plans
             of the first query of each must equal the plain version's
             (TorchPlanBackend float32 on the card, that query alone),
             both kernels must have launched and neighbor_step must not
             have; then "ensemble" at 100K x 100 through the kernel, timed, with the device time of all its climb launches (its
             plans are not compared: the plain climb would take ~1e5 host
             steps a request); and the exact backend's float64 cost
             surfaces on CUDA tensors (3 model families x SMJ/BHJ x
             time/money at 3 (ss, ls) points, paper_cluster(100, 10) and
             scaled_cluster(1_000, 100)) bit-equal to the scalar cost and
             to the same grid on CPU tensors (``cost_grid_check``);
5. times   — each kernel at the main path's largest wave shape against its
             plain version and its bound (bytes or FP32 operations); the
             climb at the largest climb group of the 1K and of the 100K
             ensemble run, with its longest chain's iterations and the time
             of one iteration; the 1K group's first 8 requests bit-equal
             to the plain climb's on them (timed); at 100K every final index must be a local
             minimum of the plain surface (one neighbor_step_ref there, for
             starts that stopped before max_iters) with the kernel's cost;
6. model kernels against plain, on the card — flash_attention at
             smollm-360m's heads (H=15, KV=5, hd=64, B=4, S in {16, 100,
             512}, float32 and bfloat16, plus window+softcap and
             non-causal cases; at qwen3-moe-30b-a3b's H=32, KV=4,
             hd=128, S in {100, 512}; at zamba2-2.7b's H=32, KV=32,
             hd=80, S in {100, 512}, plus window+softcap; at gemma2-9b's
             H=16, KV=8, hd=256, S in {100, 512}, plain and with window
             128 and softcap 50; at mixtral-8x7b's H=32, KV=8, hd=128,
             bf16, S=512, window 128, and unwindowed as
             llama-3.2-vision-11b's self blocks run it (B=4, S=256 and
             B=8, S=512); at musicgen-medium's H=24, KV=24,
             hd=64, bf16, S=512: group size 1 on the tensor cores) within
             1e-5
             (float32) / 2e-2
             (bfloat16) of attention_ref; selective_scan at falcon-mamba-7b's width
             (D=8192, B in {1, 4}, S in {1, 16, 31, 32, 33, 100, 512}
             across the 32-step chunk edge, every N the kernel takes, with
             and without h0, float32 and bfloat16) within 1e-4 of
             selective_scan_ref (allclose, atol = rtol); then K7 masking
             by positions (POSITION_HEADS: bf16 at hd 64 and 128 on the
             tensor cores, float32 and bf16 at hd 80 and 256 on the CUDA
             cores; B=4, S=300: left-padded rows, one all pads, offset
             positions, pads under a window of 100 with softcap 30)
             against attention_ref with the same positions, positions
             arange bit-equal to the index path, and K8 at the Mamba1
             hybrid's D=5120, N=64;
7. serve   — launch.serve.serve for smollm-360m, falcon-mamba-7b,
             qwen3-moe-30b-a3b, zamba2-2.7b, mixtral-8x7b (swa) and
             gemma2-9b (local_global) at full width and depth (mixtral's
             main path at 24 of its 32 layers), seeded random
             parameters on the card, 8 requests, 4 slots, prompt 256, 32
             new tokens: in float32 through the kernels and with
             impl="ref" (qwen3 at 8 of its 48 layers, mixtral at 4 of 32,
             the Mamba1 hybrid at 12 of its 54; every request's
             tokens equal, first-wave prefill logits within 1e-3; the moe
             models' router decisions compared: any that differ must be
             near-ties, and plain then reruns with the kernels'
             decisions); mixtral (4 layers) and gemma2 (8) also serve 2
             prompts of 4160 on 2 slots, 16 new, past their window of
             4096, float32 kernels against plain (tokens equal, logits
             within 1e-3, each rolling cache exactly 4096 slots holding
             the last 4096 positions after prefill and after decode);
             then in the configs' own bfloat16 through the kernels (qwen3
             and mixtral with bfloat16 parameters; tok/s, steps,
             launches; selective_scan must launch on falcon-mamba-7b,
             flash_attention once a layer a wave on the others, on
             zamba2-2.7b once a group a wave, 18 times), and the prefill
             wave and decode step of qwen3, zamba2, mixtral and gemma2
             traced by operator; then llama-3.2-vision-11b (vlm: 40
             layers, 32 self-attention and 8 gated cross-attention
             blocks, gates set to 0.5) and musicgen-medium (audio, 48
             layers) through the Model API (the serving loop feeds
             tokens only, as the reference's does): 4 prompts of 256
             (the vlm's with media (4, 1600, 1280), musicgen's frame
             embeddings), one prefill, 32 decode steps (the vlm's greedy
             tokens, musicgen's seeded frames), at full depth in float32
             through the kernels and with impl="ref" (tokens or argmax
             equal at every step, prefill logits within 1e-3), then in
             bfloat16 on float32 parameters (tok/s, prefill s, decode ms,
             K7 once a self-attention layer; zeroed media must move the
             vlm's logits), K7's and the cross attention's device time
             over one prefill, both traced by operator; the Mamba1 hybrid
             (MAMBA1_HYBRID: zamba2's widths with 54 Mamba1 blocks, K8 at
             N=64) served as the token models are (float32 against plain,
             then bf16 on float32 parameters: K8 once a block a wave, K7
             once a group a wave); batches with their own positions
             (padded_serve): smollm-360m's prompts of 256, 200, 131 and 64
             tokens left-padded to 256, 16 greedy steps, in bf16 (tok/s,
             K7 once a layer) and in float32 against plain (tokens equal,
             logits within 1e-3) and each row against itself alone,
             unpadded (logits within 1e-4); gemma2-9b at one pair on a
             prompt of 4,160 with 100 leading pads (padded_gemma, run
             beside the build: kernels against plain, the caches holding
             each valid position at its slot);
13. train  — (runs after 7) smollm-360m at full width and depth, falcon-mamba-7b at
             full width and 8 of its 64 layers, qwen3-moe-30b-a3b at
             full width and 4 of its 48, zamba2-2.7b at full width and
             12 of its 54 layers with group-level remat, mixtral-8x7b at
             2 of its 32, gemma2-9b at 8 of its 42, llama-3.2-vision-11b
             at 2 of its 8 groups (10 of 40 layers, gates 0.5) and
             musicgen-medium at 24 of its 48: in float32 (smollm B=2, S=256; falcon B=1,
             S=128; qwen3, mixtral, gemma2, the vlm and musicgen B=2,
             S=128; zamba2 B=1, S=256; one fixed batch) the model on the
             kernels (K7 / K8 forward, their analytic backwards) against
             impl="ref" (autograd through the plain versions): loss within
             1e-5, every gradient nonzero and within GRAD_TOL (max |diff|
             over max |g| per tensor), parameters after 3 AdamW steps;
             then the configs' bfloat16 with float32 masters, 20 steps of
             make_train_step on SyntheticPipeline batches of 8 x 512 (step
             ms, tokens/s, peak memory, the loss falling, launches and
             the kernel's device time on one step; qwen3's aux losses at
             step 20; the step of qwen3, zamba2, mixtral, gemma2, the vlm
             and musicgen traced by operator); then
             python -m repro_torch.launch.train on one GPU (8 steps), whole
             and, in a second process beside it, crashed at step 6 then
             resumed from step 4, final losses within LAUNCHER_LOSS_TOL,
             and float32 checks without a timed run: smollm-360m on a
             batch whose row 0 is left-padded by 56 (its own positions,
             labels -1 there), and the Mamba1 hybrid at one group of 6,
             B=1, S=128 (TRAIN_CHECKS) (these two, the launcher and
             padded_gemma run early, beside the build: see phase 2);
8. times   — flash_attention at B=1, S=4096 and at the serve shape (B=4,
             S=256), smollm's heads, bfloat16, against attention_ref and
             torch's scaled_dot_product_attention (timed here only; the port
             never calls it) in alternating rounds, each timed eagerly and
             as replays of a CUDA graph (device-bound, no host launch cost);
             the built library's SASS must show HGMMA in the tensor-core
             kernel; the same at zamba2-2.7b's heads (32:32, hd 80, bf16
             on the CUDA cores) and gemma2-9b's (16:8, hd 256, bf16 on the
             CUDA cores; at S=4096 also with softcap 50, kernel only) and
             musicgen-medium's (24:24, hd 64, bf16 on the tensor cores) at
             B=1, S=4096 and B=4, S=256 in 3 rounds; K7 masking by
             positions (arange: every kv tile visited) at B=1, S=4096
             beside SDPA with the same boolean mask; selective_scan at
             B=1, S=4096 and at the serve shape (B=4, S=256), D=8192,
             N=16, against selective_scan_ref, and at the Mamba1
             hybrid's D=5120, N=64, B=1, S=4096; the
             SASS instruction counts of the scan's per-row body and of
             K8's per-step body (cuobjdump --dump-sass) and, with the SM
             clock read under load (nvidia-smi), an estimate of the share
             of the card's issue rate each kernel takes;
9. joins   — ops.bhj_join and ops.smj_join at TPC-H SF 100 (row counts from
             tpch_schema(100)), data made on the card from a seeded
             generator: lineitem x supplier on suppkey (BHJ, 600M probes
             into 1M dense keys, all hit) and lineitem x orders on
             orderkey (SMJ, ~600M probes clustered by order into the ~72M
             orders that Q3's date filter keeps, ~half miss); each
             bit-equal to its plain version there and on small edge cases
             (duplicate keys, negative values, INT_MIN / INT_MAX keys,
             R = 1, R = 0, S = 0, ragged lengths, and join_cases: the hash
             join's dense array and table, key -1 with value -1 among keys
             that start at its slot, the merge join's staged and narrowed
             tiles, tile ranges at the staging budget and one over, all
             probes equal; each also as slices whose data pointers are off
             a 16-byte boundary); times against the plain versions, the
             byte bound (with the GB/s reached) and (SMJ)
             torch.searchsorted, timed here only;
10. service — StreamingPlannerService on the streaming bench's schema
             (random_schema(16, seed=0)), simulator models and 100K
             containers x 100 GB through the scan kernel: the bench's
             12-query churn stream and 32 sampled closed-loop tickets equal
             to solo planning on a fresh broker; closed loop at concurrency
             256 over 512 Poisson arrivals and the open-loop replay of 200
             arrivals at 100/s, with plans/s, p50/p99 latency and waves;
11. sharded — scan_argmin_sharded (K4) over D in {1, 2, 3, 4, 7} logical
             shards of the card on scaled_cluster(100_000, 100), Q = 60 and
             Q = 1, a tie-heavy surface (a floor plateau across every shard
             boundary), a grid whose last shard is below one tile and an
             all-infeasible grid: bit-equal to single-launch scan_argmin and
             to scan_argmin_sharded_ref; then RAQO.plan_queries of the TPC-H
             queries on CudaPlanBackend(devices=[cuda] * 4) (the main path)
             with plans equal to the unsharded backend's; real GPUs too when
             more than one is visible; K4 times at D in {1, 4, 7};
12. sharding — every roofline surface (10 archs x train / prefill /
             decode x plan choices x both objectives x 3 param sets) in the
             kernels bit-equal to its plain version, row by row, and its
             ensemble climb from every grid point; then
             ShardingPlanner().joint on the default CUDA backend for all ten
             archs at full width x 3 shapes x hillclimb / ensemble / brute,
             for_budget(64) and replan(lost_chips=128), every decision equal
             to backend="torch"; one broker shared by TPC-H operator
             requests, a sharding planner and a TPC-H RAQO session, plans
             equal to solo planning; the roofline scan's time;
14. plan-lint — (runs after 12) repro_torch.analysis.collect on the card:
             the registered cost surfaces evaluated on CUDA tensors, the
             grid-memo audit of "torch" and "cuda" (the seven probes
             through the real scan and climb launches), the static memo-key
             check and the host-sync lint; no unallowed warn or error, the
             audit table equal to expected_counts at one plan device and,
             in a second sweep, at devices=[cuda] * 4 (K4), each launch
             counter risen by exactly expected_launches, and no nvcc run
             after phase 2 (build.build_seconds unchanged).  Prints the
             table, its hash and the severity counts;
15. multi-device path, world of one — (runs after 14) an NCCL process
             group of one rank and a (1, 1, 1) ("pod", "data", "model")
             mesh: smollm-360m at full width and depth (32 layers), then
             qwen3-moe-30b-a3b (2 of 48 layers: the moe FFN's two
             local_maps), falcon-mamba-7b (2 of 64: K8 under its
             local_map on the rank's channels), zamba2-2.7b (one group
             of 6 Mamba2 blocks and the shared block: K7 at hd 80 under
             local_map), gemma2-9b (one (local, global) pair of 42
             layers: K7 at 16:8 hd 256 with softcap 50 under local_map,
             windowed and global), llama-3.2-vision-11b (one group of 5
             of 40 layers: 4 self blocks, K7 at 32:8 hd 128, and the
             gated cross block, its cross attention under its own
             local_map; the gates opened first) and musicgen-medium (all
             48 layers, K7 at 24:24 hd 64, on frame embeddings) and the
             Mamba1 hybrid (one group of 6, K8 at N=64 under
             map_channels, REPLAYED), each
             float32, B=2, S=256, take TRAIN_F32_STEPS
             AdamW steps under launch.specs.plan_for's train plan (remat
             none; the parameters DTensors) from the same seeded state as
             the single-device path beside it (zamba2's each step from the
             single run's state, REPLAYED): losses, grad norms and
             parameters within LOSS_TOL, GRAD_TOL and PARAM_SHARE_TOL, and
             K7's and K8's launch counters risen by exactly as much on
             both (one a layer a step, a vlm's self blocks only).
             smollm-360m again under tp_mode="shard_map" and the
             causal_skip schedule, qwen3 and the vlm again under
             tp_mode="shard_map" (MULTI_VARIANTS), each against the same
             one-device run: the explicit Megatron projections over NCCL,
             counted (_expected_projections; none in a moe FFN, a cross
             block's attention, a Mamba mixer); then
             pipeline.gpipe_apply at one
             stage against the sequential layers on the card (forward
             1e-5, gradients 1e-4);
16. serve plans, world of one — (runs after 15) a new NCCL process
             group of one rank on the (1, 1, 1) mesh: smollm-360m at full
             width and depth in its own bf16 (SERVE_PLAN_MAIN: B=4,
             prompt 256, 16 greedy decode steps), then the families of
             MULTI_FAMILIES at their depths in float32 (B=4, prompt 64, 8
             steps; gemma2 B=2 with a prompt of 4,160 past its window),
             and phase 7's left-padded smollm batch in its bf16 (K7
             masking by the positions through its local_map),
             each prefilled under plan_for's prefill plan and decoded
             under its decode plan over the same parameter tensors
             (Model.with_plan; the cache DTensors sharded along
             "kv_seq"), beside the same model on one device: tokens
             equal, every step's logits within LOGIT_TOL, K7 (through its
             local_map) and K8 launched in prefill as on one device, and
             decode attention on the sharded cache once an attention
             block a step; a "serveplan ..." line a model with its warm
             decode step on both.  smollm (8 steps), qwen3 and the vlm
             then serve again under tp_mode="shard_map" over the same
             parameter tensors (SERVE_PLAN_SHARD_MAP; a model axis of 1
             splits the one-token sequence, so decode runs, as the
             reference's does there), against the same one-device run:
             tokens equal, logits within LOGIT_TOL, the explicit
             projections of a prefill and of a decode step counted, K7
             through local_map in prefill;
17. examples — (started with the launcher, beside the build, phases
             3 and 6 and the untimed checks; joined after the launcher)
             the port's four examples
             (examples/port_*.py) on the card, each a subprocess: the
             planning example's lines equal to its lines on the kernels'
             plain versions and, but for Q3's float32 tie
             (EXAMPLE_FLOAT32_LINES), to its --device cpu lines, its
             scan launches counted; the quickstart's loss falling over
             its 200 steps, two checkpoints kept; the serving example's
             8 requests of 16 tokens; the elastic example's crash at
             step 15, replan and resume;
18. dry run — (started with the launcher, joined after phase 17) python
             -m repro_torch.launch.dryrun of DRYRUN_CELL on both
             production meshes, a subprocess on the host CPU with the
             GPU hidden: one rank of 256 and of 512 over a fake process
             group under FakeTensorMode, both records "ok" with dot
             FLOPs; one "dryrun ..." line a record (no kernel runs).

Every kernel's device time over its own path's launches (torch.profiler
over one run of the path: phases 4, 7, 9 and 11) goes into its JSON
record as path_ms / path_launches (K7 and K8 also train_path_ms /
train_path_launches over one step of phase 13's timed run; K7 also
qwen3-moe-30b-a3b's as moe_path_ms and moe_train_path_ms, zamba2-2.7b's
as hybrid_path_ms and hybrid_train_path_ms, mixtral-8x7b's as swa_*,
gemma2-9b's as local_global_*, llama-3.2-vision-11b's as vlm_*,
musicgen-medium's as audio_*, and its times at hd 80 and 256 as hd80_*
and hd256_*, at 24:24 hd 64 as mha_*; K7's and K8's launches over phase
15's mesh runs as multidevice_path_launches; the plan-scan kernels' and
K7's launches in phase 17's planning example and quickstart as
examples_launches), and
path_source says how it was read
("torch.profiler", or CUDA events around the wrapper's calls where the
profiler dropped launches: an upper bound).  The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}, after the card's
name and power limit printed a second time; each phase's
(and each model's) wall seconds are printed on lines of their own
("wall ...").
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

H100_FP32_FLOPS = 67e12        # FP32 outside the tensor cores, H100 SXM
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense, H100 SXM
H100_HBM_BYTES_S = 3.35e12     # HBM3, H100 SXM

# FP32 operations per configuration row of each surface's device function
# (every add, mul, IEEE division, logf, max, compare counted as one; the
# strict-< fold adds one) — a lower bound: a division is ~10 instructions
SURFACE_OPS = {"regression": 18, "regression+oom": 20, "smj": 23, "bhj": 15}
ROWS_PER_THREAD = 8            # plan_scan.cu: a scan thread's rows
OBJECTIVE_OPS = {"time": 0, "money": 5, "sla": 5}
FOLD_OPS = 1

QUERIES = 8                    # random 5-relation queries (seeds 0..7)
# the plain planner's comparison runs the first PLAIN_QUERIES queries of
# each main-path workload (the kernels plan all of them): the plain host
# climb takes ~20 s a query on the ensemble grid
PLAIN_QUERIES = 1
CLIMB_PLAIN_Q = 8              # requests of the main-path climb held
                               # against the plain climb
ENSEMBLE_CONTAINERS = 1_000    # the ensemble pass's grid: 1K x 100 GB
CLIMB_STARTS = 26              # the planners' 2 corners + 24 random starts

ATTN_HEADS = (15, 5, 64)       # smollm-360m: H, KV, hd
SCAN_WIDTH = (8192, 16)        # falcon-mamba-7b: d_inner, N
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_ATTN = (4, 256)          # the serve phase's prefill: 4 slots x 256
ATTN_ROUNDS = 7                # alternating K7 / SDPA timing rounds
SCAN_TOL = 1e-4
LOGIT_TOL = 1e-3               # float32 prefill logits, kernels vs plain
SERVE = dict(requests=8, slots=4, prompt_len=256, max_new=32, seed=0,
             device="cuda")
PATH_NEW = 2                   # tokens a request of serve_path_ms's run
# phase 7's models: the kernel its main path must launch, the depth of its
# float32 identity run, its main path's parameter dtype and its main
# path's depth (None: full depth, the config's).  qwen3-moe-30b-a3b's
# float32 parameters at full depth are 30.5B x 4 B ~ 122 GB, over the
# card's 80 GB: its identity run takes 8 of 48 layers (~22 GB), and its
# main path (all 48 layers) holds bfloat16 parameters (~61 GB)
MOE = "qwen3-moe-30b-a3b"
# zamba2-2.7b (the hybrid family): 54 Mamba2 blocks and one shared
# attention block after every 6, ~2.45B parameters (~9.8 GB in float32),
# so its identity run and its main path both run at full depth
HYBRID = "zamba2-2.7b"
# mixtral-8x7b (moe, every layer windowed to 4096): ~1.45B parameters a
# layer (~5.8 GB in float32), 46.7B in all (~93 GB in bfloat16, over the
# card's 80 GB): its identity run takes 4 of 32 layers, its main path
# bfloat16 parameters at 24 of 32 (~70 GB)
SWA = "mixtral-8x7b"
# gemma2-9b (dense, (local, global) layer pairs, window 4096, hd 256):
# 9.2B parameters, ~37 GB in float32, so both run at full depth
LOCAL_GLOBAL = "gemma2-9b"
# the Mamba1 hybrid (the original Zamba's kind, arXiv:2405.16712):
# zamba2-2.7b's widths with Mamba1 blocks, 54 at d_inner 5120, N 64 (K8's
# N = 64 instantiation) and dt_rank 160, the shared 32:32 hd-80 block
# after every 6; float32 parameters (~2.5B, ~10 GB), bf16 compute: its
# main path at full depth, its identity run at 12 of 54 layers (2 of its
# 9 groups: its plain scan steps the 256 prompt positions one by one in
# each block, ~25 s at 54).  No configuration file (the reference has
# none): model_config
MAMBA1_HYBRID = "zamba2-2.7b-mamba1"
MAMBA1_WIDTH = (5120, 64)      # its d_inner, N
SERVE_MODELS = {"smollm-360m": ("flash_attention", None, None, None),
                "falcon-mamba-7b": ("selective_scan", None, None, None),
                MOE: ("flash_attention", 8, "bfloat16", None),
                HYBRID: ("flash_attention", None, None, None),
                SWA: ("flash_attention", 4, "bfloat16", 24),
                LOCAL_GLOBAL: ("flash_attention", None, None, None),
                MAMBA1_HYBRID: ("selective_scan", 12, None, None)}
# batches with their own positions (phase 7): smollm-360m's prompts of
# these lengths, each left-padded (-1) to the longest, then PADDED_NEW
# greedy steps, each row also held against itself prefilled alone,
# unpadded, to ALONE_TOL; gemma2-9b at one (local, global) pair: one
# prompt of PADDED_GEMMA[0] positions, its first PADDED_GEMMA[1] pads,
# then PADDED_GEMMA[2] greedy steps
PADDED_PROMPTS = (256, 200, 131, 64)
PADDED_NEW = 16
ALONE_TOL = 1e-4
PADDED_GEMMA = (4160, 100, 8)
# llama-3.2-vision-11b (vlm): 8 groups of 4 self-attention blocks (K7 in
# prefill) and one gated cross-attention block onto 1,600 media tokens
# (plain torch), 9.78B parameters in the reference's tree (~39.1 GB in
# float32); musicgen-medium (audio): 48 layers of 24:24 heads at hd 64 on
# frame embeddings, 1.815B (~7.3 GB).  Both serve at full depth through
# the Model API (the serving loop feeds tokens only, as the
# reference's does): MEDIA_SERVE's prompts, one prefill wave, then
# max_new decode steps
VLM = "llama-3.2-vision-11b"
AUDIO = "musicgen-medium"
MEDIA_MODELS = (VLM, AUDIO)
MEDIA_SERVE = dict(requests=4, prompt_len=256, max_new=32, seed=0)
# the vlm's cross blocks' gates initialise to zero (tanh(0) = 0: every
# cross block adds nothing); every vlm run sets them to this first
GATE = 0.5
MUSICGEN_HEADS = (24, 24, 64)  # musicgen-medium: H, KV, hd (group 1)
# the models whose serve and train main paths are traced by operator
TRACED = (MOE, HYBRID, SWA, LOCAL_GLOBAL, VLM, AUDIO)
# phase 7's window runs: the standard traffic's 256 + 32 positions never
# reach a window of 4096, so each windowed model also serves prompts 64
# positions longer than its window (K7's window masks in prefill, the
# rolling caches keep the prompt's last W positions) and decodes into
# rolled slots, float32 kernels against plain, at these depths
WINDOW_SERVE = dict(requests=2, slots=2, prompt_len=4160, max_new=16, seed=0,
                    device="cuda")
WINDOW_LAYERS = {SWA: 4, LOCAL_GLOBAL: 8}
QWEN_HEADS = (32, 4, 128)      # qwen3-moe-30b-a3b: H, KV, hd (group 8)
ZAMBA_HEADS = (32, 32, 80)     # zamba2-2.7b's shared block: H, KV, hd
MIXTRAL_HEADS = (32, 8, 128)   # mixtral-8x7b: H, KV, hd (group 4)
GEMMA_HEADS = (16, 8, 256)     # gemma2-9b: H, KV, hd (group 2)
GEMMA_SOFTCAP = 50.0           # gemma2-9b's attention softcap
# a router decision (a token's top-k expert set) that differs between the
# float32 kernels and plain runs is a near-tie when the kernels run's gap
# between its k-th and (k+1)-th probability is at most this: K7 and plain
# attention differ by ~1e-7, which moves a probability by far less
FLIP_GAP = 1e-5

JOIN_SF = 100                  # TPC-H scale factor of phase 9
JOIN_SEED = 9
Q3_SELECTIVITY = 0.48          # share of orders with o_orderdate < 1995-03-15
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
# integer operations per row: BHJ hashes each build and probe key (9) and
# compares once; SMJ does one step of 3 per search level, then 2
HASH_OPS = 10
SEARCH_STEP_OPS, SEARCH_END_OPS = 3, 2
# the hash join's kernels, one launch each a call (csrc/hash_join.cu)
HASH_KERNELS = ("hash_minmax_kernel", "hash_build_kernel",
                "hash_finalize_kernel", "hash_probe_kernel")

# phase 13: training at full width; falcon-mamba-7b cut to 8 of its 64
# layers (float32 masters, grads and Adam moments at full depth are ~112
# GB), qwen3-moe-30b-a3b to 4 of its 48 (~10 GB of them a layer, ~10 GB
# for the embedding and head); zamba2-2.7b at 12 of its 54 layers (2 of
# its 9 groups of 6 Mamba2 blocks, each followed by the shared attention
# block; all 54 took ~140 s of the phase, 24 took 56.5-65.5 s, and on a
# slow host the script took 1097.9 s against its 1200 s limit) with the
# reference's group-level remat (nothing_saveable): without it
# the SSD's float32 (B, c, c, H) intermediates keep ~1.7 GB a Mamba2
# block at 8 x 512.  Values: (layers, None for all; the kernel; the
# plan's remat)
# mixtral-8x7b at 2 of its 32 layers (~1.45B parameters, ~23 GB of
# masters, grads and moments a layer), gemma2-9b at 8 of its 42 (its
# embedding alone 0.92B parameters, ~14.7 GB, each layer 0.198B, ~3.2 GB;
# all 42 would be ~147 GB)
# llama-3.2-vision-11b at 2 of its 8 groups (10 of 40 layers: 8 self and
# 2 cross blocks, 3.24B parameters with the 1.06B of embed, head and
# projector, ~52 GB of masters, grads and moments), musicgen-medium at
# 24 of its 48 layers (cut for time, as zamba2: on a slow host the script
# took 1148.8 s against its 1200 s limit)
TRAIN = {"smollm-360m": (None, "flash_attention", "none"),
         "falcon-mamba-7b": (8, "selective_scan", "none"),
         MOE: (4, "flash_attention", "none"),
         HYBRID: (12, "flash_attention", "nothing_saveable"),
         SWA: (2, "flash_attention", "none"),
         LOCAL_GLOBAL: (8, "flash_attention", "none"),
         VLM: (10, "flash_attention", "none"),
         AUDIO: (24, "flash_attention", "none")}
TRAIN_F32 = {"smollm-360m": (2, 256), "falcon-mamba-7b": (1, 128),
             MOE: (2, 128), HYBRID: (1, 256), SWA: (2, 128),
             LOCAL_GLOBAL: (2, 128), VLM: (2, 128), AUDIO: (2, 128)}  # B, S
# models whose float32 AdamW steps are each compared from the plain run's
# state (replayed_steps) instead of along two runs: zamba2-2.7b's float32
# trajectory at TRAIN_LR is chaotic whatever runs it: plain against plain
# with every parameter moved by one float32 ulp differs by more than 2%
# of lr in 57% of the elements after 2 steps and in 90% after 3 (54
# layers on one H100 80GB HBM3 at 700 W; 12 layers: kernels against plain
# 11% after 3), while one step from one state differs in 7.9e-6 of them
REPLAYED = {HYBRID, MAMBA1_HYBRID}
# float32 checks of phase 13 without a timed run (as TRAIN's values): the
# Mamba1 hybrid at one group of 6 (its timed run would add ~60 s), at
# falcon-mamba-7b's B=1, S=128 (both sides' scans step the positions one
# by one: S=256 took 17.5 s)
TRAIN_CHECKS = {MAMBA1_HYBRID: (6, "selective_scan", "nothing_saveable")}
TRAIN_F32[MAMBA1_HYBRID] = (1, 128)
TRAIN_PADS = 56                # phase 13's smollm check: row 0's left pads
MOE_METRICS = ("lb_loss", "z_loss", "drop_frac")
TRAIN_LR = 1e-3                # the float32 check's AdamW steps
TRAIN_F32_STEPS = 3
LOSS_TOL = 1e-5                # float32 loss, kernels vs plain, relative
# float32 gradients, kernels vs plain: max |diff| over max |g| per tensor
GRAD_TOL = 1e-4
# float32 parameters after the AdamW steps: each step moves an element by
# about lr * m / sqrt(v), so an element whose tiny gradient rounds another
# way moves by another fraction of lr; at most this share of the elements
# may differ by more than 2% of lr, none by more than 2 lr a step
PARAM_SHARE_TOL = 1e-4
TRAIN_BF16 = dict(batch=8, seq=512, steps=20)
TRAIN_SCHEDULE = (3e-4, 2)     # the trainer's cosine: peak, warmup steps
# 8 steps, a checkpoint every 4 (each checkpoint of the full-width float32
# state is ~4.3 GB; 12 steps, every 5, wrote 6 of them, this writes 4)
LAUNCHER = ["--arch", "smollm-360m", "--steps", "8", "--batch", "8",
            "--seq", "512", "--ckpt-every", "4"]
LAUNCHER_FAIL_AT = 6
LAUNCHER_LOSS_TOL = 1e-3       # final loss, resumed vs whole run, relative

STREAM_TABLES = 16             # the streaming bench's random_schema(16, 0)
STREAM_CLOSED = dict(concurrency=256, n_queries=512, seed=43)   # its FULL
STREAM_OPEN = dict(rate=100.0, n=200, seed=11)                  # its OPEN
STREAM_SAMPLE = 32             # closed-loop tickets checked against solo


def model_config(name: str):
    """The config of a model name: a registered arch's, or the Mamba1
    hybrid's (MAMBA1_HYBRID)."""
    from repro_torch.configs import get_config
    if name == MAMBA1_HYBRID:
        return dataclasses.replace(get_config(HYBRID), name=MAMBA1_HYBRID,
                                   ssm_version=1)
    return get_config(name)


def left_padded(lengths, S: int, offset: int = 0):
    """(B, S) int64 positions of rows of ``lengths`` valid slots each,
    right-aligned: -1 on the leading pads, then offset, offset + 1, ..."""
    return np.stack([np.r_[np.full(S - n, -1), offset + np.arange(n)]
                     for n in lengths]).astype(np.int64)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def lap(label: str, since: float) -> float:
    """Print a phase's wall seconds on a line of its own; returns now."""
    now = time.perf_counter()
    print(f"wall {label}: {now - since:.1f} s", flush=True)
    return now


def open_gates(torch, model):
    """A vlm's cross blocks' gates set to GATE, in place (other models as
    they are)."""
    with torch.no_grad():
        for blk in getattr(model, "cross", ()):
            blk.gate_attn.fill_(GATE)
            blk.gate_mlp.fill_(GATE)
    return model


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def model_kernels() -> dict:
    """The model kernels' wrapper modules, by wrapper name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    return {"flash_attention": fa, "selective_scan": ms}


def launch_counts() -> dict:
    """The model kernels' launch counters (ops.reset_launch_counts sets
    them to 0)."""
    return {name: getattr(mod, name).launches
            for name, mod in model_kernels().items()}


# the same surfaces in the DB scan's hoisted form (plan_scan.cu
# scan_db_kernel): per (row, request) only what needs both (SMJ two
# divisions, a max, a multiply and two adds; BHJ a compare and a select;
# the regression five adds and the floor's max, its OOM mask a compare and
# a select), per (request, dim-0 value) SMJ's and BHJ's quotients, per row
# the request-free terms
HOISTED_ROW_OPS = {"regression": 6, "regression+oom": 8, "smj": 6, "bhj": 2}
HOISTED_QN_OPS = {"regression": 0, "regression+oom": 0, "smj": 8, "bhj": 13}
HOISTED_R_OPS = {"regression": 8, "regression+oom": 9, "smj": 3, "bhj": 1}


def scan_ops(surface, dims, Q: int):
    """FP32 operations of a DB scan of ``Q`` requests over the grid
    ``dims``, counted two ways: (each row's whole surface, the hoisted
    form)."""
    kind = surface.kind
    if kind == "regression" and surface.oom:
        kind = "regression+oom"
    rows = math.prod(d.size for d in dims)
    per_row = OBJECTIVE_OPS[surface.objective] + FOLD_OPS
    return (rows * Q * surface_ops(surface),
            rows * Q * (HOISTED_ROW_OPS[kind] + per_row) +
            dims[0].size * Q * HOISTED_QN_OPS[kind] +
            rows * HOISTED_R_OPS[kind])


def surface_ops(surface) -> int:
    kind = surface.kind
    if kind == "regression" and surface.oom:
        kind = "regression+oom"
    return SURFACE_OPS[kind] + OBJECTIVE_OPS[surface.objective] + FOLD_OPS


def bound_ms(n_bytes: int, n_ops: int, peak: float = H100_FP32_FLOPS):
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over their type's peak (FP32 unless
    ``peak`` says otherwise)."""
    by_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    by_ops = n_ops / peak * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def time_ms(fn, reps: int, torch) -> float:
    fn()                                       # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_times(torch, fn, reps: int) -> dict:
    """One torch.profiler trace of the card's activity over ``reps`` calls
    of ``fn``: {kernel name: (device ms, launches)} of every kernel (and
    copy) in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    return out


def profile_kernels(torch, fn, reps: int, kernels: dict) -> dict:
    """One torch.profiler trace of ``reps`` calls of ``fn``: for each key
    of ``kernels`` (a tuple of kernel name substrings), the device time of
    those kernels' launches in ms and the number of launches it holds."""
    rows = kernel_times(torch, fn, reps)
    out = {}
    for key, names in kernels.items():
        hit = [v for k, v in rows.items() if any(n in k for n in names)]
        out[key] = (sum(ms for ms, _ in hit), sum(n for _, n in hit))
    return out


def device_ms(torch, fn, reps: int, kernel: str,
              launches: Optional[int] = None):
    """Device time of one launch of ``kernel`` (a name substring) over
    ``reps`` calls of ``fn``, or of one call's ``launches`` of it, from
    torch.profiler; None when the profiler records no device time for it,
    or not ``reps`` x ``launches`` launches (it can drop events)."""
    fn()
    total, count = profile_kernels(torch, fn, reps, {0: (kernel,)})[0]
    if launches is not None:
        if count != reps * launches:
            return None
        count = reps
    return total / count if count and total else None


class _Timed:
    """A kernel wrapper that records CUDA events around each of its calls
    (its launch counter stays the wrapped function's)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events = torch, fn, []

    def __call__(self, *args, **kwargs):
        e0 = self.torch.cuda.Event(enable_timing=True)
        e1 = self.torch.cuda.Event(enable_timing=True)
        e0.record()
        out = self.fn(*args, **kwargs)
        e1.record()
        self.events.append((e0, e1))
        return out

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def path_ms(torch, fn, kernels: dict) -> dict:
    """The device time of each kernel's launches in one run of the path
    ``fn`` (just run, so warm): ``kernels`` maps a key to (kernel name
    substrings, the launches the path makes, (module, wrapper name)).
    From one torch.profiler trace; where it holds another count of a
    kernel (it can drop events) the profile is taken once more, and then
    CUDA events around the wrapper's calls on one more run time it (the
    wrapper's small tensor operations included, so an upper bound).  0.0
    for a kernel the path does not launch.  Returns {key: (ms, how)}."""
    out = {k: (0.0, "no launches") for k, v in kernels.items() if v[1] == 0}
    for _ in range(2):
        todo = {k: v for k, v in kernels.items() if k not in out}
        if not todo:
            return out
        got = profile_kernels(torch, fn, 1,
                              {k: v[0] for k, v in todo.items()})
        for key, (total, count) in got.items():
            if count == todo[key][1] and total:
                out[key] = (total, "torch.profiler")
    todo = {k: v for k, v in kernels.items() if k not in out}
    timed = {k: _Timed(torch, getattr(*wrapper))
             for k, (_, _, wrapper) in todo.items()}
    for k, t in timed.items():
        setattr(*todo[k][2], t)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for k, t in timed.items():
            setattr(*todo[k][2], t.fn)
    for k, t in timed.items():
        out[k] = (sum(a.elapsed_time(b) for a, b in t.events),
                  "CUDA events around the wrapper's calls (the profiler "
                  "dropped launches)")
    return out


def cuda_graph(torch, fn, calls: int):
    """``calls`` calls of ``fn`` captured in one CUDA graph: timing its
    replays leaves out the host's launch cost between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def sm_clock_mhz(torch, fn) -> Optional[float]:
    """The SM clock in MHz (nvidia-smi) read while ``fn`` runs on the card
    back to back, so the clock under that load; None if unread."""
    import threading
    got = []

    def read():
        time.sleep(0.3)
        got.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout)

    reader = threading.Thread(target=read)
    reader.start()
    while reader.is_alive():
        fn()
    torch.cuda.synchronize()
    try:
        return float(got[0].split()[0])
    except (IndexError, ValueError):
        return None


def issue_share(torch, warp_instrs: float, ms: float, mhz):
    """The share of the card's issue rate (4 warp-instructions a clock an
    SM) that ``warp_instrs`` warp-instructions in ``ms`` take at ``mhz``:
    an estimate, as the count is static SASS times the loop's trips."""
    if mhz is None:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return warp_instrs / (sms * 4 * mhz * 1e3 * ms)


def sass_functions(path) -> dict:
    """{mangled name: [(address, instruction)]} of a built library's SASS
    (cuobjdump --dump-sass)."""
    sass = subprocess.run(["cuobjdump", "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        out[name.strip()] = [(int(m.group(1), 16), m.group(2).strip())
                             for m in line.finditer(body)]
    return out


def sass_loop(instrs, marker: str):
    """The innermost loop (a backward branch's span) that holds ``marker``:
    (its instruction count, how many of them contain ``marker``), or None.
    An IEEE division's slow path and other calls lie outside the loop and
    are not counted."""
    best = None
    for addr, ins in instrs:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in instrs if int(m.group(1), 16) <= a <= addr]
        hits = sum(marker in i for i in body)
        if hits and (best is None or len(body) < best[0]):
            best = (len(body), hits)
    return best


# phase 4's float64 surface check: test_batched_costing.py's (ss, ls)
# points, on the paper's grid and on a 100K-row scaled grid
COST_GRID_POINTS = ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0))
COST_GRID_FAMILIES = ("paper_models", "simulator_models",
                      "simulator_cost_models")


def cost_grid_check(torch, dev) -> None:
    """The exact backend's float64 cost surfaces (``OperatorCosting.
    _op_cost_grid``: ``cost_grid``, and the money objective around it) on
    CUDA tensors, for the three model families x SMJ/BHJ x time/money at
    COST_GRID_POINTS over paper_cluster(100, 10) and scaled_cluster(1_000,
    100): each point bit-equal to the scalar cost (``_op_cost_at``), inf
    included, and to the same grid on CPU tensors.  Prints one line with
    the point count and the points that differ; fails if any does."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import paper_cluster, scaled_cluster
    from repro_torch.core.planning_backend import enumerate_configs
    from repro_torch.core.plans import OperatorCosting
    t0 = time.perf_counter()
    points = vs_scalar = vs_cpu = 0
    for cluster in (paper_cluster(100, 10), scaled_cluster(1_000, 100)):
        cpu = torch.as_tensor(enumerate_configs(cluster))
        card_cfgs = cpu.to(dev)
        rows = [tuple(r) for r in cpu.tolist()]
        for family in COST_GRID_FAMILIES:
            models = getattr(cm, family)()
            for impl in ("SMJ", "BHJ"):
                for ss, ls in COST_GRID_POINTS:
                    # ``_op_cost_at`` of both objectives from one scalar
                    # cost a configuration
                    times = [models[impl].cost(ss, cs, nc, ls=ls)
                             for nc, cs in rows]
                    scalar = {"time": times, "money": [
                        cm.monetary_cost(t, cs, nc) if math.isfinite(t)
                        else math.inf for t, (nc, cs) in zip(times, rows)]}
                    for objective in ("time", "money"):
                        costing = OperatorCosting(
                            models=models, cluster=cluster,
                            objective=objective, backend="torch")
                        g = costing._op_cost_grid(impl, ss, ls, card_cfgs)
                        check(g.dtype == torch.float64 and
                              g.device == card_cfgs.device,
                              f"cost_grid left the card: {g.dtype} "
                              f"{g.device}")
                        g = g.cpu()
                        want = torch.tensor(scalar[objective],
                                            dtype=torch.float64)
                        on_cpu = costing._op_cost_grid(impl, ss, ls, cpu)
                        points += len(rows)
                        vs_scalar += int((g != want).sum())
                        vs_cpu += int((g != on_cpu).sum())
    print(f"main cost_grid float64 on the card: {points} points (3 model "
          f"families x SMJ/BHJ x time/money x {len(COST_GRID_POINTS)} "
          f"(ss, ls) over 1,000 + 100,000 configurations), {vs_scalar} "
          f"differ from the scalar cost, {vs_cpu} from the CPU grid "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(vs_scalar == 0 and vs_cpu == 0,
          f"float64 cost_grid on the card differs from the scalar cost at "
          f"{vs_scalar} points and from the CPU grid at {vs_cpu}")


def plan_signature(jp):
    """Everything a plan decides: join order, operator impls, resources
    and the float64-committed costs."""
    ops = []

    def walk(n):
        if n.is_leaf:
            ops.append(tuple(sorted(n.tables)))
            return
        ops.append((n.impl, n.resources, n.op_cost, n.total_cost,
                    n.total_money))
        walk(n.left)
        walk(n.right)
    walk(jp.plan)
    return tuple(ops), jp.exec_time, jp.money


def allclose_err(got, want, tol: float):
    """(max |got - want|, whether |got - want| <= tol + tol * |want|
    everywhere), in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(got.isfinite().all()) and bool(
        (diff <= tol + tol * want.abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def model_kernel_parity(torch, dev):
    """Phase 6: each model kernel against its plain version on the card;
    returns {kernel: {dtype: max_abs_err}}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd = ATTN_HEADS
    err = {"flash_attention": {}, "selective_scan": {}}

    def note(kernel, dtype, e):
        err[kernel][dtype] = max(err[kernel].get(dtype, 0.0), e)

    cases = [(S, dt, {}) for S in (16, 100, 512)
             for dt in ("float32", "bfloat16")]
    cases += [(512, "bfloat16", dict(window=128, attn_softcap=30.0)),
              (100, "float32", dict(window=40, attn_softcap=50.0)),
              (512, "bfloat16", dict(causal=False)),
              (100, "float32", dict(causal=False))]
    cases = [(4, S, H, KV, hd, dt, o) for S, dt, o in cases]
    # the dense 67B's head dim (64 heads, 8 KV heads, hd 128), cut to 8:2
    cases += [(2, S, 8, 2, 128, "bfloat16", o) for S, o in (
        (200, {}), (300, dict(window=70, attn_softcap=20.0)),
        (130, dict(causal=False)))]
    # qwen3-moe-30b-a3b's heads: 32 query heads over 4 KV heads (group 8)
    cases += [(4, S, *QWEN_HEADS, dt, {}) for S in (100, 512)
              for dt in ("float32", "bfloat16")]
    # zamba2-2.7b's shared block: 32:32 heads at head dim 80 (bfloat16 on
    # the CUDA cores too: the tensor-core kernel takes hd 64 and 128)
    cases += [(4, S, *ZAMBA_HEADS, dt, {}) for S in (100, 512)
              for dt in ("float32", "bfloat16")]
    cases += [(4, 512, *ZAMBA_HEADS, "bfloat16",
               dict(window=128, attn_softcap=30.0))]
    # gemma2-9b's heads (16:8, hd 256: the CUDA-core kernel in both
    # dtypes), plain and as its local layers run (window and softcap);
    # mixtral-8x7b's (32:8, hd 128, bf16 on the tensor cores), windowed
    cases += [(4, S, *GEMMA_HEADS, dt, o) for S in (100, 512)
              for dt in ("float32", "bfloat16")
              for o in ({}, dict(window=128, attn_softcap=GEMMA_SOFTCAP))]
    cases += [(4, 512, *MIXTRAL_HEADS, "bfloat16", dict(window=128))]
    # llama-3.2-vision-11b's self blocks: the same 32:8 heads at hd 128,
    # unwindowed, at its serve prefill (4 x 256) and training batch (8 x 512)
    cases += [(B, S, *MIXTRAL_HEADS, "bfloat16", {})
              for B, S in (SERVE_ATTN, (TRAIN_BF16["batch"],
                                        TRAIN_BF16["seq"]))]
    # musicgen-medium's 24:24 heads at hd 64: group size 1 on the
    # tensor-core kernel
    cases += [(4, 512, *MUSICGEN_HEADS, "bfloat16", {})]
    for B, S, H, KV, hd, dt, opts in cases:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
        want = ref.attention_ref(q, k, v, **opts)
        got = fa.flash_attention(q, k, v, **opts)
        torch.cuda.synchronize()
        e, ok = allclose_err(got, want, ATTN_TOL[dt])
        check(ok and got.dtype == dtype and got.shape == q.shape,
              f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} {dt} "
              f"{opts}: max_abs_err {e} above {ATTN_TOL[dt]}")
        note("flash_attention", dt, e)
    # K8 at falcon-mamba-7b's width: B in {1, 4}, S across the 32-step
    # chunk edge, every N the kernel instantiates, with and without h0;
    # then narrower channels: 201 (a masked last block, 4-byte copies, and
    # bfloat16 upcast), 204 (4-byte copies) and 4096 (8 lanes a channel)
    shapes = [(B, SCAN_WIDTH[0], S) for B in (1, 4)
              for S in (1, 16, 31, 32, 33, 100, 512)]
    shapes += [(B, D, S) for B, D in ((2, 201), (2, 204), (1, 4096))
               for S in (1, 33, 100)]
    n_scan = 0
    lane_counts = set()
    for B, D, S in shapes:
        for N in ms.STATE_SIZES:
            lane_counts.add(ms.lanes(B, D, N))
            for dt in ("float32", "bfloat16"):
                for with_h0 in (False, True):
                    dtype = getattr(torch, dt)
                    u = torch.randn((B, S, D), generator=g,
                                    device=dev).to(dtype)
                    dtv = torch.nn.functional.softplus(torch.randn(
                        (B, S, D), generator=g, device=dev) - 1)
                    A = -torch.exp(torch.randn((D, N), generator=g,
                                               device=dev) * 0.3)
                    Bm = torch.randn((B, S, N), generator=g,
                                     device=dev).to(dtype)
                    Cm = torch.randn((B, S, N), generator=g,
                                     device=dev).to(dtype)
                    h0 = torch.randn((B, D, N), generator=g,
                                     device=dev) if with_h0 else None
                    y, h = ms.selective_scan(u, dtv, A, Bm, Cm, h0)
                    yr, hr = ref.selective_scan_ref(u, dtv, A, Bm, Cm,
                                                    h0)
                    torch.cuda.synchronize()
                    ey, oky = allclose_err(y, yr, SCAN_TOL)
                    eh, okh = allclose_err(h, hr, SCAN_TOL)
                    check(oky and okh,
                          f"selective_scan B={B} S={S} D={D} N={N} {dt} "
                          f"h0={with_h0}: max_abs_err y {ey} h {eh} "
                          f"above {SCAN_TOL}")
                    note("selective_scan", dt, max(ey, eh))
                    n_scan += 1
    check(lane_counts == set(ms.LANES),
          f"selective_scan ran at lane counts {lane_counts}, not {ms.LANES}")
    print(f"model parity: {len(cases)} flash_attention and {n_scan} "
          f"selective_scan cases within tolerance (lanes a channel "
          f"{sorted(lane_counts)}); max_abs_err {err}", flush=True)
    positions_parity(torch, dev, g, note)
    return err


# phase 6's K7 with positions: (H, KV, hd, dtype) on each kernel (the
# tensor cores: bf16 at hd 64 and 128; the CUDA cores: float32 and bf16
# at hd 80 and 256), B=4, S=300 (ragged tiles); the rows' positions
POSITION_HEADS = [(*ATTN_HEADS, "bfloat16"), (*QWEN_HEADS, "bfloat16")] + [
    (*h, dt) for h in (ZAMBA_HEADS, GEMMA_HEADS)
    for dt in ("float32", "bfloat16")]
POSITION_S = 300


def positions_parity(torch, dev, g, note) -> None:
    """Phase 6's K7 masking by positions against its plain version on both
    kernels (POSITION_HEADS): left-padded rows (one of them all pads: a
    row with no valid key averages V), offset positions (P + arange), and
    left pads under a window of 100 with softcap 30, within ATTN_TOL; then
    positions arange(S), plain and windowed with softcap, bit-equal to the
    index path (the extra tiles add p = 0 exactly).  K8 at the Mamba1
    hybrid's width (D = 5120, N = 64) against its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    S = POSITION_S
    pads = left_padded((S, 236, 130, 0), S)
    offset = left_padded((S,) * 4, S) + np.array([[0], [5], [64], [1000]])
    cases = [("left-padded", pads, {}), ("offset", offset, {}),
             ("left-padded, window 100, softcap 30", pads,
              dict(window=100, attn_softcap=30.0))]
    n = 0
    for H, KV, hd, dt in POSITION_HEADS:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((4, S, m, hd), generator=g, device=dev)
                   .to(dtype) for m in (H, KV, KV))
        for name, pos, opts in cases:
            p = torch.as_tensor(pos, device=dev)
            kw = dict(opts, q_positions=p, kv_positions=p)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            e, ok = allclose_err(got, want, ATTN_TOL[dt])
            check(ok, f"flash_attention by positions ({name}) H={H} KV={KV} "
                  f"hd={hd} {dt}: max_abs_err {e} above {ATTN_TOL[dt]}")
            note("flash_attention", dt, e)
            n += 1
        ar = torch.arange(S, device=dev).expand(4, S).contiguous()
        for opts in ({}, dict(window=100, attn_softcap=30.0)):
            same = torch.equal(
                fa.flash_attention(q, k, v, q_positions=ar, kv_positions=ar,
                                   **opts),
                fa.flash_attention(q, k, v, **opts))
            check(same, f"flash_attention H={H} KV={KV} hd={hd} {dt} "
                  f"{opts}: positions arange(S) differ from the index path")
            n += 1
        del q, k, v
    D, N = MAMBA1_WIDTH
    for B, Sx in ((1, 33), (4, 256)):
        for dt in ("float32", "bfloat16"):
            for with_h0 in (False, True):
                dtype = getattr(torch, dt)
                u = torch.randn((B, Sx, D), generator=g, device=dev).to(dtype)
                dtv = torch.nn.functional.softplus(torch.randn(
                    (B, Sx, D), generator=g, device=dev) - 1)
                A = -torch.exp(torch.randn((D, N), generator=g,
                                           device=dev) * 0.3)
                Bm, Cm = (torch.randn((B, Sx, N), generator=g, device=dev)
                          .to(dtype) for _ in range(2))
                h0 = torch.randn((B, D, N), generator=g, device=dev) \
                    if with_h0 else None
                y, h = ms.selective_scan(u, dtv, A, Bm, Cm, h0)
                yr, hr = ref.selective_scan_ref(u, dtv, A, Bm, Cm, h0)
                torch.cuda.synchronize()
                ey, oky = allclose_err(y, yr, SCAN_TOL)
                eh, okh = allclose_err(h, hr, SCAN_TOL)
                check(oky and okh, f"selective_scan B={B} S={Sx} D={D} "
                      f"N={N} {dt} h0={with_h0}: max_abs_err y {ey} h {eh}")
                note("selective_scan", dt, max(ey, eh))
                n += 1
    print(f"model parity by positions: {n} cases (K7 on both kernels "
          f"against plain within tolerance, positions arange bit-equal to "
          f"the index path; K8 at D={D}, N={N} within {SCAN_TOL})",
          flush=True)


def print_op_table(torch, label: str, fn, top: int = 20) -> None:
    """One torch.profiler trace (host and card, with input shapes) of one
    call of ``fn``, just warmed: the card's busy time and the operators
    (aten operators by input shapes; kernels launched outside aten by
    name) that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    events = prof.key_averages(group_by_input_shape=True)
    # the card's time is its kernels' (and copies'); an aten operator's
    # self device time is the kernels it launched itself, so the table
    # holds operators and the kernels launched outside aten (K7, K8)
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and
               e.key != "Command Buffer Full") / 1e3
    own = tuple(model_kernels())
    rows = [(e.key, e.input_shapes, e.self_device_time_total / 1e3, e.count)
            for e in events if e.self_device_time_total > 0 and (
                e.key.startswith("aten::") or
                (e.device_type == DeviceType.CUDA and
                 any(k in e.key for k in own)))]
    rows.sort(key=lambda r: -r[2])
    print(f"ops {label}: {busy:.3f} ms of device kernels; top by device "
          f"time: " + "; ".join(f"{k[:60]} {shapes} {ms:.3f} ms x{c}"
                                for k, shapes, ms, c in rows[:top]),
          flush=True)


def serve_ops(torch, cfg) -> None:
    """Where a serve main path spends the card's time (the moe and hybrid
    models'): one prefill wave of SERVE's slots x prompt, then one decode
    step, each traced by operator (``print_op_table``)."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=SERVE["seed"])
    B, P = SERVE["slots"], SERVE["prompt_len"]
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (B, P))
    prefill = make_prefill_step(model, cache_len=P + SERVE["max_new"])
    decode = make_decode_step(model)
    _, cache = prefill({"tokens": toks})
    print_op_table(torch, f"serve {cfg.name} {cfg.dtype}, one prefill wave "
                   f"{B} x {P}", lambda: prefill({"tokens": toks}))
    print_op_table(torch, f"serve {cfg.name} {cfg.dtype}, one decode step "
                   f"B={B}", lambda: decode(cache, {"tokens": toks[:, :1]},
                                            np.full(B, P)))
    print(f"ops {cfg.name}: {time.perf_counter() - t:.1f} s", flush=True)
    del model, cache, prefill, decode
    gc.collect()
    torch.cuda.empty_cache()


def serve_path_ms(torch, cfg, kernel: str, launches: int):
    """The device time of ``kernel``'s launches in one more run of serve's
    main path: (ms, how it was read).  Serving launches the model kernels
    in its prefill waves only (decode attention and the decode scan step
    are plain torch), so torch.profiler traces each prefill wave and
    nothing else (a trace of a whole run holds ~1e5 decode kernels and
    takes minutes to read), and the run stops each request at
    ``PATH_NEW`` tokens: the same prefill waves of the same prompts, with
    one decode step after each wave instead of the main path's 31.  Where
    the traces hold another count of its launches (the profiler can drop
    events), CUDA events around the wrapper's calls on one more run time
    it (an upper bound)."""
    import repro_torch.launch.serve as ls
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if launches == 0:
        return 0.0, "no launches"
    make = ls.make_prefill_step
    got = [0.0, 0]

    def traced(model, cache_len=None):
        step = make(model, cache_len)

        def run(batch):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(batch)
                torch.cuda.synchronize()
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and \
                        kernel + "_" in e.name:
                    got[0] += e.device_time_total / 1e3
                    got[1] += 1
            return out
        return run

    ls.make_prefill_step = traced
    try:
        ls.serve(cfg, **dict(SERVE, max_new=PATH_NEW))
    finally:
        ls.make_prefill_step = make
    if got[1] == launches and got[0]:
        return got[0], "torch.profiler over the prefill waves"
    module = model_kernels()[kernel]
    timed = _Timed(torch, getattr(module, kernel))
    setattr(module, kernel, timed)
    try:
        ls.serve(cfg, **dict(SERVE, max_new=PATH_NEW))
        torch.cuda.synchronize()
    finally:
        setattr(module, kernel, timed.fn)
    return (sum(a.elapsed_time(b) for a, b in timed.events),
            f"CUDA events around the wrapper's calls (the profiler held "
            f"{got[1]} of {launches} launches)")


class RouterLog:
    """Stands in for ``repro_torch.models.moe.route`` while a run lasts:
    records every call's top-k expert ids and each token's gap between
    its k-th and (k+1)-th probability; given another run's ids
    (``replay``), routes by them instead, with gates from this run's own
    probabilities renormalised as ``route`` does."""

    def __init__(self, torch, replay=None):
        from repro_torch.models import moe
        self.torch, self.moe, self.fn = torch, moe, moe.route
        self.replay, self.ids, self.gaps = replay, [], []

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.fn

    def __call__(self, logits, k):
        torch = self.torch
        probs, gates, ids = self.fn(logits, k)
        if self.replay is not None:
            ids = self.replay[len(self.ids)].to(ids.device)
            gates = probs.gather(-1, ids)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        top = torch.topk(probs, k + 1, dim=-1).values
        self.ids.append(ids.cpu())
        self.gaps.append((top[..., k - 1] - top[..., k]).cpu())
        return probs, gates, ids


def router_diff(a: RouterLog, b: RouterLog):
    """(decisions whose top-k sets differ between the two runs, decisions,
    the smallest k-th to (k+1)-th gap in run a, run a's gaps at the
    decisions that differ)."""
    check(len(a.ids) == len(b.ids), f"the runs routed {len(a.ids)} and "
          f"{len(b.ids)} times")
    diff = n = 0
    flips = []
    for ia, ib, ga in zip(a.ids, b.ids, a.gaps):
        d = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        n += d.numel()
        diff += int(d.sum())
        flips += ga[d].tolist()
    return diff, n, min(float(g.min()) for g in a.gaps), flips


def _cache_leaves(cache):
    """{name: (shape, the leaf on the host for slot positions else None)}."""
    return {n: (tuple(v.shape), v.cpu() if n.startswith("slot_pos")
                else None) for n, v in cache.items()}


class WindowCaches:
    """Stands in for serve's prefill and decode step makers while a run
    lasts: keeps every cache leaf's shape and the slot positions of the
    first prefill wave's cache and of the live cache after the last
    decode step (``_cache_leaves``)."""

    def __init__(self):
        import repro_torch.launch.serve as ls
        self.ls, self.kept = ls, {}

    def __enter__(self):
        ls, kept = self.ls, self.kept
        self.saved = make_p, make_d = ls.make_prefill_step, \
            ls.make_decode_step

        def prefill(model, cache_len=None):
            step = make_p(model, cache_len)

            def run(batch):
                logits, cache = step(batch)
                kept.setdefault("prefill", _cache_leaves(cache))
                return logits, cache
            return run

        def decode(model):
            step = make_d(model)

            def run(cache, inputs, q_pos):
                logits, cache = step(cache, inputs, q_pos)
                kept["decode"] = cache
                return logits, cache
            return run

        ls.make_prefill_step, ls.make_decode_step = prefill, decode
        return kept

    def __exit__(self, *exc):
        self.ls.make_prefill_step, self.ls.make_decode_step = self.saved
        if "decode" in self.kept:
            self.kept["decode"] = _cache_leaves(self.kept["decode"])


def rolled(first: int, last: int, W: int, torch):
    """The slot positions of a rolling cache of W slots that has been
    written positions 0..last and holds first..last (last - first + 1 ==
    W): slot s holds the one position p in that range with p % W == s."""
    pos = torch.arange(first, last + 1)
    out = torch.empty(W, dtype=torch.int64)
    out[pos % W] = pos
    return out


def window_serve(torch, cfg):
    """Phase 7's window run of a windowed model (swa, local_global) at
    WINDOW_LAYERS' depth: WINDOW_SERVE's prompts, longer than the window
    W, float32 through the kernels and plain; tokens equal, first-wave
    logits within LOGIT_TOL, and each run's caches as the schedule
    builds them: every local layer's rolling cache exactly W slots, after
    prefill holding the prompt's last W positions and after the last
    decode step the last W written (slot = position % W); local_global's
    global layers hold every position written."""
    from repro_torch.launch.serve import serve
    run = WINDOW_SERVE
    W, P, n, slots = cfg.window, run["prompt_len"], run["max_new"], \
        run["slots"]
    f32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=WINDOW_LAYERS[cfg.name])
    check(W < P < 2 * W and P + n < 2 * W, f"{cfg.name}: the window run's "
          f"positions 0..{P + n} must pass one window of {W} and not two")
    t = time.perf_counter()
    local = "_local" if cfg.attention == "local_global" else ""
    n_local = f32.n_layers // 2 if local else f32.n_layers
    out = {}
    for impl in ("cuda", "ref"):
        with WindowCaches() as kept:
            res = serve(f32, impl=impl, **run)
        last = P + n - 2                       # the last decode step's
        for when, hi in (("prefill", P - 1), ("decode", last)):
            shape, sp = kept[when]["slot_pos" + local]
            check(shape == (n_local, slots, W) and
                  kept[when]["k" + local][0][:3] == (n_local, slots, W),
                  f"{cfg.name} {impl}: the rolling cache after {when} is "
                  f"{shape}, not {(n_local, slots, W)}")
            want = rolled(hi + 1 - W, hi, W, torch)
            check(bool((sp == want).all()), f"{cfg.name} {impl}: the "
                  f"rolling cache after {when} does not hold positions "
                  f"{hi + 1 - W}..{hi} at position % {W}")
            if local:
                shape, sp = kept[when]["slot_pos"]
                full = torch.full((P + n,), -1, dtype=torch.int64)
                full[:hi + 1] = torch.arange(hi + 1)
                check(shape == (n_local, slots, P + n) and
                      bool((sp == full).all()),
                      f"{cfg.name} {impl}: the global cache after {when} "
                      f"is {shape} or misses positions")
        out[impl] = res
    got, plain = out["cuda"], out["ref"]
    logits = got["first_logits"]
    check(logits.shape == (slots, cfg.vocab_size) and
          bool(logits.isfinite().all()),
          f"{cfg.name} window run: first-wave logits "
          f"{tuple(logits.shape)} not finite or misshapen")
    e = float((logits - plain["first_logits"]).abs().max())
    check(e <= LOGIT_TOL, f"{cfg.name} window run: float32 prefill logits "
          f"differ from the plain version's by {e} > {LOGIT_TOL}")
    check(got["tokens"] == plain["tokens"] and
          len(got["tokens"]) == run["requests"] and
          all(len(v) == n for v in got["tokens"].values()),
          f"{cfg.name} window run: float32 tokens differ from plain's")
    print(f"serve {cfg.name} float32 window run ({f32.n_layers} layers, "
          f"window {W}, {run['requests']} prompts of {P} on {slots} slots, "
          f"{n} new): tokens equal to plain; first-wave logits max_abs_err "
          f"{e}; rolling caches {n_local} x {W} slots holding positions "
          f"{P - W}..{P - 1} after prefill and {P + n - 1 - W}..{P + n - 2} "
          f"after decode in slot position % {W}"
          + (", global caches every position" if local else "") +
          f"; kernels {got['tok_s']:.2f} tok/s, plain "
          f"{plain['tok_s']:.2f} tok/s ({time.perf_counter() - t:.1f} s)",
          flush=True)
    del out, got, plain
    gc.collect()
    torch.cuda.empty_cache()


def padded_batch(cfg, lengths, S: Optional[int] = None, seed: int = 30):
    """Seeded prompts of ``lengths`` tokens, each left-padded to ``S``
    (the longest by default): {"tokens" (B, S), "positions" (B, S), -1 on
    the pads}."""
    S = S or max(lengths)
    toks = np.random.default_rng(seed).integers(2, cfg.vocab_size,
                                                (len(lengths), S))
    pos = left_padded(lengths, S)
    return {"tokens": np.where(pos < 0, 0, toks), "positions": pos}


def greedy(torch, model, batch, cache_len: int, new: int):
    """``model.prefill`` of ``batch``, then ``new`` greedy decode steps
    from each row's next position: ([prefill and each step's logits,
    float32 on the card], [the tokens fed], the model kernels' launches in
    the prefill, seconds to the last step's argmax)."""
    from repro_torch.kernels import ops
    B, S = batch["tokens"].shape
    dev = model.device
    q0 = torch.as_tensor(batch["positions"][:, -1] + 1, device=dev) \
        if "positions" in batch else torch.full((B,), S, device=dev)
    with torch.no_grad():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        logits, cache = model.prefill(batch, cache_len)
        launches = launch_counts()
        out, toks = [logits.float()], []
        for t in range(new):
            toks.append(out[-1].argmax(-1))
            logits, cache = model.decode_step(
                cache, {"tokens": toks[-1][:, None]}, q0 + t)
            out.append(logits.float())
        out[-1].argmax(-1).cpu()
    return out, toks, launches, time.perf_counter() - t0, cache


def padded_serve(torch, device: str = "cuda") -> dict:
    """Phase 7's batch with its own positions: smollm-360m at full width
    and depth, PADDED_PROMPTS left-padded to the longest (K7 masks by the
    positions, each row decodes from its own next position), PADDED_NEW
    greedy steps: in its own bfloat16 through the kernels (tok/s, K7 once
    a layer in the prefill), then in float32 through the kernels against
    impl="ref" (tokens equal, every logits within LOGIT_TOL) and each row
    against itself prefilled alone, unpadded (tokens equal, logits within
    ALONE_TOL).  Returns {"launches", "tok_s"} of the bf16 run
    (``device="cpu"``: a rehearsal with the plain versions)."""
    from repro_torch.models.model import build_model
    cfg = model_config("smollm-360m")
    batch = padded_batch(cfg, PADDED_PROMPTS)
    S, new = max(PADDED_PROMPTS), PADDED_NEW
    cuda = device == "cuda"
    model = build_model(cfg, device=device, seed=0)
    greedy(torch, model, batch, S + new, new)            # warm
    _, toks, launches, secs, _ = greedy(torch, model, batch, S + new, new)
    tok_s = len(PADDED_PROMPTS) * new / secs
    check(launches == {"flash_attention": cfg.n_layers * cuda,
                       "selective_scan": 0},
          f"padded smollm: prefill launches {launches}")
    del model
    f32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    for impl in ("cuda", "ref"):
        model = build_model(f32, device=device, seed=0, impl=impl)
        runs[impl] = greedy(torch, model, batch, S + new, new)[:2]
        if impl == "cuda":
            alone = []
            for b, n in enumerate(PADDED_PROMPTS):
                one = {"tokens": batch["tokens"][b:b + 1, S - n:]}
                alone.append(greedy(torch, model, one, S + new, new)[:2])
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    (got, gtok), (want, wtok) = runs["cuda"], runs["ref"]
    e = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(gtok, wtok)) and
          e <= LOGIT_TOL, f"padded smollm float32: kernels against plain: "
          f"tokens equal {[torch.equal(a, b) for a, b in zip(gtok, wtok)]},"
          f" logits max |diff| {e} (tol {LOGIT_TOL})")
    ea = 0.0
    for b, (logits, toks) in enumerate(alone):
        ea = max(ea, max(float((a[b] - c[0]).abs().max())
                         for a, c in zip(got, logits)))
        check(all(int(a[b]) == int(c[0]) for a, c in zip(gtok, toks)),
              f"padded smollm float32: row {b} ({PADDED_PROMPTS[b]} "
              f"tokens) decodes other tokens than alone")
    check(ea <= ALONE_TOL, f"padded smollm float32: a row's logits differ "
          f"from the row alone by {ea} > {ALONE_TOL}")
    print(f"serve smollm-360m left-padded prompts {list(PADDED_PROMPTS)} to "
          f"{S}, {new} greedy steps: bf16 kernels {tok_s:.2f} tok/s "
          f"(prefill and decode, {secs:.3f} s), prefill launches "
          f"{launches}; float32 kernels against plain: tokens equal, "
          f"logits max |diff| {e} (tol {LOGIT_TOL}); each row against "
          f"itself alone, unpadded: tokens equal, logits max |diff| {ea} "
          f"(tol {ALONE_TOL})", flush=True)
    return {"launches": launches["flash_attention"], "tok_s": tok_s}


def padded_gemma(torch, device: str = "cuda") -> None:
    """gemma2-9b at one (local, global) pair, float32: one prompt of
    PADDED_GEMMA[0] positions whose first PADDED_GEMMA[1] are pads (K7 at
    hd 256 with its window and softcap, masking by the positions), then
    PADDED_GEMMA[2] greedy steps, kernels against impl="ref": tokens
    equal, logits within LOGIT_TOL; after the steps the rolling local
    cache and the global cache hold each valid position at its slot and
    no pad (a pad's write lands on slot 0 or W - 1 beside a valid one).
    ``device="cpu"``: a rehearsal with the plain versions."""
    from repro_torch.models.model import build_model
    S, pads, new = PADDED_GEMMA
    cfg = dataclasses.replace(model_config(LOCAL_GLOBAL), dtype="float32",
                              n_layers=2)
    batch = padded_batch(cfg, [S - pads], S)
    runs = {}
    for impl in ("cuda", "ref"):
        model = build_model(cfg, device=device, seed=0, impl=impl)
        *runs[impl], cache = greedy(torch, model, batch, S + new, new)
        # after the decode steps: each valid position, the prompt's and
        # the steps', at its slot (a rolling cache's last W of them)
        W, valid = cfg.window, S - pads + new
        for sfx, size in (("_local", W), ("", S + new)):
            sp = cache["slot_pos" + sfx][:, 0].cpu()
            want = torch.full((sp.shape[0], size), -1, dtype=sp.dtype)
            last = torch.arange(max(0, valid - W) if sfx else 0, valid)
            want[:, last % size] = last
            check(torch.equal(sp, want), f"padded gemma2 {impl}: the "
                  f"cache{sfx} does not hold each valid position at its "
                  f"slot")
        del model, cache
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    (got, gtok, launches, _), (want, wtok, _, _) = runs["cuda"], runs["ref"]
    e = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(launches["flash_attention"] == 2 * (device == "cuda") and
          e <= LOGIT_TOL and
          all(torch.equal(a, b) for a, b in zip(gtok, wtok)),
          f"padded gemma2: launches {launches}, logits max |diff| {e}, "
          f"tokens {[int(t) for t in gtok]} vs {[int(t) for t in wtok]}")
    print(f"serve gemma2-9b float32 (one pair) prompt of {S} with {pads} "
          f"leading pads (window {cfg.window}, softcap {cfg.attn_softcap}), "
          f"{new} greedy steps: kernels against plain tokens equal, logits "
          f"max |diff| {e} (tol {LOGIT_TOL}); prefill launches {launches}; "
          f"caches hold the {S - pads + new} valid positions at their "
          f"slots",
          flush=True)


def serve_phase(torch):
    """Phase 7: each model of SERVE_MODELS, float32 kernels against
    float32 plain (qwen3-moe-30b-a3b at 8 of its 48 layers, with its
    router decisions compared, mixtral-8x7b at 4 of its 32), the windowed
    models' window runs (``window_serve``), then the config's own
    bfloat16 through the kernels (the main path: full depth but for
    mixtral's 24 of 32 layers); returns {arch: (result, launches, device
    ms of its kernel on the path, how it was read)}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    out = {}
    w = time.perf_counter()
    for arch, (kernel, f32_layers, param_dtype, main_layers) in \
            SERVE_MODELS.items():
        cfg = model_config(arch)
        f32 = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=f32_layers or cfg.n_layers)
        t = time.perf_counter()
        with RouterLog(torch) as routed:
            got = serve(f32, **SERVE)
        with RouterLog(torch) as routed_plain:
            plain = serve(f32, impl="ref", **SERVE)
        note = ""
        if cfg.is_moe:
            diff, n, gap, flips = router_diff(routed, routed_plain)
            note = (f"; router decisions (top-{cfg.top_k} sets) differing "
                    f"from plain {diff} of {n}, smallest k-th to (k+1)-th "
                    f"probability gap {gap:.4g}")
            if diff:
                # near-ties that K7's rounding flipped: plain takes the
                # kernels' decisions (its own probabilities for the gates)
                # and must then give the same tokens
                check(max(flips) <= FLIP_GAP,
                      f"{arch}: router decisions differ from plain beyond a "
                      f"near-tie, gaps {sorted(flips)[-5:]} > {FLIP_GAP}")
                with RouterLog(torch, replay=routed.ids):
                    plain = serve(f32, impl="ref", **SERVE)
                note += (f" (gaps there {sorted(flips)}, each <= "
                         f"{FLIP_GAP}; plain rerun with the kernels' "
                         f"decisions)")
        logits, plogits = got["first_logits"], plain["first_logits"]
        check(logits.shape == (SERVE["slots"], cfg.vocab_size) and
              bool(logits.isfinite().all()),
              f"{arch}: first-wave logits {tuple(logits.shape)} not finite "
              f"or misshapen")
        e = float((logits - plogits).abs().max())
        check(e <= LOGIT_TOL, f"{arch}: float32 prefill logits differ from "
              f"the plain version's by {e} > {LOGIT_TOL}")
        check(got["tokens"] == plain["tokens"] and
              len(got["tokens"]) == SERVE["requests"] and
              all(len(v) == SERVE["max_new"] for v in got["tokens"].values()),
              f"{arch}: float32 tokens differ from the plain version's")
        print(f"serve {arch} float32 ({f32.n_layers} layers): "
              f"{got['served']} requests, tokens equal to plain "
              f"(impl='ref'); first-wave logits max_abs_err {e}; kernels "
              f"{got['tok_s']:.2f} tok/s, plain {plain['tok_s']:.2f} tok/s "
              f"({time.perf_counter() - t:.1f} s){note}", flush=True)
        del got, plain, routed, routed_plain
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.attention != "full":
            window_serve(torch, cfg)
        main = dataclasses.replace(cfg,
                                   param_dtype=param_dtype or cfg.param_dtype,
                                   n_layers=main_layers or cfg.n_layers)
        t = time.perf_counter()
        ops.reset_launch_counts()
        run = serve(main, **SERVE)
        launches = launch_counts()
        check(run["served"] == SERVE["requests"] and
              bool(run["first_logits"].isfinite().all()),
              f"{arch}: {cfg.dtype} serve did not finish all requests")
        # prefill attention once a layer a wave (the hybrid's shared
        # block once a group a wave), the Mamba1 scan once a block a wave;
        # decode attention and the decode scan step are plain torch
        want = {k: n // TRAIN_F32_STEPS * run["prefill_waves"]
                for k, n in _expected_launches(main).items()}
        check(launches == want, f"{arch}: launches {launches} on the main "
              f"path, not {want}")
        print(f"serve {arch} {cfg.dtype}, {main.param_dtype} parameters, "
              f"{main.n_layers} layers (main path): {run['served']} "
              f"requests, {run['steps']} decode steps, {run['tok_s']:.2f} "
              f"tok/s, {run['seconds']:.3f} s; prefill {run['prefill_waves']}"
              f" waves {run['prefill_s']:.3f} s; decode "
              f"{run['decode_s'] / run['steps'] * 1e3:.3f} ms/step; "
              f"launches {launches}; first tokens "
              f"{[run['tokens'][r][:4] for r in sorted(run['tokens'])][:2]}"
              f" ({time.perf_counter() - t:.1f} s with the model's build)",
              flush=True)
        t = time.perf_counter()
        dev_ms, how = serve_path_ms(torch, main, kernel, launches[kernel])
        print(f"serve {arch} {cfg.dtype}: {kernel} device time on the path "
              f"{dev_ms} ms over {launches[kernel]} launches ({how}; "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
        out[arch] = (run, launches, dev_ms, how)
        gc.collect()
        torch.cuda.empty_cache()
        if arch in TRACED:
            serve_ops(torch, main)
        w = lap(f"serve {arch}", w)
    check(all(v[1][SERVE_MODELS[a][0]] > 0 for a, v in out.items()),
          f"a model kernel never launched on its main path: "
          f"{ {a: v[1] for a, v in out.items()} }")
    return out


def media_inputs(cfg):
    """MEDIA_SERVE's traffic for ``cfg`` from a seeded numpy generator: the
    prefill batch (the vlm's prompts of random tokens and its media, (B,
    n_media_tokens, media_embed_dim); musicgen's frame embeddings) and
    musicgen's decode frames (B, max_new, media_embed_dim), None for the
    vlm (its decode feeds its greedy tokens)."""
    run = MEDIA_SERVE
    B, P, n = run["requests"], run["prompt_len"], run["max_new"]
    rng = np.random.default_rng(run["seed"])
    if cfg.family == "vlm":
        return {"tokens": rng.integers(2, cfg.vocab_size, (B, P)),
                "media": rng.standard_normal(
                    (B, cfg.n_media_tokens, cfg.media_embed_dim),
                    dtype=np.float32)}, None
    emb = rng.standard_normal((B, P + n, cfg.media_embed_dim),
                              dtype=np.float32)
    return {"embeddings": emb[:, :P]}, emb[:, P:]


def media_serve(torch, cfg, impl: str = "cuda"):
    """One serving wave of ``cfg`` through the Model API on the card
    (``make_prefill_step``, then MEDIA_SERVE["max_new"] greedy
    ``make_decode_step`` steps), the vlm's gates opened: {"first_logits"
    (B, V) float32 on the host, "tokens": each step's argmax (B,) on the
    host (the prefill's first), "prefill_s", "decode_s" (host clock, each
    ending in the argmax's copy to the host), "model", "batch"}."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    run = MEDIA_SERVE
    B, P, n = run["requests"], run["prompt_len"], run["max_new"]
    batch, frames = media_inputs(cfg)
    model = open_gates(torch, build_model(cfg, device="cuda",
                                          seed=run["seed"], impl=impl))
    prefill = make_prefill_step(model, cache_len=P + n)
    decode = make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    first = logits.float().cpu()
    t1 = time.perf_counter()
    tokens = [first.argmax(-1)]
    for t in range(n):
        step = {"tokens": tokens[-1][:, None].numpy()} if frames is None \
            else {"embeddings": frames[:, t:t + 1]}
        logits, cache = decode(cache, step, np.full(B, P + t))
        tokens.append(logits.argmax(-1).cpu())
    t2 = time.perf_counter()
    return {"first_logits": first, "tokens": tokens, "prefill_s": t1 - t0,
            "decode_s": t2 - t1, "model": model, "batch": batch,
            "prefill": prefill}


def prefill_trace(torch, prefill, batch):
    """One more prefill wave traced (torch.profiler, host and card) with
    ``models.attention.cross_attention`` wrapped in a ``record_function``
    range while it lasts: (K7's device ms, its launches, the cross
    attention's device ms or None where the range holds no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as attn
    plain = attn.cross_attention

    def ranged(*a, **kw):
        with record_function("cross_attention"):
            return plain(*a, **kw)
    attn.cross_attention = ranged
    try:
        prefill(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(batch)
            torch.cuda.synchronize()
    finally:
        attn.cross_attention = plain
    k7 = [e for e in prof.events() if e.device_type == DeviceType.CUDA and
          "flash_attention_" in e.name]
    cross = sum(e.device_time_total for e in prof.events()
                if e.name == "cross_attention" and
                e.device_type == DeviceType.CPU) / 1e3
    return sum(e.device_time_total for e in k7) / 1e3, len(k7), \
        cross or None


def media_serve_phase(torch):
    """Phase 7's vlm and audio models (their serving path is the Model
    API: the serving loop feeds tokens only): each at full depth in
    float32 through the kernels and with impl="ref" (the vlm's greedy
    tokens equal at every step, musicgen's argmax equal at every step,
    first logits within LOGIT_TOL), then the main path in the config's
    bfloat16 on float32 parameters (launch counts set to 0 just before,
    read just after; K7 once a self-attention layer; the vlm's logits
    must change when its media are zeroed), K7's and the cross
    attention's device time over one more prefill, and the prefill and
    a decode step by operator.  Returns {arch: (result, launches, device
    ms of K7 on the path, how it was read)}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_decode_step
    run = MEDIA_SERVE
    B, P, n = run["requests"], run["prompt_len"], run["max_new"]
    out = {}
    w = time.perf_counter()
    for arch in MEDIA_MODELS:
        cfg = get_config(arch)
        f32 = dataclasses.replace(cfg, dtype="float32")
        t = time.perf_counter()
        res = {}
        for impl in ("cuda", "ref"):
            r = media_serve(torch, f32, impl)
            res[impl] = {k: r[k] for k in ("first_logits", "tokens")}
            del r
            gc.collect()
            torch.cuda.empty_cache()
        got, plain = res["cuda"], res["ref"]
        logits = got["first_logits"]
        check(logits.shape == (B, cfg.vocab_size) and
              bool(logits.isfinite().all()),
              f"{arch}: prefill logits {tuple(logits.shape)} not finite or "
              f"misshapen")
        e = float((logits - plain["first_logits"]).abs().max())
        check(e <= LOGIT_TOL, f"{arch}: float32 prefill logits differ from "
              f"the plain version's by {e} > {LOGIT_TOL}")
        same = [bool(torch.equal(a, b))
                for a, b in zip(got["tokens"], plain["tokens"])]
        what = "greedy tokens" if cfg.family == "vlm" else "argmax"
        check(len(same) == n + 1 and all(same), f"{arch}: float32 {what} "
              f"differ from the plain version's at steps "
              f"{[i for i, x in enumerate(same) if not x]}")
        print(f"serve {arch} float32 ({cfg.n_layers} layers, Model API, "
              f"gates {GATE if cfg.family == 'vlm' else '-'}): {B} "
              f"requests, prefill then {n} decode steps; {what} equal to "
              f"plain (impl='ref') at all {n + 1}; prefill logits "
              f"max_abs_err {e} ({time.perf_counter() - t:.1f} s)",
              flush=True)
        del res, got, plain
        t = time.perf_counter()
        ops.reset_launch_counts()
        r = media_serve(torch, cfg)
        launches = launch_counts()
        model = r["model"]
        want = len(model.layers)
        check(launches["flash_attention"] == want, f"{arch}: "
              f"flash_attention launched {launches['flash_attention']} times "
              f"on the main path, not {want} (once a self-attention layer)")
        check(bool(r["first_logits"].isfinite().all()),
              f"{arch}: {cfg.dtype} prefill logits not finite")
        wall = r["prefill_s"] + r["decode_s"]
        r.update(tok_s=B * n / wall, seconds=wall)
        note = ""
        if cfg.family == "vlm":
            zeroed = dict(r["batch"], media=np.zeros_like(r["batch"][
                "media"]))
            with torch.no_grad():
                moved = float((r["prefill"](zeroed)[0].float().cpu() -
                               r["first_logits"]).abs().max())
            check(moved > 1e-3, f"{arch}: zeroed media moved the prefill "
                  f"logits by {moved} only: the cross path is dead")
            note = f"; zeroed media move the prefill logits by {moved:.4g}"
        print(f"serve {arch} {cfg.dtype}, {cfg.param_dtype} parameters, "
              f"{cfg.n_layers} layers (main path, Model API): {B} requests, "
              f"{n} decode steps, {r['tok_s']:.2f} tok/s ({B} x {n} / "
              f"{wall:.3f} s); prefill {r['prefill_s']:.3f} s; decode "
              f"{r['decode_s'] / n * 1e3:.3f} ms/step; launches {launches}; "
              f"first tokens {[int(x) for x in r['tokens'][0][:4]]}{note} "
              f"({time.perf_counter() - t:.1f} s with the model's build)",
              flush=True)
        t = time.perf_counter()
        dev_ms, k7_n, cross_ms = prefill_trace(torch, r["prefill"],
                                               r["batch"])
        r["cross_ms"] = cross_ms
        how = "torch.profiler over one more prefill wave"
        check(k7_n == want, f"{arch}: the prefill's trace holds {k7_n} "
              f"flash_attention launches, not {want}")
        cross = "no cross attention" if cfg.family != "vlm" else \
            f"cross attention {cross_ms} ms of device time over the wave" \
            if cross_ms is not None else "cross attention not read"
        print(f"serve {arch} {cfg.dtype}: flash_attention device time on "
              f"the path {dev_ms} ms over {k7_n} launches ({how}); {cross} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        if arch in TRACED:
            first = r["tokens"][0]
            step = {"tokens": first[:, None].numpy()} \
                if cfg.family == "vlm" else \
                {"embeddings": media_inputs(cfg)[1][:, :1]}
            _, cache = r["prefill"](r["batch"])
            decode = make_decode_step(model)
            print_op_table(torch, f"serve {arch} {cfg.dtype}, one prefill "
                           f"wave {B} x {P}",
                           lambda: r["prefill"](r["batch"]))
            print_op_table(torch, f"serve {arch} {cfg.dtype}, one decode "
                           f"step B={B}",
                           lambda: decode(cache, step, np.full(B, P)))
            del cache
        for k in ("model", "prefill", "batch"):
            del r[k]
        out[arch] = (r, launches, dev_ms, how)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        w = lap(f"serve {arch}", w)
    return out


def train_parity(torch, cfg, B, S, pads: int = 0):
    """Phase 13's float32 check: the model on the kernels (impl="cuda",
    the custom backwards) against impl="ref" (autograd through the plain
    versions), the same seeded parameters and one fixed batch: the loss
    (and a moe model's aux losses), every parameter's gradient (each
    nonzero) and the parameters after TRAIN_F32_STEPS AdamW steps (for
    a model in REPLAYED, after each step taken from the plain run's
    state: ``replayed_steps``).  With ``pads``, row 0 of the batch is
    left-padded by as many slots: the batch carries its own positions
    (K7 masks by them) and labels -1 there.  The kernels run's gradients
    and parameters wait on the host while the plain run takes the card,
    and are compared a tensor at a time."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import (init_train_state, make_loss_fn,
                                           make_train_step)
    kernel, plan = {**TRAIN, **TRAIN_CHECKS}[cfg.name][1], train_plan(cfg)
    f32 = dataclasses.replace(cfg, dtype="float32")
    batch = SyntheticPipeline(f32, B, S, seed=0).batch_at(0)
    if pads:
        # row 0 left-padded: its own positions, labels -1 on the pads
        pos = left_padded([S - pads] + [S] * (B - 1), S)
        labels = np.asarray(batch["labels"]).copy()
        labels[pos < 0] = -1
        batch = dict(batch, positions=pos, labels=labels)
    replayed = cfg.name in REPLAYED
    out = {}
    for impl in ("cuda", "ref"):
        keep = (lambda t: t.detach().cpu()) if impl == "cuda" else \
            (lambda t: t.detach())
        ops.reset_launch_counts()
        model = open_gates(torch, build_model(f32, plan, device="cuda",
                                              seed=0, impl=impl))
        loss, metrics = make_loss_fn(model)(batch)
        grads = [keep(g) for g in torch.autograd.grad(
            loss, list(model.parameters()))]
        launches = launch_counts()[kernel]
        params = None
        if not replayed:
            opt = AdamW(lr=TRAIN_LR)
            state = init_train_state(model, opt)
            step = make_train_step(model, opt)
            for _ in range(TRAIN_F32_STEPS):
                state, _ = step(state, batch)
            params = [keep(p) for p in model.parameters()]
            del state, step, opt
        aux = {k: float(metrics[k].detach()) for k in MOE_METRICS
               if k in metrics}
        out[impl] = (float(loss.detach()), aux, grads, params, launches)
        del model, loss, metrics
        gc.collect()
        torch.cuda.empty_cache()
    (loss, aux, grads, params, launches), \
        (ploss, paux, pgrads, pparams, plaunch) = out["cuda"], out["ref"]
    check(launches > 0 and plaunch == 0,
          f"{cfg.name} float32: {kernel} launched {launches} times on the "
          f"kernels, {plaunch} on the plain path")
    rel = abs(loss / ploss - 1)
    check(math.isfinite(loss) and rel <= LOSS_TOL,
          f"{cfg.name} float32: loss {loss} vs plain {ploss} (rel {rel})")
    for k in ("lb_loss", "z_loss"):
        if k in aux:
            check(abs(aux[k] / paux[k] - 1) <= LOSS_TOL,
                  f"{cfg.name} float32: {k} {aux[k]} vs plain {paux[k]}")
    zero, gerr = 0, 0.0
    for g, pg in zip(grads, pgrads):
        g = g.to(pg.device)
        zero += not bool((g != 0).any())
        gerr = max(gerr, float((g - pg).abs().max() / pg.abs().max()))
    check(zero == 0, f"{cfg.name} float32: {zero} parameters got an "
          f"all-zero gradient")
    check(gerr <= GRAD_TOL, f"{cfg.name} float32: gradient max |diff| / "
          f"max |g| {gerr} > {GRAD_TOL}")
    del out, grads, pgrads
    gc.collect()
    if replayed:
        share, pmax, n, losses = replayed_steps(torch, f32, plan, batch)
        limit = 2
    else:
        pmax, n, beyond = 0.0, 0, 0
        for p, pp in zip(params, pparams):
            d = (p.to(pp.device) - pp).abs()
            pmax = max(pmax, float(d.max()) / TRAIN_LR)
            n += d.numel()
            beyond += int((d > 0.02 * TRAIN_LR).sum())
        share, limit, losses = beyond / n, 2 * TRAIN_F32_STEPS, None
        del params, pparams
    how = (f" (each step from plain's state; losses kernels, plain "
           f"{losses})" if replayed else "")
    check(share <= PARAM_SHARE_TOL and pmax <= limit,
          f"{cfg.name} float32: after {TRAIN_F32_STEPS} steps{how} {share} "
          f"of the parameters differ by more than 2% of lr (max {pmax} lr)")
    print(f"train {cfg.name} float32 B={B} S={S}"
          f"{f', row 0 left-padded by {pads}' if pads else ''} "
          f"({cfg.n_layers} layers, "
          f"remat {plan.remat}, {n} parameters): loss {loss} vs plain "
          f"{ploss} (rel {rel:.3g}); every gradient nonzero; gradient max "
          f"|diff| / max |g| {gerr:.3g} (limit {GRAD_TOL}); after "
          f"{TRAIN_F32_STEPS} AdamW steps (lr {TRAIN_LR}) max |diff| "
          f"{pmax:.4g} lr, {share:.3g} of elements beyond 2% of lr{how}; "
          f"{kernel} launches {launches}" +
          (f"; aux {aux} vs plain {paux}" if aux else ""), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def replay_steps(torch, models, batch):
    """TRAIN_F32_STEPS AdamW steps (lr TRAIN_LR) of two models, the first
    taking the second's parameters and moments before each step, so each
    step's update is compared from one state: ([losses, grad norms, step
    seconds, launch counts] of each model, the largest share over the
    steps of elements more than 2% of lr apart, the largest difference in
    lr, elements).  Either may be distributed (a world of one: its local
    shards are the whole tensors)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import full, local
    runs = []
    for model in models:
        opt = AdamW(lr=TRAIN_LR)
        runs.append([init_train_state(model, opt), make_train_step(model, opt),
                     ([], [], [], dict.fromkeys(launch_counts(), 0))])
    share, pmax, n = 0.0, 0.0, 0
    for _ in range(TRAIN_F32_STEPS):
        for run in runs:
            ops.reset_launch_counts()
            t = time.perf_counter()
            run[0], m = run[1](run[0], batch)
            losses, norms, secs, launches = run[2]
            losses.append(float(m["loss"]))                 # syncs
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t)
            for k, v in launch_counts().items():
                launches[k] += v
        (follower, *_), (leader, *_) = runs
        n = beyond = 0
        with torch.no_grad():
            for k, p in leader.params.items():
                d = (full(follower.params[k]) - full(p)).abs()
                pmax = max(pmax, float(d.max()) / TRAIN_LR)
                n += d.numel()
                beyond += int((d > 0.02 * TRAIN_LR).sum())
                local(follower.params[k]).copy_(local(p))
                local(follower.opt_state.m[k]).copy_(
                    local(leader.opt_state.m[k]))
                local(follower.opt_state.v[k]).copy_(
                    local(leader.opt_state.v[k]))
        share = max(share, beyond / n)
        runs[0][0] = follower._replace(
            opt_state=follower.opt_state._replace(
                step=leader.opt_state.step.clone()), step=leader.step.clone())
    return [run[2] for run in runs], share, pmax, n


def replayed_steps(torch, f32, plan, batch):
    """Phase 13's ``replay_steps`` of the kernels model after the plain
    one: (share, max difference in lr, elements, [(kernels loss, plain
    loss)] a step).  Both models and their moments stay on the card."""
    from repro_torch.models.model import build_model
    models = [open_gates(torch, build_model(f32, plan, device="cuda",
                                            seed=0, impl=impl))
              for impl in ("cuda", "ref")]
    runs, share, pmax, n = replay_steps(torch, models, batch)
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return share, pmax, n, list(zip(runs[0][0], runs[1][0]))


def train_plan(cfg):
    """Phase 13's single-device plan for ``cfg``: TRAIN's remat."""
    from repro_torch.sharding import single_device_plan
    return single_device_plan().with_(
        remat={**TRAIN, **TRAIN_CHECKS}[cfg.name][2])


def train_timed(torch, cfg):
    """Phase 13's main path: TRAIN_BF16["steps"] steps of make_train_step
    in the config's bfloat16 (float32 masters) on SyntheticPipeline
    batches; the launch counts are set to 0 just before and read just
    after.  Returns the kernel's (device ms on one step, how it was read,
    launches a step)."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step
    kernel, plan = TRAIN[cfg.name][1], train_plan(cfg)
    B, S, n = TRAIN_BF16["batch"], TRAIN_BF16["seq"], TRAIN_BF16["steps"]
    model = open_gates(torch, build_model(cfg, plan, device="cuda", seed=0))
    opt = AdamW(lr=cosine_schedule(TRAIN_SCHEDULE[0], TRAIN_SCHEDULE[1], n))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    pipe = SyntheticPipeline(cfg, B, S, seed=0)
    batches = [pipe.batch_at(i) for i in range(n)]      # set-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    secs, losses = [], []
    for batch in batches:
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))                 # syncs
        secs.append(time.perf_counter() - t)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{cfg.name} bfloat16: losses {losses[0]} -> {losses[-1]} did not "
          f"fall")
    check(launches[kernel] > 0, f"{cfg.name} bfloat16: {kernel} never "
          f"launched on the training path: {launches}")
    med = statistics.median(secs[1:]) * 1e3
    # every token of steps 2..n over their summed time (the first is left
    # out, as from the median); the median's rate beside it
    tok_s = B * S * (n - 1) / sum(secs[1:])
    module = model_kernels()[kernel]
    per_step = launches[kernel] // n
    dev_ms, how = path_ms(torch, lambda: step(state, batches[0]), {
        kernel: ((kernel + "_",), per_step, (module, kernel))})[kernel]
    # the card's busy time on one more step (a trace of its activity
    # only) against the median step of the unprofiled run
    rows = kernel_times(torch, lambda: step(state, batches[0]), 1)
    busy = sum(ms for ms, _ in rows.values())
    top = sorted(rows.items(), key=lambda r: -r[1][0])[:6]
    print(f"train {cfg.name} {cfg.dtype} (main path) B={B} S={S}, "
          f"{cfg.n_layers} layers, remat {plan.remat}, {n} steps: step median "
          f"{med:.3f} ms (first {secs[0] * 1e3:.1f} ms), {tok_s:.1f} "
          f"tokens/s over steps 2-{n} ({B * S / (med / 1e3):.1f} at the "
          f"median), peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated), loss step 1 "
          f"{losses[0]:.4f} -> step {n} {losses[-1]:.4f}; launches "
          f"{launches}; {kernel} device time on one step {dev_ms} ms over "
          f"{per_step} launches ({how})", flush=True)
    print(f"train {cfg.name} {cfg.dtype}: one traced step {busy:.3f} ms of "
          f"device kernels against the {med:.3f} ms median step (idle "
          f"share {1 - busy / med:.3f}); top kernels by device time: " +
          "; ".join(f"{k[:70]} {ms:.3f} ms x{c}" for k, (ms, c) in top),
          flush=True)
    if cfg.is_moe:
        print(f"train {cfg.name} {cfg.dtype}: step {n} " + ", ".join(
            f"{k} {float(m[k]):.6g}" for k in MOE_METRICS), flush=True)
    if cfg.name in TRACED:
        print_op_table(torch, f"train {cfg.name} {cfg.dtype}, one step",
                       lambda: step(state, batches[0]))
    del model, state, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dev_ms, how, per_step


def background(env, cwd):
    """(state, run) for commands in the background: ``run(key, cmd)``
    runs ``cmd`` from ``cwd`` in ``env`` to its end (or a 600 s limit)
    and stores (its ``CompletedProcess``, its seconds) at ``state[key]``.
    A process still running when the script exits is killed, and none
    starts after that."""
    import atexit
    state = {"procs": [], "stopped": False}
    lock = threading.Lock()

    def run(key, cmd):
        t = time.perf_counter()
        with lock:                  # no process starts after stop()
            if state["stopped"]:
                return
            proc = subprocess.Popen(cmd, env=env, cwd=cwd,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            state["procs"].append(proc)
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        state[key] = (subprocess.CompletedProcess(proc.args, proc.returncode,
                                                  out, err),
                      time.perf_counter() - t)

    def stop():
        with lock:
            state["stopped"] = True
            for proc in state["procs"]:
                if proc.poll() is None:
                    proc.kill()
    atexit.register(stop)
    return state, run


def _one_gpu_env(root):
    """The environment of a subprocess on this process's first GPU, with
    the checkout's package on its path."""
    import os
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return dict(os.environ, PYTHONPATH=str(root / "src"),
                CUDA_VISIBLE_DEVICES=visible or "0", PYTHONUNBUFFERED="1")


def launcher_start():
    """Start phase 13's launcher runs in the background: ``python -m
    repro_torch.launch.train`` on one GPU, whole, and beside it (two
    processes on the card at once, each into its own checkpoint
    directory) crashed at LAUNCHER_FAIL_AT (exit 1) and then resumed from
    the checkpoint before it.  Returns their state for
    ``launcher_check``; a process still running when the script exits is
    killed."""
    import tempfile
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCHER]
    tmp = tempfile.TemporaryDirectory()
    state, run_cmd = background(_one_gpu_env(root), root)
    state["tmp"] = tmp

    def run(key, *extra):
        run_cmd(key, cmd + list(extra))

    def crash_then_resume():
        run("crash", "--ckpt-dir", f"{tmp.name}/crash", "--fail-at",
            str(LAUNCHER_FAIL_AT))
        if "crash" in state and state["crash"][0].returncode == 1:
            run("resumed", "--ckpt-dir", f"{tmp.name}/crash")

    state["threads"] = [
        threading.Thread(target=run, args=("whole", "--ckpt-dir",
                                           f"{tmp.name}/whole"), daemon=True),
        threading.Thread(target=crash_then_resume, daemon=True)]
    for th in state["threads"]:
        th.start()
    return state


def launcher_check(state):
    """Phase 13's launcher (``launcher_start``'s runs), joined: the whole
    run and the resumed one exit 0, the crashed one 1, and the two final
    losses agree."""
    for th in state["threads"]:
        th.join()
    state["tmp"].cleanup()
    for key in ("whole", "crash"):
        check(key in state, f"the trainer's {key} run did not finish")
    (whole, s1), (crash, s2) = state["whole"], state["crash"]
    resumed, s3 = state.get("resumed", (None, 0.0))

    def final(out):
        lines = [l for l in out.splitlines() if "done:" in l]
        check(bool(lines), f"the trainer printed no final line:\n{out}")
        return float(lines[-1].split("final loss")[-1])

    check(whole.returncode == 0, f"trainer exit {whole.returncode}:\n"
          f"{whole.stdout[-2000:]}{whole.stderr[-3000:]}")
    check(crash.returncode == 1 and "SIMULATED FAILURE" in crash.stdout,
          f"--fail-at: exit {crash.returncode}:\n{crash.stdout[-2000:]}"
          f"{crash.stderr[-3000:]}")
    every = int(LAUNCHER[LAUNCHER.index("--ckpt-every") + 1])
    start = LAUNCHER_FAIL_AT // every * every
    check(resumed.returncode == 0 and
          f"resumed from step {start}" in resumed.stdout,
          f"resume: exit {resumed.returncode}:\n{resumed.stdout[-2000:]}"
          f"{resumed.stderr[-3000:]}")
    a, b = final(whole.stdout), final(resumed.stdout)
    rel = abs(a / b - 1)
    check(rel <= LAUNCHER_LOSS_TOL, f"final loss whole {a} vs resumed {b}")
    print(f"train launcher ({' '.join(LAUNCHER)}, one GPU, beside phases 3 "
          f"and 6): whole run {s1:.1f} s final loss {a}; beside it "
          f"--fail-at {LAUNCHER_FAIL_AT} exit 1 ({s2:.1f} s); resumed from "
          f"step {start} ({s3:.1f} s) final loss "
          f"{b} (rel diff {rel:.3g}, limit {LAUNCHER_LOSS_TOL})", flush=True)


# phase 17: the port's examples (examples/port_*.py), each a subprocess
# on the card beside the build, phases 3 and 6 and the untimed checks
# (the elastic example alone takes ~60-80 s); the planning example and the
# quickstart run through EXAMPLE_RUNNER, which calls the example's main
# and writes the kernels' launch counters to a file
EXAMPLE_RUNNER = """import json, runpy, sys
path, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rc = runpy.run_path(path)["main"](argv)
from repro_torch.kernels import flash_attention as fa, plan_scan as ps
with open(out, "w") as f:
    json.dump({n: getattr(ps, n).launches for n in ("scan_argmin",
               "scan_argmin_sharded", "neighbor_step", "ensemble_climb")} |
              {"flash_attention": fa.flash_attention.launches}, f)
sys.exit(rc)
"""
# the CPU twin of the planning example's lines on the card: its domains on
# the CUDA backend's plain versions (CudaPlanBackend(device="cpu"))
EXAMPLE_PLAIN = """import runpy, sys
from repro_torch.kernels.plan_scan import CudaPlanBackend
mod = runpy.run_path(sys.argv[1])
backend = CudaPlanBackend(device="cpu")
mod["db_domain"](backend)
mod["tpu_domain"](backend)
"""
# the lines of port_raqo_plan.py that its float32 CUDA backend prints
# otherwise than its exact backend (--device cpu): Q3's root join takes
# another config of the same time in float32, as the reference's pallas
# backend does (tests/test_torch_examples.py)
EXAMPLE_FLOAT32_LINES = [3, 4, 5]


def examples_start():
    """Start phase 17 in the background: the four examples on the card,
    each in a process of its own (the planning and quickstart examples
    through EXAMPLE_RUNNER), beside them the planning example's twins on
    the host CPU (``--device cpu``, and its domains on the kernels' plain
    versions, EXAMPLE_PLAIN).  Returns their state for
    ``examples_check``; a process still running when the script exits is
    killed."""
    import tempfile
    root = Path(__file__).resolve().parent
    ex = root / "examples"
    tmp = tempfile.TemporaryDirectory()
    py = sys.executable
    runs = {
        "port_raqo_plan.py": [py, "-c", EXAMPLE_RUNNER,
                              str(ex / "port_raqo_plan.py"),
                              f"{tmp.name}/raqo.json", "--device", "cuda"],
        "port_raqo_plan.py --device cpu": [
            py, str(ex / "port_raqo_plan.py"), "--device", "cpu"],
        "port_raqo_plan.py on the plain versions": [
            py, "-c", EXAMPLE_PLAIN, str(ex / "port_raqo_plan.py")],
        "port_quickstart.py": [py, "-c", EXAMPLE_RUNNER,
                               str(ex / "port_quickstart.py"),
                               f"{tmp.name}/quickstart.json", "--device",
                               "cuda", "--ckpt-dir", f"{tmp.name}/qs"],
        "port_serve_batch.py": [py, str(ex / "port_serve_batch.py"),
                                "--device", "cuda"],
        "port_elastic_train.py": [py, str(ex / "port_elastic_train.py"),
                                  "--device", "cuda", "--ckpt-dir",
                                  f"{tmp.name}/elastic"]}
    state, run = background(_one_gpu_env(root), root)
    state.update(tmp=tmp, runs=runs)
    state["threads"] = [threading.Thread(target=run, args=(key, cmd),
                                         daemon=True)
                        for key, cmd in runs.items()]
    for th in state["threads"]:
        th.start()
    return state


# phase 18: the dry run (repro_torch.launch.dryrun) of one cell on both
# production meshes, a subprocess on the host CPU with the GPU hidden (it
# needs none), beside everything up to phase 17's join: the only run of
# the fake process group, FakeTensorMode and the step analysis on the
# card's host's torch
DRYRUN_CELL = ("smollm-360m", "decode_32k")


def dryrun_start():
    """Start phase 18 in the background; returns its state for
    ``dryrun_check``."""
    import os
    import tempfile
    root = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    arch, shape = DRYRUN_CELL
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "both", "--out", tmp.name]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="", PYTHONUNBUFFERED="1")
    state, run = background(env, root)
    state.update(tmp=tmp, thread=threading.Thread(
        target=run, args=("dryrun", cmd), daemon=True))
    state["thread"].start()
    return state


def dryrun_check(state) -> None:
    """Phase 18, joined: exit 0, both records "ok" with dot FLOPs; one
    ``dryrun ...`` line a record."""
    import torch
    state["thread"].join()
    arch, shape = DRYRUN_CELL
    try:
        check("dryrun" in state, "phase 18: the dry run did not finish")
        proc, secs = state["dryrun"]
        check(proc.returncode == 0, f"phase 18: the dry run exit "
              f"{proc.returncode}:\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-3000:]}")
        for mesh in ("single", "multi"):
            with open(f"{state['tmp'].name}/{arch}__{shape}__{mesh}.json") \
                    as f:
                rec = json.load(f)
            hlo = rec.get("hlo", {})
            check(rec["status"] == "ok" and
                  hlo.get("dot_flops_per_device", 0) > 0,
                  f"phase 18: {arch} x {shape} x {mesh}: {rec}")
            print(f"dryrun {arch} {shape} {mesh} ({rec['chips']} devices, "
                  f"rank 0 on the host CPU, torch {torch.__version__}): dot "
                  f"FLOPs a device {hlo['dot_flops_per_device']:.6e}, "
                  f"collective bytes {hlo['collective_bytes_per_device']}, "
                  f"counts {hlo['collective_counts']}, build "
                  f"{rec['lower_s']} s, step {rec['compile_s']} s",
                  flush=True)
        print(f"wall phase 18 dry run (in the background): {secs:.1f} s",
              flush=True)
    finally:
        state["tmp"].cleanup()


def examples_check(state) -> dict:
    """Phase 17 (``examples_start``'s runs), joined: each exits 0; the
    planning example's lines on the card equal its lines on the kernels'
    plain versions, and its --device cpu lines but for
    EXAMPLE_FLOAT32_LINES (the ``planner ... ms`` field masked); the
    quickstart's loss at its last step lies below its loss at its first
    logged step, with two checkpoints; the serving example finishes 8
    requests of 16 tokens; the elastic example crashes at step 15,
    resumes from it and completes.  Prints each run's wall seconds;
    returns the kernels' launches in the planning example and the
    quickstart."""
    for th in state["threads"]:
        th.join()
    try:
        for key in state["runs"]:
            check(key in state, f"phase 17: {key} did not finish")
            proc, secs = state[key]
            check(proc.returncode == 0, f"phase 17: {key} exit "
                  f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                  f"{proc.stderr[-3000:]}")
            print(f"wall phase 17 {key} (in the background): "
                  f"{secs:.1f} s", flush=True)
        launches = {}
        for name in ("raqo", "quickstart"):
            with open(f"{state['tmp'].name}/{name}.json") as f:
                launches[name] = json.load(f)
    finally:
        state["tmp"].cleanup()

    def lines(key):
        return [re.sub(r"planner [0-9.]+ms", "planner <ms>", line)
                for line in state[key][0].stdout.splitlines()]
    card_lines = lines("port_raqo_plan.py")
    plain = lines("port_raqo_plan.py on the plain versions")
    exact = lines("port_raqo_plan.py --device cpu")
    differ = [i for i, (a, b) in enumerate(zip(card_lines, exact))
              if a != b]
    check(card_lines == plain, f"phase 17: port_raqo_plan.py on the card "
          f"differs from its plain versions: {card_lines} != {plain}")
    check(len(card_lines) == len(exact) == 24 and
          differ in ([], EXAMPLE_FLOAT32_LINES),
          f"phase 17: port_raqo_plan.py on the card differs from --device "
          f"cpu at lines {differ}: {card_lines} != {exact}")
    ran = launches["raqo"]
    check(ran["scan_argmin"] > 0,
          f"phase 17: port_raqo_plan.py launched {ran}")
    out = state["port_quickstart.py"][0].stdout
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    check(len(losses) == 10 and losses[-1] < losses[0] and
          "done — checkpoints: [100, 200]" in out and
          launches["quickstart"]["flash_attention"] > 0,
          f"phase 17: port_quickstart.py: {out[-2000:]}")
    out = state["port_serve_batch.py"][0].stdout
    done = re.findall(r"rid=\d+ done: .*\(16 toks\)", out)
    check(len(done) == 8 and "[serve] served 8 requests" in out,
          f"phase 17: port_serve_batch.py: {out[-2000:]}")
    out = state["port_elastic_train.py"][0].stdout
    check(all(line in out for line in (
        "[train] SIMULATED FAILURE at step 15",
        "[train] resumed from step 15", "[elastic] training completed")),
        f"phase 17: port_elastic_train.py: {out[-3000:]}")
    tok_s = re.findall(r"served 8 requests, \d+ decode steps, ([0-9.]+)",
                       state["port_serve_batch.py"][0].stdout)
    print(f"examples (phase 17, on the card): port_raqo_plan.py's 24 lines "
          f"equal its lines on the kernels' plain versions, and its "
          f"--device cpu lines but for {differ} (Q3's float32 tie); its "
          f"launches {ran}; port_quickstart.py loss {losses[0]} at step "
          f"20, {losses[-1]} at step 200, K7 "
          f"{launches['quickstart']['flash_attention']} launches, "
          f"checkpoints [100, 200]; port_serve_batch.py 8 requests of 16 "
          f"tokens ({tok_s[0] if tok_s else '?'} tok/s); "
          f"port_elastic_train.py crashed at step 15, resumed from step 15 "
          f"and completed", flush=True)
    return launches


def train_phase(torch):
    """Phase 13: training at full width on the card; returns {arch:
    (its kernel's device ms on one step of its timed run, how, launches a
    step)}."""
    w = time.perf_counter()
    print(f"phase 13 on {card()}", flush=True)
    out = {}
    for arch, (layers, _, _) in TRAIN.items():
        cfg = model_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        train_parity(torch, cfg, *TRAIN_F32[arch])
        w = lap(f"train {arch} float32 check", w)
        out[arch] = train_timed(torch, cfg)
        w = lap(f"train {arch} main path", w)
    return out


def untimed_checks(torch) -> None:
    """The float32 checks of phases 7 and 13 that no timed run follows,
    run beside the launcher (phase 2): gemma2's padded prompt
    (``padded_gemma``), smollm-360m's train step on a batch with its own
    positions, and TRAIN_CHECKS."""
    w = time.perf_counter()
    padded_gemma(torch)
    w = lap("serve gemma2-9b float32 check, left-padded", w)
    train_parity(torch, model_config("smollm-360m"),
                 *TRAIN_F32["smollm-360m"], pads=TRAIN_PADS)
    w = lap("train smollm-360m float32 check, left-padded", w)
    for arch, (layers, _, _) in TRAIN_CHECKS.items():
        train_parity(torch, dataclasses.replace(model_config(arch),
                                                n_layers=layers),
                     *TRAIN_F32[arch])
        w = lap(f"train {arch} float32 check", w)


def attn_bound(B: int, S: int, H: int, KV: int, hd: int):
    """bound_ms of causal bf16 attention: q, k, v read and o written once;
    4 hd FLOPs (QK^T and PV) per unmasked (q, k) pair and head over the
    bf16 tensor cores' peak."""
    pairs = B * S * (S + 1) // 2
    return bound_ms(2 * B * (2 * S * H * hd + 2 * S * KV * hd),
                    4 * hd * pairs * H, H100_BF16_FLOPS)


def attn_vs_sdpa(torch, q, k, v, rounds: int = ATTN_ROUNDS):
    """flash_attention against torch's scaled_dot_product_attention (KV
    heads repeated first; timed here only, the port never calls it) on
    bf16 causal q, k, v, in alternating rounds: 50 eager calls on CUDA
    events (the host's launch cost included), then 10 replays of a CUDA
    graph of 20 calls (device-bound; decides the order).  Prints the
    rounds; returns the two graph medians (kernel ms, SDPA ms)."""
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    calls = {"flash_attention": lambda: fa.flash_attention(q, k, v),
             "sdpa": lambda: sdpa(qt, kt, vt, is_causal=True)}
    graphs = {n: cuda_graph(torch, fn, 20) for n, fn in calls.items()}
    eager = {n: [] for n in calls}
    dev_r = {n: [] for n in calls}
    for _ in range(rounds):
        for n, fn in calls.items():
            eager[n].append(time_ms(fn, 50, torch))
            dev_r[n].append(time_ms(graphs[n].replay, 10, torch) / 20)
    del graphs

    def spread(r):
        return (f"median {statistics.median(r):.6f} ms [" +
                ", ".join(f"{t:.6f}" for t in r) + "]")
    a, b = dev_r["flash_attention"], dev_r["sdpa"]
    wins = sum(x < y for x, y in zip(a, b))
    order = ("resolved" if max(a) < min(b) or min(a) > max(b) else
             "unresolved (ranges overlap)")
    print(f"time flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
          f"bf16 causal, {rounds} alternating rounds, CUDA graph "
          f"(device-bound): kernel {spread(a)}; "
          f"scaled_dot_product_attention {spread(b)}; kernel faster in "
          f"{wins} of {rounds}, ordering {order}; eager (host launch "
          f"included): kernel {spread(eager['flash_attention'])}; "
          f"scaled_dot_product_attention {spread(eager['sdpa'])}",
          flush=True)
    return statistics.median(a), statistics.median(b)


def positions_vs_sdpa(torch, q, k, v, rounds: int = 3):
    """K7 masking by positions (arange(S): a prompt's own positions, every
    kv tile visited) against scaled_dot_product_attention with the same
    boolean mask (KV heads repeated; timed here only), bf16, in
    alternating rounds of CUDA-graph replays (device-bound): the kernel
    first held against the plain version, then (kernel ms, SDPA ms), each
    the median of the rounds."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    pos = torch.arange(S, device=q.device).expand(B, S).contiguous()
    e, ok = allclose_err(
        fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos),
        ref.attention_ref(q, k, v, q_positions=pos, kv_positions=pos),
        ATTN_TOL["bfloat16"])
    check(ok, f"flash_attention by positions B={B} S={S}: max_abs_err {e}")
    # kept where kv_pos >= 0 and q_pos - kv_pos >= 0, as K7's mask
    mask = ((pos[:, None, :, None] - pos[:, None, None, :]) >= 0) & \
        (pos[:, None, None, :] >= 0)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    calls = {"kernel": lambda: fa.flash_attention(
                 q, k, v, q_positions=pos, kv_positions=pos),
             "sdpa": lambda: sdpa(qt, kt, vt, attn_mask=mask)}
    graphs = {n: cuda_graph(torch, fn, 10) for n, fn in calls.items()}
    got = {n: [] for n in calls}
    for _ in range(rounds):
        for n in calls:
            got[n].append(time_ms(graphs[n].replay, 3, torch) / 10)
    del graphs
    out = tuple(statistics.median(got[n]) for n in calls)
    print(f"time flash_attention by positions B={B} S={S} H={H} "
          f"KV={k.shape[2]} hd={hd} bf16 (positions arange, every kv tile "
          f"visited): median {out[0]:.4f} ms of {rounds} rounds "
          f"{[round(t, 4) for t in got['kernel']]}; scaled_dot_product_"
          f"attention with the same boolean mask {out[1]:.4f} ms "
          f"{[round(t, 4) for t in got['sdpa']]} (CUDA graphs); "
          f"max_abs_err against plain {e}", flush=True)
    return out, e


def head_dim_times(torch, dev, g, err, heads, key: str,
                   softcap: Optional[float] = None) -> dict:
    """Phase 8's K7 at a model's heads (bf16: zamba2-2.7b's 32:32 at hd 80
    and gemma2-9b's 16:8 at hd 256 on the CUDA cores, musicgen-medium's
    24:24 at hd 64 on the tensor cores), causal: at B=1, S=4096 and
    at the serve shape (B=4, S=256), each held against attention_ref, timed
    against SDPA (3 rounds: the kernel takes milliseconds at S=4096) beside
    its bound; plain timed at S=4096; with ``softcap``, the kernel at
    S=4096 with that softcap too (held against attention_ref, timed as
    CUDA-graph replays; SDPA has no softcap, so no library time).  Keys
    ``{key}_ms``, ``{key}_serve_ms`` and their ``_library_ms``,
    ``_bound_ms``, ``_bound_by``; ``{key}_plain_ms``;
    ``{key}_softcap_ms``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    H, KV, hd = heads
    out = {}
    for B, S in ((1, 4096), SERVE_ATTN):
        q, k, v = (torch.randn((B, S, n, hd), generator=g,
                               device=dev).to(torch.bfloat16)
                   for n in (H, KV, KV))
        e, ok = allclose_err(fa.flash_attention(q, k, v),
                             ref.attention_ref(q, k, v),
                             ATTN_TOL["bfloat16"])
        check(ok, f"flash_attention hd={hd} B={B} S={S}: max_abs_err {e}")
        err["flash_attention"]["bfloat16"] = max(
            err["flash_attention"]["bfloat16"], e)
        ms, lib = attn_vs_sdpa(torch, q, k, v, rounds=3)
        bnd, by = attn_bound(B, S, H, KV, hd)
        name = key if B == 1 else f"{key}_serve"
        out.update({f"{name}_ms": ms, f"{name}_library_ms": lib,
                    f"{name}_bound_ms": bnd, f"{name}_bound_by": by})
        note = ""
        if B == 1:
            out[f"{key}_plain_ms"] = time_ms(
                lambda: ref.attention_ref(q, k, v), 3, torch)
            note = f"; plain {out[f'{key}_plain_ms']:.3f} ms"
        if B == 1 and softcap is not None:
            e, ok = allclose_err(
                fa.flash_attention(q, k, v, attn_softcap=softcap),
                ref.attention_ref(q, k, v, attn_softcap=softcap),
                ATTN_TOL["bfloat16"])
            check(ok, f"flash_attention hd={hd} B={B} S={S} softcap "
                  f"{softcap}: max_abs_err {e}")
            err["flash_attention"]["bfloat16"] = max(
                err["flash_attention"]["bfloat16"], e)
            graph = cuda_graph(torch, lambda: fa.flash_attention(
                q, k, v, attn_softcap=softcap), 10)
            capped = [time_ms(graph.replay, 3, torch) / 10
                      for _ in range(3)]
            del graph
            out[f"{key}_softcap_ms"] = statistics.median(capped)
            note += (f"; with attn_softcap={softcap}: median "
                     f"{out[f'{key}_softcap_ms']:.4f} ms of 3 rounds "
                     f"{[round(t, 4) for t in capped]} (CUDA graph; no "
                     f"library time: SDPA has no softcap)")
        where = "tensor cores" if hd in fa.TC_HEAD_DIMS else "CUDA cores"
        print(f"time flash_attention hd={hd} B={B} S={S} H={H} KV={KV} "
              f"bf16 ({where}): {ms:.4f} ms; scaled_dot_product_"
              f"attention {lib:.4f} ms ({ms / lib:.2f}x); bound {bnd:.4f} "
              f"ms ({by})" + note, flush=True)
        del q, k, v
    return out


def model_times(torch, dev, err, served, trained, padded):
    """Phase 8: each model kernel at a long-prefill shape against its plain
    version, its bound and (attention) torch's fused call; K7 also masking
    by positions (``padded``: phase 7's left-padded run), K8 also at the
    Mamba1 hybrid's N = 64."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(1)
    S = 4096
    H, KV, hd = ATTN_HEADS
    bf16 = torch.bfloat16
    q = torch.randn((1, S, H, hd), generator=g, device=dev).to(bf16)
    k = torch.randn((1, S, KV, hd), generator=g, device=dev).to(bf16)
    v = torch.randn((1, S, KV, hd), generator=g, device=dev).to(bf16)
    e, ok = allclose_err(fa.flash_attention(q, k, v),
                         ref.attention_ref(q, k, v), ATTN_TOL["bfloat16"])
    check(ok, f"flash_attention S={S}: max_abs_err {e}")
    err["flash_attention"]["bfloat16"] = max(
        err["flash_attention"]["bfloat16"], e)
    fa_plain = time_ms(lambda: ref.attention_ref(q, k, v), 3, torch)
    fa_bound, fa_by = attn_bound(1, S, H, KV, hd)
    fa_ms, fa_lib = attn_vs_sdpa(torch, q, k, v)
    (pos_ms, pos_lib), e = positions_vs_sdpa(torch, q, k, v)
    err["flash_attention"]["bfloat16"] = max(
        err["flash_attention"]["bfloat16"], e)
    B, Sx = SERVE_ATTN
    attn_vs_sdpa(torch, *(torch.randn((B, Sx, n, hd), generator=g,
                                      device=dev).to(bf16)
                          for n in (H, KV, KV)))
    print(f"time flash_attention B=1 S={S}: {fa_ms:.4f} ms; plain "
          f"{fa_plain:.3f} ms; scaled_dot_product_attention {fa_lib:.4f} "
          f"ms; bound {fa_bound:.4f} ms ({fa_by})", flush=True)
    # the tensor-core kernel must really issue wgmma (SASS HGMMA)
    sass = subprocess.run(
        ["cuobjdump", "--dump-sass", str(build.library_path(
            "flash_attention"))], capture_output=True, text=True,
        check=True).stdout
    funcs = {b.split("\n", 1)[0].strip(): b.count("HGMMA")
             for b in sass.split("Function : ")[1:]}
    tc = {f: n for f, n in funcs.items() if "flash_attention_tc" in f}
    check(len(tc) == len(fa.TC_HEAD_DIMS) and all(tc.values()),
          f"the bfloat16 tensor-core kernels show no HGMMA in SASS: {tc}")
    print(f"SASS: HGMMA in every tensor-core instantiation "
          f"{sorted(tc.values())}, none in the CUDA-core kernel "
          f"({sum(n for f, n in funcs.items() if f not in tc)})",
          flush=True)
    # K8 at B=1, S=4096 and at the serve shape (B=4, S=256), bf16 u/B/C
    # with h0 as the model's prefill passes it
    D, N = SCAN_WIDTH
    ss, k8_inputs = {}, {}
    for B, Sx in ((1, S), SERVE_ATTN):
        u = torch.randn((B, Sx, D), generator=g, device=dev).to(bf16)
        dtv = torch.nn.functional.softplus(
            torch.randn((B, Sx, D), generator=g, device=dev) - 1)
        A = -torch.exp(torch.randn((D, N), generator=g, device=dev) * 0.3)
        Bm = torch.randn((B, Sx, N), generator=g, device=dev).to(bf16)
        Cm = torch.randn((B, Sx, N), generator=g, device=dev).to(bf16)
        h0 = torch.randn((B, D, N), generator=g, device=dev)
        y, h = ms.selective_scan(u, dtv, A, Bm, Cm, h0)
        yr, hr = ref.selective_scan_ref(u, dtv, A, Bm, Cm, h0)
        ey, oky = allclose_err(y, yr, SCAN_TOL)
        eh, okh = allclose_err(h, hr, SCAN_TOL)
        check(oky and okh, f"selective_scan B={B} S={Sx}: max_abs_err y "
              f"{ey} h {eh} above {SCAN_TOL}")
        err["selective_scan"]["bfloat16"] = max(
            err["selective_scan"]["bfloat16"], ey, eh)
        del y, h, yr, hr
        k_ms = time_ms(lambda: ms.selective_scan(u, dtv, A, Bm, Cm, h0), 20,
                       torch)
        plain = time_ms(lambda: ref.selective_scan_ref(u, dtv, A, Bm, Cm,
                                                       h0), 2, torch)
        # reads u (bf16), dt (f32), A, h0, B and C (bf16); writes y and
        # h_last (f32); per (t, d): dt*u, and per (t, d, n): dt*A, exp, two
        # multiplies and an add for h, a multiply and an add for y
        n_bytes = B * Sx * D * (2 + 4 + 4) + D * N * 4 + 2 * B * D * N * 4 \
            + 2 * B * Sx * N * 2
        bnd, by = bound_ms(n_bytes, B * Sx * D * (7 * N + 1))
        ss[B, Sx] = (k_ms, plain, bnd, by)
        k8_inputs[B, Sx] = (u, dtv, A, Bm, Cm, h0)
        print(f"time selective_scan B={B} S={Sx} D={D} N={N} bf16 u/B/C, "
              f"h0, {ms.lanes(B, D, N)} lanes a channel: {k_ms:.4f} ms; "
              f"plain {plain:.3f} ms; bound {bnd:.4f} ms ({by})", flush=True)
    ss_ms, ss_plain, ss_bound, ss_by = ss[1, S]
    # K8 at the Mamba1 hybrid's width (D = 5120, N = 64), B=1, S=4096
    D1, N1 = MAMBA1_WIDTH
    u = torch.randn((1, S, D1), generator=g, device=dev).to(bf16)
    dtv = torch.nn.functional.softplus(
        torch.randn((1, S, D1), generator=g, device=dev) - 1)
    A = -torch.exp(torch.randn((D1, N1), generator=g, device=dev) * 0.3)
    Bm, Cm = (torch.randn((1, S, N1), generator=g, device=dev).to(bf16)
              for _ in range(2))
    h0 = torch.randn((1, D1, N1), generator=g, device=dev)
    n64 = (u, dtv, A, Bm, Cm, h0)
    t0 = time.perf_counter()
    yr, hr = ref.selective_scan_ref(*n64)
    torch.cuda.synchronize()
    n64_plain = (time.perf_counter() - t0) * 1e3
    y, h = ms.selective_scan(*n64)
    ey, oky = allclose_err(y, yr, SCAN_TOL)
    eh, okh = allclose_err(h, hr, SCAN_TOL)
    check(oky and okh, f"selective_scan S={S} D={D1} N={N1}: max_abs_err "
          f"y {ey} h {eh} above {SCAN_TOL}")
    err["selective_scan"]["bfloat16"] = max(
        err["selective_scan"]["bfloat16"], ey, eh)
    del y, h, yr, hr
    n64_ms = time_ms(lambda: ms.selective_scan(*n64), 20, torch)
    n64_bound, n64_by = bound_ms(
        S * D1 * (2 + 4 + 4) + D1 * N1 * 4 + 2 * D1 * N1 * 4 + 2 * S * N1 * 2,
        S * D1 * (7 * N1 + 1))
    print(f"time selective_scan B=1 S={S} D={D1} N={N1} bf16 u/B/C, h0, "
          f"{ms.lanes(1, D1, N1)} lanes a channel: {n64_ms:.4f} ms; plain "
          f"{n64_plain:.3f} ms (one call, host clock); bound "
          f"{n64_bound:.4f} ms ({n64_by})", flush=True)
    del n64, u, dtv, A, Bm, Cm, h0
    # SASS: the time loop of the bf16 N=16 kernels these shapes launch (one
    # MUFU.EX2 a state update, N / G updates a lane and step)
    fns = sass_functions(build.library_path("mamba_scan"))
    for G in sorted({ms.lanes(B, D, N) for B, _ in ss}):
        fn = [f for f in fns
              if f"selective_scan_kernelI13__nv_bfloat16Li{N}ELi{G}E" in f]
        loop = sass_loop(fns[fn[0]], "MUFU.EX2") if fn else None
        check(loop is not None, f"no time loop in the G={G} kernel's SASS")
        steps = loop[1] // (N // G)
        print(f"SASS selective_scan bf16 N={N} G={G}: time loop {loop[0]} "
              f"instructions for {steps} steps of {N // G} updates a lane: "
              f"{loop[0] / steps:.1f} a step, {loop[0] / loop[1]:.1f} an "
              f"update", flush=True)
        for (B, Sx), (k_ms, _, _, _) in ss.items():
            if ms.lanes(B, D, N) != G:
                continue
            x = k8_inputs[B, Sx]
            mhz = sm_clock_mhz(torch, lambda: ms.selective_scan(*x))
            warps = B * D * G / 32 * Sx * loop[0] / steps
            share = issue_share(torch, warps, k_ms, mhz)
            print(f"issue selective_scan B={B} S={Sx}: {warps:.4g} warp-"
                  f"instructions (SASS time loop x steps) in {k_ms:.4f} ms "
                  f"at an SM clock of {mhz} MHz read under this load: "
                  f"{share} of the card's issue rate (an estimate)",
                  flush=True)
    hd80 = head_dim_times(torch, dev, g, err, ZAMBA_HEADS, "hd80")
    hd256 = head_dim_times(torch, dev, g, err, GEMMA_HEADS, "hd256",
                           softcap=GEMMA_SOFTCAP)
    mha = head_dim_times(torch, dev, g, err, MUSICGEN_HEADS, "mha")
    csrc = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:26",
         "launches": served["smollm-360m"][1]["flash_attention"],
         "max_abs_err": max(err["flash_attention"].values()), "ms": fa_ms,
         "plain_ms": fa_plain, "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": fa_lib, "path_ms": served["smollm-360m"][2],
         "path_launches": served["smollm-360m"][1]["flash_attention"],
         "path_source": served["smollm-360m"][3],
         "train_path_ms": trained["smollm-360m"][0],
         "train_path_launches": trained["smollm-360m"][2],
         "train_path_source": trained["smollm-360m"][1],
         # qwen3-moe-30b-a3b's own paths (its serve main path at 48
         # layers, one step of its 4-layer training run)
         "moe_path_ms": served[MOE][2],
         "moe_path_launches": served[MOE][1]["flash_attention"],
         "moe_path_source": served[MOE][3],
         "moe_train_path_ms": trained[MOE][0],
         "moe_train_path_launches": trained[MOE][2],
         "moe_train_path_source": trained[MOE][1],
         # zamba2-2.7b's own paths (its shared block's prefill attention
         # in its serve main path and one step of its training run)
         "hybrid_path_ms": served[HYBRID][2],
         "hybrid_path_launches": served[HYBRID][1]["flash_attention"],
         "hybrid_path_source": served[HYBRID][3],
         "hybrid_train_path_ms": trained[HYBRID][0],
         "hybrid_train_path_launches": trained[HYBRID][2],
         "hybrid_train_path_source": trained[HYBRID][1],
         # mixtral-8x7b's own paths (its serve main path at 24 layers,
         # every one windowed; one step of its 2-layer training run)
         "swa_path_ms": served[SWA][2],
         "swa_path_launches": served[SWA][1]["flash_attention"],
         "swa_path_source": served[SWA][3],
         "swa_train_path_ms": trained[SWA][0],
         "swa_train_path_launches": trained[SWA][2],
         "swa_train_path_source": trained[SWA][1],
         # gemma2-9b's (hd 256 on the CUDA cores, softcap 50, its local
         # layers windowed: its serve main path at 42 layers, one step of
         # its 8-layer training run)
         "local_global_path_ms": served[LOCAL_GLOBAL][2],
         "local_global_path_launches":
             served[LOCAL_GLOBAL][1]["flash_attention"],
         "local_global_path_source": served[LOCAL_GLOBAL][3],
         "local_global_train_path_ms": trained[LOCAL_GLOBAL][0],
         "local_global_train_path_launches": trained[LOCAL_GLOBAL][2],
         "local_global_train_path_source": trained[LOCAL_GLOBAL][1],
         # llama-3.2-vision-11b's (its 32 self-attention blocks in one
         # prefill wave of its Model-API serve main path at 40 layers; one
         # step of its 10-layer training run: 8 self blocks)
         "vlm_path_ms": served[VLM][2],
         "vlm_path_launches": served[VLM][1]["flash_attention"],
         "vlm_path_source": served[VLM][3],
         "vlm_train_path_ms": trained[VLM][0],
         "vlm_train_path_launches": trained[VLM][2],
         "vlm_train_path_source": trained[VLM][1],
         # musicgen-medium's (24:24 heads at hd 64, group size 1 on the
         # tensor cores: its 48 layers in one prefill wave; one step of
         # its 48-layer training run)
         "audio_path_ms": served[AUDIO][2],
         "audio_path_launches": served[AUDIO][1]["flash_attention"],
         "audio_path_source": served[AUDIO][3],
         "audio_train_path_ms": trained[AUDIO][0],
         "audio_train_path_launches": trained[AUDIO][2],
         "audio_train_path_source": trained[AUDIO][1],
         # K7 at zamba2's heads (hd 80) and gemma2's (hd 256), bf16 on the
         # CUDA cores, and at musicgen's (24:24, hd 64) on the tensor
         # cores, B=1, S=4096 and the serve shape
         **hd80, **hd256, **mha,
         # masking by positions at the main shape (every kv tile visited,
         # so beside the causal bound), SDPA with the same boolean mask;
         # its launches in phase 7's left-padded smollm prefill
         "positions_ms": pos_ms, "positions_library_ms": pos_lib,
         "positions_bound_ms": fa_bound, "positions_bound_by": fa_by,
         "positions_launches": padded["launches"]},
        {"name": "selective_scan", "route": "cuda",
         "source": csrc + "mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:27",
         "launches": served["falcon-mamba-7b"][1]["selective_scan"],
         "max_abs_err": max(err["selective_scan"].values()), "ms": ss_ms,
         "plain_ms": ss_plain, "bound_ms": ss_bound, "bound_by": ss_by,
         "library_ms": None, "path_ms": served["falcon-mamba-7b"][2],
         "path_launches": served["falcon-mamba-7b"][1]["selective_scan"],
         "path_source": served["falcon-mamba-7b"][3],
         "train_path_ms": trained["falcon-mamba-7b"][0],
         "train_path_launches": trained["falcon-mamba-7b"][2],
         "train_path_source": trained["falcon-mamba-7b"][1],
         # the Mamba1 hybrid's serve main path (54 blocks at D = 5120,
         # N = 64), and K8 at its width, B=1, S=4096
         "hybrid_mamba1_path_ms": served[MAMBA1_HYBRID][2],
         "hybrid_mamba1_path_launches":
             served[MAMBA1_HYBRID][1]["selective_scan"],
         "hybrid_mamba1_path_source": served[MAMBA1_HYBRID][3],
         "n64_ms": n64_ms, "n64_plain_ms": n64_plain,
         "n64_bound_ms": n64_bound, "n64_bound_by": n64_by},
    ]


def tpch_join_inputs(torch, dev, tpch):
    """Phase 9's inputs at the row counts of ``tpch``, made on the card
    from a seeded generator: BHJ (l_suppkey, s_suppkey, s_nationkey) and
    SMJ (l_orderkey, o_orderkey, o_custkey) as int32."""
    rows = {n: r.rows for n, r in tpch.relations.items()}
    g = torch.Generator(device=dev).manual_seed(JOIN_SEED)
    i32 = torch.int32
    R = rows["supplier"]
    bhj = (torch.randint(1, R + 1, (rows["lineitem"],), generator=g,
                         device=dev, dtype=i32),
           torch.arange(1, R + 1, device=dev, dtype=i32),
           torch.randint(0, rows["nation"], (R,), generator=g, device=dev,
                         dtype=i32))
    # dbgen's sparse order keys: 8 of every 32, so the largest is ~4x the
    # order count; 1..7 lines per order (L_LINENUMBER), clustered by order
    i = torch.arange(rows["orders"], device=dev)
    okey = (32 * (i // 8) + i % 8 + 1).to(i32)
    del i
    lines = torch.randint(1, 8, (rows["orders"],), generator=g, device=dev)
    probe = torch.repeat_interleave(okey, lines)
    del lines
    keep = torch.rand(rows["orders"], generator=g, device=dev) < \
        Q3_SELECTIVITY
    bkeys = okey[keep]
    del okey, keep
    bvals = torch.randint(1, rows["customer"] + 1, (bkeys.numel(),),
                          generator=g, device=dev, dtype=i32)
    return bhj, (probe, bkeys, bvals)


def join_edge_cases(torch, dev):
    """Phase 9's small cases: each join kernel bit-equal to its plain
    version, and the two hand-checked cases equal to their answers;
    returns the number of kernel/plain comparisons."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import hash_join as hj
    from repro_torch.kernels import join_cases as jc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(JOIN_SEED + 1)

    def t(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    def rand(n, lo, hi, sort=False):
        x = torch.randint(lo, hi, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        return torch.sort(x).values if sort else x

    lo, hi = INT32_MIN, INT32_MAX
    # name -> (probe, build keys ascending, build values, answer or None)
    cases = {
        "duplicates, negative values": (
            t([5, 9, 2, 3]), t([2, 5, 9, 9]), t([20, -50, 90, 91]),
            [-50, 90, 20, -1]),
        "INT_MIN and INT_MAX keys": (
            t([hi, lo, 7, -1, 0, lo + 1]), t([lo, -1, 0, hi]),
            t([1, 2, 3, 4]), [4, 1, -1, 2, 3, -1]),
        "R=1": (t([4, 3, 4]), t([4]), t([-7]), [-7, -1, -7]),
        "R=0": (t([1, 2]), t([]), t([]), [-1, -1]),
        "S=0": (t([]), t([1, 2]), t([3, 4]), []),
        "ragged, duplicates": (rand(100_003, -500, 500),
                               rand(4_099, -400, 400, sort=True),
                               rand(4_099, lo, hi), None),
        "dense duplicates": (rand(1_000_003, 0, 5_000),
                             rand(200_001, 0, 5_000, sort=True),
                             rand(200_001, lo, hi), None),
        "full int32 range": (rand(300_007, lo, hi),
                             rand(100_003, lo, hi, sort=True),
                             rand(100_003, lo, hi), None),
    }
    # the hash join also takes unsorted build sides: the first row wins
    for name in [name for name, c in cases.items() if c[1].numel() > 4]:
        p, k, v, _ = cases[name]
        perm = torch.randperm(k.numel(), generator=g, device=dev)
        cases[name + ", unsorted"] = (p, k[perm], v[perm], None)

    def sliced(x):          # x one element into a larger tensor: its data
        y = torch.zeros(x.numel() + 1, dtype=torch.int32, device=dev)
        y[1:] = x                          # pointer off a 16-byte boundary
        return y[1:]

    # each mode of the kernels (join_cases), the build side sorted for both
    # joins and as it is for the hash join, each also as unaligned slices
    for name, (p, k, v) in jc.join_cases(JOIN_SEED).items():
        sk, sv = jc.sorted_build(k, v)
        p, k, v, sk, sv = (torch.from_numpy(x).to(dev)
                           for x in (p, k, v, sk, sv))
        cases[name] = (p, sk, sv, None)
        cases[name + ", unsorted"] = (p, k, v, None)
        cases[name + ", unaligned"] = (*(sliced(x) for x in (p, sk, sv)),
                                       None)
    sizes = (ctypes.c_int32 * 3)()
    build.load_library("merge_join").merge_join_sizes(sizes)
    check(list(sizes) == [mj.TILE, mj.STAGE, mj.SAMPLE],
          f"merge_join compiled with sizes {list(sizes)}, the wrapper says "
          f"{[mj.TILE, mj.STAGE, mj.SAMPLE]}")
    n = 0
    for name, (p, k, v, answer) in cases.items():
        pairs = [("hash_join", hj.hash_join, ref.hash_join_ref)]
        if not name.endswith("unsorted"):
            pairs.append(("merge_join", mj.merge_join, ref.merge_join_ref))
        for kname, kernel, plain in pairs:
            got, want = kernel(p, k, v), plain(p, k, v)
            torch.cuda.synchronize()
            check(got.dtype == torch.int32 and torch.equal(got, want) and
                  (answer is None or got.tolist() == answer),
                  f"{kname} {name}: kernel {got.tolist()[:8]} vs plain "
                  f"{want.tolist()[:8]} (answer {answer})")
            n += 1
    return n


def join_modes(torch, bhj, smj) -> dict:
    """The modes the kernels choose on phase 9's inputs (join_cases'
    rules): the hash join's dense array or table, and how many merge-join
    tiles stage their build keys in shared memory."""
    from repro_torch.kernels import join_cases as jc
    from repro_torch.kernels import merge_join as mj
    span = jc.tile_spans(smj[0], smj[1])
    return {"hash_join": "dense array" if jc.takes_dense(bhj[1]) else "table",
            "merge_join": f"{int((span <= mj.STAGE).sum())} of "
                          f"{span.numel()} tiles staged (median span "
                          f"{int(span.median())} build keys)"}


def join_phase(torch, dev, sf: int = JOIN_SF):
    """Phase 9: both join operators through their public wrappers at TPC-H
    scale factor ``sf`` (the main path of the joins), held against their
    plain versions; returns the kernels' JSON records."""
    from repro_torch.core.schema import tpch_schema
    from repro_torch.kernels import hash_join as hj
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import ops, ref
    t = time.perf_counter()
    tpch = tpch_schema(sf)
    bhj, smj = tpch_join_inputs(torch, dev, tpch)
    torch.cuda.synchronize()
    print(f"joins: TPC-H SF {sf} inputs made on the card in "
          f"{time.perf_counter() - t:.2f} s: BHJ S={bhj[0].numel()} "
          f"R={bhj[1].numel()}, SMJ S={smj[0].numel()} R={smj[1].numel()}",
          flush=True)
    ops.reset_launch_counts()
    got_b = ops.bhj_join(*bhj)
    got_s = ops.smj_join(*smj)
    torch.cuda.synchronize()
    launches = {"hash_join": hj.hash_join.launches,
                "merge_join": mj.merge_join.launches}
    check(all(launches.values()),
          f"a join kernel never launched on its main path: {launches}")
    err = {}
    for name, got, args, plain in (("hash_join", got_b, bhj,
                                    ref.hash_join_ref),
                                   ("merge_join", got_s, smj,
                                    ref.merge_join_ref)):
        want = plain(*args)
        check(got.shape == want.shape and got.dtype == torch.int32,
              f"{name}: {tuple(got.shape)} {got.dtype}")
        same = torch.equal(got, want)
        err[name] = 0.0 if same else \
            float((got.long() - want.long()).abs().max())
        check(same, f"{name} at TPC-H SF {sf}: "
              f"{int((got != want).sum())} values differ from the plain "
              f"version's (max_abs_err {err[name]})")
        del want
    # every lineitem has its supplier; ~half the orders fail Q3's filter
    check(bool((got_b >= 0).all()) and
          int(got_b.max()) < tpch.relations["nation"].rows,
          "BHJ: a lineitem missed its supplier or got no nation key")
    miss = int((got_s == -1).sum()) / got_s.numel()
    hits = got_s[got_s != -1]
    check(abs(miss - (1 - Q3_SELECTIVITY)) < 0.01 and int(hits.min()) >= 1
          and int(hits.max()) <= tpch.relations["customer"].rows,
          f"SMJ: miss share {miss} (expected ~{1 - Q3_SELECTIVITY}) or a "
          f"custkey out of range")
    del got_b, got_s, hits
    modes = join_modes(torch, bhj, smj)
    n_edge = join_edge_cases(torch, dev)
    print(f"joins (main path): hash_join and merge_join bit-equal to their "
          f"plain versions at TPC-H SF {sf} (SMJ miss share {miss:.4f})"
          f" and in {n_edge} edge cases; launches {launches}; {modes}",
          flush=True)

    # the device time of the main path's one call of each: the hash join's
    # four kernels (min/max, build, finalize, probe) together
    path = path_ms(torch, lambda: (ops.bhj_join(*bhj), ops.smj_join(*smj)),
                   {"hash_join": (HASH_KERNELS,
                                  len(HASH_KERNELS) * launches["hash_join"],
                                  (hj, "hash_join")),
                    "merge_join": (("merge_join_kernel",),
                                   launches["merge_join"],
                                   (mj, "merge_join"))})
    print(f"joins on their path: {path} (ms of device time over "
          f"{launches} launches)", flush=True)
    hj_ms = time_ms(lambda: ops.bhj_join(*bhj), 10, torch)
    hj_plain = time_ms(lambda: ref.hash_join_ref(*bhj), 3, torch)
    mj_ms = time_ms(lambda: ops.smj_join(*smj), 10, torch)
    mj_plain = time_ms(lambda: ref.merge_join_ref(*smj), 3, torch)
    mj_lib = time_ms(lambda: torch.searchsorted(smj[1], smj[0]), 3, torch)
    # bytes: probe keys read and values written (8 a probe), build keys
    # and values read (8 a build row); operations: integer, over the
    # card's 32-bit rate outside the tensor cores
    S, R = bhj[0].numel(), bhj[1].numel()
    hj_bound, hj_by = bound_ms(8 * S + 8 * R, HASH_OPS * (S + R))
    S, R = smj[0].numel(), smj[1].numel()
    mj_bound, mj_by = bound_ms(
        8 * S + 8 * R,
        S * (SEARCH_STEP_OPS * R.bit_length() + SEARCH_END_OPS))
    hj_bytes = 8 * (bhj[0].numel() + bhj[1].numel())
    print(f"time hash_join S={bhj[0].numel()} R={bhj[1].numel()}: "
          f"{hj_ms:.4f} ms ({hj_bytes / hj_ms / 1e6:.1f} GB/s of the bound's "
          f"bytes); plain {hj_plain:.3f} ms; bound {hj_bound:.4f} ms "
          f"({hj_by}, {H100_HBM_BYTES_S / 1e9:.0f} GB/s)", flush=True)
    print(f"time merge_join S={S} R={R}: {mj_ms:.4f} ms "
          f"({8 * (S + R) / mj_ms / 1e6:.1f} GB/s of the bound's bytes); "
          f"plain {mj_plain:.3f} ms; torch.searchsorted {mj_lib:.3f} ms; "
          f"bound {mj_bound:.4f} ms ({mj_by}, "
          f"{H100_HBM_BYTES_S / 1e9:.0f} GB/s)", flush=True)
    del bhj, smj
    torch.cuda.empty_cache()
    csrc = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "hash_join", "route": "cuda", "source": csrc + "hash_join.cu",
         "replaces": "src/repro/kernels/hash_join.py:28",
         "launches": launches["hash_join"], "max_abs_err": err["hash_join"],
         "ms": hj_ms, "plain_ms": hj_plain, "bound_ms": hj_bound,
         "bound_by": hj_by, "library_ms": None,
         "path_ms": path["hash_join"][0],
         "path_launches": launches["hash_join"],
         "path_source": path["hash_join"][1], "mode": modes["hash_join"]},
        {"name": "merge_join", "route": "cuda",
         "source": csrc + "merge_join.cu",
         "replaces": "src/repro/kernels/merge_join.py:28",
         "launches": launches["merge_join"],
         "max_abs_err": err["merge_join"], "ms": mj_ms, "plain_ms": mj_plain,
         "bound_ms": mj_bound, "bound_by": mj_by, "library_ms": mj_lib,
         "path_ms": path["merge_join"][0],
         "path_launches": launches["merge_join"],
         "path_source": path["merge_join"][1], "mode": modes["merge_join"]},
    ]


def service_phase(torch, cluster):
    """Phase 10: the streaming planner service through the scan kernel on
    the streaming bench's schema and traffic; plans equal to solo planning
    on a fresh broker.  Returns the closed-loop run's scan launches."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.plan_broker import PlanBroker
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import random_query, random_schema
    from repro_torch.kernels import plan_scan as ps
    from repro_torch.service import StreamingPlannerService, poisson_trace
    schema = random_schema(STREAM_TABLES, seed=0)
    backend = ps.CudaPlanBackend()

    def raqo():
        return RAQO(schema, models=cm.simulator_cost_models(),
                    cluster=cluster, resource_planning="batched",
                    backend=backend, broker=PlanBroker(backend))

    def equal_to_solo(tickets):
        return all(t.done and plan_signature(raqo().joint(t.tables)) ==
                   plan_signature(t.joint) for t in tickets)

    def workload(n, seed):
        return [(a.tenant, a.tables) for a in poisson_trace(
            schema, n, rate=1000.0, seed=seed, tenants=64)]

    def summary(rep):
        return (f"{rep['completed']} plans, {rep['plans_per_s']:.2f} plans/s,"
                f" p50 {rep['query_p50_s']:.4f} s, p99 "
                f"{rep['query_p99_s']:.4f} s, {rep['waves']} waves, max wave "
                f"{rep['broker']['max_wave']}, mean wave "
                f"{rep['broker']['mean_wave']:.1f}, {rep['elapsed_s']:.3f} s")

    t = time.perf_counter()
    svc = StreamingPlannerService(raqo())
    churn = []
    for i in range(12):                  # the bench's churn stream
        churn.append(svc.submit(random_query(schema, 2 + i % 5,
                                             seed=100 + i), tenant=i))
        if i % 2:
            svc.step()
    svc.drain()
    check(equal_to_solo(churn), "service: a churn-stream plan differs from "
          "solo planning")

    conc, n, seed = (STREAM_CLOSED[k] for k in
                     ("concurrency", "n_queries", "seed"))
    shared = raqo()
    StreamingPlannerService(shared).run_closed_loop(
        workload(max(8, n // 8), seed + 999), conc)            # warm-up
    svc = StreamingPlannerService(shared)
    work = workload(n, seed)
    ps.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = svc.run_closed_loop(work, conc)
    torch.cuda.synchronize()
    closed = svc.report(elapsed_s=time.perf_counter() - t0)
    launches = ps.scan_argmin.launches
    check(len(tickets) == n and all(
        t.done and t.joint.plan is not None and
        math.isfinite(t.joint.exec_time) for t in tickets),
        "service: a closed-loop query has no finite plan")
    check(launches > 0, "service: scan_argmin never launched")
    pick = np.random.default_rng(0).choice(n, STREAM_SAMPLE, replace=False)
    check(equal_to_solo([tickets[i] for i in sorted(pick)]),
          "service: a closed-loop plan differs from solo planning")
    print(f"service closed loop x{conc} (main path): {summary(closed)}; "
          f"scan_argmin launches {launches}, float64 re-searches "
          f"{svc.broker.f64_researches}", flush=True)

    shared = raqo()
    StreamingPlannerService(shared).run_closed_loop(workload(16, 1234), 8)
    svc = StreamingPlannerService(shared)
    trace = poisson_trace(schema, STREAM_OPEN["n"], rate=STREAM_OPEN["rate"],
                          seed=STREAM_OPEN["seed"], tenants=64)
    t0 = time.perf_counter()
    tickets = svc.run_open_loop(trace)
    torch.cuda.synchronize()
    opened = svc.report(elapsed_s=time.perf_counter() - t0)
    check(len(tickets) == STREAM_OPEN["n"] and all(t.done for t in tickets),
          "service: an open-loop query did not finish")
    print(f"service open loop {STREAM_OPEN['rate']:g}/s: {summary(opened)}",
          flush=True)
    print(f"service: 12 churn and {STREAM_SAMPLE} closed-loop plans equal "
          f"to solo planning ({time.perf_counter() - t:.1f} s)", flush=True)
    return launches


SHARDS = (1, 2, 3, 4, 7)        # logical shards phase 11 holds K4 at
SHARDED_MAIN = 4               # logical shards of phase 11's main path
SHARD_TIMES = (1, 4, 7)        # shard counts phase 11 times K4 at
PLAN_MODES = ("hillclimb", "ensemble", "brute")
BUDGET_CHIPS = 64              # ShardingPlanner.for_budget's chip budget
LOST_CHIPS = 128               # ShardingPlanner.replan's lost chips


def sharded_phase(torch, dev):
    """Phase 11: the sharded scan (K4) over logical shards of one card,
    against single-launch scan_argmin and its plain version; then
    RAQO.plan_queries on sharded and unsharded backends (the main path);
    then times.  Returns K4's JSON record."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import (ClusterConditions, ResourceDim,
                                          scaled_cluster)
    from repro_torch.core.plan_broker import PlanBroker
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import TPCH_QUERIES, tpch_schema
    from repro_torch.kernels import plan_scan as ps
    t = time.perf_counter()
    rng = np.random.default_rng(11)
    big = scaled_cluster(100_000, 100)
    dims = ps.grid_dims(big, dev)
    # 1000 rows past the last whole tile of every shard count below
    ragged = ps.grid_dims(ClusterConditions(dims=(
        ResourceDim("num_containers", 1, 3197),
        ResourceDim("container_gb", 1, 8))), dev)
    sim = cm.simulator_cost_models()
    smj = cm.Surface(sim["SMJ"], "time")
    # cost 2000 ss - nc, clamped at the 1e-3 floor: every row from
    # nc >= 2000 ss on ties at the floor (all 100 container sizes of an nc
    # tie anyway), across every shard boundary past the first minimum
    ties = cm.Surface(cm.RegressionModel(
        "ties", np.array([2000.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0])), "time")

    def params(Q, ss_hi=60.0):
        ss = rng.uniform(0.01, ss_hi, Q)
        return torch.tensor(np.stack([ss, ss + rng.uniform(0.0, 200.0, Q)],
                                     1), dtype=torch.float32, device=dev)

    cases = [("sim/SMJ", smj, dims, params(60)),
             ("sim/SMJ", smj, dims, params(1)),
             ("ties", ties, dims, params(60, 45.0)),
             ("ties", ties, dims, params(1, 4.0)),
             ("ragged", smj, ragged, params(60)),
             ("all-infeasible", cm.Surface(sim["BHJ"], "time"), dims,
              torch.tensor([[80.0, 300.0]] * 8, device=dev))]
    total_ragged = math.prod(d.size for d in ragged)
    for D in (4, 7):
        check(0 < ps.shard_spans(total_ragged, D)[-1][1] < ps.TILE_ROWS,
              f"the ragged grid's last of {D} shards is not below a tile")

    def hold(devices_of, label):
        n = 0
        for name, surface, d, p in cases:
            Q = p.shape[0]
            qb = ps.CudaPlanBackend.q_per_block(Q)
            one = ps.scan_argmin(surface, d, p, qb)
            plain1 = ps.scan_argmin_ref(surface, d, p)
            for D in SHARDS:
                devs = devices_of(D)
                if devs is None:
                    continue
                got = ps.scan_argmin_sharded(surface, d, p, devs, qb)
                plain = ps.scan_argmin_sharded_ref(surface, d, p, D)
                torch.cuda.synchronize()
                check(all(torch.equal(a.to(dev), b) for a, b in
                          zip(got + one + plain, plain1 * 3)),
                      f"scan_argmin_sharded {name} Q={Q} {label} D={D}: "
                      f"{got[1].tolist()[:4]} vs single launch "
                      f"{one[1].tolist()[:4]}, plain {plain[1].tolist()[:4]}")
                n += 1
            if name == "all-infeasible":
                check(bool(torch.isinf(one[0]).all()) and
                      bool((one[1] == -1).all()),
                      "all-infeasible scan found a configuration")
        return n

    n = hold(lambda D: [dev] * D, "logical shards of one card")
    print(f"K4 parity: {n} cases (10M rows, ties across shard boundaries, "
          f"a last shard of {ps.shard_spans(total_ragged, 7)[-1][1]} rows, "
          f"all-infeasible; D in {SHARDS}) bit-equal to single-launch "
          f"scan_argmin and to scan_argmin_sharded_ref", flush=True)

    # the main path: TPC-H planning on a sharded backend
    tpch = tpch_schema(100)
    qs = list(TPCH_QUERIES.values())

    def plan(backend):
        t0 = time.perf_counter()
        plans = RAQO(schema=tpch, models=cm.paper_models(), cluster=big,
                     resource_planning="batched", backend=backend,
                     broker=PlanBroker(backend)).plan_queries(qs)
        torch.cuda.synchronize()
        return [plan_signature(j) for j in plans], time.perf_counter() - t0

    solo, solo_s = plan(ps.CudaPlanBackend())
    ps.reset_launch_counts()
    sharded, sharded_s = plan(ps.CudaPlanBackend(devices=[dev] *
                                                 SHARDED_MAIN))
    launches = ps.scan_argmin_sharded.launches
    check(sharded == solo, "sharded TPC-H plans differ from unsharded ones")
    check(launches > 0 and ps.scan_argmin.launches == 0,
          f"the sharded main path did not go through K4 alone: "
          f"{launches} K4 and {ps.scan_argmin.launches} K1/K2 launches")
    k4_path, k4_how = path_ms(torch, lambda: plan(ps.CudaPlanBackend(
        devices=[dev] * SHARDED_MAIN)), {"k4": (
            ("scan_db_kernel", "scan_argmin_kernel"), launches,
            (ps, "scan_argmin_sharded"))})["k4"]
    print(f"K4 main path: RAQO.plan_queries of the {len(qs)} TPC-H queries "
          f"on CudaPlanBackend(devices=[cuda]*{SHARDED_MAIN}) in "
          f"{sharded_s:.3f} s (unsharded {solo_s:.3f} s), plans equal; "
          f"scan_argmin_sharded launches {launches}, device time "
          f"{k4_path} ms over them ({k4_how})", flush=True)

    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        real = [torch.device("cuda", i) for i in range(n_gpu)]
        n = hold(lambda D: real[:D] if D <= n_gpu else None,
                 f"{n_gpu} GPUs")
        multi, _ = plan(ps.CudaPlanBackend(devices=n_gpu))
        check(multi == solo, f"TPC-H plans on {n_gpu} GPUs differ")
        print(f"K4 across {n_gpu} GPUs: {n} cases bit-equal, TPC-H plans "
              f"equal", flush=True)
    else:
        print("K4: one GPU visible, so only logical shards of one card ran "
              "(real multi-GPU shards need a host with more than one GPU)",
              flush=True)

    p60 = params(60)
    qb = ps.CudaPlanBackend.q_per_block(60)
    one_ms = time_ms(lambda: ps.scan_argmin(smj, dims, p60, qb), 10, torch)
    k4_ms = {D: time_ms(lambda D=D: ps.scan_argmin_sharded(
        smj, dims, p60, [dev] * D, qb), 10, torch) for D in SHARD_TIMES}
    plain_ms = time_ms(lambda: ps.scan_argmin_sharded_ref(
        smj, dims, p60, SHARDED_MAIN), 2, torch)
    rows = big.grid_size()
    bound, by = bound_ms(60 * smj.n_params * 4 + 60 * 8,
                         scan_ops(smj, dims, 60)[1])
    print(f"time scan_argmin_sharded sim/SMJ/time rows={rows} Q=60: "
          + "; ".join(f"D={D} {ms:.4f} ms" for D, ms in k4_ms.items())
          + f"; single-launch scan_argmin {one_ms:.4f} ms; plain (D="
          f"{SHARDED_MAIN}) {plain_ms:.3f} ms; bound {bound:.4f} ms ({by})",
          flush=True)
    return {"name": "scan_argmin_sharded", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/plan_scan.cu",
            "replaces": "src/repro/kernels/plan_scan.py:367",
            "launches": launches, "max_abs_err": 0.0,
            "ms": k4_ms[SHARDED_MAIN], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "path_ms": k4_path, "path_launches": launches,
            "path_source": k4_how}


def decision(planner_call):
    """A ShardingPlanner decision as (resources, plan choice, objective),
    or the error's type when no plan is feasible."""
    try:
        d = planner_call()
    except RuntimeError:
        return "infeasible"
    return (d.resources, d.plan_choice, d.objective_value)


def plan_lint_phase(torch, built: dict) -> None:
    """Phase 14: plan-lint of the planning path on the card (module
    docstring).  ``built`` is ``build.build_seconds`` after phase 2."""
    from repro_torch.analysis import recompile_audit as ra
    from repro_torch.analysis.__main__ import collect
    from repro_torch.analysis.report import summarize
    from repro_torch.kernels import build, plan_scan as ps

    def launches():
        return {n: getattr(ps, n).launches for n in ra.DISPATCHED}

    def delta(before):
        torch.cuda.synchronize()
        return {n: v - before[n] for n, v in launches().items()}

    before = launches()
    findings, table, thash = collect(backends=list(ra.BACKENDS),
                                     device="cuda", devices=1)
    moved = delta(before)
    bad = [f.render() for f in findings
           if not f.allowed and f.severity != "info"]
    check(not bad, f"plan-lint findings on the card: {bad}")
    want = {n: ra.expected_counts(n, 1) for n in ra.BACKENDS}
    check(table == want, f"plan-lint audit table {table} != {want}")
    check(moved == ra.expected_launches(1),
          f"plan-lint launches {moved} != {ra.expected_launches(1)}")

    before = launches()
    table4, found4 = ra.audit_backends(["cuda"], device="cuda",
                                       devices=["cuda"] * 4)
    moved4 = delta(before)
    check(not found4, f"plan-lint audit at 4 shards: "
                      f"{[f.render() for f in found4]}")
    want4 = {"cuda": ra.expected_counts("cuda", 4)}
    check(table4 == want4, f"plan-lint audit table at 4 shards {table4} "
                           f"!= {want4}")
    check(moved4 == ra.expected_launches(4),
          f"plan-lint launches at 4 shards {moved4} != "
          f"{ra.expected_launches(4)}")
    check(build.build_seconds == built,
          f"nvcc ran after phase 2: {build.build_seconds} != {built}")

    s = summarize(findings)
    print(f"plan-lint table {json.dumps(table, sort_keys=True)}",
          flush=True)
    print(f"plan-lint table_hash {thash}", flush=True)
    print(f"plan-lint severities {json.dumps(s['by_severity'])} "
          f"allowed {s['allowed']}", flush=True)
    print(f"plan-lint 4 shards {json.dumps(table4, sort_keys=True)} "
          f"hash {ra.table_hash(table4)}", flush=True)
    print(f"plan-lint launches D=1 {json.dumps(moved)} D=4 "
          f"{json.dumps(moved4)}", flush=True)


def sharding_phase(torch, dev):
    """Phase 12: the roofline surfaces in-kernel against their plain
    versions, then ShardingPlanner on the default CUDA backend against
    backend="torch" for every arch at full width, and one broker session
    shared with TPC-H costing."""
    from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import scaled_cluster
    from repro_torch.core.plan_broker import PlanBroker
    from repro_torch.core.planning_backend import get_backend
    from repro_torch.core.plans import OperatorCosting
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import TPCH_QUERIES, tpch_schema
    from repro_torch.core.sharding_planner import (PLAN_CHOICES,
                                                   ShardingPlanner,
                                                   TpuCluster)
    from repro_torch.kernels import plan_scan as ps
    t = time.perf_counter()
    train = ShapeConfig("train", 4096, 256, "train")
    shapes = (train, SHAPES["prefill_32k"], SHAPES["decode_32k"])
    inf = math.inf
    exact = get_backend("torch")

    # every roofline surface: each row's cost (neighbor_step from every
    # grid point) and the scan's argmin bit-equal to the plain version
    n = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes:
            cluster = TpuCluster().dims(shape)
            dims = ps.grid_dims(cluster, dev)
            cur = torch.tensor(np.indices([d.size for d in dims]).reshape(
                len(dims), -1).T.copy(), device=dev)
            for obj in ("time", "chip_seconds"):
                planner = ShardingPlanner(objective=obj, backend="torch")
                for choice in PLAN_CHOICES[shape.kind]:
                    s = planner._grid_fn(cfg, shape, choice,
                                         exact).surface
                    for pr in ((inf, inf), (64.0, inf), (inf, 384.0)):
                        p = torch.tensor([pr], dtype=torch.float32,
                                         device=dev)
                        got = ps.neighbor_step(s, dims, cur, p) + \
                            ps.scan_argmin(s, dims, p) + \
                            ps.ensemble_climb(s, dims, cur, p, 100_000)
                        want = ps.neighbor_step_ref(s, dims, cur, p) + \
                            ps.scan_argmin_ref(s, dims, p) + \
                            ps.ensemble_climb_ref(s, dims, cur, p, 100_000)
                        torch.cuda.synchronize()
                        check(all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
                              f"roofline {arch} {shape.name} {obj} {choice} "
                              f"{pr}: kernel {got[3].tolist()} "
                              f"{got[4].tolist()} vs plain "
                              f"{want[3].tolist()} {want[4].tolist()}")
                        n += 1
    print(f"roofline surfaces: {n} kernel/plain cases bit-equal (every "
          f"grid row's cost, the argmin and the climb from every row)",
          flush=True)

    # the main path: joint / for_budget / replan on the default backend
    ps.reset_launch_counts()
    walls, n_dec = [], 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes:
            for mode in PLAN_MODES:
                t0 = time.perf_counter()
                got = decision(lambda: ShardingPlanner(
                    resource_planning=mode).joint(cfg, shape, arch=arch))
                walls.append((f"{arch}/{shape.name}/{mode}",
                              time.perf_counter() - t0))
                want = decision(lambda: ShardingPlanner(
                    resource_planning=mode, backend="torch").joint(
                        cfg, shape, arch=arch))
                check(got == want, f"joint {arch} {shape.name} {mode}: "
                      f"{got} vs torch {want}")
                n_dec += 1
        for call in (lambda p: p.for_budget(cfg, train, BUDGET_CHIPS),
                     lambda p: p.replan(cfg, train, lost_chips=LOST_CHIPS)):
            got = decision(lambda: call(ShardingPlanner()))
            want = decision(lambda: call(ShardingPlanner(backend="torch")))
            check(got == want, f"{arch} budget/replan: {got} vs {want}")
            n_dec += 1
    torch.cuda.synchronize()
    launches = {"scan_argmin": ps.scan_argmin.launches,
                "ensemble_climb": ps.ensemble_climb.launches,
                "neighbor_step": ps.neighbor_step.launches}
    check(launches["scan_argmin"] > 0 and launches["ensemble_climb"] > 0 and
          launches["neighbor_step"] == 0,
          f"the sharding planner did not go through the kernels: {launches}")
    print(f"sharding planner (main path): {n_dec} decisions of "
          f"{len(ARCH_IDS)} archs x {len(shapes)} shapes x {PLAN_MODES} "
          f"plus for_budget({BUDGET_CHIPS}) and replan(lost_chips="
          f"{LOST_CHIPS}) equal to backend='torch'; launches {launches}",
          flush=True)
    print("joint wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in walls),
          flush=True)

    # one broker session: TPC-H operators and a sharding planner's plan
    # choices in one flush, then a TPC-H RAQO session on the same broker
    backend = ps.CudaPlanBackend()
    broker = PlanBroker(backend)
    big = scaled_cluster(100_000, 100)
    tpch = tpch_schema(100)
    models = cm.paper_models()
    sizes = sorted(r.size_gb for r in tpch.relations.values())
    ops = [(impl, sizes[i], sizes[-1]) for i in range(len(sizes) - 1)
           for impl in ("SMJ", "BHJ")]
    costing = OperatorCosting(models=models, cluster=big,
                              resource_planning="batched", broker=broker)
    for op in ops:
        costing.prefetch(*op)
    pending = broker.pending_count()
    cfg = get_config("deepseek-67b")
    shared = decision(lambda: ShardingPlanner(
        resource_planning="ensemble", broker=broker).joint(cfg, train))
    check(pending > 0 and broker.pending_count() == 0,
          f"the sharding planner's flush did not take the {pending} DB "
          f"requests along")
    solo_costing = OperatorCosting(models=models, cluster=big,
                                   resource_planning="batched",
                                   backend=ps.CudaPlanBackend())
    check(all(costing.plan_resources(*op) == solo_costing.plan_resources(*op)
              for op in ops), "shared-flush DB plans differ from solo")
    check(shared == decision(lambda: ShardingPlanner(
        resource_planning="ensemble").joint(cfg, train)),
        "shared-flush sharding decision differs from solo")
    qs = list(TPCH_QUERIES.values())
    got = RAQO(schema=tpch, models=models, cluster=big,
               resource_planning="batched", backend=backend,
               broker=broker).plan_queries(qs)
    want = RAQO(schema=tpch, models=models, cluster=big,
                resource_planning="batched", backend=backend,
                broker=PlanBroker(backend)).plan_queries(qs)
    check([plan_signature(j) for j in got] ==
          [plan_signature(j) for j in want],
          "TPC-H plans on the shared broker differ from solo planning")
    print(f"shared broker: {pending} TPC-H operator requests flushed with "
          f"deepseek-67b's plan choices, then {len(qs)} TPC-H queries; "
          f"plans and decisions equal to solo planning; broker "
          f"{broker.counters_snapshot()['waves']} waves", flush=True)

    # the roofline scan's kernel time (deepseek-67b train, first choice)
    planner = ShardingPlanner(backend="torch")
    s = planner._grid_fn(cfg, train, PLAN_CHOICES["train"][0],
                         exact).surface
    dims = ps.grid_dims(TpuCluster().dims(train), dev)
    p = torch.tensor([[inf, inf]], dtype=torch.float32, device=dev)
    roof_ms = time_ms(lambda: ps.scan_argmin(s, dims, p), 200, torch)
    dev_ms = device_ms(torch, lambda: ps.scan_argmin(s, dims, p), 50,
                       "scan_argmin_kernel")
    print(f"time scan_argmin roofline train deepseek-67b "
          f"{math.prod(d.size for d in dims)} rows Q=1: {roof_ms:.4f} ms a "
          f"call (CUDA events; the wrapper's host work bounds it), kernel "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} on "
          f"the device (torch.profiler)", flush=True)


MULTI_AXES = ("pod", "data", "model")
MULTI_TRAIN = ("smollm-360m", 2, 256)      # arch, B, S (float32)
# phase 15's other families, each at a cut depth (float32 masters, grads
# and moments of two models in turn; PERF.md §4): qwen3 2 of 48 layers
# (~1.9B parameters, ~30 GB of state a model), falcon 2 of 64, zamba2 one
# group of 6 Mamba2 blocks and the shared block (its float32 trajectory is
# chaotic, REPLAYED: the mesh takes one device's state before each step),
# gemma2 one (local, global) pair of 42 layers (~1.31B, ~21 GB), the vlm
# one group of 5 of 40 (4 self blocks and the cross block, ~2.15B, ~34
# GB), musicgen all 48 layers (~1.81B, ~29 GB)
MULTI_FAMILIES = {MOE: 2, "falcon-mamba-7b": 2, HYBRID: 6, LOCAL_GLOBAL: 2,
                  VLM: 5, AUDIO: None, MAMBA1_HYBRID: 6}
# plan variants phase 15 also trains, each against the same one-device run
MULTI_VARIANTS = {
    "smollm-360m": ({"tp_mode": "shard_map",
                     "attention_schedule": "causal_skip"},),
    MOE: ({"tp_mode": "shard_map"},),
    VLM: ({"tp_mode": "shard_map"},)}
GPIPE = dict(L=8, B=8, S=16, d=32, n_micro=4)
# forward max |diff|; each gradient's max |diff| over its max |g|
GPIPE_TOL = (1e-5, 1e-4)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _f32_steps(torch, model, batch):
    """TRAIN_F32_STEPS AdamW steps (lr TRAIN_LR) from the model's state:
    ([loss], [grad norm], [step seconds], the model kernels' launches,
    the whole parameters after them, on the model's device: compared
    there, they spare the host a copy and a pass over each of the ~2B
    float32 elements of phase 15's larger models)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import full
    opt = AdamW(lr=TRAIN_LR)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    losses, norms, secs = [], [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_F32_STEPS):
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))                 # syncs
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t)
    launches = launch_counts()
    params = {k: full(p.detach()) for k, p in state.params.items()}
    return losses, norms, secs, launches, params


def _expected_launches(cfg) -> dict:
    """K7's and K8's launches in TRAIN_F32_STEPS steps without remat: K7
    one a layer (a hybrid's shared block once a group, a vlm's self blocks
    only: its cross blocks' attention is plain torch), K8 one a Mamba1
    block (the ssm family's or a hybrid's)."""
    attn = 0 if cfg.family == "ssm" else cfg.n_layers // (
        cfg.hybrid_period if cfg.family == "hybrid" else 1)
    if cfg.family == "vlm":
        attn -= cfg.n_layers // cfg.cross_attn_period
    scan = cfg.n_layers if cfg.family in ("ssm", "hybrid") and \
        cfg.ssm_version == 1 else 0
    return {"flash_attention": attn * TRAIN_F32_STEPS,
            "selective_scan": scan * TRAIN_F32_STEPS}


def _expected_projections(cfg) -> tuple:
    """The explicit (column, row) projections of TRAIN_F32_STEPS steps
    under tp_mode="shard_map" without remat: q and wo of each
    self-attention block, the gates and w2 of each MLP (a vlm's cross
    blocks' MLPs and a hybrid's shared block's among them); none in a moe
    FFN, a cross block's attention or a Mamba mixer."""
    if cfg.family == "ssm":
        return 0, 0
    attn = cfg.n_layers // (cfg.hybrid_period if cfg.family == "hybrid"
                            else 1)
    mlp = 0 if cfg.is_moe else attn
    if cfg.family == "vlm":
        attn -= cfg.n_layers // cfg.cross_attn_period
    gates = 2 if cfg.activation in ("swiglu", "geglu") else 1
    return ((attn + gates * mlp) * TRAIN_F32_STEPS,
            (attn + mlp) * TRAIN_F32_STEPS)


def _counting(counts: dict, module, names) -> dict:
    """Wrap each of ``names`` in ``module`` to count its calls into
    ``counts`` ({name: n}, which the caller zeroes); returns it."""
    for name in names:
        counts[name] = 0

        def counted(*a, _fn=getattr(module, name), _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(module, name, counted)
    return counts


def multidevice_train(torch, mesh, arch, layers, B, S, device, explicit,
                      variants=({},)):
    """One family of phase 15: ``arch`` (at ``layers`` layers, None for
    the config's) in float32 takes TRAIN_F32_STEPS AdamW steps on one
    device from seed 0, then under ``plan_for``'s train plan on ``mesh``
    with each of ``variants`` (plan overrides: ``tp_mode``,
    ``attention_schedule``); each mesh run's losses, grad norms and
    parameters held to one device's at LOSS_TOL, GRAD_TOL and
    PARAM_SHARE_TOL, K7's and K8's launches equal on both and to one a
    layer a step, the explicit projections as many as
    ``_expected_projections`` under shard_map and none under gspmd
    (``explicit``: ``_counting``'s counts of them); a REPLAYED arch's
    each step from one device's state.  Returns the mesh runs' launches,
    summed."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.specs import plan_for
    from repro_torch.models.model import build_model
    from repro_torch.sharding import single_device_plan
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model_config(arch), dtype="float32",
                              **({} if layers is None else
                                 {"n_layers": layers}))
    shape = ShapeConfig("train", S, B, "train")
    # remat none on both paths, so each launches K7 / K8 once a layer a step
    plans = [plan_for(cfg, shape, mesh, remat="none", **kw)
             for kw in variants]
    one = single_device_plan().with_(
        moe_target_groups=plans[0].moe_target_groups)
    batch = SyntheticPipeline(cfg, B, S, seed=0).batch_at(0)

    def build(plan):
        # a vlm's gates opened on both, or its cross blocks add nothing
        return open_gates(torch, build_model(cfg, plan, device=device,
                                             seed=0))

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    replay = arch in REPLAYED
    if not replay:
        model = build(one)
        l1, n1, s1, k1, p1 = _f32_steps(torch, model, batch)
        del model
        free()
    total = {}
    for kw, plan in zip(variants, plans):
        t1 = time.perf_counter()
        explicit.update(dict.fromkeys(explicit, 0))
        if replay:      # the mesh takes one device's state before each step
            ((l2, n2, s2, k2), (l1, n1, s1, k1)), share, pmax, n = \
                replay_steps(torch, [build(p) for p in (plan, one)], batch)
            limit = 2
        else:
            model = build(plan)
            l2, n2, s2, k2, p2 = _f32_steps(torch, model, batch)
            del model
            n = beyond = 0
            pmax = 0.0
            for k, want in p1.items():
                d = (p2[k] - want).abs()
                pmax = max(pmax, float(d.max()) / TRAIN_LR)
                n += d.numel()
                beyond += int((d > 0.02 * TRAIN_LR).sum())
            del p2
            share, limit = beyond / n, 2 * TRAIN_F32_STEPS
        tag = f"{arch} {plan.tp_mode} {plan.attention_schedule}"
        rel = max(abs(a / b - 1) for a, b in zip(l2, l1))
        check(rel <= LOSS_TOL, f"phase 15 {tag}: losses {l2} vs one device "
              f"{l1}")
        nrel = max(abs(a / b - 1) for a, b in zip(n2, n1))
        check(nrel <= GRAD_TOL, f"phase 15 {tag}: grad norms {n2} vs one "
              f"device {n1}")
        how = " (each step from one device's state)" if replay else ""
        check(share <= PARAM_SHARE_TOL and pmax <= limit,
              f"phase 15 {tag}: {share} of {n} parameters beyond 2% of "
              f"lr{how} (max {pmax} lr)")
        want = _expected_launches(cfg) if device == "cuda" else \
            {k: 0 for k in k1}
        check(k1 == k2 == want, f"phase 15 {tag}: launches {k2} on the "
              f"mesh, {k1} on one device (want {want})")
        proj = tuple(explicit.values())          # (column, row)
        want_proj = _expected_projections(cfg) \
            if plan.tp_mode == "shard_map" else (0, 0)
        check(proj == want_proj, f"phase 15 {tag}: explicit projections "
              f"(col, row) {proj}, want {want_proj}")
        print(f"multidevice {arch} float32 B={B} S={S} ({cfg.n_layers} "
              f"layers) on a (1, 1, 1) mesh, plan {plan.name} tp_mode "
              f"{plan.tp_mode} schedule {plan.attention_schedule}: losses "
              f"{l2} vs one device {l1} (max rel {rel:.3g}); grad norms "
              f"max rel {nrel:.3g}; after {TRAIN_F32_STEPS} AdamW "
              f"steps{how} max |diff| {pmax:.4g} lr, {share:.3g} of {n} "
              f"elements beyond 2% of lr; launches {k2} (one device {k1}); "
              f"explicit projections (col, row) {proj}; step s mesh "
              f"{[round(x, 4) for x in s2]} vs one device "
              f"{[round(x, 4) for x in s1]}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        free()
        for k, v in k2.items():
            total[k] = total.get(k, 0) + v
    lap(f"multidevice {arch}", t0)
    return total


def multidevice_phase(torch, device: str = "cuda") -> dict:
    """Phase 15: the multi-device path as a world of one (module
    docstring; ``device="cpu"`` runs it over gloo, a rehearsal with the
    plain versions).  Returns K7's and K8's launches over its training
    runs on the mesh."""
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pipeline import gpipe_apply
    print(f"phase 15 on {card()}", flush=True)
    arch, B, S = MULTI_TRAIN
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), MULTI_AXES)
        launches = {"flash_attention": 0, "selective_scan": 0}
        explicit = _counting({}, sharding, ("explicit_col_project",
                                            "explicit_row_project"))
        for name, layers in [(arch, None)] + list(MULTI_FAMILIES.items()):
            for k, v in multidevice_train(
                    torch, mesh, name, layers, B, S, device, explicit,
                    ({},) + MULTI_VARIANTS.get(name, ())).items():
                launches[k] += v

        g = torch.Generator(device=device).manual_seed(2)
        L, Bp, Sp, d = (GPIPE[k] for k in ("L", "B", "S", "d"))
        ws, bs, x = ((torch.randn(shape, generator=g, device=device) * sc)
                     .requires_grad_() for shape, sc in
                     (((L, d, d), 0.2), ((L, d), 0.1), ((Bp, Sp, d), 1.0)))

        def body(stage_p, h):
            w, b = stage_p
            for i in range(w.shape[0]):
                h = torch.tanh(h @ w[i] + b[i])
            return h

        out = gpipe_apply((ws, bs), x, body, mesh=mesh, stage_axis="pod",
                          n_micro=GPIPE["n_micro"])
        got = [out.detach()] + list(torch.autograd.grad(out.sum(),
                                                        (ws, bs, x)))
        want = body((ws, bs), x)
        want = [want.detach()] + list(torch.autograd.grad(want.sum(),
                                                          (ws, bs, x)))
        # the output absolute, each gradient over its largest element
        errs = [float((a - b).abs().max() / (b.abs().max() if i else 1))
                for i, (a, b) in enumerate(zip(got, want))]
        check(errs[0] <= GPIPE_TOL[0] and max(errs[1:]) <= GPIPE_TOL[1],
              f"phase 15: gpipe_apply at one stage vs sequential: {errs}")
        print(f"multidevice gpipe_apply, 1 stage, L={L} B={Bp} S={Sp} "
              f"d={d}, n_micro {GPIPE['n_micro']}: max |diff| forward "
              f"{errs[0]:.3g}, gradients (over max |g|) "
              f"{max(errs[1:]):.3g}", flush=True)
    finally:
        dist.destroy_process_group()
    return launches


# phase 16: serving under plan_for's prefill and decode plans, a world of
# one: smollm-360m at full width and depth in its own dtype (bf16
# activations, float32 masters), B, prompt, greedy decode steps; the
# other families in float32 at phase 15's depths (MULTI_FAMILIES), B,
# prompt, steps, gemma2 with a prompt past its window of 4,096 (its local
# layers' rolling caches wrap)
SERVE_PLAN_MAIN = ("smollm-360m", 4, 256, 16)
# phase 7's left-padded smollm batch, under the serve plans too
SERVE_PLAN_FAMILIES = (4, 64, 8)
SERVE_PLAN_PROMPT = {LOCAL_GLOBAL: (2, WINDOW_SERVE["prompt_len"])}
# the models phase 16 serves under tp_mode="shard_map" too, over the GSPMD
# run's parameter tensors and against its one-device run: {arch: greedy
# decode steps}
SERVE_PLAN_SHARD_MAP = {"smollm-360m": 8, MOE: 8, VLM: 8}


def serveplan_inputs(cfg, B: int, P: int, new: int, lengths=None):
    """A seeded prompt batch of ``cfg`` (B x P tokens, or frame
    embeddings; a vlm's media; with ``lengths``, each row's prompt that
    long, left-padded to P: its own positions) and the audio family's
    decode frames (B, new, E), None for a token model (its steps feed
    greedy tokens)."""
    if lengths is not None:
        batch = padded_batch(cfg, lengths)
        return batch, None
    rng = np.random.default_rng(16)
    if not cfg.embed_inputs:
        emb = rng.standard_normal((B, P + new, cfg.media_embed_dim),
                                  dtype=np.float32)
        return {"embeddings": emb[:, :P]}, emb[:, P:]
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (B, P))}
    if cfg.family == "vlm":
        batch["media"] = rng.standard_normal(
            (B, cfg.n_media_tokens, cfg.media_embed_dim), dtype=np.float32)
    return batch, None


def serveplan_serve(torch, model, decoder, batch, frames, new: int,
                    cache_len: Optional[int] = None, counts=None):
    """``model.prefill`` of ``batch`` into a cache of ``cache_len`` slots
    (P + ``new`` when None), then ``new`` greedy ``decoder.decode_step``
    steps (the audio family fed ``frames``): (each logits (B, V) float32
    whole on the card, the tokens fed, each decode step's seconds, the
    model kernels' launches in the prefill, a copy of ``counts`` after
    the prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import full
    P = next(iter(batch.values())).shape[1]
    # each row's next position: its last + 1 (P without positions)
    rows = len(next(iter(batch.values())))
    q0 = torch.as_tensor(batch["positions"][:, -1] + 1) \
        if "positions" in batch else torch.full((rows,), P)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(model, cache_len or P + new)(batch)
    logits = full(logits)
    launches = launch_counts()
    after_prefill = dict(counts or {})
    decode = make_decode_step(decoder)
    out, toks, secs = [logits], [], []
    B = logits.shape[0]
    for t in range(new):
        if frames is None:
            tok = logits.argmax(-1)
            toks.append(tok)
            step = {"tokens": tok[:, None]}
        else:
            step = {"embeddings": frames[:, t:t + 1]}
        q_pos = (q0 + t).to(logits.device)
        t0 = time.perf_counter()
        logits, cache = decode(cache, step, q_pos)
        logits = full(logits)
        if logits.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append(logits)
    return out, toks, secs, launches, after_prefill


def serveplan_run(torch, mesh, arch, layers, dtype, B, P, new, device,
                  counts, lengths=None, shard_map_new=None):
    """One model of phase 16: ``arch`` (at ``layers`` layers, None for the
    config's; compute ``dtype``, None for the config's) served on one
    device, then under plan_for's prefill plan and, over the same
    parameter tensors, its decode plan on ``mesh`` (``Model.with_plan``):
    tokens equal, every logits within LOGIT_TOL, K7 through ``local_map``
    once an attention block in prefill and K8 once a Mamba1 block, as on
    one device, decode attention on the sharded cache once an attention
    block a step (``counts``: the wrappers' calls).  With ``lengths``,
    the prompts are that long, left-padded to P (``padded_batch``).  With
    ``shard_map_new``, the same parameter tensors then serve under the
    plans with ``tp_mode="shard_map"`` (``serveplan_shard_map``).
    Returns the model kernels' launches in the mesh's prefill."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import plan_for
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg = model_config(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype,
                              n_layers=layers or cfg.n_layers)
    batch, frames = serveplan_inputs(cfg, B, P, new, lengths)
    if frames is not None:
        frames = torch.as_tensor(frames, device=device)
    model = open_gates(torch, build_model(cfg, None, device=device, seed=0))
    one = serveplan_serve(torch, model, model, batch, frames, new)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    prefill, decode = (plan_for(cfg, ShapeConfig(kind, P + new, B, kind),
                                mesh) for kind in ("prefill", "decode"))
    model = open_gates(torch, build_model(cfg, prefill, device=device,
                                          seed=0))
    decoder = model.with_plan(decode)
    check(all(a is b for a, b in zip(model.parameters(),
                                     decoder.parameters())),
          f"phase 16 {arch}: the decode model copies the parameters")
    counts.update(dict.fromkeys(counts, 0))
    got = serveplan_serve(torch, model, decoder, batch, frames, new)
    k7_calls = counts["_flash_attention_sharded"]
    dec_calls = counts["_decode_attention_sharded"]
    err = max(float((a - b).abs().max()) for a, b in zip(got[0], one[0]))
    ok = all(torch.equal(a, b) for a, b in zip(got[1], one[1]))
    argmax = all(torch.equal(a.argmax(-1), b.argmax(-1))
                 for a, b in zip(got[0], one[0]))
    # one prefill launches what one training step without remat does
    want = {k: n // TRAIN_F32_STEPS
            for k, n in _expected_launches(cfg).items()}
    attn = want["flash_attention"]
    check(ok and argmax, f"phase 16 {arch}: tokens differ from one device's")
    check(err <= LOGIT_TOL, f"phase 16 {arch}: logits differ from one "
          f"device's by {err} > {LOGIT_TOL}")
    if device != "cuda":        # the plain versions launch nothing
        want = dict.fromkeys(want, 0)
    check(got[3] == one[3] == want and k7_calls == attn and
          dec_calls == attn * new,
          f"phase 16 {arch}: launches {got[3]} in the mesh's prefill "
          f"({k7_calls} K7 through local_map), {one[3]} on one device, "
          f"{dec_calls} sharded decode attentions (want {want}, {attn} "
          f"and {attn * new})")
    warm = lambda s: sorted(s[1:])[len(s[1:]) // 2] * 1e3
    print(f"serveplan {arch} {cfg.dtype} ({cfg.n_layers} layers) B={B} "
          f"prompt {P}" + (f" (rows of {list(lengths)}, left-padded: "
                           f"their own positions)" if lengths else "") +
          f", {new} greedy decode steps, prefill plan then "
          f"decode plan over its parameters on a (1, 1, 1) mesh: tokens "
          f"equal to one device's; logits max |diff| {err} (tol "
          f"{LOGIT_TOL}); prefill launches {got[3]} (one device "
          f"{one[3]}), K7 {k7_calls} through local_map; sharded decode "
          f"attention {dec_calls}; "
          f"warm decode step {warm(got[2]):.3f} ms on the mesh, "
          f"{warm(one[2]):.3f} ms on one device; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if shard_map_new:
        serveplan_shard_map(torch, mesh, model, batch, frames, P + new,
                            shard_map_new, one, got[2], counts, device)
    del model, decoder
    gc.collect()
    torch.cuda.empty_cache()
    return got[3]


def serveplan_shard_map(torch, mesh, model, batch, frames, cache_len, new,
                        one, gspmd_secs, counts, device) -> None:
    """Phase 16 under ``tp_mode="shard_map"``: ``model``'s parameter
    tensors (``Model.with_plan``) prefill ``batch`` into a cache of
    ``cache_len`` slots under plan_for's prefill plan with the explicit
    projections, then take ``new`` greedy steps under its decode plan
    (a model axis of 1 splits the one-token sequence, so decode runs, as
    the reference's does there), held against the one-device run
    ``one`` (``serveplan_serve``'s): tokens equal, logits within
    LOGIT_TOL, K7 launched once an attention block and through
    ``local_map``, the explicit projections of a prefill every one of a
    forward (``_expected_projections``), of a decode step q and the
    MLPs'."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import plan_for
    t0 = time.perf_counter()
    cfg = model.cfg
    B = one[0][0].shape[0]
    prefill, decode = (plan_for(cfg, ShapeConfig(kind, cache_len, B, kind),
                                mesh, tp_mode="shard_map")
                       for kind in ("prefill", "decode"))
    sm = model.with_plan(prefill)
    counts.update(dict.fromkeys(counts, 0))
    got = serveplan_serve(torch, sm, model.with_plan(decode), batch, frames,
                          new, cache_len, counts)
    err = max(float((a - b).abs().max())
              for a, b in zip(got[0], one[0][:new + 1]))
    ok = all(torch.equal(a, b) for a, b in zip(got[1], one[1][:new]))
    argmax = all(torch.equal(a.argmax(-1), b.argmax(-1))
                 for a, b in zip(got[0], one[0][:new + 1]))
    names = ("explicit_col_project", "explicit_row_project")
    pre = tuple(got[4][k] for k in names)
    step = tuple((counts[k] - got[4][k]) // new for k in names)
    col, row = (n // TRAIN_F32_STEPS for n in _expected_projections(cfg))
    want = {k: n // TRAIN_F32_STEPS
            for k, n in _expected_launches(cfg).items()}
    attn = want["flash_attention"]
    if device != "cuda":        # the plain versions launch nothing
        want = dict.fromkeys(want, 0)
    check(ok and argmax, f"phase 16 {cfg.name} shard_map: tokens differ "
          f"from one device's")
    check(err <= LOGIT_TOL, f"phase 16 {cfg.name} shard_map: logits differ "
          f"from one device's by {err} > {LOGIT_TOL}")
    check(pre == (col, row) and step == (col, row - attn) and
          counts[names[0]] - pre[0] == col * new and
          got[3] == want and got[4]["_flash_attention_sharded"] == attn,
          f"phase 16 {cfg.name} shard_map: explicit projections {pre} in "
          f"the prefill (want {(col, row)}), {step} a decode step (want "
          f"{(col, row - attn)}); prefill launches {got[3]} (want {want}), "
          f"{got[4]['_flash_attention_sharded']} K7 through local_map")
    warm = lambda s: sorted(s[1:])[len(s[1:]) // 2] * 1e3
    print(f"serveplan {cfg.name} {cfg.dtype} ({cfg.n_layers} layers) "
          f"tp_mode=shard_map B={B}, {new} greedy decode steps over the "
          f"GSPMD run's parameter tensors: tokens equal to one device's; "
          f"logits max |diff| {err} (tol {LOGIT_TOL}); explicit (col, row) "
          f"projections {pre} in the prefill, {step} a decode step; "
          f"prefill launches {got[3]}, K7 "
          f"{got[4]['_flash_attention_sharded']} through local_map; warm "
          f"decode step {warm(got[2]):.3f} ms under shard_map, "
          f"{warm(gspmd_secs):.3f} ms under GSPMD, {warm(one[2]):.3f} ms "
          f"on one device; {time.perf_counter() - t0:.1f} s", flush=True)


def serveplan_phase(torch, device: str = "cuda") -> int:
    """Phase 16: serving under the serve plans as a world of one
    (``serveplan_run`` of SERVE_PLAN_MAIN, then of each family of
    MULTI_FAMILIES at its depth; ``device="cpu"`` rehearses it over gloo
    with the plain versions).  Returns the model kernels' launches over
    the mesh prefills."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch import sharding
    from repro_torch.models import attention
    print(f"phase 16 on {card()}", flush=True)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    counts = _counting({}, ops, ("_flash_attention_sharded",))
    _counting(counts, attention, ("_decode_attention_sharded",))
    _counting(counts, sharding, ("explicit_col_project",
                                 "explicit_row_project"))
    try:
        mesh = make_mesh((1, 1, 1), MULTI_AXES)
        arch, B, P, new = SERVE_PLAN_MAIN
        runs = [(arch, None, None, B, P, new)]
        # phase 7's left-padded batch in smollm's own dtype, 4 steps
        runs += [(arch, None, None, len(PADDED_PROMPTS),
                  max(PADDED_PROMPTS), 4, PADDED_PROMPTS)]
        Bf, Pf, newf = SERVE_PLAN_FAMILIES
        runs += [(name, layers, "float32") + SERVE_PLAN_PROMPT.get(
            name, (Bf, Pf)) + (newf,) for name, layers in
            MULTI_FAMILIES.items()]
        launches = {}
        for i, run in enumerate(runs):
            run, lengths = run[:6], (run[6] if len(run) > 6 else None)
            # the padded smollm run (i == 1) takes no shard_map run
            sm_new = SERVE_PLAN_SHARD_MAP.get(run[0]) if i != 1 else None
            for k, n in serveplan_run(torch, mesh, *run, device, counts,
                                      lengths, sm_new).items():
                launches[k] = launches.get(k, 0) + n
    finally:
        dist.destroy_process_group()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import (ClusterConditions, ResourceDim,
                                          scaled_cluster)
    from repro_torch.core.plan_broker import PlanBroker
    from repro_torch.core.planning_backend import TorchPlanBackend
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import (TPCH_QUERIES, random_query,
                                         random_schema, tpch_schema)
    from repro_torch.kernels import build, plan_scan as ps

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    # full float32 products everywhere (the parity runs compare float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device ------------------------------------------------------------ #
    print(card(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    # 2. build ------------------------------------------------------------- #
    # every nvcc at once; phase 3 needs plan_scan only and the launcher's
    # trainer flash_attention only, so both start as soon as those two are
    # built, while the other three still build
    t_build = time.perf_counter()
    first = ("plan_scan", "flash_attention")
    rest = [name for name in build.SOURCES if name not in first]
    rest_built = {}
    rest_thread = threading.Thread(target=lambda: rest_built.update(
        build.build_all(rest)), daemon=True)
    rest_thread.start()
    libs = build.build_all(first)
    for name in first:
        build.load_library(name)
    launcher = launcher_start()
    examples = examples_start()
    dry = dryrun_start()
    w = lap("phases 1-2 (device, build of plan_scan and flash_attention)",
            t_start)

    # 3. kernel against plain, on the card --------------------------------- #
    rng = np.random.default_rng(0)
    models = {"paper": cm.paper_models(), "simreg": cm.simulator_models(),
              "sim": cm.simulator_cost_models()}
    surfaces = [(f"{src}/{impl}/{obj}", cm.Surface(m[impl], obj))
                for src, m in models.items() for impl in ("SMJ", "BHJ")
                for obj in ("time", "money", "sla")]
    # the DB scan's tiles are whole values of dim 0 x dim 1, at most
    # ps.TILE_ROWS rows: 100 and 7 container sizes do not divide a tile,
    # 2,013, 4,286 and 20,011 values of dim 0 leave a ragged last one, and
    # 5,000 container sizes are more than a tile, so a tile is a window
    # of dim 1
    grids = {"scaled_100000x100": scaled_cluster(100_000, 100),
             "ragged": ClusterConditions(dims=(
                 ResourceDim("num_containers", 1, 29_998, 7),
                 ResourceDim("container_gb", 1, 64,
                             values=(1, 2, 3, 5, 8, 13, 21, 34, 55, 64)))),
             "2013x100": ClusterConditions(dims=(
                 ResourceDim("num_containers", 1, 2_013),
                 ResourceDim("container_gb", 1, 100))),
             "20011x7": ClusterConditions(dims=(
                 ResourceDim("num_containers", 1, 20_011),
                 ResourceDim("container_gb", 1, 7))),
             "3x5000": ClusterConditions(dims=(
                 ResourceDim("num_containers", 1, 3),
                 ResourceDim("container_gb", 1, 5_000)))}
    max_err = {"scan_argmin": 0.0, "neighbor_step": 0.0,
               "ensemble_climb": 0.0}
    n_cases = 0

    def params_for(surface, Q):
        ss = rng.uniform(0.01, 60.0, Q)
        cols = [ss, ss + rng.uniform(0.0, 200.0, Q)]
        if surface.objective == "sla":
            cols.append(rng.uniform(2.0, 40.0, Q))
        return torch.tensor(np.stack(cols, 1), dtype=torch.float32,
                            device=dev)

    def same_scan(name, surface, dims, p):
        nonlocal n_cases
        rc, rf = ps.scan_argmin_ref(surface, dims, p)
        Q = p.shape[0]
        for qb in sorted({1, min(Q, ps.UNROLL_Q)}):
            kc, kf = ps.scan_argmin(surface, dims, p, qb)
            torch.cuda.synchronize()
            fin = torch.isfinite(rc) & torch.isfinite(kc)
            if fin.any():
                max_err["scan_argmin"] = max(
                    max_err["scan_argmin"],
                    float((rc[fin] - kc[fin]).abs().max()))
            check(torch.equal(rf, kf) and torch.equal(rc, kc),
                  f"scan_argmin {name} Q={Q} q_per_block={qb}: kernel "
                  f"{kc.tolist()[:4]} {kf.tolist()[:4]} vs plain "
                  f"{rc.tolist()[:4]} {rf.tolist()[:4]}")
            n_cases += 1
        return rc, rf

    def climb_starts(dims, S=CLIMB_STARTS):
        sizes = [d.size for d in dims]
        cur = np.stack([rng.integers(0, s, S) for s in sizes], 1)
        cur[0], cur[1] = 0, np.asarray(sizes) - 1      # the two corners
        return torch.tensor(cur, device=dev)

    def same_climb(name, surface, dims, starts, p, max_iters):
        nonlocal n_cases
        got = ps.ensemble_climb(surface, dims, starts, p, max_iters)
        want = ps.ensemble_climb_ref(surface, dims, starts, p, max_iters)
        torch.cuda.synchronize()
        fin = torch.isfinite(got[1]) & torch.isfinite(want[1])
        if fin.any():
            max_err["ensemble_climb"] = max(
                max_err["ensemble_climb"],
                float((got[1][fin] - want[1][fin]).abs().max()))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"ensemble_climb {name} Q={p.shape[0]} max_iters={max_iters}: "
              f"kernel {got[1].tolist()} {got[2].tolist()} vs plain "
              f"{want[1].tolist()} {want[2].tolist()}")
        n_cases += 1
        return int(got[2].max())

    t0 = time.perf_counter()
    longest = {}
    for gname, cluster in grids.items():
        dims = ps.grid_dims(cluster, dev)
        for sname, surface in surfaces:
            for Q in ((1, 8, 65) if gname == "scaled_100000x100" else
                      (1, 8, 63, 64, 65)):
                same_scan(f"{sname} {gname}", surface, dims,
                          params_for(surface, Q))
            if gname not in ("scaled_100000x100", "ragged"):
                continue
            sizes = [d.size for d in dims]
            cur = np.stack([rng.integers(0, s, 26) for s in sizes], 1)
            cur[0], cur[1] = (0, 0), (sizes[0] - 1, sizes[1] - 1)
            cur = torch.tensor(cur, device=dev)
            p1 = params_for(surface, 1)
            ref = ps.neighbor_step_ref(surface, dims, cur, p1)
            got = ps.neighbor_step(surface, dims, cur, p1)
            torch.cuda.synchronize()
            for r, g in zip(ref[:2], got[:2]):
                fin = torch.isfinite(r) & torch.isfinite(g)
                if fin.any():
                    max_err["neighbor_step"] = max(
                        max_err["neighbor_step"],
                        float((r[fin] - g[fin]).abs().max()))
            check(all(torch.equal(r, g) for r, g in zip(ref, got)),
                  f"neighbor_step {sname} {gname}: kernel {got} vs plain "
                  f"{ref}")
            n_cases += 1
            # the 10M-row grid's plain climb takes ~1e5 steps a request:
            # two surfaces there, cut at 2000 iterations
            if gname == "ragged":
                longest[f"{sname} {gname}"] = same_climb(
                    f"{sname} {gname}", surface, dims, climb_starts(dims),
                    params_for(surface, 3), 200)
            elif sname in ("sim/SMJ/time", "paper/BHJ/money"):
                longest[f"{sname} {gname}"] = same_climb(
                    f"{sname} {gname}", surface, dims, climb_starts(dims),
                    params_for(surface, 2), 2_000)
    ens_dims = ps.grid_dims(scaled_cluster(ENSEMBLE_CONTAINERS, 100), dev)
    for sname in ("sim/SMJ/time", "sim/BHJ/money"):
        surface = dict(surfaces)[sname]
        longest[f"{sname} ensemble grid"] = same_climb(
            f"{sname} ensemble grid", surface, ens_dims,
            climb_starts(ens_dims), params_for(surface, 2), 100_000)
    # a table on a 3-D grid: three cost levels, so ties everywhere
    cube = ClusterConditions(dims=(
        ResourceDim("a", 1, 7), ResourceDim("b", 2, 20, 3),
        ResourceDim("c", 1, 8, values=(1, 2, 4, 8))))
    levels = rng.integers(0, 3, size=(7, 7, 4)).astype(np.float64)
    levels[rng.random(levels.shape) < 0.2] = np.inf
    table = cm.Surface(cm.CostTable.of(cube, levels))
    cube_dims = ps.grid_dims(cube, dev)
    for max_iters in (1, 2, 100_000):
        same_climb(f"table 3-D max_iters {max_iters}", table, cube_dims,
                   climb_starts(cube_dims, 9),
                   torch.tensor([[3.0], [0.0]], device=dev), max_iters)
    print(f"ensemble_climb: longest chains {longest}", flush=True)
    # all-OOM: the hash side exceeds 70% of every container size
    oom = cm.Surface(models["sim"]["BHJ"], "time")
    dims = ps.grid_dims(grids["scaled_100000x100"], dev)
    p = torch.tensor([[80.0, 300.0]] * 8, dtype=torch.float32, device=dev)
    rc, rf = same_scan("all-OOM", oom, dims, p)
    check(bool(torch.isinf(rc).all()) and bool((rf == -1).all()),
          "all-OOM scan found a feasible configuration")
    # a tie plateau across tile boundaries: 2000 ss - nc clamped at the
    # 1e-3 floor ties every row from nc >= 2000 ss on, over many tiles
    ties = cm.Surface(cm.RegressionModel(
        "ties", np.array([2000.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0])), "time")
    ss = rng.uniform(0.01, 9.0, 65)
    p = torch.tensor(np.stack([ss, ss], 1), dtype=torch.float32, device=dev)
    for gname, cluster in grids.items():
        same_scan(f"ties {gname}", ties, ps.grid_dims(cluster, dev), p)
    print(f"parity: {n_cases} kernel/plain cases bit-equal in "
          f"{time.perf_counter() - t0:.1f} s; max_abs_err {max_err}",
          flush=True)

    w = lap("phase 3 (parity)", w)

    rest_thread.join()
    check(sorted(rest_built) == sorted(rest), f"nvcc failed for "
          f"{sorted(set(rest) - set(rest_built))} (its error above)")
    libs.update(rest_built)
    for name in rest:
        build.load_library(name)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t_build:.2f} s "
          f"from its start (nvcc, in parallel: {build.build_seconds} s)",
          flush=True)
    built = dict(build.build_seconds)
    w = lap("build of the other kernels (beside phase 3)", w)

    # 6. the model kernels against plain (untimed, beside the launcher) --- #
    err = model_kernel_parity(torch, dev)
    w = lap("phase 6 (model parity)", w)
    untimed_checks(torch)
    launcher_check(launcher)
    w = lap("train launcher (beside the build, phases 3 and 6 and the "
            "untimed checks)", w)
    example_launches = examples_check(examples)
    w = lap("phase 17 (the examples, beside the build, phases 3 and 6, "
            "the untimed checks and the launcher's wait)", w)
    dryrun_check(dry)
    w = lap("phase 18 (the dry run's wait, beside phases 2-17)", w)

    # 4. main path --------------------------------------------------------- #
    schema = random_schema(10, seed=0)
    queries = [random_query(schema, 5, seed=q) for q in range(QUERIES)]
    tpch = tpch_schema(100)
    big = scaled_cluster(100_000, 100)
    runs = [
        ("batched", dict(schema=schema, models=cm.simulator_cost_models(),
                         cluster=big, resource_planning="batched"),
         queries),
        ("ensemble", dict(schema=schema, models=cm.simulator_cost_models(),
                          cluster=scaled_cluster(ENSEMBLE_CONTAINERS, 100),
                          resource_planning="ensemble"),
         queries),
        ("tpch", dict(schema=tpch, models=cm.paper_models(), cluster=big,
                      resource_planning="batched"),
         list(TPCH_QUERIES.values())),
    ]

    def plan_all(backend, depth=None):
        out = {}
        for name, kw, qs in runs:
            qs = qs[:depth]
            broker = PlanBroker(backend)
            t = time.perf_counter()
            plans = RAQO(backend=backend, broker=broker, **kw
                         ).plan_queries(qs)
            torch.cuda.synchronize()
            out[name] = (plans, time.perf_counter() - t, broker)
        return out

    cuda_be = ps.CudaPlanBackend()
    ps.reset_launch_counts()
    got = plan_all(cuda_be)
    launches = {"scan_argmin": ps.scan_argmin.launches,
                "neighbor_step": ps.neighbor_step.launches,
                "ensemble_climb": ps.ensemble_climb.launches}
    # the kernels' plans of the first PLAIN_QUERIES queries of each
    # workload against the plain planner's
    plain = plan_all(TorchPlanBackend(device="cuda", dtype=torch.float32),
                     PLAIN_QUERIES)
    for name, kw, qs in runs:
        plans, secs, broker = got[name]
        check(len(plans) == len(qs) and all(
            jp.plan is not None and math.isfinite(jp.exec_time)
            for jp in plans), f"{name}: missing or infinite plan")
        check([plan_signature(j) for j in plans[:PLAIN_QUERIES]] ==
              [plan_signature(j) for j in plain[name][0]],
              f"{name}: kernel plans differ from the plain version's")
        c = broker.counters_snapshot()
        print(f"main {name}: {len(qs)} queries on "
              f"{kw['cluster'].grid_size()} configs, plan_queries "
              f"{secs:.3f} s, waves {c['waves']}, requests "
              f"{c['requests']}, max wave {c['max_wave']}, float64 "
              f"re-searches {broker.f64_researches}; the plans of its "
              f"first {PLAIN_QUERIES} queries equal the plain version's "
              f"(plain {plain[name][1]:.3f} s)", flush=True)
    cost_grid_check(torch, dev)
    print(f"main launches: {launches} (neighbor_step: the ensemble climb "
          f"no longer steps from the host)", flush=True)
    check(launches["scan_argmin"] > 0 and launches["ensemble_climb"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(launches["neighbor_step"] == 0,
          f"the ensemble climb still stepped from the host: {launches}")
    # each kernel's device time over the main path's own launches
    scan_names = ("scan_db_kernel", "scan_argmin_kernel")
    main_path = path_ms(torch, lambda: plan_all(ps.CudaPlanBackend()), {
        name: (names, launches[name], (ps, name)) for name, names in (
            ("scan_argmin", scan_names),
            ("neighbor_step", ("neighbor_step_kernel",)),
            ("ensemble_climb", ("ensemble_climb_kernel",)))})
    print(f"main path device time (ms over the launches above): "
          f"{main_path}", flush=True)

    # the §VII-C grid through the climb kernel: timed, not compared (the
    # plain climb would take ~1e5 host steps a request there)
    def plan_big():
        be = ps.CudaPlanBackend()
        broker = PlanBroker(be)
        plans = RAQO(schema=schema, models=cm.simulator_cost_models(),
                     cluster=big, resource_planning="ensemble", backend=be,
                     broker=broker).plan_queries(queries)
        return be, broker, plans

    ps.reset_launch_counts()
    t = time.perf_counter()
    big_be, broker, plans = plan_big()
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t
    big_launches = ps.ensemble_climb.launches
    check(len(plans) == len(queries) and all(
        jp.plan is not None and math.isfinite(jp.exec_time)
        for jp in plans), "ensemble at 100K containers: missing plan")
    check(ps.ensemble_climb.launches > 0 and ps.neighbor_step.launches == 0,
          "ensemble at 100K containers did not climb in the kernel")
    c = broker.counters_snapshot()
    print(f"main ensemble at {big.grid_size()} configs (kernel only, plans "
          f"not compared with plain): plan_queries {big_s:.3f} s, waves "
          f"{c['waves']}, requests {c['requests']}, max wave "
          f"{c['max_wave']}, ensemble_climb launches {big_launches}, "
          f"largest climb group {big_be.max_climb_stack}", flush=True)
    # the device time of all of one run's climb launches (torch.profiler)
    big_climb_ms = device_ms(torch, plan_big, 1, "ensemble_climb",
                             big_launches)
    big_climb_txt = ("not measured (the profiler dropped launches)"
                     if big_climb_ms is None else f"{big_climb_ms} ms")
    print(f"main ensemble at {big.grid_size()} configs: ensemble_climb "
          f"device time of one plan_queries {big_climb_txt} over "
          f"{big_launches} launches", flush=True)

    w = lap("phase 4 (main path)", w)

    # 5. times at the main path's largest wave shape ----------------------- #
    Q = max(1, cuda_be.max_stack)
    surface = cm.Surface(models["sim"]["SMJ"], "time")
    dims = ps.grid_dims(big, dev)
    p = params_for(surface, Q)
    rows = big.grid_size()
    # reads the (Q, P) float32 params, writes (Q,) 64-bit keys; the bound
    # counts the hoisted form's operations (the row form's beside it)
    row_ops, hoisted_ops = scan_ops(surface, dims, Q)
    scan_bound, scan_by = bound_ms(Q * surface.n_params * 4 + Q * 8,
                                   hoisted_ops)
    row_bound = bound_ms(Q * surface.n_params * 4 + Q * 8, row_ops)[0]
    rule = cuda_be.q_per_block(Q)
    geo_ms = {qb: time_ms(lambda qb=qb: ps.scan_argmin(surface, dims, p, qb),
                          10, torch)
              for qb in sorted({1, min(Q, ps.UNROLL_Q)})}
    scan_plain = time_ms(lambda: ps.scan_argmin_ref(surface, dims, p), 2,
                         torch)
    for qb, ms in geo_ms.items():
        print(f"time scan_argmin sim/SMJ/time rows={rows} Q={Q} "
              f"q_per_block={qb}{' (rule)' if qb == rule else ''}: "
              f"{ms:.4f} ms; plain {scan_plain:.3f} ms; bound "
              f"{scan_bound:.4f} ms ({scan_by}, hoisted form; "
              f"{row_bound:.4f} ms counting each row's whole surface)",
              flush=True)
    # SASS: the request loop of each main-path DB scan (8 rows a thread
    # and one warp reduction an iteration)
    for fn, instrs in sass_functions(
            build.library_path("plan_scan")).items():
        m = re.search(r"scan_db_kernelILi(\d)ELi0ELb(\d)E", fn)
        if not m:
            continue
        loop = sass_loop(instrs, "SHFL")
        check(loop is not None, f"no request loop found in {fn}'s SASS")
        surf = {0: "regression", 1: "smj", 2: "bhj"}[int(m.group(1))]
        print(f"SASS scan_db_kernel {surf}{'+oom' if m.group(2) == '1' else ''}"
              f"/time: request loop {loop[0]} instructions for "
              f"{ROWS_PER_THREAD} rows and one warp reduction, "
              f"{loop[0] / ROWS_PER_THREAD:.1f} a row", flush=True)
        if surf == "smj" and m.group(2) == "0":
            qb = min(Q, ps.UNROLL_Q)
            mhz = sm_clock_mhz(torch, lambda: ps.scan_argmin(surface, dims,
                                                             p, qb))
            warps = rows / (32 * ROWS_PER_THREAD) * Q * loop[0]
            share = issue_share(torch, warps, geo_ms[qb], mhz)
            print(f"issue scan_argmin sim/SMJ/time rows={rows} Q={Q} "
                  f"q_per_block={qb}: {warps:.4g} warp-instructions (SASS "
                  f"request loop x trips) in {geo_ms[qb]:.4f} ms at an SM "
                  f"clock of {mhz} MHz read under this load: {share} of "
                  f"the card's issue rate (an estimate)", flush=True)
    S = 26
    cur = torch.tensor(np.stack([rng.integers(0, d.size, S)
                                 for d in ens_dims], 1), device=dev)
    p1 = params_for(surface, 1)
    nb_ms = time_ms(lambda: ps.neighbor_step(surface, ens_dims, cur, p1),
                    200, torch)
    nb_plain = time_ms(lambda: ps.neighbor_step_ref(surface, ens_dims, cur,
                                                    p1), 50, torch)
    # reads (S, 2) int64 indices and the params, writes 2 floats + 1 int
    # per start; costs S centres and 4 neighbours each
    nb_bound, nb_by = bound_ms(S * 16 + surface.n_params * 4 + S * 12,
                               S * 5 * surface_ops(surface))
    print(f"time neighbor_step sim/SMJ/time S={S}: {nb_ms:.4f} ms; plain "
          f"{nb_plain:.4f} ms; bound {nb_bound:.7f} ms ({nb_by})",
          flush=True)

    # the climb at the main path's largest climb group (the ensemble grid),
    # then at the 100K run's, from each grid's own starts
    from repro_torch.core.planning_backend import start_indices
    ITERS = 100_000                           # the planners' max_iters

    def climb_time(cl, cdims, Qc, plain_q: int = 0):
        """The climb of Qc requests from the grid's own starts, timed; with
        ``plain_q``, its first plain_q requests' outputs (each request
        climbs on its own) bit-equal to the plain climb's on them, whose
        one call is timed too."""
        starts = torch.tensor(start_indices(cl, None, 24, 0), device=dev)
        pc = params_for(surface, Qc)
        out = ps.ensemble_climb(surface, cdims, starts, pc, ITERS)
        ms = time_ms(lambda: ps.ensemble_climb(surface, cdims, starts, pc,
                                               ITERS), 10, torch)
        pl = None
        if plain_q:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ref = ps.ensemble_climb_ref(surface, cdims, starts,
                                        pc[:plain_q], ITERS)
            e1.record()
            torch.cuda.synchronize()
            pl = e0.elapsed_time(e1)          # one call: ~1e3 host steps
            check(len(ref) == len(out) and all(
                torch.equal(o[:plain_q], r) for o, r in zip(out, ref)),
                f"ensemble_climb Q={Qc} on {cl.grid_size()} configs: its "
                f"first {plain_q} requests differ from the plain climb")
        S, D = starts.shape
        # reads the starts and params, writes index, cost and three counts
        # per (request, start); costs each start's first centre and every
        # in-grid neighbour its iterations visit (a later centre's cost is
        # the previous best; an off-grid slot costs nothing)
        bnd, by = bound_ms(
            starts.numel() * 8 + pc.numel() * 4 + Qc * S * (D * 8 + 4 + 3 * 8),
            (int(out[3].sum()) + Qc * S) * surface_ops(surface))
        chain = int(out[2].max())             # the longest start's
        pl_txt = ("not timed (~1e5 host steps a request)" if pl is None
                  else f"{pl:.3f} ms for its first {plain_q} requests, "
                       f"their outputs bit-equal")
        print(f"time ensemble_climb sim/SMJ/time Q={Qc} S={S} on "
              f"{cl.grid_size()} configs: {ms:.4f} ms; plain {pl_txt}; "
              f"bound {bnd:.7f} ms ({by}, {int(out[2].sum())} "
              f"start-iterations, {int(out[3].sum())} in-grid "
              f"neighbours); longest chain {chain} iterations, "
              f"{ms * 1e6 / max(chain, 1):.1f} ns an iteration", flush=True)
        return pc, out, ms, pl, bnd, by

    # the main path's largest climb group on the ensemble grid, its first
    # CLIMB_PLAIN_Q requests against the plain climb (~1.6 s of host steps
    # a request)
    ens = scaled_cluster(ENSEMBLE_CONTAINERS, 100)
    cl_q = max(1, cuda_be.max_climb_stack)
    _, _, cl_ms, cl_plain, cl_bound, cl_by = climb_time(
        ens, ens_dims, cl_q, min(CLIMB_PLAIN_Q, cl_q))
    Qb = max(1, big_be.max_climb_stack)
    pb, out = climb_time(big, dims, Qb)[:2]
    # the long chains, checked without the plain climb: at each final
    # index one plain step finds the kernel's cost, and no strictly better
    # in-grid neighbour where the start stopped before ITERS
    for qi in range(Qb):
        centre, best, _ = ps.neighbor_step_ref(surface, dims, out[0][qi],
                                               pb[qi:qi + 1])
        stopped = out[2][qi] < ITERS
        check(torch.equal(centre, out[1][qi]) and
              not bool((stopped & (best < centre)).any()),
              f"ensemble_climb on {big.grid_size()} configs, request {qi}: "
              f"a final index is not a local minimum of the plain surface "
              f"or its cost differs")
    cut = int((out[2] >= ITERS).sum())
    print(f"ensemble_climb on {big.grid_size()} configs: the costs of all "
          f"{Qb} x {out[2].shape[1]} final indices equal the plain "
          f"surface's, and the {Qb * out[2].shape[1] - cut} starts that "
          f"stopped before {ITERS} iterations end at local minima ({cut} "
          f"cut there; chains up to {int(out[2].max())})", flush=True)

    src = "src/repro_torch/kernels/csrc/plan_scan.cu"
    kernels = [
        {"name": "scan_argmin", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/plan_scan.py:231",
         "launches": launches["scan_argmin"],
         "max_abs_err": max_err["scan_argmin"], "ms": geo_ms[rule],
         "plain_ms": scan_plain, "bound_ms": scan_bound,
         "bound_by": scan_by, "library_ms": None,
         "path_ms": main_path["scan_argmin"][0],
         "path_launches": launches["scan_argmin"],
         "path_source": main_path["scan_argmin"][1]},
        {"name": "neighbor_step", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/plan_scan.py:290",
         "launches": launches["neighbor_step"],
         "max_abs_err": max_err["neighbor_step"], "ms": nb_ms,
         "plain_ms": nb_plain, "bound_ms": nb_bound,
         "bound_by": nb_by, "library_ms": None,
         "path_ms": main_path["neighbor_step"][0],
         "path_launches": launches["neighbor_step"],
         "path_source": main_path["neighbor_step"][1]},
        {"name": "ensemble_climb", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/plan_scan.py:290",
         "launches": launches["ensemble_climb"],
         "max_abs_err": max_err["ensemble_climb"], "ms": cl_ms,
         "plain_ms": cl_plain, "bound_ms": cl_bound, "bound_by": cl_by,
         # ms and bound_ms at the main path's largest climb group,
         # plain_ms over its first plain_requests requests
         "requests": cl_q, "plain_requests": min(CLIMB_PLAIN_Q, cl_q),
         "library_ms": None, "path_ms": main_path["ensemble_climb"][0],
         "path_launches": launches["ensemble_climb"],
         "path_source": main_path["ensemble_climb"][1]},
    ]
    w = lap("phase 5 (times)", w)

    # 7-8. the serving slice ----------------------------------------------- #
    served = serve_phase(torch)
    served.update(media_serve_phase(torch))
    padded = padded_serve(torch)
    w = lap("phase 7 (serve)", w)
    trained = train_phase(torch)
    w = lap("phase 13 (train)", w)
    kernels += model_times(torch, dev, err, served, trained, padded)
    w = lap("phase 8 (model kernel times)", w)

    # 9-10. the joins and the streaming service ---------------------------- #
    kernels += join_phase(torch, dev)
    w = lap("phase 9 (joins)", w)
    service_phase(torch, big)
    w = lap("phase 10 (service)", w)

    # 11-12. the sharded scan and the sharding planner -------------------- #
    kernels.append(sharded_phase(torch, dev))
    w = lap("phase 11 (sharded scan)", w)
    sharding_phase(torch, dev)
    w = lap("phase 12 (sharding planner)", w)

    # 14. plan-lint of the planning path ---------------------------------- #
    plan_lint_phase(torch, built)
    w = lap("phase 14 (plan-lint)", w)

    # 15. the multi-device path, as a world of one ------------------------ #
    for name, n in multidevice_phase(torch).items():
        next(k for k in kernels if k["name"] == name)[
            "multidevice_path_launches"] = n
    w = lap("phase 15 (multi-device, world of one)", w)

    # 16. serving under the serve plans, a world of one -------------------- #
    print(f"serveplan launches in the mesh prefills: "
          f"{serveplan_phase(torch)}", flush=True)
    lap("phase 16 (serve plans, world of one)", w)
    # phase 17's launches (its runs in the background, above):
    # the planning example's and the quickstart's
    for k in kernels:
        if k["name"] in example_launches["raqo"]:
            k["examples_launches"] = sum(
                example_launches[run][k["name"]]
                for run in ("raqo", "quickstart"))
    lap("total", t_start)
    print(card(), flush=True)      # again, for readers of the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
