#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, drives Algorithm 1
(``FederatedRun(..., "fim_lbfgs")``), FedAvg and the paper's other
strategies at the full width of the paper's F-MNIST CNN through the
kernels, the cohort simulator, checkpoint/resume and the fleet engine's
device backend, serves granite-8b and hubert-xlarge at their full
published widths through the flash-attention kernels (bf16 on the
tensor-core kernel, f32 on the SIMT kernel), trains both at full width
with the federated LLM train step (FIM-L-BFGS over microbatch cohorts,
the Gram kernel reading the bf16 history in place), then serves the MoE,
Mamba-2 and hybrid families (qwen3-moe-235b, dbrx-132b, jamba-52b,
mamba2-370m) at full width and trains mamba2-370m at full depth.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: the card's name and power limit, then the kernel build;
  2. each kernel against its plain version at the main path's shapes,
     with CUDA-event times (see ``time_ms``) beside the card's bound:
     fim_diag over one client's 8 leaves at B = 600 in one launch (and each
     leaf alone); the Gram read in place from an m = 10 history of the
     CNN's leaves in one launch (and on a materialised basis); int8
     over fim_lbfgs's whole (g, Γ) payload in one launch pair (and each
     leaf alone); the top-k select on its one-launch cluster path, the
     four-launch path timed beside it, and one n above the cluster's
     capacity (the four-launch path); the Gram read in place from an
     m = 10 bf16 history of granite-8b's 12 leaves at 2 layers beside an
     f32 g (the train step's, 838.9 M columns), and of mamba2-370m's at
     its 48 layers (419.7 M columns); flash attention at the prefill
     shapes of granite, hubert, qwen3-moe (64 q heads on 4 KV heads) and
     dbrx (48 on 8);
  3. the main paths, each 5 rounds on 60,000 synthetic F-MNIST examples,
     100 clients, 20 per round, non-IID-2: fim_lbfgs under
     compress="none", "int8" and "topk:0.1", and fedavg_sgd under
     "topk:0.1" (per-client error feedback); launch counts, losses and the
     byte ledger are checked, and under top-k the error-feedback identity
     on one client; then, for each, one more round with kernels="off"
     beside kernels="auto" from the same state, holding every part of the
     strategy's state (and the residuals) after it; then 2 rounds of each
     of fedavg_adam, fedprox, feddane, fedova and fedova_lbfgs under
     "none"; last the split of a round's time between the client step,
     the codec round-trips and the server step;
  edge. the resource-constrained edge runtime (``FedConfig.edge``) under
     fim_lbfgs at the same width and data, 5 rounds a run, each beside a
     kernels="off" twin in lockstep: E1 energy_opt with enforced
     deadlines under churn and SNR bursts, traced, on the per-client and
     the fleet fast path; E2 adaptive_codec (top-k at per-client k); E3
     buffered async under int8 with expiring grants.  Gates: the
     simulation's fingerprint the same with and without kernels and on
     both fleet paths, the state within phase 3's bounds every round,
     E1's PlanAudit balanced, drops, several k and stale entries
     present, and each round's launches those its decisions imply;
  cohort. the cohort simulator (``fed/simulator.from_strategy``) at the
     same width and data: 5 rounds each under "none", "int8" and
     "topk:0.1", 20 slots of 512 examples a round, each round beside the
     per-slot loop and the kernels="off" cohort path on the same batches
     from the same state; gates on the state, the payloads and the
     launches (fim_diag 3 a round, the Gram 1, int8 5 pairs, top-k 20);
     seconds a round against the loop and the peak memory printed;
  cohort_edge. ``simulator.with_edge`` over E1's edge, 5 rounds beside a
     kernels="off" twin: the edge stats and drop masks bit-identical; the
     cohort path's two refusals raised;
  resume. int8 fim_lbfgs on E1's edge: 3 rounds, ``save``,
     ``restore_from`` into a fresh run, 3 more, against 6 straight rounds:
     the simulation bit-identical, the params against the card's noise
     floor (two straight runs), with deterministic and default cuDNN;
  fleet. ``FleetEngine`` at 10^5 and 10^6 clients, 1 % a round, 5 rounds
     each of bandwidth_opt and energy_opt: the numpy ``exact`` backend
     against the float64 torch backend on the card (``jit``): identical
     decisions, clock, energy and batteries within rtol 1e-9;
  sync. no device->host sync: the fleet backend's device bodies
     (``_bw_widths``, ``_energy_widths``, ``_sync_round`` with and without
     re-allocation) at 10^5 clients, then one call each of the kernel
     wrappers (``fim_diag_update_leaves``, ``vlbfgs_gram_leaves``,
     ``int8_roundtrip_leaves``, ``topk_select``, ``flash_attention``) at
     the main path's shapes, each after a warm call, inputs on the card,
     under ``torch.cuda.set_sync_debug_mode("error")``: a sync fails the
     run;
  4. LLM serving: granite-8b at full width in bf16 (36 layers, ~8.2 B
     parameters drawn on the card): prefill of 2 Zipf prompts of 4,096
     tokens through the tensor-core kernel (36 launches a call, each one
     counted on that kernel), the same prefill with kernels="off" beside
     it, greedy decode of 8 streams for 64 steps; decode against prefill
     at full width in f32 with 4 layers (the SIMT kernel); the
     hubert-xlarge encoder at full width (48 layers) on 2 x 4,096 frames,
     with its off-beside-auto check;
  llm_train. the federated LLM train step (``launch/train.py``) at
     granite-8b's full width in bf16, 2 of its 36 layers (838.9 M
     parameters, an m = 10 bf16 history), 4 Zipf sequences of 4,096
     tokens in 4 microbatch cohorts: 3 fim_lbfgs steps (one Gram launch
     each), its Gram against the plain version on the trained history,
     the kernels="off" twin from the same init (step 1 equal, then loss and
     dir_norm within their bounds), 2 steps each of fedavg_adam and
     fedavg_sgd; then hubert-xlarge's encoder loss at full width, 12 of 48
     layers, 2 x 4,096 frames, 2 fim_lbfgs steps and their twin.  Each step
     prints its loss, seconds, tokens/s, peak memory and Gram launches;
  sharded. the same granite-8b train step (2 layers, 4 x 4,096 tokens, 4
     cohorts) on a (1, 1) ("data", "model") DeviceMesh over a 1-rank NCCL
     group (``make_train_step(..., mesh=)``: params and ZeRO-1 optimizer
     state as DTensors, each cohort sharded over the data axes, the Gram
     from the local shards and one (2m+1)^2 all-reduce) beside the
     unsharded step, 2 steps each from one init: step 1's loss equal, one
     Gram launch and one Gram all-reduce a step, dir_norm and every param
     leaf within TRAIN_DIR_TOL; then one dry-run record (granite-20b's
     train step on a fake 16 x 16 mesh of 256 ranks) in a subprocess;
  llm_families. qwen3-moe-235b-a22b (2 of 94 layers), dbrx-132b (2 of
     40), jamba-v0.1-52b (one period of 8 of its 32 layers) and
     mamba2-370m (all 48) at full width in bf16, each from fresh counts
     and freed before the next: 2 prefills of 2 x 4,096 Zipf tokens (one
     tensor-core flash launch an attention layer), the kernels="off" twin
     on the last 512 positions with its routing pinned to the auto run's
     (FAMILY_OFF_TOL) and the wiring controls, greedy decode of 8 streams
     for 64 steps, each MoE layer's dropped share; decode against prefill
     in f32 at a capacity that drops nothing (qwen3-moe 2 layers,
     mamba2 48, jamba 8; the SIMT kernel); one MoE layer of qwen3-moe
     and of dbrx in f32 against moe_apply_plain over 8,192 tokens; then
     mamba2-370m trained at full width and depth (3 fim_lbfgs steps of 4 x
     4,096 tokens, one Gram launch each, and the kernels="off" twin);
  5. one JSON line listing every ported kernel, then the result line.

Needs CUDA and about 65 GB of device memory at its peak (the train
step's 33.6 GB bf16 history beside its f32 accumulators, Fisher
diagonal and step).
Without CUDA the script exits 2 and prints no result.  It imports nothing
of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (dbrx_132b, granite_8b,  # noqa: E402
                                 hubert_xlarge, jamba_52b, mamba2_370m,
                                 qwen3_moe_235b)
from repro_torch.configs.base import FedConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN  # noqa: E402
from repro_torch.data.synthetic import make_classification, zipf_tokens  # noqa: E402
from repro_torch.edge import (ChannelConfig, DeviceConfig, EdgeConfig,  # noqa: E402
                              EdgeRuntime, FleetEngine)
from repro_torch.edge.allocation import BISECT_ITERS  # noqa: E402
from repro_torch.edge.device import flops_grad_fim  # noqa: E402
from repro_torch.edge.fleet import kernel as fleet_kernel  # noqa: E402
from repro_torch.fed import codecs, simulator, strategies  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.kernels import (_build, codec_ops, fim_diag,  # noqa: E402
                                 flash_attention, ops, ref, vlbfgs)
from repro_torch.launch import cost as costlib  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.train import (init_train_state,  # noqa: E402
                                      make_prefill_step, make_serve_step,
                                      make_train_step, opt_config,
                                      shard_batch, shard_train_state)
from repro_torch.models import attention, cnn, moe, transformer  # noqa: E402
from repro_torch.models import model as zoo  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

# launch counters of the kernel wrappers, by kernel name: (module, attribute);
# flash_attention counts both of its kernels, flash_attention_tc the bf16
# tensor-core kernel's share (the rest ran the f32 SIMT kernel);
# int8_roundtrip counts launch pairs (one a payload of up to 64 leaves);
# topk_select counts calls on either path, topk_select_cluster those on the
# one-launch cluster path (the rest ran the four-launch path)
COUNTERS = {"fim_diag": (fim_diag, "LAUNCHES"),
            "vlbfgs_gram": (vlbfgs, "LAUNCHES"),
            "int8_roundtrip": (codec_ops, "LAUNCHES"),
            "topk_select": (codec_ops, "TOPK_LAUNCHES"),
            "topk_select_cluster": (codec_ops, "TOPK_CLUSTER_LAUNCHES"),
            "flash_attention": (flash_attention, "LAUNCHES"),
            "flash_attention_tc": (flash_attention, "TC_LAUNCHES")}

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the f32 rate outside the
# tensor cores (the f32 SIMT kernels' plain FMAs) and the bf16 tensor-core
# rate; rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12   # dense, tensor cores

# main-path configuration (F-MNIST's own split sizes)
N_TRAIN, N_TEST = 60_000, 10_000
RUN = dict(num_clients=100, participation=0.2, noniid_l=2, rounds=5, seed=0)
ROUNDS = RUN["rounds"]
COHORT = int(RUN["participation"] * RUN["num_clients"])

# tolerances, kernel vs plain version on the same inputs:
#   fim_diag: both accumulate in f32 but in other orders -> 1e-5 rel/abs
#   gram: the same, each entry (i, j) relative to sqrt(want_ii * want_jj),
#   the Cauchy-Schwarz bound on the products it sums (gram_err) -> 1e-5
#   int8: every step correctly rounded on both paths -> bit-identical
FIM_TOL = 1e-5
GRAM_TOL = 1e-5
# one round with kernels="off" vs "auto" from the same state, each part of
# the strategy's state held as ||auto - off|| / ||off||:
#   Fisher diagonal: per-client means of g^2 summed in other orders, then
#   the same cohort mean and EMA -> 1e-5
#   params and history s, y: the Gram matrix sums in other orders and the
#   two-loop divides by curvature products of those sums -> 1e-3
#   under int8 every part: a one-ulp difference in a client's Fisher or
#   gradient can move its stochastic rounding by one level, max|x|/127, i.e.
#   at most 1/127 of that leaf's norm and 1/20 of it after the cohort mean;
#   a few such flips per round stay below 2e-3
FISHER_TOL = 1e-5
STEP_TOL = 1e-3
INT8_STATE_TOL = 2e-3
#   under top-k the select is bit-identical on identical inputs, and its
#   inputs differ only by the f32 sums above and by cuDNN's unordered
#   backward sums (~1e-7 relative); a coordinate changes sides of the
#   threshold only when it lies that close to an edge of the threshold
#   bucket.  Such a swap moves two coordinates of about the threshold's
#   magnitude: far below 1e-3 of the params and the history after the
#   cohort mean, but about 1% of one client's residual.  So params and
#   history -> 1e-3, residuals -> 1e-3 on the coordinates both runs
#   treated alike (a sent coordinate leaves a zero residual), and the
#   swapped coordinates are counted: at most 1e-3 of the k sent, where a
#   wrong select would differ in thousands
TOPK_STATE_TOL = 1e-3
TOPK_SWAP_SHARE = 1e-3
TOPK = "topk:0.1"
# FedDANE diverges at the default local lr (0.05) on the full-width CNN
# with 5 local epochs of batch 15: the reference's own FederatedRun reads
# NaN losses from round 1 there as well (checked on the CPU at 12,000
# examples, 20 clients); at lr 0.01 both converge
STRATEGY_OVERRIDES = {"feddane": {"learning_rate": 0.01}}
# flash attention, kernel vs plain version on the same inputs: both take
# the scores and the softmax in f32 and sum in other orders -> 2e-5 in f32
# (tests/test_kernels.py's tolerance).  In bf16 both compute that f32
# result (apart by ~1e-6, the f32 rows' reading) and round it to bf16 once,
# so an element may differ by one bf16 ulp and no more: at most 2^-7 of
# |want| (8 significant bits), plus FLASH_BF16_ATOL for elements so near
# zero that the f32 difference spans several of their ulps.  A lost key
# tile moves outputs of |out| ~ 0.03 (S = 4096) by ~1e-3, far outside it.
FLASH_F32_TOL = 2e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-5
# LLM serving at full width: prefill of PREFILL_B prompts of PREFILL_S
# tokens, timed on the second of PREFILL_CALLS calls; greedy decode of
# DECODE_B streams for DECODE_STEPS steps from an empty cache
PREFILL_B, PREFILL_S, PREFILL_CALLS = 2, 4096, 2
DECODE_B, DECODE_STEPS = 8, 64
# kernels="off" beside "auto" for a bf16 prefill, on the last-position
# logits (an encoder's last frames), as max|diff| / max|logits| and
# rms(diff) / rms(logits).  Both paths compute each attention output in f32
# from the same bf16 q, k, v and differ only in summation order (~1e-6
# relative); the rounding to bf16 then moves about one output in a
# thousand by one bf16 ulp, and every later bf16 residual add, norm and
# matmul re-rounds what differs, so the two runs end apart by the bf16
# forward's own noise floor, which grows with depth.  The card read max /
# rms 1.41 % / 1.62 % at granite-8b (36 layers) and 3.67 % / 3.27 % at
# hubert-xlarge (48 layers); each bound is 2.5x its model's own reading.
# The kernel itself is held to one bf16 ulp in phase 2, so this gate has
# to catch faults of the wiring (layout, strides, mask, head map), and
# wiring_controls shows each run that it does: a wrong mask and a wrong
# q -> kv head map on the same inputs must fail it.
OFF_TOL = {"granite-8b": {"max": 0.035, "rms": 0.04},
           "hubert-xlarge": {"max": 0.09, "rms": 0.08}}
# decode against prefill at full width in f32, LLM_F32_LAYERS layers,
# DECODE_T tokens: the same function through the cache (plain attention,
# one-row matmuls) and through the kernel (full-sequence matmuls), f32
# sums in other orders over d = 4096 (~1e-6 relative each) through 4
# layers -> 1e-4 of max|logits| (the reference's decode test holds 1e-4
# absolute on logits of about that scale)
LLM_F32_LAYERS, DECODE_T = 4, 64
DECODE_TOL = 1e-4
# GPU spin that hides the host's enqueue cost while timing (~10 ms at the
# H100's ~2 GHz SM clock)
SLEEP_CYCLES = 20_000_000

# phase "edge": examples/edge_noniid.py's wireless edge (2e5 Hz a client,
# SNR 10 +- 3 dB with Rayleigh fading, a 1.5 Mb/s server link, tree
# aggregation; devices of 1e9 FLOP/s mean, lognormal sigma 1.2) under
# fim_lbfgs at phase 3's full width, 100 clients, 20 a round, non-IID-2
EDGE_CHANNEL = ChannelConfig(bandwidth_hz=2e5, snr_db_mean=10.0,
                             snr_db_std=3.0, fading="rayleigh",
                             server_rate_bps=1.5e6, topology="tree")
EDGE_FLEET = DeviceConfig(flops_per_s_mean=1e9, flops_per_s_sigma=1.2)
EDGE_SCENARIO = "markov:p_drop=0.2,p_join=0.4|snr_burst:prob=0.4,scale=0.1"
# the three runs, 5 rounds each.  E1: energy-optimal widths for a 60 s
# deadline, every upload cut at 40 s (a 1.65 MB (g, Γ) payload takes ~19 s
# at the nominal rate, so fades, bursts and slow devices bust it), under
# churn and SNR bursts, traced, on the per-client path and on the fleet
# fast path; E2: adaptive_codec's per-client top-k; E3: buffered async
# under int8, uploads cut at 20 s so that granted spectrum expires
EDGE_RUNS = {
    "E1": dict(compress="none", traced=True, edge=dict(
        scheduler="energy_opt", deadline_s=60.0, enforce_deadline_s=40.0,
        min_clients=2, scenario=EDGE_SCENARIO)),
    "E2": dict(compress="none", traced=False, edge=dict(
        scheduler="adaptive_codec", adaptive_ratio=0.25,
        adaptive_ratio_floor=0.02)),
    "E3": dict(compress="int8", traced=False, edge=dict(
        mode="async", buffer_size=10, staleness_alpha=0.5,
        enforce_deadline_s=20.0)),
}
EDGE_LEDGER_FIELDS = ("down_bytes", "up_star_bytes", "up_tree_bytes",
                      "scalar_bytes", "rounds")

# phase "cohort": the cohort simulator (fed/simulator.py) at phase 3's
# width, data and selection: COHORT clients a round, each slot COHORT_B of
# its ~600 examples drawn without replacement.  Against the per-slot loop
# and the kernels="off" cohort path, one round from the same state and
# codec stream: the vmapped convolutions and per-example gradients run the
# loop's function in other batch shapes (other cuDNN algorithms, sums in
# other orders, ~1e-7 relative), and one quasi-Newton step carries that
# into the params at ~1e-7 -> 1e-5 under "none"; int8 and top-k keep
# phase 3's bounds (INT8_STATE_TOL with each payload coordinate within one
# level; TOPK_STATE_TOL with swaps counted against k)
COHORT_B = 512
COHORT_STATE_TOL = 1e-5
# phase "resume": RESUME_HALF rounds, checkpoint, RESUME_HALF more
RESUME_HALF = 3
# phase "fleet": the fleet engine at 10^5 and 10^6 clients, 1 % a round;
# the device backend sums in other orders than numpy (float64), so
# tests/test_fleet.py's contract: identical decisions, floats to 1e-9
FLEET_POPULATIONS = (100_000, 1_000_000)
FLEET_SHARE = 0.01
FLEET_RTOL = 1e-9
# phase "sync": the fleet backend's device bodies at SYNC_CLIENTS clients
# and one call of each kernel wrapper, each under
# torch.cuda.set_sync_debug_mode("error"), where a device->host sync raises
SYNC_CLIENTS = 100_000
# phase "llm_train": the federated LLM train step (launch/train.py) at
# granite-8b's full width, bf16, with the config's own m = 10 bf16
# history, its depth cut from 36 layers to TRAIN_LAYERS (838,881,280
# parameters; all 36 would need ~610 GB of optimizer state); TRAIN_B Zipf
# sequences of TRAIN_S tokens (train_4k's length), one a microbatch
# cohort; TRAIN_STEPS fim_lbfgs steps, then BASELINE_STEPS of each
# first-order baseline from a fresh state; hubert-xlarge's encoder loss
# at full width with HUBERT_LAYERS of its 48 layers
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_MICRO = 2, 4, 4096, 4
TRAIN_STEPS, BASELINE_STEPS = 3, 2
HUBERT_LAYERS, HUBERT_B, HUBERT_MICRO, HUBERT_STEPS = 12, 2, 2, 2
# the kernels="off" twin of the fim_lbfgs steps, from the same init on the
# same batches: step 1 is bit-identical (an empty history makes the
# direction -g exactly, whatever the Gram reads); from step 2 the two
# differ only by the Gram's f32 summation order (within GRAM_TOL of each
# entry's Cauchy-Schwarz scale), which the two-loop carries into the
# direction, and the bf16 params and history re-round wherever that moves
# a value across a rounding boundary.  The card read 1.3e-5 on dir_norm
# and 3.6e-6 on the loss at granite's step 3 (PR 19); each bound is ~30x
# to ~80x that, while a Gram that misreads a row group or a leaf moves
# dir_norm by O(1)
TRAIN_DIR_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-4
# phase "sharded": the same granite-8b train step (TRAIN_LAYERS, TRAIN_B x
# TRAIN_S, TRAIN_MICRO cohorts) on a (1, 1) ("data", "model") DeviceMesh
# over a 1-rank NCCL group (make_train_step(..., mesh=)) beside the
# unsharded step, SHARDED_STEPS each from the same init: step 1's loss
# equal; each step one Gram launch and one (2m+1)^2 f32 all-reduce;
# dir_norm within TRAIN_DIR_TOL and each param leaf within TRAIN_DIR_TOL of
# its norm (the llm_train twin's bound: on one rank the two steps run the
# same local ops, so the reading is expected to be 0).  Then one dry-run
# record (launch/dryrun.py) in a subprocess: SHARDED_DRYRUN's train step on
# a fake 16 x 16 mesh
SHARDED_STEPS = 2
SHARDED_DRYRUN = ("granite-20b", "train_4k", "16x16")
# the card's memory
CARD_GB = 80.0
# phase "llm_families": the MoE, Mamba-2 and hybrid families served at full
# published width in bf16, each from fresh counts and freed before the
# next, with its depth cut to fit the card (a "reduced" field says so):
# arch -> (config module, layers served)
FAMILIES = {"qwen3-moe-235b-a22b": (qwen3_moe_235b, 2),
            "dbrx-132b": (dbrx_132b, 2),
            "jamba-v0.1-52b": (jamba_52b, 8),
            "mamba2-370m": (mamba2_370m, 48)}
# kernels="off" beside "auto" for these prefills, on the logits of the last
# LOSS_CHUNK positions of each prompt, position by position.  Top-k routing
# turns noise into jumps: a pick whose probability sits within the bf16
# forward's noise of the k-th largest changes experts (or moves a later
# pick of its expert past the capacity), which moves that token's output by
# O(1), and in a later layer attention spreads it into every later
# position's input, whose routing flips in turn (qwen3-moe's top-8 of 128
# experts has the tightest gaps).  So the off run routes as the auto run
# did: RouteRecorder(pin=) gives each of its MoE calls the auto run's
# expert indices, the gates renormalised from its own probabilities at
# them, and counts the positions whose own choice differed (reported, not
# gated); a run with its own routing is reported beside it (flipped
# positions excluded).  What is left is the bf16 forward's noise floor from
# the attention's summation order, as for granite (1.41 % / 1.62 % at 36
# layers): here 2 attention layers whose output is small beside the MoE's,
# so a few tenths of a percent is expected.  Bounds: granite's 3.5 % on
# max|diff| / max|logits| and 1.5 % on the rms ratio for the 2-layer MoE
# models; jamba, whose one attention layer comes after 7 Mamba layers of
# 8, 1.5 % and 0.5 %.  wiring_controls (the mask flipped, the q -> kv head
# map rolled by one head; routing pinned the same way) must fail them.
# mamba2-370m has no attention: its two runs run the same ops and must be
# equal.
FAMILY_OFF_TOL = {"qwen3-moe-235b-a22b": {"max": 0.035, "rms": 0.015},
                  "dbrx-132b": {"max": 0.035, "rms": 0.015},
                  "jamba-v0.1-52b": {"max": 0.015, "rms": 0.005},
                  "mamba2-370m": {"max": 0.0, "rms": 0.0}}
# decode against prefill in f32 at full width, with capacity_factor E / k
# so that no pick can drop (each expert then holds the whole group): arch ->
# (layers, tokens, bound on max|diff| / max|logits|).  qwen3-moe holds
# DECODE_TOL as granite does; the SSM models 1e-3, the reference's own
# bound (tests/test_decode_consistency.py): the chunked SSD and the
# recurrence sum the state's decays in other orders (cumulative exp)
FAMILY_F32 = {"qwen3-moe-235b-a22b": (2, DECODE_T, DECODE_TOL),
              "mamba2-370m": (48, DECODE_T, 1e-3),
              "jamba-v0.1-52b": (8, 32, 1e-3)}
# the MoE dispatch against moe_apply_plain at full width in f32, one layer,
# MOE_B x MOE_S tokens (8 groups of 1,024): the same products summed by
# other matmul shapes, and the k picks by index_add -> 1e-5 of max|out|;
# the keep mask and the dropped share equal.  The tokens are rows of a
# random table picked by Zipf ids, so that routing crowds experts and
# drops picks, as in serving
MOE_B, MOE_S, MOE_PLAIN_TOL = 2, 4096, 1e-5


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in COUNTERS.items()}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int = 21, per: int = 10,
            warmup: int = 3) -> tuple[float, float]:
    """-> (device ms, call ms) of one call of ``fn``, medians over ``reps``.

    Device ms: ``per`` calls queued behind a ~10 ms ``torch.cuda._sleep``,
    timed by CUDA events around them and divided by ``per``; the host
    enqueues them while the device spins, so its launch cost is hidden.
    Call ms: one call timed by CUDA events from an idle device, which
    includes the host's cost of issuing it (what a caller that waits on
    each call sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device, call = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / per)
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(call)


def timings(kernel, plain, library=None, **reps) -> dict:
    """``time_ms`` of the kernel, its plain version and the library call;
    ``reps`` (reps=, per=, warmup=) for calls too long for the default."""
    k_ms, k_call = time_ms(kernel, **reps)
    p_ms, p_call = time_ms(plain, **reps)
    return {"kernel_ms": k_ms, "kernel_call_ms": k_call, "plain_ms": p_ms,
            "plain_call_ms": p_call,
            "library_ms": None if library is None
            else time_ms(library, **reps)[0]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_fim_diag(dev, B, D, dtype):
    gen = torch.Generator(device=dev).manual_seed(B * 7 + D)
    g = torch.randn((B, D), generator=gen, device=dev).to(dtype)
    old = torch.zeros((D,), device=dev)   # the main path's old=0, ema=0
    got = ops.fim_diag_update(g, old, 0.0, mode="on")
    want = ref.fim_diag_ref(g, old, 0.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=FIM_TOL, atol=FIM_TOL))
    elt = g.element_size()
    b_ms, by = bound_ms(B * D * elt + 2 * D * 4, 2.0 * B * D + 3.0 * D)
    row = {"kernel": "fim_diag", "shape": [B, D], "dtype": str(dtype)[6:],
           "max_err": err, "tol": FIM_TOL,
           **timings(lambda: ops.fim_diag_update(g, old, 0.0, mode="on"),
                     lambda: ref.fim_diag_ref(g, old, 0.0)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(ok, f"fim_diag {B}x{D} {dtype}: max err {err} > {FIM_TOL}")
    return row


def gram_err(got, want) -> float:
    """max over (i, j) of |got_ij - want_ij| / sqrt(want_ii * want_jj): each
    entry against the size of the products it sums, so an entry far below
    the largest (a history row's against another) is held as tightly as
    its own rows allow."""
    d = want.diagonal().clamp_min(0).sqrt()
    scale = torch.outer(d, d).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / scale).max())


def check_gram(dev, n, D):
    gen = torch.Generator(device=dev).manual_seed(n * 13 + D)
    basis = torch.randn((n, D), generator=gen, device=dev)
    got = ops.vlbfgs_gram(basis, mode="on")
    want = ref.vlbfgs_gram_ref(basis)
    torch.cuda.synchronize()
    err, rel = float((got - want).abs().max()), gram_err(got, want)
    b_ms, by = bound_ms(n * D * 4 + n * n * 4, 2.0 * D * n * (n + 1) / 2)
    row = {"kernel": "vlbfgs_gram", "shape": [n, D], "dtype": "float32",
           "max_err": err, "rel_err": rel, "tol": GRAM_TOL,
           **timings(lambda: ops.vlbfgs_gram(basis, mode="on"),
                     lambda: ref.vlbfgs_gram_ref(basis),
                     lambda: torch.matmul(basis, basis.T)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(rel <= GRAM_TOL,
            f"vlbfgs_gram {n}x{D}: relative err {rel} > {GRAM_TOL}")
    require(bool(torch.equal(got, got.T)), "vlbfgs_gram: not symmetric")
    return row


def check_fim_leaves(dev, B, shapes):
    """One client's Fisher diagonal in one call, as core/fim makes it:
    every (B, D_i) leaf in one launch, no old (zeros) and ema = 0; each leaf
    held to the plain version at FIM_TOL, and a second call bit-equal (the
    kernel's fixed summation order).  The bound reads every gradient once
    and writes the results; no single PyTorch call computes it."""
    gen = torch.Generator(device=dev).manual_seed(B)
    grads = [torch.randn((B, math.prod(s)), generator=gen, device=dev)
             for s in shapes]
    before = fim_diag.LAUNCHES
    got = ops.fim_diag_update_leaves(grads, None, 0.0, mode="on")
    launches = fim_diag.LAUNCHES - before
    again = ops.fim_diag_update_leaves(grads, None, 0.0, mode="on")
    want = [ref.fim_diag_ref(g, None, 0.0) for g in grads]
    torch.cuda.synchronize()
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    ok = all(bool(torch.allclose(a, w, rtol=FIM_TOL, atol=FIM_TOL))
             for a, w in zip(got, want))
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    D = sum(g.shape[1] for g in grads)
    b_ms, by = bound_ms(B * D * 4 + D * 4, 2.0 * B * D + D)
    row = {"kernel": "fim_diag", "call": "one client, all leaves",
           "shape": [B, D], "leaves": [list(s) for s in shapes],
           "dtype": "float32", "launches_a_call": launches, "max_err": err,
           "tol": FIM_TOL, "deterministic": same,
           **timings(lambda: ops.fim_diag_update_leaves(grads, None, 0.0,
                                                        mode="on"),
                     lambda: [ref.fim_diag_ref(g, None, 0.0) for g in grads]),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(launches == 1, f"fim_diag over {len(shapes)} leaves: {launches} "
            "launches, want 1")
    require(ok, f"fim_diag leaves at B={B}: max err {err} > {FIM_TOL}")
    require(same, "fim_diag leaves: two calls differ")
    return row


def gram_faults(s, y, g, want) -> dict:
    """Controls for the Gram gate: the kernel run on histories with one
    defect planted, each as a kernel with that defect would read the true
    history, held to the true history's Gram ``want``.  -> fault -> its
    gram_err and, for comparison, its error relative to max|want| (a gate
    on the largest entry)."""
    odd = [i for i, a in enumerate(g) if a.numel() % 4]  # rows off 16 bytes
    wide = max(range(len(g)), key=lambda i: g[i].numel())

    def zero_odd_rows(leaves):
        out = [a.clone() for a in leaves]
        for i in odd:
            out[i][1::2] = 0
        return out

    def only_wide(leaves):
        return [a if i == wide else torch.zeros_like(a)
                for i, a in enumerate(leaves)]

    planted = {
        # the 4-byte copies of the misaligned rows never land
        "misaligned_odd_rows_zeroed": (zero_odd_rows(s), zero_odd_rows(y), g),
        # only the widest leaf of the history is read
        "history_narrow_leaves_dropped": (only_wide(s), only_wide(y), g),
        # the y row group read from s's rows
        "y_read_as_s": (s, s, g),
    }
    scale = float(want.abs().max())
    out = {}
    for name, (fs, fy, fg) in planted.items():
        got = ops.vlbfgs_gram_leaves(fs, fy, fg, mode="on")
        out[name] = {"rel_err": gram_err(got, want),
                     "rel_to_max_entry": float((got - want).abs().max()) / scale}
    return out


def check_gram_leaves(dev, m, shapes):
    """The server step's Gram as core/lbfgs makes it: read in place from an
    m-slot history of the leaves (s, y: (m, *shape)) and g's leaves, one
    launch; held to the plain version on the materialised basis at
    GRAM_TOL (gram_err), exactly symmetric, a second call bit-equal; the
    gate must reject each fault that gram_faults plants.  The library call
    is basis @ basis.T on that basis (built outside the timing)."""
    gen = torch.Generator(device=dev).manual_seed(m)
    s = [torch.randn((m, *sh), generator=gen, device=dev) * 1e-2
         for sh in shapes]
    y = [a * (0.5 + 1.5 * torch.rand(a.shape, generator=gen, device=dev))
         for a in s]
    g = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    basis = torch.cat([torch.cat([a.reshape(m, -1) for a in s], 1),
                       torch.cat([a.reshape(m, -1) for a in y], 1),
                       torch.cat([a.reshape(-1) for a in g])[None]])
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    launches = vlbfgs.LAUNCHES - before
    again = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    want = ref.vlbfgs_gram_ref(basis)
    torch.cuda.synchronize()
    err, rel = float((got - want).abs().max()), gram_err(got, want)
    faults = gram_faults(s, y, g, want)
    n, D = basis.shape
    b_ms, by = bound_ms(n * D * 4 + n * n * 4, 2.0 * D * n * (n + 1) / 2)
    row = {"kernel": "vlbfgs_gram", "call": "read in place from an m-slot "
           "history", "shape": [n, D], "m": m, "leaves": len(shapes),
           "dtype": "float32", "launches_a_call": launches, "max_err": err,
           "rel_err": rel, "tol": GRAM_TOL, "planted_faults": faults,
           **timings(lambda: ops.vlbfgs_gram_leaves(s, y, g, mode="on"),
                     lambda: ops.vlbfgs_gram_leaves(s, y, g, mode="off"),
                     lambda: torch.matmul(basis, basis.T)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(launches == 1, f"vlbfgs_gram leaves: {launches} launches, want 1")
    require(rel <= GRAM_TOL, f"vlbfgs_gram leaves m={m}: relative "
            f"err {rel} > {GRAM_TOL}")
    require(bool(torch.equal(got, got.T)), "vlbfgs_gram leaves: not symmetric")
    require(bool(torch.equal(got, again)), "vlbfgs_gram leaves: two calls "
            "differ")
    for name, f in faults.items():
        require(f["rel_err"] > GRAM_TOL, f"vlbfgs_gram gate: planted fault "
                f"{name} passes ({f['rel_err']} <= {GRAM_TOL})")
    return row


def gram_f64(s, y, g, block: int = ref.GRAM_BLOCK) -> torch.Tensor:
    """The Gram of a history kept a leaf, summed in f64 a leaf and a
    column block at a time: the truth both f32 paths are read against."""
    m = s[0].shape[0]
    out = torch.zeros((2 * m + 1, 2 * m + 1), dtype=torch.float64,
                      device=g[0].device)
    for a, b, c in zip(s, y, g):
        a2, b2, c2 = a.reshape(m, -1), b.reshape(m, -1), c.reshape(1, -1)
        for i in range(0, c2.shape[1], block):
            rows = torch.cat([a2[:, i:i + block].double(),
                              b2[:, i:i + block].double(),
                              c2[:, i:i + block].double()])
            out += rows @ rows.T
    return out


def check_gram_history_bf16(dev, m, shapes):
    """The train step's Gram: an m-slot bf16 history (s, y) of ``shapes``
    beside an f32 g, read in place in one launch; held to the plain
    version (f32 products a leaf and a column block at a time) and to the
    f64 Gram at GRAM_TOL (gram_err), exactly symmetric, a second call
    bit-equal.  The bound reads each bf16 row and g once.  No one library
    call takes the leaves and dtypes together, so the library time is
    torch.matmul(b, b.T) summed over the leaves: each leaf's f32
    (2m+1, n_i) basis b built in turn outside the timing, timed, freed
    (the same work as the kernel's); the largest leaf's time is kept
    beside it as ``library_largest_leaf_ms``."""
    gen = torch.Generator(device=dev).manual_seed(m + 1)
    bf16 = torch.bfloat16
    s, y, g = [], [], []
    for sh in shapes:
        a = torch.randn((m, *sh), generator=gen, device=dev, dtype=bf16)
        s.append(a.mul_(1e-2))
        r = torch.rand((m, *sh), generator=gen, device=dev, dtype=bf16)
        y.append(r.mul_(1.5).add_(0.5).mul_(a))
        g.append(torch.randn(sh, generator=gen, device=dev))
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    launches = vlbfgs.LAUNCHES - before
    again = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    want = ops.vlbfgs_gram_leaves(s, y, g, mode="off")
    torch.cuda.synchronize()
    err, rel = float((got - want).abs().max()), gram_err(got, want)
    truth = gram_f64(s, y, g)
    f64 = {"kernel": gram_err(got.double(), truth),
           "plain": gram_err(want.double(), truth)}
    del truth
    n, D = 2 * m + 1, sum(x.numel() for x in g)
    reps = dict(reps=5, per=2, warmup=1)
    times = timings(lambda: ops.vlbfgs_gram_leaves(s, y, g, mode="on"),
                    lambda: ops.vlbfgs_gram_leaves(s, y, g, mode="off"),
                    **reps)
    big = max(range(len(g)), key=lambda i: g[i].numel())
    leaf_ms = []
    for a, b, c in zip(s, y, g):
        basis = torch.cat([a.reshape(m, -1).float(), b.reshape(m, -1).float(),
                           c.reshape(1, -1)])
        leaf_ms.append(time_ms(lambda: torch.matmul(basis, basis.T),
                               **reps)[0])
        del basis
    times["library_ms"] = sum(leaf_ms)
    times["library_largest_leaf_ms"] = leaf_ms[big]
    b_ms, by = bound_ms(D * (2 * m * 2 + 4) + n * n * 4,
                        2.0 * D * n * (n + 1) / 2)
    row = {"kernel": "vlbfgs_gram", "call": "bf16 history read in place "
           "(the LLM train step's)", "shape": [n, D], "m": m,
           "leaves": len(shapes), "dtype": "bfloat16 s, y; float32 g",
           "launches_a_call": launches, "max_err": err, "rel_err": rel,
           "f64_rel_err": f64, "tol": GRAM_TOL, **times,
           "library_is": f"torch.matmul(b, b.T) summed over the {len(g)} "
           "leaves' f32 bases (the largest alone: "
           f"{g[big].numel()} columns)",
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(launches == 1, f"vlbfgs_gram bf16 history: {launches} launches, "
            "want 1")
    require(rel <= GRAM_TOL, f"vlbfgs_gram bf16 history m={m}: relative err "
            f"{rel} > {GRAM_TOL}")
    require(f64["kernel"] <= GRAM_TOL, f"vlbfgs_gram bf16 history m={m}: "
            f"relative err {f64['kernel']} against f64 > {GRAM_TOL}")
    require(bool(torch.equal(got, got.T)), "vlbfgs_gram bf16: not symmetric")
    require(bool(torch.equal(got, again)), "vlbfgs_gram bf16: two calls "
            "differ")
    return row


def check_int8(dev, shape):
    """One leaf through the payload kernel (one launch pair), bit-identical
    to the plain version; its scale to the correctly rounded max/127."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev) * 0.05
    u = torch.rand(shape, generator=gen, device=dev)
    s = ref.int8_scale(x)
    amax = float(x.abs().max())
    require(float(s) == float(np.float32(amax) / np.float32(127)),
            f"int8_scale on the card is not the correctly rounded "
            f"max/127 for {shape}")
    (got,), scales = codec_ops.int8_roundtrip_leaves([x], [u])
    want = ref.int8_roundtrip_ref(x, u, s)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n = x.numel()
    b_ms, by = bound_ms(12.0 * n + 4, 8.0 * n)
    row = {"kernel": "int8_roundtrip", "shape": list(shape), "dtype": "float32",
           "max_err": err, "tol": 0.0,
           **timings(lambda: codec_ops.int8_roundtrip_leaves([x], [u]),
                     lambda: ref.int8_roundtrip_ref(x, u)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
            f"int8_roundtrip {shape}: not bit-identical (max err {err})")
    require(bool(torch.equal(scales.view(torch.int32),
                             s.reshape(1).view(torch.int32))),
            f"int8_roundtrip {shape}: scale {float(scales[0])} != {float(s)}")
    return row


def check_int8_payload(dev, shapes):
    """Every leaf of one payload in one call: one launch pair, each leaf
    bit-identical to the per-leaf plain version and each scale to
    ref.int8_scale.  The bound reads x and u and writes out once (12 B an
    element) and writes the scales."""
    gen = torch.Generator(device=dev).manual_seed(len(shapes))
    half = len(shapes) // 2
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05
          for s in shapes[:half]]
    xs += [torch.randn(s, generator=gen, device=dev).square() * 1e-4
           for s in shapes[half:]]       # Fisher-like Γ leaves
    us = [torch.rand(s, generator=gen, device=dev) for s in shapes]
    before = codec_ops.LAUNCHES
    got, scales = codec_ops.int8_roundtrip_leaves(xs, us)
    pairs = codec_ops.LAUNCHES - before
    want_s = [ref.int8_scale(x) for x in xs]
    want = [ref.int8_roundtrip_ref(x, u, s) for x, u, s in zip(xs, us, want_s)]
    torch.cuda.synchronize()
    same = all(bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
               for g, w in zip(got, want))
    same_s = bool(torch.equal(scales.view(torch.int32),
                              torch.stack(want_s).view(torch.int32)))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    n = sum(x.numel() for x in xs)
    b_ms, by = bound_ms(12.0 * n + 4 * len(xs), 8.0 * n)
    row = {"kernel": "int8_roundtrip", "payload": "(g, Γ) of fim_lbfgs",
           "shape": [list(s) for s in shapes], "leaves": len(shapes), "n": n,
           "dtype": "float32", "launch_pairs": pairs, "max_err": err,
           "tol": 0.0,
           **timings(lambda: codec_ops.int8_roundtrip_leaves(xs, us),
                     lambda: [ref.int8_roundtrip_ref(x, u)
                              for x, u in zip(xs, us)]),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(pairs == 1, f"int8 payload of {len(shapes)} leaves: {pairs} "
            "launch pairs, want 1")
    require(same, f"int8 payload: not bit-identical (max err {err})")
    require(same_s, "int8 payload: scales differ from ref.int8_scale")
    return row


def check_topk(dev, n, k, cluster, capacity):
    """The select on a (g, Γ)-like payload: half gradient-like normals,
    half small Fisher-like squares.  Bit-identical to the plain version,
    exactly k kept, on the cluster path iff n is within its capacity.  The
    four-launch path (the design before the cluster path) is timed on the
    same input beside it, and checked too.  The nearest library call,
    torch.topk of |x|, is an exact top-k with other ties: timed only as a
    yardstick."""
    gen = torch.Generator(device=dev).manual_seed(n + k)
    half = n // 2
    x = torch.cat([torch.randn((half,), generator=gen, device=dev) * 1e-2,
                   torch.randn((n - half,), generator=gen, device=dev)
                   .square() * 1e-4])
    before = codec_ops.TOPK_CLUSTER_LAUNCHES
    got = ops.topk_select(x, k, mode="on")
    path = "cluster" if codec_ops.TOPK_CLUSTER_LAUNCHES > before else "tiles"
    want = ref.topk_select_ref(x, k)
    tiles = codec_ops.topk_select_tiles(x, k)
    torch.cuda.synchronize()
    same = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
    same_tiles = bool(torch.equal(tiles.view(torch.int32),
                                  want.view(torch.int32)))
    kept = int(torch.count_nonzero(got))
    err = float((got - want).abs().max())
    tiles_ms, tiles_call = time_ms(lambda: codec_ops.topk_select_tiles(x, k))
    # each input read once and the output written once; integer work only
    b_ms, by = bound_ms(8.0 * n, 0.0)
    row = {"kernel": "topk_select", "shape": [n], "k": k, "dtype": "float32",
           "path": path, "cluster": cluster if path == "cluster" else None,
           "capacity": capacity, "max_err": err, "tol": 0.0, "kept": kept,
           **timings(lambda: ops.topk_select(x, k, mode="on"),
                     lambda: ref.topk_select_ref(x, k),
                     lambda: torch.topk(x.abs(), k)),
           "four_launch_ms": tiles_ms, "four_launch_call_ms": tiles_call,
           "library": "torch.topk(x.abs(), k): nearest library call, exact "
                      "top-k, different ties",
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(same, f"topk_select n={n} k={k}: not bit-identical (max err {err})")
    require(same_tiles, f"topk_select n={n} k={k}: the four-launch path is "
            "not bit-identical")
    require(kept == k, f"topk_select n={n} k={k}: kept {kept}")
    require(path == ("cluster" if n <= capacity else "tiles"),
            f"topk_select n={n}: ran the {path} path, capacity {capacity}")
    return row


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep in one head: the work this input
    needs, whatever the kernel's tiles also touch."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = i if causal else np.full(S, S - 1)
    return int((hi - lo + 1).sum())


def check_flash(dev, B, H, KV, S, hd, causal, window, dtype):
    """The kernel against ref.flash_attention_ref on q (B,H,S,hd), k, v
    (B,KV,S,hd).  The bound counts 4*hd flops a live pair (q.k and p.v) at
    the tensor cores' bf16 rate or the f32 rate, or each input read and
    the output written once, whichever is longer.  The library call is
    scaled_dot_product_attention, timed only."""
    gen = torch.Generator(device=dev).manual_seed(S * 31 + H + hd)
    q = torch.randn((B, H, S, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, KV, S, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, KV, S, hd), generator=gen, device=dev).to(dtype)
    tc_before = flash_attention.TC_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window, mode="on")
    path = ("tensor_core" if flash_attention.TC_LAUNCHES > tc_before
            else "simt")
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        tol = {"rtol": FLASH_BF16_RTOL, "atol": FLASH_BF16_ATOL}
    else:
        tol = {"rtol": FLASH_F32_TOL, "atol": FLASH_F32_TOL}
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), **tol))
    del want
    flops = 4.0 * hd * live_pairs(S, causal, window) * B * H
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    b_ms, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S
                        if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    mask = None
    if window:
        i = torch.arange(S, device=dev)
        mask = i[None, :] > i[:, None] - window
        if causal:
            mask &= i[:, None] >= i[None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    row = {"kernel": "flash_attention", "shape": [B, H, KV, S, hd],
           "causal": causal, "window": window, "dtype": str(dtype)[6:],
           "path": path, "max_err": err, "tol": tol,
           **timings(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 window=window, mode="on"),
                     lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                     window=window),
                     library),
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "flops": flops, "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(ok, f"flash_attention {row['shape']} causal={causal} "
            f"window={window} {dtype}: max err {err} > {tol}")
    require(path == ("tensor_core" if dtype == torch.bfloat16 else "simt"),
            f"flash_attention {dtype} ran the {path} kernel")
    return row


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def expected_ledger(plan, rounds: int, cohort: int) -> dict:
    """CommLedger.summary() the plan predicts, accumulated with the
    ledger's own float operations."""
    down = up_star = up_tree = scal = 0.0
    depth = max(1, math.ceil(math.log2(max(cohort, 2))))
    for _ in range(rounds):
        for ph in plan.phases:
            down += ph.down_floats * 4 * cohort
            up_star += ph.wire_up_bytes() * cohort
            up_tree += ph.wire_up_bytes() * (depth if ph.aggregatable
                                             else cohort)
        scal += (plan.round_scalars + plan.scalars_per_client * cohort) * 4
    return {"rounds": rounds, "down_MB_per_round": down / rounds / 1e6,
            "up_star_MB_per_round": up_star / rounds / 1e6,
            "up_tree_MB_per_round": up_tree / rounds / 1e6,
            "scalar_KB_per_round": scal / rounds / 1e3}


def expected_launches(alg: str, compress: str, rounds: int,
                      cohort: int) -> dict:
    """Kernel launches the code of ``alg`` implies for a run without
    FedOVA (whose counts depend on each client's label set)."""
    # fim_diag: one launch a client grad_fim call, all leaves at once
    fim = {"fim_lbfgs": cohort * rounds,
           "feddane": cohort * rounds}.get(alg, 0)
    # one int8 launch pair a client payload; every main-path top-k call on
    # the one-launch cluster path
    topk = cohort * rounds if compress == TOPK else 0
    return {"fim_diag": fim,
            "vlbfgs_gram": rounds if alg == "fim_lbfgs" else 0,
            "int8_roundtrip": (cohort * rounds
                               if compress == "int8" and alg == "fim_lbfgs"
                               else 0),
            "topk_select": topk, "topk_select_cluster": topk,
            "flash_attention": 0, "flash_attention_tc": 0}


def drive(train, test, alg: str, compress: str, rounds: int, **overrides):
    """``rounds`` rounds of ``alg`` from fresh counts; -> (run, history,
    setup seconds, per-round seconds, launches, cohorts)."""
    reset_counts()
    t0 = time.perf_counter()
    run = FederatedRun(FMNIST_CNN,
                       FedConfig(compress=compress, **{**RUN, **overrides}),
                       train, test, alg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cohorts = []
    sample = run.sample_clients

    def recording():
        out = sample()
        cohorts.append([int(c) for c in out])
        return out

    run.sample_clients = recording
    history, round_s = [], []
    for t in range(rounds):
        t0 = time.perf_counter()
        info = run.round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        info["round"] = t + 1
        history.append(info)
    launches = read_counts()
    run.sample_clients = sample
    return run, history, setup_s, round_s, launches, cohorts


def check_run(run, history, launches, want, alg, compress, rounds):
    losses = [h["loss"] for h in history]
    tag = f"{alg}/{compress}"
    require(all(math.isfinite(v) for v in losses), f"{tag}: loss not finite")
    require(all(h["cohort"] == COHORT for h in history), f"{tag}: cohort size")
    require(launches == want, f"{tag}: launches {launches} != {want}")
    ledger = run.ledger.summary()
    plan_ledger = expected_ledger(run.plan, rounds, COHORT)
    require(ledger == plan_ledger,
            f"{tag}: ledger {ledger} != plan {plan_ledger}")
    return losses


def main_path(train, test, compress: str, alg: str = "fim_lbfgs"):
    run, history, setup_s, round_s, launches, _ = drive(
        train, test, alg, compress, ROUNDS)
    acc = run.evaluate()
    n_leaves = len(tree_leaves(run.params))
    want = expected_launches(alg, compress, ROUNDS, COHORT)
    emit({"phase": "main_path", "algorithm": alg, "compress": compress,
          "d": run.strategy.n_params(), "leaves": n_leaves,
          "cohorts": [h["cohort"] for h in history],
          "losses": [h["loss"] for h in history], "accuracy": acc,
          "setup_s": setup_s, "round_s": round_s, "launches": launches,
          "ef_clients": len(run._ef_residual), "ledger": run.ledger.summary()})
    losses = check_run(run, history, launches, want, alg, compress, ROUNDS)
    require(losses[-1] < losses[0],
            f"{alg}/{compress}: last loss {losses[-1]} not below first "
            f"{losses[0]}")
    require(0.0 <= acc <= 1.0, f"{alg}/{compress}: accuracy {acc}")
    if compress == TOPK:
        check_error_feedback(run)
    return run, launches


def check_error_feedback(run) -> None:
    """On one client of the last cohort, through the kernel: exactly k
    coordinates are sent and sent + new residual == payload + old
    residual, coordinate for coordinate."""
    cid = min(run._ef_residual)
    payload, _ = run.strategy.client_step(run._client_data(cid),
                                          np.random.default_rng(0))
    old = run._ef_residual[cid]
    gen = torch.Generator(device=run.device).manual_seed(0)
    sent, res = run.codec.roundtrip(payload, gen, old)
    leaves = list(zip(tree_leaves(sent), tree_leaves(res),
                      tree_leaves(payload), tree_leaves(old), strict=True))
    exact = all(bool(torch.equal(s + r, p + o)) for s, r, p, o in leaves)
    n = sum(p.numel() for _, _, p, _ in leaves)
    kept = sum(int(torch.count_nonzero(s)) for s, _, _, _ in leaves)
    emit({"phase": "error_feedback", "algorithm": run.algorithm,
          "client": cid, "n": n, "k": run.codec._k(n), "kept": kept,
          "exact": exact})
    require(exact, f"{run.algorithm}: sent + residual != payload + old "
            "residual")
    require(kept == run.codec._k(n), f"{run.algorithm}: kept {kept} of "
            f"{n}, billed {run.codec._k(n)}")


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def _rel(x, y) -> float:
    fx, fy = _flat(x), _flat(y)
    return float((fx - fy).norm()) / max(float(fy.norm()), 1e-30)


def kernels_off_beside_auto(run_auto, train, test, compress: str):
    """One more round from the auto run's state, on a kernels="off" run
    with the same state, sampling stream, codec stream and error-feedback
    residuals.  The off round launches no kernel; afterwards every part of
    the strategy's state agrees: params and, for fim_lbfgs, the Fisher
    diagonal (this round's fim_diag output) and the history pairs (this
    round's Gram and codec), and under top-k every residual."""
    alg = run_auto.algorithm
    run_off = FederatedRun(FMNIST_CNN,
                           FedConfig(compress=compress, kernels="off", **RUN),
                           train, test, alg, device="cuda")
    run_off.strategy.load_state_dict(run_auto.strategy.state_dict())
    run_off.rng.bit_generator.state = run_auto.rng.bit_generator.state
    run_off.codec_generator.set_state(run_auto.codec_generator.get_state())
    run_off._ef_residual = {c: tree_map(torch.clone, r)
                            for c, r in run_auto._ef_residual.items()}
    start = _flat(run_auto.params).clone()
    run_auto.round()
    reset_counts()
    run_off.round()
    torch.cuda.synchronize()
    off_launches = read_counts()
    require(not any(off_launches.values()),
            f"{alg}/{compress}: kernels='off' launched {off_launches}")

    if compress == "int8":
        state_tol = INT8_STATE_TOL
    elif compress == TOPK:
        state_tol = TOPK_STATE_TOL
    else:
        state_tol = STEP_TOL
    parts = {"params": (run_auto.params, run_off.params, state_tol)}
    counters = {}
    if alg == "fim_lbfgs":
        a, b = run_auto.strategy.opt_state, run_off.strategy.opt_state
        parts.update({
            "fim_diag": (a.fim.diag, b.fim.diag,
                         FISHER_TOL if compress == "none" else state_tol),
            "history_s": (a.history.s, b.history.s, state_tol),
            "history_y": (a.history.y, b.history.y, state_tol)})
        counters = {name: (int(x), int(y)) for name, (x, y) in {
            "history_idx": (a.history.idx, b.history.idx),
            "history_count": (a.history.count, b.history.count),
            "fim_steps": (a.fim.steps, b.fim.steps),
            "step": (a.step, b.step)}.items()}
    rel = {name: _rel(x, y) for name, (x, y, _) in parts.items()}
    tol = {name: t for name, (_, _, t) in parts.items()}
    swaps = []
    if compress == TOPK:
        require(sorted(run_auto._ef_residual) == sorted(run_off._ef_residual),
                f"{alg}: residuals kept for other clients")
        res = []
        for c in sorted(run_off._ef_residual):
            fa = _flat(run_auto._ef_residual[c])
            fb = _flat(run_off._ef_residual[c])
            alike = (fa == 0) == (fb == 0)
            swaps.append(int((~alike).sum()))
            res.append(float((fa - fb)[alike].norm())
                       / max(float(fb[alike].norm()), 1e-30))
        rel["residual_max"], tol["residual_max"] = max(res), TOPK_STATE_TOL
        k = run_auto.codec._k(fa.numel())
        require(max(swaps) <= TOPK_SWAP_SHARE * k,
                f"{alg}: kernels='off' vs 'auto': {max(swaps)} coordinates "
                f"swapped sides of the threshold (k = {k})")
    step = float((_flat(run_off.params) - start).norm())
    emit({"phase": "kernels_off_vs_auto", "algorithm": alg,
          "compress": compress, "step_norm": step, "rel": rel, "tol": tol,
          "counters": counters, "swapped_per_client": swaps})
    require(step > 0, f"{alg}/{compress}: kernels='off' round took no step")
    for name, r in rel.items():
        require(r <= tol[name], f"{alg}/{compress}: kernels='off' vs 'auto': "
                f"{name} differs by {r} > {tol[name]} (relative)")
    for name, (x, y) in counters.items():
        require(x == y, f"{alg}/{compress}: kernels='off' vs 'auto': {name} "
                f"{x} != {y}")


def other_strategy(train, test, alg: str) -> dict:
    """2 rounds of ``alg`` under compress="none": ledger == plan and the
    fim_diag/Gram launches its code implies; the second round's time is
    the steady one."""
    rounds = 2
    overrides = STRATEGY_OVERRIDES.get(alg, {})
    run, history, setup_s, round_s, launches, cohorts = drive(
        train, test, alg, "none", rounds, **overrides)
    if alg == "fedova_lbfgs":
        # one grad_fim (one fim_diag launch) and one FIM-L-BFGS step (one
        # Gram) per class present in each selected client's data
        trained = sum(len(np.unique(train.y[run.partition[c]]))
                      for cohort in cohorts for c in cohort)
        want = {**dict.fromkeys(COUNTERS, 0),
                "fim_diag": trained, "vlbfgs_gram": trained}
    else:
        want = expected_launches(alg, "none", rounds, COHORT)
    row = {"phase": "strategy", "algorithm": alg, "overrides": overrides,
           "losses": [h["loss"] for h in history], "setup_s": setup_s,
           "round_s": round_s, "steady_round_s": round_s[-1],
           "launches": launches, "ledger": run.ledger.summary()}
    emit(row)
    check_run(run, history, launches, want, alg, "none", rounds)
    return row


def round_breakdown(run) -> None:
    """Where a round's time goes: one client step (gradient + per-example
    Fisher), one int8 and one top-k payload round-trip and one aggregate +
    server step, each the median of 3 synchronised host-clock timings."""
    sizes = [len(p) for p in run.partition]
    k = max(range(len(sizes)), key=sizes.__getitem__)
    data = run._client_data(k)
    int8, topk = codecs.make("int8"), codecs.make(TOPK)
    gen = torch.Generator(device=run.device).manual_seed(0)

    def timed(fn, reps=3):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)

    (payload, _), client_s = timed(lambda: run.strategy.client_step(data, None))
    _, int8_s = timed(lambda: int8.roundtrip(payload, gen))
    _, topk_s = timed(lambda: topk.roundtrip(payload, gen, payload))
    weights = torch.full((COHORT,), float(sizes[k]), device=run.device)
    snapshot = run.strategy.state_dict()

    def server():
        run.strategy.load_state_dict(snapshot)
        run.strategy.server_step(run.strategy.aggregate([payload] * COHORT,
                                                        weights))

    _, server_s = timed(server)
    emit({"phase": "round_breakdown", "client_examples": sizes[k],
          "client_step_s": client_s, "int8_payload_s": int8_s,
          "topk_payload_s": topk_s, "aggregate_server_step_s": server_s,
          "round_estimate_s": COHORT * client_s + server_s})


# ---------------------------------------------------------------------------
# phase "edge": the resource-constrained edge runtime under fim_lbfgs
# ---------------------------------------------------------------------------
def edge_fingerprint(run) -> dict:
    """tests/test_determinism.py's fingerprint (ledger, cohorts,
    exclusions, drops, bandwidths, clock, energy); async runs add their
    pending expiries, held spectrum and buffer sizes."""
    edge = run.edge
    fp = {"ledger": {f: getattr(run.ledger, f) for f in EDGE_LEDGER_FIELDS},
          "drops": [tuple(sorted(d.dropped)) for d in edge.decisions],
          "excluded": [tuple(sorted(d.excluded)) for d in edge.decisions],
          "cohorts": [tuple(sorted(d.selected)) for d in edge.decisions],
          "clock_s": edge.clock.now, "energy_j": edge.energy_j,
          "bandwidths": [tuple(np.asarray(d.bandwidth()).tolist())
                         for d in edge.decisions]}
    if edge.async_agg is not None:
        fp["expiry"] = sorted(edge._expiry.items())
        fp["held"] = sorted(edge._held_hz.items())
        fp["aggregated"] = [h.get("cohort") for h in edge.history]
    return fp


def edge_instrument(run) -> dict:
    """Time the edge layer's host work on ``run`` (``sample_clients``,
    which runs ``edge.decide``, and the round's finish: the sync clock or
    the async dispatch and buffer pop) and record each popped async
    entry's staleness."""
    acc = {"edge_s": 0.0, "staleness": []}

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            acc["edge_s"] += time.perf_counter() - t0
            return out
        return wrapper

    run.sample_clients = timed(run.sample_clients)
    run._edge_sync_finish = timed(run._edge_sync_finish)
    agg = run.edge.async_agg
    if agg is not None:
        run.edge.dispatch_async = timed(run.edge.dispatch_async)
        run.edge.pop_async_buffer = timed(run.edge.pop_async_buffer)
        pop = agg.pop_buffer

        def popping(size=None):
            version = agg.version
            entries, w = pop(size)
            acc["staleness"].extend(version - e.version for e in entries)
            return entries, w

        agg.pop_buffer = popping
    return acc


def edge_state_check(run_auto, run_off, compress: str, tag: str) -> dict:
    """Phase 3's kernels="off" beside "auto" bounds on one round from the
    same state: params, Fisher diagonal and history, the L-BFGS counters,
    and the per-client top-k residuals (alike coordinates, swaps counted
    against the client's own k)."""
    a, b = run_auto.strategy.opt_state, run_off.strategy.opt_state
    # adaptive_codec's per-client top-k keeps residuals under "none"
    if compress == "int8":
        tol = INT8_STATE_TOL
    else:
        tol = TOPK_STATE_TOL if run_auto._ef_residual else STEP_TOL
    parts = {"params": (run_auto.params, run_off.params, tol),
             "fim_diag": (a.fim.diag, b.fim.diag,
                          FISHER_TOL if tol == STEP_TOL else tol),
             "history_s": (a.history.s, b.history.s, tol),
             "history_y": (a.history.y, b.history.y, tol)}
    rel = {name: _rel(x, y) for name, (x, y, _) in parts.items()}
    for name, (_, _, t) in parts.items():
        require(rel[name] <= t, f"{tag}: kernels='off' vs 'auto': {name} "
                f"differs by {rel[name]} > {t} (relative)")
    for name, (x, y) in {"history_idx": (a.history.idx, b.history.idx),
                         "history_count": (a.history.count, b.history.count),
                         "fim_steps": (a.fim.steps, b.fim.steps),
                         "step": (a.step, b.step)}.items():
        require(int(x) == int(y), f"{tag}: kernels='off' vs 'auto': {name} "
                f"{int(x)} != {int(y)}")
    require(sorted(run_auto._ef_residual) == sorted(run_off._ef_residual),
            f"{tag}: residuals kept for other clients")
    dec, swaps = run_auto._decision, 0
    for c in run_auto._ef_residual:
        fa, fb = _flat(run_auto._ef_residual[c]), _flat(run_off._ef_residual[c])
        alike = (fa == 0) == (fb == 0)
        n_swap = int((~alike).sum())
        codec = dec.codec_for(c) if c in dec.survivors else None
        k = codec._k(fa.numel()) if codec is not None else 0
        require(n_swap <= TOPK_SWAP_SHARE * max(k, 1),
                f"{tag}: client {c}: {n_swap} coordinates swapped sides of "
                f"the threshold (k = {k})")
        r = float((fa - fb)[alike].norm()) / max(float(fb[alike].norm()),
                                                 1e-30)
        require(r <= TOPK_STATE_TOL, f"{tag}: client {c}: residual differs "
                f"by {r} > {TOPK_STATE_TOL}")
        rel["residual_max"] = max(rel.get("residual_max", 0.0), r)
        swaps = max(swaps, n_swap)
    rel["swaps_max"] = swaps
    return rel


def edge_run(train, test, name: str, card: str, fleet: str = "off") -> tuple:
    """One edge run of ``ROUNDS`` fim_lbfgs rounds on the card, a
    kernels="off" run beside it in lockstep (before each round its
    strategy state, residuals and codec stream are set to the auto run's,
    so each round is phase 3's one-round comparison from the same
    state); the simulation must not notice the kernel mode, and each
    round's launches must be those its decisions imply.  Returns (the
    auto run, its launches, this run's row, its fingerprint)."""
    spec = EDGE_RUNS[name]
    compress = spec["compress"]
    edge = EdgeConfig(channel=EDGE_CHANNEL, device=EDGE_FLEET, fleet=fleet,
                      **spec["edge"])
    runs = {}
    for kernels in ("auto", "off"):
        runs[kernels] = FederatedRun(
            FMNIST_CNN, FedConfig(edge=edge, compress=compress,
                                  kernels=kernels, **RUN),
            train, test, "fim_lbfgs", device="cuda",
            tracer=Tracer() if spec["traced"] and kernels == "auto" else None)
    auto, off = runs["auto"], runs["off"]
    tag = f"edge {name} fleet={fleet}"
    acc = edge_instrument(auto)
    total = dict.fromkeys(COUNTERS, 0)
    want = dict.fromkeys(COUNTERS, 0)
    rows, rel_max, coded_k = [], {}, set()
    for t in range(ROUNDS):
        off.strategy.load_state_dict(auto.strategy.state_dict())
        off._ef_residual = {c: tree_map(torch.clone, r)
                            for c, r in auto._ef_residual.items()}
        off.codec_generator.set_state(auto.codec_generator.get_state())
        edge_before = acc["edge_s"]
        reset_counts()
        t0 = time.perf_counter()
        info = auto.round()
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        launches = read_counts()
        reset_counts()
        info_off = off.round()
        torch.cuda.synchronize()
        off_launches = read_counts()
        require(not any(off_launches.values()),
                f"{tag}: kernels='off' launched {off_launches}")
        keys = ("cohort", "dropped", "aggregated", "wall_s", "sim_time_s",
                "energy_j", "barrier_s")
        require({k: info.get(k) for k in keys}
                == {k: info_off.get(k) for k in keys},
                f"{tag}: round {t + 1}: kernels='off' record {info_off} != "
                f"{info}")
        require(all(math.isfinite(v) for k, v in info.items()
                    if isinstance(v, float)), f"{tag}: record {info}")
        for key, r in edge_state_check(auto, off, compress, tag).items():
            rel_max[key] = max(rel_max.get(key, 0.0), r)
        # the launches this round's decisions imply: fim_diag one a landed
        # client, topk_select one a landed client with its own codec, int8
        # one a landed client's payload, the Gram one a non-empty server
        # step (sync: anyone landed; async: the buffer popped entries)
        dec = auto._decision
        landed = list(dec.survivors)
        coded = [dec.codec_for(c) for c in landed
                 if dec.codec_for(c) is not None]
        coded_k.update(codec._k(2 * auto.strategy.n_params())
                       for codec in coded)
        stepped = (info.get("aggregated", 0)
                   if auto.edge.async_agg is not None else len(landed))
        round_want = {**dict.fromkeys(COUNTERS, 0),
                      "fim_diag": len(landed), "vlbfgs_gram": int(stepped > 0),
                      "int8_roundtrip": len(landed) if compress == "int8" else 0,
                      "topk_select": len(coded),
                      "topk_select_cluster": len(coded)}
        require(launches == round_want, f"{tag}: round {t + 1}: launches "
                f"{launches} != {round_want} from its decisions")
        for key in COUNTERS:
            total[key] += launches[key]
            want[key] += round_want[key]
        rows.append({"round_s": round_s,
                     "edge_s": acc["edge_s"] - edge_before, **info})
    fp_auto, fp_off = edge_fingerprint(auto), edge_fingerprint(off)
    require(fp_auto == fp_off, f"{tag}: kernels='off' fingerprint differs")
    row = {"phase": "edge", "run": name, "card": card, "fleet": fleet,
           "fleet_active": auto.edge.fleet_active(),
           "policy": edge.scheduler, "mode": edge.mode, "compress": compress,
           "rounds": ROUNDS,
           "host_s_per_round": [r["round_s"] for r in rows],
           "edge_host_s_per_round": [r["edge_s"] for r in rows],
           "sim_time_s": [r.get("sim_time_s") for r in rows],
           "wall_s": [r.get("wall_s") for r in rows],
           "energy_j": [r.get("energy_j") for r in rows],
           "barrier_s": [r.get("barrier_s") for r in rows],
           "cohort": [r["cohort"] for r in rows],
           "dropped": [r.get("dropped", 0) for r in rows],
           "aggregated": [r.get("aggregated") for r in rows],
           "losses": [r.get("loss") for r in rows],
           "deadline_dropped_total": auto.edge.deadline_dropped_total,
           "excluded_total": auto.edge.dropped_total,
           "unavailable_total": auto.edge.unavailable_total,
           "distinct_k": len(coded_k),
           "k_range": [min(coded_k), max(coded_k)] if coded_k else None,
           "stale_entries": sum(1 for s in acc["staleness"] if s > 0),
           "launches": total, "launches_from_decisions": want,
           "off_beside_auto_rel_max": rel_max,
           "fingerprint_equal_kernels_off": True}
    return auto, total, row, fp_auto


def edge_phase(train, test, card: str) -> dict:
    """E1 (per-client path and fleet fast path), E2 and E3: each beside
    its kernels="off" twin, with the gates of the edge runtime: the
    fleet fast path's fingerprint equal to the per-client path's, E1's
    PlanAudit balanced against its ledger, each run exercising what it
    claims.  Returns the launches of the four auto runs."""
    t0 = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    fps = {}
    for name, fleet in (("E1", "off"), ("E1", "on"), ("E2", "off"),
                        ("E3", "off")):
        run, launches, row, fps[name, fleet] = edge_run(train, test, name,
                                                        card, fleet)
        for key in COUNTERS:
            total[key] += launches[key]
        if name == "E1":
            require(run.edge.fleet_active() == (fleet == "on"),
                    f"E1 fleet={fleet}: fleet path active: "
                    f"{run.edge.fleet_active()}")
            audit = run.tracer.audit
            audit.verify(run.ledger)
            row["audit"] = {"rows": len(audit.rows),
                            "shortfall_rows": len(audit.shortfall_rows()),
                            "billed_total": audit.billed_total(),
                            "planned_total": audit.planned_total(),
                            "spans": len(run.tracer.spans),
                            "events": len(run.tracer.events)}
            require(len(audit.shortfall_rows())
                    == run.edge.deadline_dropped_total,
                    f"E1: {len(audit.shortfall_rows())} audit shortfall rows "
                    f"for {run.edge.deadline_dropped_total} deadline drops")
            require(run.edge.deadline_dropped_total > 0,
                    "E1: no client was cut off at the deadline")
        if name == "E2":
            require(row["distinct_k"] >= 2,
                    f"E2: {row['distinct_k']} distinct per-client k")
        if name == "E3":
            require(row["stale_entries"] > 0, "E3: no stale entry aggregated")
            require(run.edge.deadline_dropped_total > 0,
                    "E3: no dispatch expired")
        emit(row)
        del run
    require(fps["E1", "on"] == fps["E1", "off"],
            "E1: the fleet fast path's fingerprint differs from the "
            "per-client path's")
    emit({"phase": "edge_gates", "seconds": time.perf_counter() - t0,
          "fleet_on_equals_off": True, "kernels_off_equals_auto": True,
          "launches": total})
    return total


# ---------------------------------------------------------------------------
# phase "cohort": the cohort simulator (fed/simulator.py) at full width
# ---------------------------------------------------------------------------
def cohort_slot_examples(run) -> int:
    """Examples a cohort slot takes: COHORT_B, or the smallest non-empty
    client's size where one holds fewer."""
    return min(COHORT_B, min(len(p) for p in run.partition if len(p)))


def cohort_batches(run, b: int) -> tuple[list, dict, torch.Tensor]:
    """One round's stacked cohort: the run's numpy rng picks the clients
    (``sample_clients``: COHORT of the non-IID-2 clients) and then ``b``
    of each client's examples without replacement.  -> (client ids,
    {"x": (K, b, 28, 28, 1), "y": (K, b)}, the (K,) weights)."""
    clients = [int(c) for c in run.sample_clients()]
    rows = [run.partition[c][run.rng.choice(len(run.partition[c]), size=b,
                                            replace=False)]
            for c in clients]
    idx = torch.from_numpy(np.stack(rows)).to(run.device)
    weights = torch.full((len(clients),), float(b), device=run.device)
    return clients, {"x": run._train_x[idx], "y": run._train_y[idx]}, weights


def recording_slots(strategy) -> dict:
    """Keep the payloads ``strategy``'s cohort path last received (the
    codec round-trip of every slot) in the returned dict."""
    seen = {}
    compress = strategy.compress_slots

    def recording(slots, generator):
        seen["slots"] = compress(slots, generator)
        return seen["slots"]

    strategy.compress_slots = recording
    return seen


def payload_gate(got, want, compress: str, k: int, tag: str) -> dict:
    """The cohort's received payloads against another path's, slot by
    slot: under int8 each coordinate within one level of its leaf
    (max|x| / 127, with 1 % for the two paths' own maxima), under top-k
    the coordinates that changed sides of the threshold at most
    TOPK_SWAP_SHARE of the k sent.  -> the worst reading."""
    worst = {"levels": 0.0, "swaps": 0}
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if compress == "int8":
            for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
                level = max(float(x.abs().max()), float(y.abs().max())) / 127
                if level == 0:
                    continue
                r = float((x - y).abs().max()) / level
                worst["levels"] = max(worst["levels"], r)
                require(r <= 1.01, f"{tag}: slot {i}: int8 payload differs "
                        f"by {r} levels")
        elif compress == TOPK:
            fa, fb = _flat(a), _flat(b)
            swaps = int(((fa == 0) != (fb == 0)).sum())
            worst["swaps"] = max(worst["swaps"], swaps)
            require(swaps <= TOPK_SWAP_SHARE * k, f"{tag}: slot {i}: {swaps} "
                    f"coordinates swapped sides of the threshold (k = {k})")
    return worst


def cohort_state_rel(a, b) -> dict:
    """||a - b|| / ||b|| of each part of two fim_lbfgs strategies' state."""
    sa, sb = a.opt_state, b.opt_state
    return {"params": _rel(a.params, b.params),
            "fim_diag": _rel(sa.fim.diag, sb.fim.diag),
            "history_s": _rel(sa.history.s, sb.history.s),
            "history_y": _rel(sa.history.y, sb.history.y)}


def cohort_run(train, test, compress: str, dev) -> dict:
    """ROUNDS cohort rounds of fim_lbfgs at full width under ``compress``,
    each beside the per-slot loop (``client_step`` -> ``compress_payload``
    -> ``aggregate`` -> ``server_step``, the kernels on) and the cohort
    path with kernels="off", both from the cohort's state and codec
    stream of that round, on the same stacked batches.  Gates every
    round: the launches, the state (params within COHORT_STATE_TOL under
    "none", phase 3's int8 and top-k bounds under those codecs) and the
    received payloads (payload_gate)."""
    fcfg = FedConfig(compress=compress, **RUN)
    run = FederatedRun(FMNIST_CNN, fcfg, train, test, "fim_lbfgs",
                       device=dev)
    auto = run.strategy
    loop, off = (strategies.get("fim_lbfgs")(
        FMNIST_CNN, FedConfig(compress=compress, kernels=kernels, **RUN),
        train.n_classes, device=dev) for kernels in ("auto", "off"))
    step_auto = simulator.from_strategy(auto)
    step_off = simulator.from_strategy(off)
    got, got_off = recording_slots(auto), recording_slots(off)
    codec = auto.codec
    gen = None if codec.identity else run.codec_generator
    twin_gen = torch.Generator(device=dev)
    b = cohort_slot_examples(run)
    n_leaves = len(tree_leaves(auto.params))
    tol = {"none": COHORT_STATE_TOL, "int8": INT8_STATE_TOL,
           TOPK: TOPK_STATE_TOL}[compress]
    k = codec._k(2 * auto.n_params()) if compress == TOPK else 0
    tag = f"cohort {compress}"
    rows = []
    for t in range(ROUNDS):
        clients, batch, weights = cohort_batches(run, b)
        K = len(clients)
        want = {**dict.fromkeys(COUNTERS, 0),
                "fim_diag": -(-K * n_leaves // fim_diag.MAX_LEAVES),
                "vlbfgs_gram": 1,
                "int8_roundtrip": (-(-K * 2 * n_leaves
                                     // codec_ops.INT8_MAX_LEAVES)
                                   if compress == "int8" else 0),
                "topk_select": K if compress == TOPK else 0,
                "topk_select_cluster": K if compress == TOPK else 0}
        snapshot = auto.state_dict()
        for twin in (loop, off):
            twin.load_state_dict(snapshot)
        g0 = None if gen is None else gen.get_state()
        # the cohort path, from fresh counts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        auto.params, auto.opt_state, stats = step_auto(
            auto.params, auto.opt_state, batch, weights, gen)
        torch.cuda.synchronize()
        cohort_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        loss = float(stats["loss"])
        require(math.isfinite(loss), f"{tag}: round {t + 1}: loss {loss}")
        require(launches == want, f"{tag}: round {t + 1}: launches "
                f"{launches} != {want}")
        # the per-slot loop on the same batches and codec stream
        if g0 is not None:
            twin_gen.set_state(g0)
        t0 = time.perf_counter()
        received = []
        for i in range(K):
            payload, _ = loop.client_step((batch["x"][i], batch["y"][i]),
                                          None)
            if not codec.identity:
                payload, _ = loop.compress_payload(payload, twin_gen)
            received.append(payload)
        loop.server_step(loop.aggregate(received, weights))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        # the cohort path with kernels="off"
        if g0 is not None:
            twin_gen.set_state(g0)
        reset_counts()
        off.params, off.opt_state, _ = step_off(
            off.params, off.opt_state, batch, weights,
            None if gen is None else twin_gen)
        torch.cuda.synchronize()
        off_launches = read_counts()
        require(not any(off_launches.values()),
                f"{tag}: kernels='off' launched {off_launches}")
        rel = {"loop": cohort_state_rel(auto, loop),
               "off": cohort_state_rel(auto, off)}
        for twin, parts in rel.items():
            require(parts["params"] <= tol, f"{tag}: round {t + 1}: params "
                    f"differ from the {twin} path's by {parts['params']} > "
                    f"{tol} (relative)")
        worst = {}
        if not codec.identity:
            worst = {"loop": payload_gate(got["slots"], received, compress,
                                          k, f"{tag} vs loop"),
                     "off": payload_gate(got["slots"], got_off["slots"],
                                         compress, k, f"{tag} vs off")}
        rows.append({"cohort_s": cohort_s, "loop_s": loop_s,
                     "peak_GB": peak_gb, "loss": loss, "launches": launches,
                     "rel": rel, "payloads": worst})
    steady = rows[1:]
    row = {"phase": "cohort", "compress": compress, "slots": K,
           "slot_examples": b, "slot_examples_cut": b < COHORT_B,
           "d": auto.n_params(), "rounds": ROUNDS,
           "cohort_s": [r["cohort_s"] for r in rows],
           "loop_s": [r["loop_s"] for r in rows],
           "cohort_s_median": statistics.median(r["cohort_s"] for r in steady),
           "loop_s_median": statistics.median(r["loop_s"] for r in steady),
           "peak_GB": max(r["peak_GB"] for r in rows),
           "losses": [r["loss"] for r in rows],
           "launches_per_round": rows[0]["launches"],
           "rel_max": {twin: {p: max(r["rel"][twin][p] for r in rows)
                              for p in rows[0]["rel"][twin]}
                       for twin in ("loop", "off")},
           "payload_worst": rows[-1]["payloads"] and {
               twin: {m: max(r["payloads"][twin][m] for r in rows)
                      for m in ("levels", "swaps")}
               for twin in ("loop", "off")},
           "state_tol": tol}
    emit(row)
    total = dict.fromkeys(COUNTERS, 0)
    for r in rows:
        for key in COUNTERS:
            total[key] += r["launches"][key]
    return total


def cohort_phase(train, test, dev) -> dict:
    total = dict.fromkeys(COUNTERS, 0)
    for compress in ("none", "int8", TOPK):
        for key, n in cohort_run(train, test, compress, dev).items():
            total[key] += n
        free_cuda()
    return total


def raises(fn, match: str) -> str:
    """The ValueError ``fn`` must raise, naming ``match``; fails otherwise."""
    try:
        fn()
    except ValueError as e:
        require(match in str(e), f"refusal names {str(e)!r}, not {match!r}")
        return str(e)
    fail(f"no refusal where one naming {match!r} is due")


def cohort_edge_phase(train, test, dev) -> dict:
    """``with_edge`` over E1's edge (energy_opt, the 40 s cut, Markov churn
    and SNR bursts): ROUNDS cohort rounds of fim_lbfgs at full width
    beside a kernels="off" twin on the same batches, each with its own
    runtime of the same seed.  Gates: the edge stats and each round's
    drop mask bit-identical, drops and landers present, the launches of a
    cohort round (Γ for every slot and the Gram; none where every slot
    dropped, since the wrapper then skips the step); then the two
    refusals of the cohort path (a policy of per-client codecs, a
    compressing codec given no generator)."""
    edge = EdgeConfig(channel=EDGE_CHANNEL, device=EDGE_FLEET,
                      **EDGE_RUNS["E1"]["edge"])
    run = FederatedRun(FMNIST_CNN, FedConfig(**RUN), train, test,
                       "fim_lbfgs", device=dev)
    twins = {"auto": run.strategy,
             "off": strategies.get("fim_lbfgs")(
                 FMNIST_CNN, FedConfig(kernels="off", **RUN),
                 train.n_classes, device=dev)}
    d = run.strategy.n_params()
    rts = {name: EdgeRuntime(edge, RUN["num_clients"], RUN["seed"],
                             device=dev) for name in twins}
    steps = {name: simulator.with_edge(simulator.from_strategy(s),
                                       rts[name], d)
             for name, s in twins.items()}
    b = cohort_slot_examples(run)
    n_leaves = len(tree_leaves(run.params))
    keys = ("wall_s", "sim_time_s", "energy_j", "dropped", "barrier_s")
    rows, total = [], dict.fromkeys(COUNTERS, 0)
    for t in range(ROUNDS):
        clients, batch, weights = cohort_batches(run, b)
        out = {}
        for name, strat in twins.items():
            reset_counts()
            t0 = time.perf_counter()
            strat.params, strat.opt_state, stats = steps[name](
                strat.params, strat.opt_state, batch, weights,
                clients=np.asarray(clients))
            torch.cuda.synchronize()
            dec = rts[name].decisions[-1]
            out[name] = {"host_s": time.perf_counter() - t0,
                         "launches": read_counts(),
                         "stats": {k: stats.get(k) for k in keys},
                         "landed": [int(c not in dec.dropped)
                                    for c in clients],
                         "loss": float(stats["loss"])}
        a, o = out["auto"], out["off"]
        require(a["stats"] == o["stats"] and a["landed"] == o["landed"],
                f"cohort_edge: round {t + 1}: kernels='off' stats {o} != "
                f"{a}")
        require(not any(o["launches"].values()),
                f"cohort_edge: kernels='off' launched {o['launches']}")
        # an all-dropped round runs no step at all (with_edge skips it)
        stepped = any(a["landed"])
        want = {**dict.fromkeys(COUNTERS, 0),
                "fim_diag": stepped * -(-len(clients) * n_leaves
                                        // fim_diag.MAX_LEAVES),
                "vlbfgs_gram": int(stepped)}
        require(a["launches"] == want, f"cohort_edge: round {t + 1}: "
                f"launches {a['launches']} != {want}")
        for key in COUNTERS:
            total[key] += a["launches"][key]
        rows.append(a)
    landed = [sum(r["landed"]) for r in rows]
    require(any(n < len(r["landed"]) for n, r in zip(landed, rows, strict=True))
            and any(landed), f"cohort_edge: landed {landed} a round: no "
            "drop, or no lander")
    # the refusals: adaptive_codec's per-client codecs, and an int8 step
    # billed without the generator that makes its round-trip real
    adaptive = EdgeRuntime(
        EdgeConfig(channel=EDGE_CHANNEL, device=EDGE_FLEET,
                   **EDGE_RUNS["E2"]["edge"]),
        RUN["num_clients"], RUN["seed"], device=dev)
    s = run.strategy
    adaptive_step = simulator.with_edge(simulator.from_strategy(s),
                                        adaptive, d)
    s8 = strategies.get("fim_lbfgs")(FMNIST_CNN,
                                     FedConfig(compress="int8", **RUN),
                                     train.n_classes, device=dev)
    int8_step = simulator.with_edge(
        simulator.from_strategy(s8),
        EdgeRuntime(edge, RUN["num_clients"], RUN["seed"], device=dev), d)
    refusals = {
        "adaptive_codec": raises(lambda: adaptive_step(
            s.params, s.opt_state, batch, weights,
            clients=np.asarray(clients)), "per-client upload codecs"),
        "no_generator": raises(lambda: int8_step(
            s8.params, s8.opt_state, batch, weights), "bills compressed")}
    emit({"phase": "cohort_edge", "policy": edge.scheduler, "rounds": ROUNDS,
          "slot_examples": b,
          "host_s_per_round": [r["host_s"] for r in rows],
          "landed": landed, "losses": [r["loss"] for r in rows],
          **{k: [r["stats"][k] for r in rows] for k in keys},
          "launches": total, "equal_kernels_off": True,
          "refusals": refusals})
    return total


# ---------------------------------------------------------------------------
# phase "resume": checkpoint/resume on the card
# ---------------------------------------------------------------------------
def resume_fingerprint(run, tail: int = 3) -> dict:
    """What a resumed run must reproduce over its last ``tail`` rounds."""
    edge = run.edge
    return {"ledger": {f: getattr(run.ledger, f) for f in EDGE_LEDGER_FIELDS},
            "cohorts": [tuple(sorted(d.selected))
                        for d in edge.decisions[-tail:]],
            "drops": [tuple(sorted(d.dropped))
                      for d in edge.decisions[-tail:]],
            "clock_s": edge.clock.now, "energy_j": edge.energy_j,
            "battery_j": edge.fleet.battery_j.tolist()}


def resume_runs(train, test, dev, folder: str) -> dict:
    """Two straight 6-round runs and one of 3 rounds, saved, restored
    into a fresh run and run 3 more: -> the resumed fingerprint's
    equality and the params' distances (straight against straight: the
    noise floor; resumed against straight)."""
    edge = EdgeConfig(channel=EDGE_CHANNEL, device=EDGE_FLEET,
                      **EDGE_RUNS["E1"]["edge"])
    fcfg = FedConfig(edge=edge, compress="int8", **RUN)

    def make():
        return FederatedRun(FMNIST_CNN, fcfg, train, test, "fim_lbfgs",
                            device=dev)

    straight = []
    for _ in range(2):
        run = make()
        run.run(rounds=2 * RESUME_HALF, eval_every=2 * RESUME_HALF)
        straight.append(run)
    head = make()
    head.run(rounds=RESUME_HALF, eval_every=RESUME_HALF)
    path = os.path.join(folder, "resume.npz")
    head.save(path)
    resumed = make().restore_from(path)
    resumed.run(rounds=RESUME_HALF, eval_every=RESUME_HALF)
    torch.cuda.synchronize()
    a, b = straight
    fp = resume_fingerprint(a)
    require(resume_fingerprint(b) == fp, "resume: two straight runs disagree "
            "on the simulation")
    require(resume_fingerprint(resumed) == fp, "resume: the resumed run's "
            "ledger, cohorts, drops, clock, energy or batteries differ")
    return {"floor": _rel(b.params, a.params),
            "resumed": _rel(resumed.params, a.params),
            "resumed_equal": all(bool(torch.equal(x, y)) for x, y in zip(
                tree_leaves(resumed.params), tree_leaves(a.params),
                strict=True)),
            "clock_s": fp["clock_s"], "drops": [len(d) for d in fp["drops"]]}


def resume_phase(train, test, dev) -> dict:
    """fim_lbfgs under int8 on E1's edge with its scenario: 6 straight
    rounds against 3, ``save``, ``restore_from`` into a fresh run, then 3
    more; the simulation (ledger, cohorts, drops, clock, energy,
    batteries) must be bit-identical.  The params are judged against the
    card's noise floor, the distance between two straight runs: with
    cuDNN's deterministic algorithms the floor must be 0 and the resumed
    run bit-identical; with its default (unordered backward sums) both
    distances are read and printed."""
    reset_counts()
    rows = {}
    with tempfile.TemporaryDirectory() as folder:
        previous = torch.backends.cudnn.deterministic
        try:
            for mode, deterministic in (("deterministic", True),
                                        ("default", False)):
                torch.backends.cudnn.deterministic = deterministic
                rows[mode] = resume_runs(train, test, dev, folder)
        finally:
            torch.backends.cudnn.deterministic = previous
    launches = read_counts()
    emit({"phase": "resume", "compress": "int8", "rounds": 2 * RESUME_HALF,
          "policy": EDGE_RUNS["E1"]["edge"]["scheduler"],
          "scenario": EDGE_SCENARIO, **rows, "launches": launches})
    det = rows["deterministic"]
    require(det["floor"] == 0.0, f"resume: two straight runs with "
            f"deterministic cuDNN differ by {det['floor']}")
    require(det["resumed_equal"], f"resume: the resumed params differ by "
            f"{det['resumed']} where the noise floor is 0")
    return launches


# ---------------------------------------------------------------------------
# phase "fleet": the fleet engine's two backends at 10^5 and 10^6 clients
# ---------------------------------------------------------------------------
def fleet_phase(dev) -> None:
    """FleetEngine over FLEET_POPULATIONS clients, FLEET_SHARE of them a
    round, ROUNDS rounds each of bandwidth_opt and energy_opt, E1's edge
    with star aggregation (the device backend's topology) and a 50 J
    battery, energy_opt under E1's 60 s deadline and 40 s cut,
    bandwidth_opt uncut (it equalises the cohort's finish times, so a
    hard cut below the slowest device's compute drops every client):
    ``exact`` (numpy on the host) against ``jit`` (float64 torch on the
    card).  Gates (tests/test_fleet.py's contract): the same
    selected sets and drop counts every round, clock, energy and
    batteries within rtol FLEET_RTOL."""
    d = sum(p.numel() for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0))))
    channel = dataclasses.replace(EDGE_CHANNEL, topology="star")
    device = dataclasses.replace(EDGE_FLEET, battery_j=50.0)
    for pop in FLEET_POPULATIONS:
        k = int(FLEET_SHARE * pop)
        for policy in ("bandwidth_opt", "energy_opt"):
            cut = 40.0 if policy == "energy_opt" else float("inf")
            cfg = EdgeConfig(channel=channel, device=device, scheduler=policy,
                             deadline_s=60.0, enforce_deadline_s=cut,
                             min_clients=2)
            engines, seconds, build_s = {}, {}, {}
            for backend in ("exact", "jit"):
                t0 = time.perf_counter()
                engines[backend] = FleetEngine(
                    cfg, pop, up_bytes=8.0 * d, flops=flops_grad_fim(d, 600),
                    down_bytes=4.0 * d, seed=0, backend=backend, device=dev)
                build_s[backend] = time.perf_counter() - t0
                seconds[backend] = []
            ex, jt = engines["exact"], engines["jit"]
            dropped, cohort = [], []
            for t in range(ROUNDS):
                recs = {}
                for backend, eng in engines.items():
                    t0 = time.perf_counter()
                    recs[backend] = eng.run_round(k)
                    seconds[backend].append(time.perf_counter() - t0)
                ra, rb = recs["exact"], recs["jit"]
                tag = f"fleet {pop} {policy} round {t + 1}"
                require(np.array_equal(ex.last_decision.selected,
                                       jt.last_decision.selected),
                        f"{tag}: the backends selected other clients")
                require(ra["dropped"] == rb["dropped"]
                        and ra["cohort"] == rb["cohort"],
                        f"{tag}: exact {ra} != jit {rb}")
                require(np.isclose(ra["wall_s"], rb["wall_s"],
                                   rtol=FLEET_RTOL, atol=0),
                        f"{tag}: wall_s {ra['wall_s']} != {rb['wall_s']}")
                dropped.append(ra["dropped"])
                cohort.append(ra["cohort"])
            rel = {"clock_s": abs(jt.clock_s - ex.clock_s) / ex.clock_s,
                   "energy_j": abs(jt.energy_j - ex.energy_j) / ex.energy_j,
                   "battery_j": float(np.max(
                       np.abs(jt.state.battery_j - ex.state.battery_j)
                       / np.maximum(np.abs(ex.state.battery_j), 1e-300)))}
            emit({"phase": "fleet", "population": pop, "k": k,
                  "policy": policy, "rounds": ROUNDS,
                  "exact_s_per_round": seconds["exact"],
                  "jit_s_per_round": seconds["jit"],
                  "exact_s_median": statistics.median(seconds["exact"][1:]),
                  "jit_s_median": statistics.median(seconds["jit"][1:]),
                  "build_s": build_s, "cohort": cohort, "dropped": dropped,
                  "clock_s": ex.clock_s, "energy_j": ex.energy_j,
                  "rel": rel, "rtol": FLEET_RTOL})
            for name, r in rel.items():
                require(r <= FLEET_RTOL, f"fleet {pop} {policy}: {name} "
                        f"differs by {r} > {FLEET_RTOL} (relative)")
            require(any(cohort), f"fleet {pop} {policy}: cohorts {cohort}")


# ---------------------------------------------------------------------------
# phase "sync": no device->host sync in a device body or a kernel wrapper
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def sync_errors():
    """Inside: ``torch.cuda.set_sync_debug_mode("error")``, so that any op
    that waits for the device (a host read of a value, a blocking copy, a
    data-dependent shape) raises."""
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def sync_phase(dev, leaf_shapes) -> dict:
    """The card-side half of the RPL003 lint rule.  The fleet backend's
    device bodies at SYNC_CLIENTS clients (E1's channel: equal widths,
    per-client deadlines that drop some clients early so that
    re-allocation moves survivors), then one call of each kernel wrapper
    at the main path's shapes: a client's 8 leaves at B = 600, an m = 10
    history of them, the 16-leaf (g, Γ) int8 payload, top-k at n = 2d and
    k = ceil(0.1 n), granite-8b's bf16 prefill attention.  Inputs are made
    on the card first and each call is warmed once; the checked call runs
    under ``sync_errors``, and a sync fails the run.  The gate must catch
    two planted syncs: the parent's selection (indexing by a 0-d argmax)
    and a host->device copy of a number (torch's sync debug mode is a
    prototype that does not see every sync)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    f64, n = torch.float64, SYNC_CLIENTS

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev,
                                           dtype=f64)

    d = sum(math.prod(s) for s in leaf_shapes)
    snr = 10.0 ** uniform(0.2, 1.8)
    eff = torch.log2(1.0 + snr)
    up = torch.full((n,), 8.0 * d, dtype=f64, device=dev)
    bits = 8.0 * up
    tc = torch.exp(uniform(math.log(0.5), math.log(40.0)))
    w = torch.full((n,), EDGE_CHANNEL.bandwidth_hz, dtype=f64, device=dev)
    deadline = (tc + bits / (w * eff)) * uniform(0.7, 1.3)
    budget = EDGE_CHANNEL.bandwidth_hz * n
    c, w_min = uniform(0.1, 2.0), uniform(1e3, 1e5)
    feas = uniform(0.0, 1.0) < 0.9
    e_comp, battery = uniform(1.0, 5.0), torch.full_like(up, 50.0)
    srv_rate = torch.full((), 1e9, dtype=f64, device=dev)

    def sync_round(reallocate):
        return lambda: fleet_kernel._sync_round(
            w, snr, tc, up, e_comp, deadline, 1e-9, 0.2, srv_rate, 0.01,
            battery, up, reallocate)

    grads = [torch.randn((600, math.prod(s)), generator=gen, device=dev)
             for s in leaf_shapes]
    hist_s = [torch.randn((10, *s), generator=gen, device=dev) * 1e-2
              for s in leaf_shapes]
    hist_y = [a * 1.5 for a in hist_s]
    hist_g = [torch.randn(s, generator=gen, device=dev) for s in leaf_shapes]
    payload = [torch.randn(s, generator=gen, device=dev)
               for s in leaf_shapes + leaf_shapes]
    codec_gen = torch.Generator(device=dev).manual_seed(3)
    flat = torch.randn(2 * d, generator=gen, device=dev)
    q = torch.randn((2, 32, 4096, 128), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv = torch.randn((2, 8, 4096, 128), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    checks = {
        "fleet._bw_widths": lambda: fleet_kernel._bw_widths(
            bits, eff, tc, budget, BISECT_ITERS),
        "fleet._energy_widths": lambda: fleet_kernel._energy_widths(
            c, w_min, feas, budget, BISECT_ITERS),
        "fleet._sync_round": sync_round(False),
        "fleet._sync_round(reallocate)": sync_round(True),
        "ops.fim_diag_update_leaves": lambda: ops.fim_diag_update_leaves(
            grads, None, 0.0, mode="on"),
        "ops.vlbfgs_gram_leaves": lambda: ops.vlbfgs_gram_leaves(
            hist_s, hist_y, hist_g, mode="on"),
        "ops.int8_roundtrip_leaves": lambda: ops.int8_roundtrip_leaves(
            payload, codec_gen, mode="on"),
        "ops.topk_select": lambda: ops.topk_select(
            flat, math.ceil(0.1 * flat.numel()), mode="on"),
        "ops.flash_attention": lambda: ops.flash_attention(
            q, kv, kv, causal=True, mode="on"),
    }
    for name, call in checks.items():
        call()
        with sync_errors():
            try:
                call()
            except RuntimeError as e:
                fail(f"sync: {name} synchronised with the host: {e}")
    planted = {
        "index by a 0-d argmax": lambda: flat[torch.argmax(flat)],
        "host->device copy": lambda: torch.as_tensor(np.float64(1.0),
                                                     device=dev),
    }
    caught = {}
    for name, call in planted.items():
        with sync_errors():
            try:
                call()
                caught[name] = False
            except RuntimeError:
                caught[name] = True
    torch.cuda.synchronize()
    rounds = {r: sync_round(r)() for r in (False, True)}
    row = {"phase": "sync", "clients": n, "checked": list(checks),
           "syncs": 0, "planted_caught": caught,
           "dropped": int(rounds[False][3]),
           "reallocated": int(rounds[True][6]),
           "seconds": time.perf_counter() - t0}
    emit(row)
    require(all(caught.values()), f"sync: the gate missed a planted sync "
            f"({caught})")
    require(row["dropped"] > 0 and row["reallocated"] > 0,
            f"sync: the sync round dropped {row['dropped']} and "
            f"re-allocated {row['reallocated']}: a branch went unchecked")
    return row


# ---------------------------------------------------------------------------
# phase 4: LLM serving at full width
# ---------------------------------------------------------------------------
def timed_s(fn):
    """(result, seconds) of ``fn`` on the host clock, ended by a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_diff(got, want) -> dict:
    d = (got - want).float()
    w = want.float()
    return {"max": float(d.abs().max() / w.abs().max()),
            "rms": float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt())}


def wiring_controls(cfg, params, batch, n_out: int, off) -> dict:
    """The plain path with a wrong wiring, beside ``off`` (the plain
    prefill's logits): the mask flipped (causal <-> non-causal) and the
    q -> kv head map shifted by one KV head (wk and wv rolled by one head,
    which is what reading the wrong KV head does).  Each must fail the
    off-beside-auto gate, or that gate could not see such a fault."""
    inputs = next(iter(batch.values()))
    hd = cfg.resolved_head_dim

    def logits(p, c):
        hidden, _ = transformer.forward(p, c, inputs, kernels="off")
        return transformer.logits_fn(p, cfg, hidden[:, -n_out:])

    return {"mask": rel_diff(logits(params, cfg.replace(
                is_encoder=not cfg.is_encoder)), off),
            "head_map": rel_diff(logits(with_rolled_heads(cfg, params, hd),
                                        cfg), off)}


def timed_prefills(cfg, params, batch):
    """PREFILL_CALLS prefills through make_prefill_step, each from fresh
    counts: one flash launch an attention layer and no other kernel, each
    on the tensor-core kernel for a bf16 model.  -> (the last call's
    logits, seconds, flash launches, tensor-core launches), a call each."""
    n = attention_layers(cfg)
    # a bf16 model's every launch goes through the tensor-core kernel
    tc = n if cfg.dtype == "bfloat16" else 0
    prefill = make_prefill_step(cfg)
    seconds, flash_launches, tc_launches, logits = [], [], [], None
    for call in range(PREFILL_CALLS):
        reset_counts()
        logits, sec = timed_s(lambda: prefill(params, batch))
        seconds.append(sec)
        launches = read_counts()
        flash_launches.append(launches["flash_attention"])
        tc_launches.append(launches["flash_attention_tc"])
        require(launches == {**dict.fromkeys(COUNTERS, 0), "flash_attention": n,
                             "flash_attention_tc": tc},
                f"{cfg.name} prefill call {call}: launches {launches}, "
                f"want {n} flash_attention, {tc} on the tensor-core kernel")
    require(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: logits "
            "not finite")
    return logits, seconds, flash_launches, tc_launches


def greedy_decode(cfg, params, dev):
    """DECODE_B streams greedy-decoded for DECODE_STEPS steps from an empty
    cache through make_serve_step, from fresh counts.  -> (seconds on the
    host clock ended by a sync, the cache, the last tokens, whether every
    logit was finite)."""
    serve = make_serve_step(cfg)
    cache = zoo.init_cache(cfg, DECODE_B, DECODE_STEPS, device=dev)
    # one start token a stream, so the streams differ
    tok = torch.arange(DECODE_B, dtype=torch.int32, device=dev)[:, None]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, cache = serve(params, cache, tok)         # (B, 1, V)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)  # greedy (B, 1)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, cache, tok, bool(finite)


def prefill_phase(cfg, params, batch, n_out: int) -> dict:
    """PREFILL_CALLS prefills through the kernel (timed_prefills), then one
    with kernels="off" (no launch), and the logits of the two (the last
    position, or an encoder's last frames) held within OFF_TOL of their
    scale; wiring_controls shows that bound rejects a wrong mask or head
    map."""
    L = cfg.num_layers
    logits, seconds, flash_launches, tc_launches = timed_prefills(cfg, params,
                                                                  batch)
    B, S = next(iter(batch.values())).shape[:2]
    require(tuple(logits.shape) == (B, n_out, cfg.vocab_size)
            and logits.dtype == torch.float32,
            f"{cfg.name} prefill: logits {tuple(logits.shape)} {logits.dtype}")
    reset_counts()
    off, off_s = timed_s(lambda: make_prefill_step(cfg, kernels="off")(params,
                                                                       batch))
    off_launches = read_counts()
    require(not any(off_launches.values()),
            f"{cfg.name} kernels='off' prefill launched {off_launches}")
    last = rel_diff(logits, off)
    tol = OFF_TOL[cfg.name]
    row = {"phase": "llm_prefill", "arch": cfg.name, "batch": B, "seq": S,
           "layers": L, "prefill_s": seconds,
           "prefill_tokens_per_s": B * S / seconds[-1],
           "flash_launches": flash_launches, "tc_launches": tc_launches,
           "off_prefill_s": off_s,
           "off_vs_auto_rel": last, "tol": tol,
           "wrong_wiring_rel": wiring_controls(cfg, params, batch, n_out, off)}
    emit(row)
    require(last["max"] <= tol["max"] and last["rms"] <= tol["rms"],
            f"{cfg.name}: kernels='off' vs 'auto' last-position logits differ "
            f"by {last} of their scale")
    for fault, r in row["wrong_wiring_rel"].items():
        require(r["max"] > tol["max"] or r["rms"] > tol["rms"],
                f"{cfg.name}: a wrong {fault} moves the logits by only {r}, "
                f"inside the off-beside-auto bound {tol}")
    return row


def serve_granite(dev) -> dict:
    """granite-8b at full width in bf16: prefill, then greedy decode."""
    cfg = granite_8b.CONFIG
    params, init_s = timed_s(lambda: zoo.init(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = sum(t.numel() for t in tree_leaves(params))
    emit({"phase": "llm_init", "arch": cfg.name, "params": n_params,
          "param_count": cfg.param_count(), "init_s": init_s,
          "memory_GB": torch.cuda.memory_allocated() / 1e9})
    toks = torch.from_numpy(zipf_tokens(PREFILL_B, PREFILL_S, cfg.vocab_size,
                                        seed=0)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    row = prefill_phase(cfg, params, {"tokens": toks}, 1)

    decode_s, cache, tok, finite = greedy_decode(cfg, params, dev)
    launches = read_counts()
    row.update({"decode_batch": DECODE_B, "decode_steps": DECODE_STEPS,
                "decode_s": decode_s,
                "decode_tokens_per_s": DECODE_B * DECODE_STEPS / decode_s,
                "decode_ms_per_step": 1e3 * decode_s / DECODE_STEPS,
                "cache_pos": int(cache.pos), "sample": tok[:, 0].tolist(),
                "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "llm_decode", **{k: row[k] for k in (
        "decode_batch", "decode_steps", "decode_s", "decode_tokens_per_s",
        "decode_ms_per_step", "cache_pos", "sample", "peak_memory_GB")}})
    require(finite, f"{cfg.name} decode: logits not finite")
    require(int(cache.pos) == DECODE_STEPS, f"{cfg.name} decode: cache at "
            f"{int(cache.pos)}")
    require(not any(launches.values()),
            f"{cfg.name} decode (plain attention) launched {launches}")
    print(f"{cfg.name}: prefill {row['prefill_tokens_per_s']:.0f} tokens/s "
          f"({PREFILL_B} x {PREFILL_S}), decode {row['decode_tokens_per_s']:.1f} "
          f"tokens/s ({DECODE_B} streams x {DECODE_STEPS} steps)", flush=True)
    return row


def decode_vs_prefill(dev, cfg=None, tokens: int = DECODE_T,
                      tol: float = DECODE_TOL) -> dict:
    """A model in f32 at full width (granite-8b with LLM_F32_LAYERS layers
    unless ``cfg`` says otherwise): ``tokens`` tokens of 2 streams decoded
    one by one against the forward + logits_fn over them through the
    kernel (tests/test_decode_consistency.py's check), within ``tol`` of
    max|logits|; one SIMT flash launch an attention layer, and no MoE pick
    dropped on either path."""
    cfg = cfg or granite_8b.CONFIG.replace(dtype="float32",
                                           num_layers=LLM_F32_LAYERS)
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    toks = torch.from_numpy(zipf_tokens(2, tokens, cfg.vocab_size,
                                        seed=1)).to(dev)
    cache = zoo.init_cache(cfg, 2, tokens, device=dev)
    outs = []
    with RouteRecorder() as rec:
        for t in range(tokens):
            lg, cache = zoo.decode_fn(params, cfg, cache, toks[:, t:t + 1])
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        reset_counts()
        hidden, _ = zoo.forward(params, cfg, toks)
        ref_logits = transformer.logits_fn(params, cfg, hidden)
        torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["flash_attention"]
    rel = rel_diff(dec, ref_logits)
    n_attn = attention_layers(cfg)
    row = {"phase": "llm_decode_vs_prefill", "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": "float32", "tokens": tokens,
           "rel": rel, "tol": tol, "flash_launches": launches,
           "tc_launches": counts["flash_attention_tc"],
           "moe_dropped_max": max(rec.dropped(), default=0.0)}
    emit(row)
    require(launches == n_attn and counts["flash_attention_tc"] == 0,
            f"{cfg.name} decode vs prefill: {counts}, want {n_attn} flash "
            "launches, all on the f32 SIMT kernel")
    require(row["moe_dropped_max"] == 0.0, f"{cfg.name} decode vs prefill: "
            f"MoE dropped {row['moe_dropped_max']} of its picks")
    require(rel["max"] <= tol, f"{cfg.name} decode vs prefill (f32, full "
            f"width): max diff {rel['max']} of max|logits| > {tol}")
    return row


def serve_hubert(dev) -> dict:
    """hubert-xlarge's encoder at full width: per-frame logits of the last
    LOSS_CHUNK frames of 2 x 4,096 frames."""
    cfg = hubert_xlarge.CONFIG
    gen = torch.Generator(device=dev).manual_seed(2)
    params = zoo.init(cfg, gen, device=dev)
    feats = torch.randn((PREFILL_B, PREFILL_S, cfg.d_model), generator=gen,
                        device=dev)
    return prefill_phase(cfg, params, {"features": feats},
                         min(transformer.LOSS_CHUNK, PREFILL_S))


# ---------------------------------------------------------------------------
# phase "llm_train": the federated LLM train step
# ---------------------------------------------------------------------------
def train_steps(cfg, batch, n_micro: int, optimizer: str, steps: int,
                kernels: str, dev, tag: str):
    """``steps`` train steps of ``optimizer`` from the seed-0 init on one
    batch, each from fresh counts: -> (rows, params, opt_state).  Each row
    holds the step's loss and stats, seconds (host clock ended by a sync),
    tokens/s, the peak device memory and the launches; a fim_lbfgs step
    under "auto" launches the Gram once and nothing else, any other step
    nothing."""
    ocfg = opt_config(cfg)
    params, opt = init_train_state(
        cfg, ocfg, torch.Generator(device=dev).manual_seed(0), optimizer,
        device=dev)
    step = make_train_step(cfg, ocfg, n_micro, optimizer, kernels)
    B, S = tree_leaves(batch)[0].shape[:2]
    gram = int(optimizer == "fim_lbfgs" and kernels != "off")
    rows = []
    for t in range(steps):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (params, opt, stats), sec = timed_s(lambda: step(params, opt, batch))
        launches = read_counts()
        row = {"phase": "llm_train", "run": tag, "arch": cfg.name,
               "layers": cfg.num_layers, "optimizer": optimizer,
               "kernels": kernels, "step": t + 1, "batch": B, "seq": S,
               "n_micro": n_micro,
               **{k: float(v) for k, v in stats.items()}, "seconds": sec,
               "tokens_per_s": B * S / sec,
               "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
               "gram_launches": launches["vlbfgs_gram"]}
        emit(row)
        print(f"{tag} step {t + 1}: loss {row['loss']:.5f} dir_norm "
              f"{row.get('dir_norm', float('nan')):.5g} pair_accepted "
              f"{row.get('pair_accepted', float('nan')):.0f} {sec:.3f} s "
              f"{row['tokens_per_s']:.0f} tokens/s peak "
              f"{row['peak_memory_GB']:.2f} GB Gram launches "
              f"{row['gram_launches']}", flush=True)
        require(math.isfinite(row["loss"]), f"{tag} step {t + 1}: loss "
                f"{row['loss']}")
        require(row["peak_memory_GB"] < CARD_GB, f"{tag}: peak "
                f"{row['peak_memory_GB']} GB")
        require(launches == {**dict.fromkeys(COUNTERS, 0),
                             "vlbfgs_gram": gram},
                f"{tag} step {t + 1}: launches {launches}, want {gram} Gram "
                "and nothing else")
        rows.append(row)
    return rows, params, opt


def train_twin_gate(auto, off, tag: str) -> dict:
    """The kernels="off" twin against the "auto" run, step for step (see
    TRAIN_DIR_TOL): step 1 equal; loss and dir_norm within their bounds."""
    rel = {"loss": [], "dir_norm": []}
    for a, o in zip(auto, off, strict=True):
        for key in rel:
            rel[key].append(abs(a[key] - o[key]) / abs(o[key]))
    gate = {"phase": "llm_train_twin", "run": tag, "rel": rel,
            "tol": {"loss": TRAIN_LOSS_TOL, "dir_norm": TRAIN_DIR_TOL}}
    emit(gate)
    require(all(auto[0][k] == off[0][k] for k in rel), f"{tag}: step 1 "
            f"differs off beside auto ({rel})")
    require(max(rel["loss"]) <= TRAIN_LOSS_TOL, f"{tag}: losses off beside "
            f"auto {rel['loss']} > {TRAIN_LOSS_TOL}")
    require(max(rel["dir_norm"]) <= TRAIN_DIR_TOL, f"{tag}: dir_norm off "
            f"beside auto {rel['dir_norm']} > {TRAIN_DIR_TOL}")
    return gate


def gram_on_history(opt, tag: str) -> dict:
    """The Gram kernel against its plain version on the trained history in
    place (s, y after the last step, the Fisher diagonal as g): GRAM_TOL.
    Counted apart from the run's launches."""
    s, y = tree_leaves(opt.history.s), tree_leaves(opt.history.y)
    g = tree_leaves(opt.fim.diag)
    got = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    want = ops.vlbfgs_gram_leaves(s, y, g, mode="off")
    rel = gram_err(got, want)
    row = {"phase": "llm_train_gram", "run": tag,
           "dtypes": [str(s[0].dtype)[6:], str(g[0].dtype)[6:]],
           "live_pairs": int(opt.history.count), "rel_err": rel,
           "tol": GRAM_TOL}
    emit(row)
    require(rel <= GRAM_TOL, f"{tag}: Gram on the trained history, relative "
            f"err {rel} > {GRAM_TOL}")
    return row


def train_model(cfg, batch, n_micro: int, steps: int, dev,
                baselines: bool) -> dict:
    """fim_lbfgs under "auto" (its Gram checked on the trained history),
    its kernels="off" twin after the first run's state is freed, and (with
    ``baselines``) fedavg_adam and fedavg_sgd from fresh states.  -> the
    rows, and the Gram launches of the fim_lbfgs run."""
    tag = f"{cfg.name}/fim_lbfgs"
    auto, params, opt = train_steps(cfg, batch, n_micro, "fim_lbfgs", steps,
                                    "auto", dev, tag)
    gram = gram_on_history(opt, tag)
    del params, opt
    free_cuda()
    off, params, opt = train_steps(cfg, batch, n_micro, "fim_lbfgs", steps,
                                   "off", dev, tag + "/off")
    del params, opt
    free_cuda()
    out = {"fim_lbfgs": auto, "off": off, "twin": train_twin_gate(auto, off,
                                                                   tag),
           "gram": gram, "gram_launches": sum(r["gram_launches"] for r in auto)}
    if baselines:
        for name in ("fedavg_adam", "fedavg_sgd"):
            out[name], params, opt = train_steps(
                cfg, batch, n_micro, name, BASELINE_STEPS, "auto", dev,
                f"{cfg.name}/{name}")
            del params, opt
            free_cuda()
    return out


def llm_train(dev, granite=None, hubert=None) -> dict:
    """granite-8b at full width (depth TRAIN_LAYERS) on TRAIN_B Zipf
    sequences of TRAIN_S tokens, TRAIN_MICRO cohorts; hubert-xlarge's
    encoder loss (depth HUBERT_LAYERS) on HUBERT_B x TRAIN_S frames.
    ``granite``/``hubert``: other configs (a CPU rehearsal's smaller
    ones)."""
    granite = granite or granite_8b.CONFIG.replace(num_layers=TRAIN_LAYERS)
    hubert = hubert or hubert_xlarge.CONFIG.replace(num_layers=HUBERT_LAYERS)
    n_params = sum(math.prod(s) for s in param_shapes(granite, dev))
    emit({"phase": "llm_train_config", "arch": granite.name,
          "layers": granite.num_layers, "params": n_params,
          "lbfgs_m": granite.lbfgs_m, "history": granite.lbfgs_dtype,
          "reduced": {"num_layers": f"{granite_8b.CONFIG.num_layers} -> "
                                    f"{granite.num_layers}"}})
    toks = torch.from_numpy(zipf_tokens(TRAIN_B, TRAIN_S, granite.vocab_size,
                                        seed=3)).to(dev)
    out = {"granite": train_model(granite, {"tokens": toks}, TRAIN_MICRO,
                                  TRAIN_STEPS, dev, baselines=True)}
    del toks
    free_cuda()
    shape = ShapeConfig("hubert_train", TRAIN_S, HUBERT_B, "train")
    batch = zoo.synth_batch(hubert, shape,
                            torch.Generator(device=dev).manual_seed(4))
    out["hubert"] = train_model(hubert, batch, HUBERT_MICRO, HUBERT_STEPS, dev,
                                baselines=False)
    return out


# ---------------------------------------------------------------------------
# phase "sharded": the federated train step on a DeviceMesh
# ---------------------------------------------------------------------------
def sharded_rows(step, state, batch, steps: int, tag: str, n: int,
                 counted: bool) -> tuple[list, tuple]:
    """``steps`` calls of a train step from ``state`` = (params, opt), each
    from fresh counts: -> (rows, the last state).  ``counted``: under the
    collective counter (``launch/cost.CostCounter(flops=False)``), each
    row with its (n, n) f32 all-reduces."""
    rows = []
    for t in range(steps):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        counter = costlib.CostCounter(flops=False)
        with counter if counted else contextlib.nullcontext():
            (params, opt, st), sec = timed_s(lambda: step(*state, batch))
        state = (params, opt)
        row = {"phase": "sharded", "run": tag, "step": t + 1,
               "loss": float(st["loss"]), "dir_norm": float(st["dir_norm"]),
               "seconds": sec, "peak_memory_GB":
                   torch.cuda.max_memory_allocated() / 1e9,
               "gram_launches": read_counts()["vlbfgs_gram"]}
        if counted:
            row["gram_all_reduces"] = counter.calls_of(
                "all-reduce", (n, n), torch.float32)
            row["collectives"] = dict(counter.count)
        emit(row)
        print(f"{tag} step {t + 1}: loss {row['loss']:.6f} dir_norm "
              f"{row['dir_norm']:.6g} {sec:.3f} s peak "
              f"{row['peak_memory_GB']:.2f} GB Gram launches "
              f"{row['gram_launches']}", flush=True)
        require(row["gram_launches"] == 1, f"{tag} step {t + 1}: "
                f"{row['gram_launches']} Gram launches, want 1")
        rows.append(row)
    return rows, state


def sharded_dryrun(arch: str, shape: str, mesh: str) -> dict:
    """One dry-run record in a subprocess (its fake process group of 256
    or 512 ranks cannot live beside this process's NCCL group)."""
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--out", out],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        require(proc.returncode == 0, f"dry run {arch} x {shape} x {mesh}: "
                f"{proc.stderr[-2000:]}")
        with open(os.path.join(out, f"{arch}_{shape}_{mesh}.json")) as f:
            rec = json.load(f)
    emit({"phase": "sharded_dryrun", **rec})
    require(rec["status"] == "ok" and rec["collectives"]["count"],
            f"dry run record {rec}")
    return rec


def sharded_phase(dev, cfg=None, backend: str = "nccl") -> dict:
    """The unsharded fim_lbfgs step, then the sharded one on a (1, 1) mesh,
    from the same init on the same batch (see SHARDED_STEPS); ``cfg`` and
    ``backend``: a CPU rehearsal's smaller config and "gloo"."""
    import torch.distributed as dist

    cfg = cfg or granite_8b.CONFIG.replace(num_layers=TRAIN_LAYERS)
    ocfg = opt_config(cfg)
    n = 2 * ocfg.m + 1
    toks = torch.from_numpy(zipf_tokens(TRAIN_B, TRAIN_S, cfg.vocab_size,
                                        seed=3)).to(dev)

    def fresh():
        return init_train_state(cfg, ocfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)

    plain, (params, opt) = sharded_rows(
        make_train_step(cfg, ocfg, TRAIN_MICRO), fresh(), {"tokens": toks},
        SHARDED_STEPS, f"{cfg.name}/unsharded", n, counted=False)
    want = [p.cpu() for p in tree_leaves(params)]
    del params, opt
    free_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1, device_type=dev.type)
            state = shard_train_state(cfg, ocfg, *fresh(), mesh)
            sharded, (params, opt) = sharded_rows(
                make_train_step(cfg, ocfg, TRAIN_MICRO, mesh=mesh), state,
                shard_batch({"tokens": toks}, mesh, TRAIN_MICRO),
                SHARDED_STEPS, f"{cfg.name}/sharded", n, counted=True)
            leaf_err = [float(torch.linalg.vector_norm(
                (p.to_local().cpu().float() - w.float())) / max(float(
                    torch.linalg.vector_norm(w.float())), 1e-30))
                for p, w in zip(tree_leaves(params), want, strict=True)]
            del params, opt, state
        finally:
            dist.destroy_process_group()
    free_cuda()
    dir_rel = [abs(a["dir_norm"] - b["dir_norm"]) / abs(b["dir_norm"])
               for a, b in zip(sharded, plain, strict=True)]
    gate = {"phase": "sharded_gate", "loss": [[a["loss"], b["loss"]] for a, b
                                              in zip(sharded, plain)],
            "dir_norm_rel": dir_rel, "max_leaf_err": max(leaf_err),
            "tol": TRAIN_DIR_TOL}
    emit(gate)
    require(sharded[0]["loss"] == plain[0]["loss"], f"sharded step 1 loss "
            f"{sharded[0]['loss']} != unsharded {plain[0]['loss']}")
    require(all(r["gram_all_reduces"] == 1 for r in sharded),
            f"sharded Gram all-reduces {[r['gram_all_reduces'] for r in sharded]}"
            f", want one (2m+1)^2 f32 a step")
    require(max(dir_rel) <= TRAIN_DIR_TOL, f"sharded dir_norm {dir_rel}")
    require(max(leaf_err) <= TRAIN_DIR_TOL, f"sharded params {max(leaf_err)}")
    record = sharded_dryrun(*SHARDED_DRYRUN)
    return {"plain": plain, "sharded": sharded, "gate": gate,
            "dryrun": record,
            "gram_launches": sum(r["gram_launches"] for r in plain + sharded)}


# ---------------------------------------------------------------------------
# phase "llm_families": MoE, Mamba-2 and the hybrid at full width
# ---------------------------------------------------------------------------
class RouteRecorder:
    """For the length of a ``with``, wraps ``moe.route`` and
    ``moe.assign_slots``: records each MoE call's own expert indices (G, T,
    k), the indices it used, its (E, C) and its keep mask (G, T*k), on the
    device.  With ``pin`` (the recorder of an earlier run over the same
    tokens) each call uses that run's indices for the same call, its gates
    renormalised from its own probabilities at them."""

    def __init__(self, pin: "RouteRecorder | None" = None):
        self.pin = pin
        self.own, self.used, self.caps, self.keep = [], [], [], []

    def __enter__(self):
        self._route, self._slots = moe.route, moe.assign_slots

        def route(p, cfg, xg):
            probs, gates, idx = self._route(p, cfg, xg)
            self.own.append(idx)
            if self.pin is not None:
                idx = self.pin.used[len(self.used)]
                g = torch.gather(probs, -1, idx)
                gates = g / g.sum(dim=-1, keepdim=True)
            self.used.append(idx)
            return probs, gates, idx

        def slots(expert_idx, num_experts, capacity):
            slot, keep = self._slots(expert_idx, num_experts, capacity)
            self.caps.append((num_experts, capacity))
            self.keep.append(keep)
            return slot, keep

        moe.route, moe.assign_slots = route, slots
        return self

    def __exit__(self, *exc):
        moe.route, moe.assign_slots = self._route, self._slots
        return False

    def dropped(self) -> list:
        return [float((~k).float().mean()) for k in self.keep]

    def own_choice(self, i: int):
        """(sorted expert set (G, T, k), keep (G, T, k)) of call i's own
        routing."""
        idx = self.own[i]
        keep = moe.assign_slots(idx, *self.caps[i])[1]
        return idx.sort(dim=-1).values, keep.reshape(idx.shape)


def route_flips(a: RouteRecorder, b: RouteRecorder) -> torch.Tensor:
    """(B*S,) bool: the tokens whose own expert set or keep differs between
    two runs over the same tokens in any MoE call."""
    flips = None
    for i in range(len(a.own)):
        (ea, ka), (eb, kb) = a.own_choice(i), b.own_choice(i)
        f = ((ea != eb) | (ka != kb)).any(dim=-1).reshape(-1)
        flips = f if flips is None else flips | f
    return flips


def attention_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // 8
    return cfg.num_layers


@contextlib.contextmanager
def flipped_mask():
    """For the length of a ``with``, every attention layer's mask flipped
    (causal <-> non-causal): a wiring fault of the mask."""
    apply = attention.attn_apply
    attention.attn_apply = (lambda p, cfg, x, causal=True, kernels="auto":
                            apply(p, cfg, x, not causal, kernels))
    try:
        yield
    finally:
        attention.attn_apply = apply


def with_rolled_heads(cfg, params, hd: int) -> dict:
    """``params`` with wk and wv rolled by one head (reading the wrong KV
    head): the hybrid's ma block, every other family's stacked layers."""
    block = "ma" if cfg.family == "hybrid" else "layers"
    attn = dict(params[block]["attn"])
    for name in ("wk", "wv"):
        attn[name] = torch.roll(attn[name], hd, dims=-1)
    return {**params, block: {**params[block], "attn": attn}}


def last_logits(cfg, params, toks, kernels: str, pin=None, n_out=None):
    """(logits of the last n_out positions (B, n_out, V), the run's
    RouteRecorder) of one forward."""
    n_out = n_out or transformer.LOSS_CHUNK
    with RouteRecorder(pin) as rec:
        hidden, _ = zoo.forward(params, cfg, toks, kernels=kernels)
        logits = transformer.logits_fn(params, cfg, hidden[:, -n_out:])
    return logits, rec


def family_twin(cfg, params, toks) -> dict:
    """kernels="off" beside "auto" on the last LOSS_CHUNK positions of each
    prompt, the off run's routing pinned to the auto run's (FAMILY_OFF_TOL
    says why), position by position within its bound; the wiring controls
    (pinned the same way) must fail it.  A run with its own routing is
    reported beside it: its flipped positions, and the rest's difference.
    -> the row's twin fields and the auto run's recorder."""
    B, S = toks.shape
    n_out = min(transformer.LOSS_CHUNK, S)
    tol = FAMILY_OFF_TOL[cfg.name]
    auto, rec = last_logits(cfg, params, toks, "auto")
    off, pinned = last_logits(cfg, params, toks, "off", pin=rec)
    free, own = last_logits(cfg, params, toks, "off")
    out = {"off_vs_auto_rel": rel_diff(off, auto), "tol": tol}
    if rec.own:
        last = torch.zeros((B, S), dtype=torch.bool, device=toks.device)
        last[:, -n_out:] = True
        flips = route_flips(rec, own).reshape(B, S)
        kept = ~flips[last].reshape(B, n_out)
        out["own_routing"] = {
            "flipped_share": float(flips.float().mean()),
            "flipped_in_compared": int((~kept).sum()),
            "rel_unflipped": rel_diff(free[kept], auto[kept]) if kept.any()
            else None}
        out["pinned_own_choice_flipped_share"] = float(
            route_flips(rec, pinned).float().mean())
    del free, own, pinned
    if attention_layers(cfg):
        hd = cfg.resolved_head_dim
        with flipped_mask():
            mask, _ = last_logits(cfg, params, toks, "off", pin=rec)
        rolled, _ = last_logits(cfg, with_rolled_heads(cfg, params, hd), toks,
                                "off", pin=rec)
        out["wrong_wiring_rel"] = {"mask": rel_diff(mask, auto),
                                   "head_map": rel_diff(rolled, auto)}
        del mask, rolled
    return out, rec


def serve_family(dev, name: str) -> dict:
    """One family model at full width in bf16 (depth as FAMILIES says):
    PREFILL_CALLS prefills (one flash launch an attention layer, each on the
    tensor-core kernel, no other kernel), the off-beside-auto twin and its
    controls, greedy decode of DECODE_B streams for DECODE_STEPS steps (no
    kernel), with each MoE layer's dropped share in prefill and decode."""
    mod, layers = FAMILIES[name]
    cfg = mod.CONFIG.replace(num_layers=layers)
    params, init_s = timed_s(lambda: zoo.init(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    n_attn = attention_layers(cfg)
    row = {"phase": "llm_family", "arch": cfg.name, "layers": layers,
           "reduced": ({} if layers == mod.CONFIG.num_layers else
                       {"num_layers": f"{mod.CONFIG.num_layers} -> {layers}"}),
           "params": sum(t.numel() for t in tree_leaves(params)),
           "param_count": cfg.param_count(), "init_s": init_s,
           "attention_layers": n_attn, "batch": PREFILL_B, "seq": PREFILL_S}
    toks = torch.from_numpy(zipf_tokens(PREFILL_B, PREFILL_S, cfg.vocab_size,
                                        seed=0)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    logits, seconds, flash, tc = timed_prefills(cfg, params, {"tokens": toks})
    require(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab_size),
            f"{cfg.name} prefill: logits {tuple(logits.shape)}")
    reset_counts()
    _, off_s = timed_s(lambda: make_prefill_step(cfg, kernels="off")(
        params, {"tokens": toks}))
    require(not any(read_counts().values()),
            f"{cfg.name} kernels='off' prefill launched {read_counts()}")
    twin, rec = family_twin(cfg, params, toks)
    row.update({"prefill_s": seconds,
                "prefill_tokens_per_s": PREFILL_B * PREFILL_S / seconds[-1],
                "flash_launches": flash, "tc_launches": tc,
                "off_prefill_s": off_s, **twin,
                "prefill_dropped": rec.dropped()})
    del rec

    with RouteRecorder() as rec:
        decode_s, cache, tok, finite = greedy_decode(cfg, params, dev)
    launches = read_counts()
    n_moe = len(row["prefill_dropped"])
    drops = rec.dropped()
    row.update({"decode_batch": DECODE_B, "decode_steps": DECODE_STEPS,
                "decode_s": decode_s,
                "decode_ms_per_step": 1e3 * decode_s / DECODE_STEPS,
                "decode_tokens_per_s": DECODE_B * DECODE_STEPS / decode_s,
                "decode_dropped_mean": [statistics.fmean(drops[i::n_moe])
                                        for i in range(n_moe)],
                "cache_pos": int(cache.pos), "sample": tok[:, 0].tolist(),
                "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit(row)
    require(finite, f"{cfg.name} decode: logits not finite")
    require(int(cache.pos) == DECODE_STEPS, f"{cfg.name} decode: cache at "
            f"{int(cache.pos)}")
    require(not any(launches.values()), f"{cfg.name} decode launched "
            f"{launches}")
    require(len(drops) == n_moe * DECODE_STEPS, f"{cfg.name} decode: "
            f"{len(drops)} MoE calls, want {n_moe} a step")
    tol, rel = row["tol"], row["off_vs_auto_rel"]
    require(rel["max"] <= tol["max"] and rel["rms"] <= tol["rms"],
            f"{cfg.name}: kernels='off' vs 'auto' logits differ by {rel} of "
            f"their scale, bound {tol}")
    for fault, r in row.get("wrong_wiring_rel", {}).items():
        require(r["max"] > tol["max"] or r["rms"] > tol["rms"],
                f"{cfg.name}: a wrong {fault} moves the logits by only {r}, "
                f"inside the off-beside-auto bound {tol}")
    print(f"{cfg.name} ({layers} layers): prefill "
          f"{row['prefill_tokens_per_s']:.0f} tokens/s, decode "
          f"{row['decode_tokens_per_s']:.1f} tokens/s, off vs auto {rel}, "
          f"peak {row['peak_memory_GB']:.1f} GB", flush=True)
    return row


def moe_apply_plain(p, cfg, x):
    """The MoE layer's function, computed independently of ``moe``'s
    dispatch: per group and expert, the first C picks of that expert in
    token-major order are kept, their tokens gathered by index, run through
    the expert's SwiGLU and index_add-ed back weighted by their gates.
    -> (out (B, S, d), keep (G, T*k), dropped share)."""
    B, S, d = x.shape
    T = moe.group_size(B * S, cfg.moe_group)
    G, E, k = B * S // T, cfg.num_experts, cfg.top_k
    C = moe._capacity(T, k, E, cfg.capacity_factor)
    xt = x.reshape(G, T, d)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = (gates / gates.sum(dim=-1, keepdim=True)).reshape(G, T * k)
    out = torch.zeros((G * T, d), dtype=torch.float32, device=x.device)
    keep = torch.zeros((G, T * k), dtype=torch.bool, device=x.device)
    for g in range(G):
        picks_of = idx[g].reshape(-1)                   # token-major picks
        for e in range(E):
            picks = torch.nonzero(picks_of == e)[:C, 0]
            keep[g, picks] = True
            tok = picks // k
            xe = xt[g, tok]
            h = (xe @ p["wi"][e]) * torch.nn.functional.silu(xe @ p["wg"][e])
            out.index_add_(0, g * T + tok,
                           (h @ p["wo"][e]).float() * gates[g, picks, None])
    return out.to(x.dtype).reshape(B, S, d), keep, (~keep).float().mean()


def check_moe_dispatch(dev, mod) -> dict:
    """One MoE layer of ``mod``'s config at full width in f32 over MOE_B x
    MOE_S tokens: ``moe.moe_apply`` against ``moe_apply_plain`` (keep mask
    and dropped share equal, the output within MOE_PLAIN_TOL of its
    scale)."""
    cfg = mod.CONFIG.replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = moe.moe_init(gen, cfg)
    table = torch.randn((4096, cfg.d_model), generator=gen, device=dev)
    ids = torch.from_numpy(zipf_tokens(MOE_B, MOE_S, 4096, seed=5)).to(dev)
    x = table[ids.long()]
    with RouteRecorder() as rec:
        (out, (aux, dropped)), moe_s = timed_s(lambda: moe.moe_apply(p, cfg, x))
    (want, keep, want_dropped), plain_s = timed_s(
        lambda: moe_apply_plain(p, cfg, x))
    rel = float((out - want).abs().max() / want.abs().max())
    row = {"phase": "llm_moe_dispatch", "arch": cfg.name, "dtype": "float32",
           "tokens": MOE_B * MOE_S, "groups": rec.keep[0].shape[0],
           "capacity": rec.caps[0][1], "dropped": float(dropped),
           "plain_dropped": float(want_dropped), "aux": float(aux),
           "rel_err": rel, "tol": MOE_PLAIN_TOL, "moe_s": moe_s,
           "plain_s": plain_s}
    emit(row)
    require(bool(torch.equal(rec.keep[0], keep)), f"{cfg.name} MoE: the keep "
            "mask differs from the plain dispatch's")
    require(float(dropped) == float(want_dropped), f"{cfg.name} MoE: dropped "
            f"{float(dropped)} against the plain {float(want_dropped)}")
    require(rel <= MOE_PLAIN_TOL, f"{cfg.name} MoE: output {rel} of its scale "
            f"off the plain dispatch > {MOE_PLAIN_TOL}")
    return row


def llm_families(dev) -> dict:
    """The phase: each of FAMILIES served (serve_family), decode against
    prefill in f32 for FAMILY_F32, the MoE dispatch against the plain one
    for qwen3-moe and dbrx, then mamba2-370m trained at full width and depth
    (train_model: TRAIN_STEPS fim_lbfgs steps, one Gram launch each, and
    its kernels="off" twin); each config from FAMILIES (a CPU rehearsal
    swaps in smaller ones)."""
    out = {"serve": {}, "decode_vs_prefill": {}, "moe_dispatch": {}}
    for name in FAMILIES:
        out["serve"][name] = serve_family(dev, name)
        free_cuda()
    for name, (layers, tokens, tol) in FAMILY_F32.items():
        mod = FAMILIES[name][0]
        cfg = mod.CONFIG.replace(dtype="float32", num_layers=layers)
        if cfg.num_experts:
            cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
        out["decode_vs_prefill"][name] = decode_vs_prefill(dev, cfg, tokens, tol)
        free_cuda()
    for name in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        out["moe_dispatch"][name] = check_moe_dispatch(dev, FAMILIES[name][0])
        free_cuda()
    cfg = FAMILIES["mamba2-370m"][0].CONFIG
    emit({"phase": "llm_train_config", "arch": cfg.name,
          "layers": cfg.num_layers,
          "params": sum(math.prod(s) for s in param_shapes(cfg, dev)),
          "lbfgs_m": cfg.lbfgs_m, "history": cfg.lbfgs_dtype, "reduced": {}})
    toks = torch.from_numpy(zipf_tokens(TRAIN_B, TRAIN_S, cfg.vocab_size,
                                        seed=6)).to(dev)
    out["train"] = train_model(cfg, {"tokens": toks}, TRAIN_MICRO, TRAIN_STEPS,
                               dev, baselines=False)
    return out


def param_shapes(cfg, dev) -> list[tuple]:
    """The shapes of ``cfg``'s parameter leaves, in tree order (an init on
    ``dev``, freed)."""
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    return [tuple(p.shape) for p in tree_leaves(params)]


def free_cuda() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2

    # phase 1: the card and the build
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    # f32 everywhere: cuDNN would run f32 convolutions in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # phase 2: kernels against their plain versions at the main path's shapes
    leaf_shapes = [tuple(p.shape) for p in
                   tree_leaves(cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    # a client of ~600 examples: all 8 leaves in one call (the row the
    # kernels line reports), then one (600, D) call per leaf, fc0.w first
    leaf_sizes = sorted({math.prod(s) for s in leaf_shapes}, reverse=True)
    fim_rows = [check_fim_leaves(dev, 600, leaf_shapes)]
    fim_rows += [check_fim_diag(dev, 600, D, torch.float32)
                 for D in leaf_sizes]
    fim_rows.append(check_fim_diag(dev, 257, 2049, torch.bfloat16))
    # the Gram read in place from an m = 10 history of the CNN's leaves
    # (the row the kernels line reports), then on a materialised basis
    gram_rows = [check_gram_leaves(dev, 10, leaf_shapes),
                 check_gram(dev, 21, 206_922), check_gram(dev, 21, 10_001)]
    # the LLM train step's Gram: an m = 10 bf16 history of granite-8b's 12
    # leaves at TRAIN_LAYERS layers beside an f32 g (the row the kernels
    # line reports as "llm_train")
    granite_train = granite_8b.CONFIG.replace(num_layers=TRAIN_LAYERS)
    gram_rows.append(check_gram_history_bf16(
        dev, granite_train.lbfgs_m, param_shapes(granite_train, dev)))
    free_cuda()
    # and mamba2-370m's at its full depth (phase llm_families' train step,
    # 419.2 M columns), the row the kernels line reports as "llm_families"
    mamba = mamba2_370m.CONFIG
    gram_mamba = check_gram_history_bf16(dev, mamba.lbfgs_m,
                                         param_shapes(mamba, dev))
    free_cuda()
    # int8: fim_lbfgs's (g, Γ) payload (16 leaves) in one call, the row
    # the kernels line reports; then each leaf alone, for comparison
    int8_payload = check_int8_payload(dev, leaf_shapes + leaf_shapes)
    int8_rows = [check_int8(dev, s) for s in leaf_shapes]
    # the (g, Γ) payload of fim_lbfgs (2d) and the delta of fedavg_sgd (d)
    # at k = ceil(0.1 n), a size that is no multiple of the 4096-element
    # tile, the ends k = 1 and k = n, and one n above the cluster's capacity
    # (the four-launch path)
    d = sum(leaf_sizes)
    cluster, capacity = codec_ops.cluster_shape(dev)
    emit({"phase": "topk_cluster", "cluster": cluster, "capacity": capacity})
    require(capacity >= 2 * d, f"topk_select: the cluster path holds "
            f"{capacity} elements, fewer than the main path's {2 * d}")
    above = capacity + 12_345
    topk_rows = [check_topk(dev, n, k, cluster, capacity) for n, k in (
        (2 * d, math.ceil(0.1 * 2 * d)), (d, math.ceil(0.1 * d)),
        (100_003, 10_001), (2 * d, 1), (2 * d, 2 * d),
        (above, math.ceil(0.1 * above)))]
    # flash attention: granite-8b's prefill first (the row the kernels line
    # reports for the bf16 tensor-core kernel), then decode-vs-prefill's f32
    # call (its row for the f32 SIMT kernel), hubert-xlarge's in bf16 and
    # f32, a window at full width, ragged S, tests/test_kernels.py's cases
    # in f32 and bf16, and the prefills of qwen3-moe (64 q heads on 4 KV
    # heads) and dbrx (48 on 8)
    bf16, f32 = torch.bfloat16, torch.float32
    flash_rows = [check_flash(dev, *case) for case in (
        (2, 32, 8, 4096, 128, True, 0, bf16),
        (2, 32, 8, DECODE_T, 128, True, 0, f32),
        (2, 16, 16, 4096, 80, False, 0, bf16),
        (2, 16, 16, 4096, 80, False, 0, f32),
        (2, 32, 8, 4096, 128, True, 1024, bf16),
        (1, 32, 8, 1000, 128, True, 0, f32),
        (1, 32, 8, 1000, 128, False, 0, f32),
        (1, 4, 2, 256, 64, True, 0, f32), (2, 8, 8, 128, 32, True, 0, f32),
        (1, 8, 1, 256, 64, True, 0, f32), (1, 4, 4, 256, 64, True, 96, f32),
        (1, 2, 1, 128, 64, False, 0, f32), (1, 4, 2, 128, 64, True, 0, bf16),
        (2, 64, 4, 4096, 128, True, 0, bf16),
        (2, 48, 8, 4096, 128, True, 0, bf16))]
    free_cuda()

    # phase 3: the main paths, with launch counts from these runs only
    train, test = make_classification(FMNIST_CNN, n_train=N_TRAIN,
                                      n_test=N_TEST, seed=0)
    total = dict.fromkeys(COUNTERS, 0)

    def count(launches):
        for name, n in launches.items():
            total[name] += n

    run_none, launches = main_path(train, test, "none")
    count(launches)
    kernels_off_beside_auto(run_none, train, test, "none")
    for alg, compress in (("fim_lbfgs", "int8"), ("fim_lbfgs", TOPK),
                          ("fedavg_sgd", TOPK)):
        run, launches = main_path(train, test, compress, alg)
        count(launches)
        kernels_off_beside_auto(run, train, test, compress)
        del run
    for alg in ("fedavg_adam", "fedprox", "feddane", "fedova",
                "fedova_lbfgs"):
        count(other_strategy(train, test, alg)["launches"])
    round_breakdown(run_none)
    del run_none
    free_cuda()

    # phase "edge": the edge runtime's runs, their launches from fresh
    # counts each round
    count(edge_phase(train, test, card))
    free_cuda()

    # phases "cohort", "cohort_edge" and "resume": the cohort simulator,
    # its edge wrapper and checkpoint/resume, launches from fresh counts
    count(cohort_phase(train, test, dev))
    count(cohort_edge_phase(train, test, dev))
    free_cuda()
    count(resume_phase(train, test, dev))
    free_cuda()
    # phase "fleet": no kernel of csrc/ (float64 torch ops on the card)
    fleet_phase(dev)
    free_cuda()
    # phase "sync": the fleet bodies and each kernel wrapper under
    # set_sync_debug_mode("error"); launches made here are not counted
    sync_phase(dev, leaf_shapes)
    free_cuda()

    # phase 4: LLM serving, each path from fresh counts
    llm = {"granite": serve_granite(dev)}
    free_cuda()
    llm["decode_vs_prefill"] = decode_vs_prefill(dev)
    free_cuda()
    llm["hubert"] = serve_hubert(dev)
    free_cuda()
    for name, key in (("flash_attention", "flash_launches"),
                      ("flash_attention_tc", "tc_launches")):
        total[name] = (sum(llm["granite"][key]) + llm["decode_vs_prefill"][key]
                       + sum(llm["hubert"][key]))

    # phase "llm_train": the federated LLM train step; every run from fresh
    # counts, the Gram once a fim_lbfgs step
    t0 = time.perf_counter()
    trained = llm_train(dev)
    emit({"phase": "llm_train_seconds", "seconds": time.perf_counter() - t0})
    train_gram = sum(r["gram_launches"] for r in trained.values())
    free_cuda()

    # phase "sharded": the train step on a (1, 1) DeviceMesh beside the
    # unsharded one, and one dry-run record; launches from fresh counts
    t0 = time.perf_counter()
    sharded = sharded_phase(dev)
    emit({"phase": "sharded_seconds", "seconds": time.perf_counter() - t0})
    train_gram += sharded["gram_launches"]

    # phase "llm_families": MoE, Mamba-2 and the hybrid at full width, each
    # path from fresh counts
    t0 = time.perf_counter()
    families = llm_families(dev)
    emit({"phase": "llm_families_seconds",
          "seconds": time.perf_counter() - t0})
    for row in families["serve"].values():
        total["flash_attention"] += sum(row["flash_launches"])
        total["flash_attention_tc"] += sum(row["tc_launches"])
    for row in families["decode_vs_prefill"].values():
        total["flash_attention"] += row["flash_launches"]
    train_gram += families["train"]["gram_launches"]
    total["vlbfgs_gram"] += train_gram
    free_cuda()

    # phase 5: the kernels line, then the result line
    def entry(name, source, replaces, rows, launches):
        main = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_err"] for r in rows),
                "shape": main["shape"], "ms": main["kernel_ms"],
                "call_ms": main["kernel_call_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"]}

    emit({"total_seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {**entry("fim_diag", "src/repro_torch/csrc/fim_diag.cu",
                 "src/repro/kernels/fim_diag.py:40", fim_rows,
                 total["fim_diag"]),
         "launches_are": "one a client grad_fim call, all leaves; on the "
                         "cohort path one a 64 (slot, leaf) matrices"},
        {**entry("vlbfgs_gram", "src/repro_torch/csrc/vlbfgs.cu",
                 "src/repro/kernels/vlbfgs.py:40", [*gram_rows, gram_mamba],
                 total["vlbfgs_gram"]),
         "launches_are": "one a server step, read in place from the "
                         "history; one a fim_lbfgs LLM train step; on a "
                         "mesh one a replication group of local shards, "
                         "then one (2m+1)^2 all-reduce",
         "sharded_launches": sum(r["gram_launches"]
                                 for r in sharded["sharded"]),
         **{phase: {k: row[k] for k in (
             "shape", "dtype", "kernel_ms", "kernel_call_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_largest_leaf_ms",
             "library_is")}
            for phase, row in (("llm_train", gram_rows[-1]),
                               ("llm_families", gram_mamba))},
         "llm_train_launches": train_gram},
        {**entry("int8_roundtrip", "src/repro_torch/csrc/codec_ops.cu",
                 "src/repro/kernels/codec_ops.py:69",
                 [int8_payload, *int8_rows], total["int8_roundtrip"]),
         "launches_are": "launch pairs (int8_amax + int8_apply), one a "
                         "client payload; on the cohort path one a 64 "
                         "leaves of the cohort's payloads"},
        {**entry("topk_select", "src/repro_torch/csrc/topk.cu",
                 "src/repro/kernels/codec_ops.py:133", topk_rows,
                 total["topk_select"]),
         "cluster_size": cluster, "cluster_launches":
             total["topk_select_cluster"],
         "four_launch_ms": topk_rows[0]["four_launch_ms"]},
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:106",
              [r for r in flash_rows if r["path"] == "tensor_core"],
              total["flash_attention_tc"]),
        entry("flash_attention_simt", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:106",
              [r for r in flash_rows if r["path"] == "simt"],
              total["flash_attention"] - total["flash_attention_tc"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
