#!/usr/bin/env python3
"""Drive the PyTorch port (deepdfa_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints one JSON line; any failure exits non-zero.

1. device — the card's name and power limit, and the build of every CUDA
   source of the port with ``nvcc`` for ``sm_90a`` (with ptxas's register
   and spill report).
2. kernel — the fused GGNN kernel (B1) against its plain torch version at
   width 128 and 5 rounds, at the serving ladder's three shapes and the
   megabatch shape, on padded batches of synthetic requests: max abs
   difference of the node states (limit ``KERNEL_LIMIT``) for the variant
   the call took (every shape must take the tensor-core ``wgmma`` one, 11
   launches a call) and for the kept ``ffma`` variant forced; the
   tensor-core edge sum's aggregates of one round's messages bitwise equal
   to the ``ffma`` variant's serial in-order sums (the padding sink's
   segment of thousands of edges included); CUDA-event and CUDA-graph
   times of both variants and the plain version; and the least time the
   card could take (the bound) for each variant (3xTF32 products on the
   tensor cores, FFMA on the FP32 units). One more row times the megabatch
   shape with its padding edges spread over all padding nodes, to show
   what the padding sink's long edge segment costs.
3. serve — the golden model (hidden 32 × 4 subkeys, 5 rounds, 3 head
   layers, input_dim 1002) with seeded random weights in the fused layout:
   ``ScoringEngine.from_model(..., max_batch=16, megabatch=True)`` and
   ``warmup()``, then 256 concurrent requests through ``MicroBatcher`` and
   one ``score_packed`` over a mixed window, with the kernel's launch count
   reset just before. The same requests scored by the segment layout on the
   card and by the fused layout's plain version on the CPU must agree
   within ``PROB_LIMIT``.
4. train_kernel — the fused backward kernel (B2) against its plain version
   at width 128 and 5 rounds at the three bucket shapes ``fit`` derives
   for the synthetic corpus at 256 graphs per batch, on ``batch_np``
   batches: max abs difference of dL/dh0 and of every weight gradient from
   the plain version evaluated in float64, each within ``GRAD_LIMIT`` of
   that gradient's largest magnitude (the float32 plain version's own
   difference is reported beside it), for the ``wgmma`` variant the call
   takes and for the kept ``ffma`` one forced, bitwise equality of two
   runs, CUDA-event and CUDA-graph times of the banked training forward,
   the backward (both variants) and the plain backward, both bounds and
   the launches per call (17 on ``wgmma``).
5. train — ``train.fit.fit`` of the golden model in the fused layout on the
   card: the synthetic corpus, no undersampling, 256 graphs per batch,
   derived buckets, 3 epochs (6 train steps at N = 16,768), with every
   launch count reset just before: steps/s, graphs/s, p50 step ms, launch
   counts (forward launches = (train steps + eval batches) × 11, backward
   launches = train steps × 17, every one on the ``wgmma`` variant),
   finite final metrics. Then one train step
   from one seed and batch, fused on the card against the segment layout on
   the card and the fused layout on the CPU (loss, gradients and new
   parameters within stated limits), and ``fit`` for 2 epochs plus
   ``fit(resume=True)`` to 3 in a spawned process against the
   uninterrupted run, and a second uninterrupted run: both bitwise equal
   (the port's reductions on the card have a fixed order). One step runs
   under ``torch.use_deterministic_algorithms(True, warn_only=True)`` as a
   diagnostic: the ops that warn are listed.
6. mega_kernel — the whole-model kernel (B3) against its plain version
   ``megabatch_reference`` on the card at the golden width, 5 rounds and 3
   head layers, at the megabatch serving shape and the three training
   buckets: max abs difference of the logits (limit ``KERNEL_LIMIT``), two
   calls bitwise equal, CUDA-event and CUDA-graph times (and with B1's
   ``ffma`` rounds forced), both bounds and launches per call, all of a
   call's rounds on ``wgmma``.
7. packed — the golden model with seeded weights in the megabatch layout
   scores the serve phase's 256 requests packed by
   ``pack_megabatches(uniform=True)`` under ``inference_mode``, with the B3
   count reset just before: graphs/s, packing efficiency, dispatches beside
   the per-bucket ladder's for the same graphs, B3 launches = batches ×
   launches per call; probabilities against the segment layout on the card
   and the megabatch layout's plain version on the CPU within
   ``PROB_LIMIT``.
8. train_megabatch — phase 5 in the megabatch layout: B3 launches =
   (train steps + eval batches) × 14, B1 = train steps × 11 (the backward's
   banked recompute), B2 = train steps × 17, all on ``wgmma``; the first
   step against the
   segment layout on the card and the megabatch layout on the CPU; the
   resumed and the repeated fit bitwise equal to the straight one.
9. hier_kernel — the level-1 encoder (B4: B3's launches with a head of 0
   layers) against its plain version ``megabatch_encoder_reference`` at the
   golden width and 5 rounds, at the megabatch serving shape and at a full
   hierarchical bin (64 graphs, about 4,094 nodes): max abs difference of
   the pooled rows (limit ``KERNEL_LIMIT``), two calls bitwise equal,
   CUDA-event and CUDA-graph times (and B1's ``ffma`` rounds forced), both
   bounds and launches per call; and each function's
   row embedded inside the full bin bitwise equal to its row embedded
   alone.
10. hier — the golden model's engine scores 16 seeded units (3-32
   functions each, the serve phase's request graphs, a seeded call DAG
   and summaries) through ``ScoringEngine.score_unit`` with a
   ``FunctionEmbeddingCache`` in a temporary directory, the B3/B4 count
   reset just before: the cold pass makes B4 launches = level-1
   dispatches × 14, all on B1's ``wgmma`` rounds, no fallback and one
   recompute per function; a warm
   pass over a fresh cache handle makes no dispatch and no recompute, hits
   every lookup and gives the same unit scores; unit and function scores
   against a CPU engine on the same state within ``PROB_LIMIT``, with the
   same level-2 weights. Units/s and functions/s cold and warm, the cold
   time per unit split into its two levels, and the device profile of the
   largest unit scored without the cache.
11. int8_kernel — the int8 product (B5) against its plain version
   ``int8_matmul_reference`` at M in {2048, 4096, 5120, 16768}, K = 128,
   N in {128, 384} (float32 activations, limit ``INT8_LIMIT``) and at the
   LLM's projections with bf16 activations and output, M = 1024, K × N in
   {4096 × 4096, 4096 × 11008, 11008 × 4096} (limit ``INT8_BF16_LIMIT``):
   max abs error over the largest output, two calls bitwise equal, the
   variant both took (every one of these shapes must take the tensor-core
   variant ``wgmma``), CUDA-event and CUDA-graph times of the kernel, the
   plain version and ``torch.matmul`` on the weight dequantized in advance
   in the activations' type (TF32 off), the host's microseconds to enqueue
   a call (a bf16 call encodes two TMA descriptors), TFLOP/s and the bound.
   Then the FFMA variant, off the main paths, at a shape TMA cannot
   describe (37 × 100 × 130), float32 and bf16.
12. serve_int8 — ``ScoringEngine.from_model(golden, precision="int8")``:
   the calibration gate must accept; the serve phase's 256 requests
   through ``MicroBatcher`` with the B5 count reset just before: B5
   launches = dispatches × 3 × rounds, all on the ``wgmma`` variant;
   probabilities against the float32
   engine within ``int8_max_score_delta`` and against ``GGNNInt8`` on the
   CPU within ``PROB_LIMIT``; requests/s, p50 and p99, and the device
   profile of one packed 48-request window.
13. flash_kernel — causal segment-masked attention (B6) against its plain
   version ``flash_attention_reference`` at the 7B serving shape (b 4, h 32,
   s 256, d 128, bf16, left pads as ``HashTokenizer`` makes them), the 13B
   ``pb_ft_pb_noexpl`` shape (b 6, h 40, s 1024), h 40 at s 2048 (b 4) and
   ``tiny_llama`` in float32 (b 2, h 4, 2 kv heads, s 128, d 16): the
   largest error of an output row over that row's largest value, every
   row (limits ``FLASH_BF16_LIMIT`` and ``FLASH_F32_LIMIT``; the max abs
   error over the whole output's largest value is printed beside it), two
   calls bitwise equal, CUDA-event and CUDA-graph times of the kernel, the
   plain version and ``scaled_dot_product_attention`` with the same
   boolean mask, the bound, TFLOP/s and the launches per call by variant:
   every bf16 d-128 shape must take ``wgmma``, float32 ``ffma``; at those
   shapes also the graph time of the ``mma`` variant (the kernel before
   ``wgmma``). Then,
   off the main paths, the ``mma`` variant at the 7B serving shape with
   d 64.
14. flash_bwd_kernel — the attention backward (B6b: the dk/dv kernel and
   the dq kernel) against its plain version
   ``flash_attention_backward_reference`` on the same forward output and
   logsumexp, at 7B training (b 4, h 32, s 256, d 128, bf16, left pads),
   13B ``pb_ft_pb_noexpl`` (b 6, h 40, s 1024), h 40 at s 2048 (b 4) and a
   grouped-query float32 shape (b 4, h 4, 2 kv heads, s 256, d 16): each
   row of dq, dk and dv over that row's largest value (limits
   ``FLASH_BF16_LIMIT`` and ``FLASH_F32_LIMIT``; rows whose exact gradient
   is 0 — a query that sees one key — over the tensor's largest), two calls
   bitwise equal, CUDA-event and CUDA-graph times of the kernels, the plain
   version and the autograd of ``scaled_dot_product_attention`` with the
   same boolean mask, the bound, TFLOP/s and the launches per call by
   variant (``wgmma`` at bf16 d 128, beside the ``mma`` variants' graph
   time, ``ffma`` in float32); then, off the
   main paths, the ``mma`` variants at b 4, s 256, 8 heads over 2 kv
   heads, d 64.
15. joint — ``JointEngine`` over ``LlamaModel(codellama_7b(attn_impl=
   "flash"))`` at full width and depth (32 layers, hidden 4096, bf16,
   weights drawn on the card from a seed), the golden GGNN in encoder mode
   (segment layout) and a seeded fusion head, ``HashTokenizer(32016)``,
   block 256, ``max_batch`` 4: 64 seeded C-like functions of 20-600
   subtokens paired with the serve phase's request graphs, one ``score``
   call per batch, the B6 count reset just before: functions/s, real and
   padded tokens/s, p50 batch ms, B6 launches = batches × 32 (every one
   on ``wgmma``, as in phases 19-21), the device
   profile of one batch, the weight GB. Probabilities against the same
   engine with B6 replaced by its plain version on the card
   (``FLASH_PROB_LIMIT``), against the same weights with
   ``attn_impl="full"`` on the card (``FULL_PROB_LIMIT``), the weights cut
   to 2 layers on the card against the CPU
   (``JOINT_PROB_LIMIT``), and the fused GGNN layout (B1) against segment
   (``PROB_LIMIT``).
16. scan — ``scan_paths`` from C source on the card. Vocabularies built
   with the port's ``build_vocab`` from a seeded training corpus of 2,000
   ``codegen`` functions; the golden model (the serve phase's seeded
   weights) behind ``ScoringEngine`` and the joint phase's 7B
   ``JointEngine`` as tier 2. The corpus: 256 seeded ``codegen`` files of 4
   functions each (1,024 functions, half vulnerable, the easy and the
   dataflow-hard templates) plus the ten ``tests/fixtures/realworld`` files
   and ``interproc/cross_taint.c``. With every count reset just before:
   a cold scan into a cache directory, the same cold scan encoded by 4
   spawned frontend processes (``FrontendConfig(mode="process")``: its
   report equal to the thread mode's in every key but the timings and the
   pool's steals), a warm scan (every file a hit, the
   rows the cold scan's), an interprocedural scan of ``cross_taint.c`` and
   32 generated files cold then warm (the warm one makes no level-1
   dispatch and no fallback), and a cascade scan whose band holds 64 of the
   cold scan's tier-1 scores, taken from their quantiles: B1 launches =
   tier-1 calls × 11, B4 = level-1 dispatches × 14, B6 = tier-2 batches ×
   32, every one on ``wgmma``. Off the main path: the three solver
   backends give identical graphs (and dependence edges and dataflow
   families) on every fixture and on 64 generated functions, the native one
   built; ``goldens.json``'s line facts hold on all ten fixtures; tier-1
   probabilities and the unit score against the same scans on a CPU engine
   (``PROB_LIMIT``). Files/s and functions/s of encode and of scoring, the
   device's busy share of the scoring and of a warm scan, the cache hit
   rates and the pycparser version.
17. corpus — C source → shards → ``fit`` → ``predict_paths`` through the
   port's entry points, in the run's own storage root
   (``DEEPDFA_STORAGE``, a temporary directory for the whole run, so the
   train phases find no shards). Build: ``deepdfa_tpu_torch.preprocess``
   over ``demo_corpus(2000, seed=0)`` with 4 thread workers and the random
   split (extraction, labelling and build functions/s, shards, vulnerable
   graphs); rebuild into a fresh directory with the extraction cache warm
   (every function a hit): every shard file, ``manifest.json``,
   ``splits.json``, ``split.txt`` and ``vocab.json`` byte for byte equal.
   Fit: the golden model in the fused layout for 3 epochs at 256 graphs a
   batch on those shards, the counts reset just before: the corpus ``fit``
   logs and ``load_corpus`` equal ``splits.json`` per split, B1 launches =
   (train steps + eval batches) × 11 and B2 = train steps × 17, all on
   ``wgmma``, finite final metrics; steps/s, graphs/s, p50 step ms, the
   busy share of a profiled step. Predict: ``predict_paths`` with the
   restored best checkpoint over the test split's sources (one ``.c`` file
   each) and ``tests/fixtures/realworld``, every statement ranked by
   occlusion, the B1 count reset just before: B1 launches = scorer calls ×
   11, all on ``wgmma``; every probability and every ranked saliency, and
   the gate mode's, within ``PROB_LIMIT`` of the same weights on the CPU
   (B1's plain version); functions/s, statements/s, the largest batch
   scored, the busy share of predict over the fixtures, and the top-1
   localization rate over the vulnerable test functions (reported only).
   The run directory and the test sources stay for serve_http.
17b. serve_http — the HTTP service on the corpus run: ``build_server``
   restores its best checkpoint into the fused layout (tier 1 on B1) with
   the joint phase's 7B ``JointEngine`` as the cascade's tier 2 (B6), a
   band from the quantiles of the tier-1 scores that holds 64 of them, a
   process-mode frontend pool of 4 workers. With every count reset just
   before, 16 closed-loop HTTP clients post the 400 test sources and the
   realworld fixtures twice (the second pass all result-cache hits):
   requests/s, functions/s, p50/p99 ms per pass, tier-1 and tier-2 p50,
   escalations, tier-2 answers, degradations (0), the pool's spawn seconds
   and encode rates, the cache hit rate; B1 launches = tier-1 dispatches ×
   11 and B6 = tier-2 batches × 32, all ``wgmma``. Off the main path:
   every tier-1 answer within 1e-6 of ``ScoringEngine.score`` (an engine
   restored the same way) and within ``PROB_LIMIT`` of a CPU engine, every
   tier-2 answer within ``JOINT_PROB_LIMIT`` of ``JointEngine.score`` on
   its function; ``/metrics``, ``/slo`` and ``/healthz`` (the JAX
   package's keys); the device's busy share of a profiled cold pass;
   SIGTERM with requests in flight (every request not refused for the
   drain answered 200, the listener closed). Then ``python -m
   deepdfa_tpu_torch.serve.server`` as a subprocess (its ``serving`` line,
   8 requests, SIGTERM, its ``drained`` line, rc 0) and ``python -m
   deepdfa_tpu_torch.scan --interproc`` over the fixtures (its
   ``scan.json`` rows and unit score equal to ``scan_paths`` in this
   process on B1 and B4).
17c. artifact — exported artifacts and the warm store on the corpus run.
   ``train.cli.export_model`` traces the restored best checkpoint on the
   card at the config's ceiling shapes (257 graphs × 40,960 nodes × 81,920
   edges) into ``model.pt2`` + ``manifest.json``, and ``serving.
   export_ggnn`` the same state on the CPU: export and load seconds,
   ``.pt2`` bytes, and each program must call the registered ops
   ``deepdfa.fused_ggnn`` and ``deepdfa.segment_sum`` and no
   ``index_add``. ``ScoringEngine.from_artifact`` of each on the card
   scores the 400 test sources + the realworld fixtures, each with B1's
   count reset just before: B1 launches = dispatches × 11, all ``wgmma``;
   functions/s beside the ``from_checkpoint`` engine's; both within
   ``ARTIFACT_LIMIT`` of it, and the CPU-exported artifact run on the CPU
   within ``PROB_LIMIT`` of the card. The warm store: two engines restored
   from the checkpoint warm through one ``WarmStore`` (the first misses 3
   and exports 3, the second hits 3, per bucket the first call's, the
   load's and the saved seconds as measured) and score the same functions
   bitwise equal, the joiner's B1 launches = dispatches × 11; then the same
   for two int8 engines (the gate must accept; the joiner's B5 launches =
   dispatches × 15, its programs call ``deepdfa.int8_matmul``) over the
   golden model's seeded weights: the gate refuses the corpus fit's (its
   verdict and delta are reported).
   Then ``serve.server --artifact`` and ``serve.server`` with
   ``serve.warm_store_dir`` (its ``serving`` line: 3 hits) as
   subprocesses (8 × 200, bodies within ``ARTIFACT_LIMIT`` of the engine,
   ``drained``, rc 0), and ``scan --artifact`` over the fixtures (rows
   equal to ``scan_paths`` on the in-process artifact engine).
17d. trainer — ``python -m deepdfa_tpu_torch.train.cli`` on the corpus
   phase's ``demo`` shards, the golden model in the fused layout, 3 epochs
   of 6 steps, every child with ``--device cuda``. A clean ``fit`` through
   ``cli.main`` in this process, the counts reset just before: B1 =
   (steps + eval batches) × 11, B2 = steps × 17, all ``wgmma``; its final
   parameters are the oracle. Four children side by side: a crash
   between the second checkpoint's payload and its ``meta.json`` (rc 137,
   a ``*.tmp`` left), a ``preempt.sigterm`` mid-epoch (rc 75, the
   emergency commit within ``preempt_deadline_s``, steps done > 0), a real
   SIGUSR1 sent after the first commit (rc 75, its newest checkpoint
   restorable), and a ``step.hang`` with a 10 s deadline whose
   ``/metrics``, ``/healthz`` and ``/slo`` (``serve.obs.train_port=0``)
   are scraped while it is wedged (non-zero exit within the deadline plus
   ``TRAINER_ABORT_MARGIN_S`` of the wedge being seen, ``watchdog_timeout``
   journaled, a flight dump). Then ``fit --resume`` of the crashed and the
   preempted runs, each bitwise the clean run, beside an isolated tuning
   trial (a ``fit`` child on the card). In this process: a fit with
   ``step.nan_grads`` on three consecutive steps and patience 2 (it
   completes, ``n_rollbacks`` ≥ 1, ``lr_scale`` = backoff ** rollbacks, B1
   and B2 following every step run); ``test`` (B1 = batches × 11; its
   probabilities within ``PROB_LIMIT`` of the same checkpoint on the CPU;
   ``pr.csv`` and ``pr_binned.csv`` with the JAX header), ``predict``
   over the realworld fixtures (B1 = scorer calls × 11, within
   ``ARTIFACT_LIMIT`` of ``predict_paths`` in this process), ``analyze``
   (the 28 variants) and ``trace export`` (``train.epoch`` spans);
   ``run_int8_train`` over two megabatch-packed corpus batches, 8 steps
   (B5 = (gate batches + steps) × 15, all ``wgmma``; the gate's deltas
   within ``INT8_TRAIN_LIMIT`` of the gate on the CPU); one epoch with
   ``frozen_encoder_optimizer`` (every encoder tensor bitwise unchanged,
   the head moved); a two-point tuning grid. Steps/s and p50 step ms, the
   children's seconds to their ``corpus:`` line and the resumes' to their
   first step, the emergency commit's and the abort's seconds.
17e. dataflow — the source paper's node-level and dataflow-lattice GGNN,
   on the corpus phase's ``demo`` shards and test sources. ``preprocess
   --dataset demo_hard --n 400 --dataflow-labels --dataflow-families``
   (``scripts/dataflow_experiment.py``'s corpus plus the families). Two
   ``train.cli fit`` runs with ``label_style dataflow_solution_out`` in the
   segment layout (the unions run on the ordered segment sums, no
   kernel), ``aggregation`` sum and ``union_relu``, the golden model, 12
   epochs: the train loss falls, the test F1 beside BASELINE.md's 0.974
   (reported only), ``test`` on the card within ``PROB_LIMIT`` of the CPU
   (loss and every node's probability); a ``union_simple`` step repeats
   bitwise on the card. A ``node`` fit in the fused layout on the demo
   shards (B1 = (steps + eval batches) × 11, B2 = steps × 17, all
   ``wgmma``), ``test`` (``statement_hit@1..10``, B1 = batches × 11),
   ``predict`` over the fixtures and the test sources (one scorer call a
   function, B1 = functions × 11; every node probability within
   ``PROB_LIMIT`` of the CPU). One epoch each with the families in the
   fused layout: width 224 (``dataflow_families``, solver labels) and 288
   (both flags, the same functions rebuilt with the interprocedural
   columns, graph labels): B1 = (steps + eval batches) × 11 and B2 = steps
   × 32, all ``ffma``; B1 and B2 at each width against their plain
   versions (``KERNEL_LIMIT``, ``GRAD_LIMIT`` against float64), bitwise
   repeats, graph times and bounds; the kernels' shared-memory width
   limits read on the card. The node model exported on the card (its
   program calls ``deepdfa.fused_ggnn``), loaded by ``from_artifact`` and
   served over HTTP through ``build_server`` to 64 test sources (B1 =
   dispatches × 11, all ``wgmma``; every score within ``ARTIFACT_LIMIT``
   of the engine). Then, as children side by side: a node fit crashed
   between a checkpoint's payload and its ``meta.json`` (rc 137), resumed
   bitwise the clean run, and ``train.cli scan`` over the fixtures with
   the node checkpoint (rc 0). Export and load seconds, p50 step ms, test
   graphs/s, predict functions/s, each with the card's name and power
   limit.
18. bigvul — the real-dataset readers and Joern ingestion, in the run's
   storage root, with inputs written in the published schemas without
   pandas. Big-Vul: a full-schema ``external/MSR_data_cleaned.csv`` (a
   leading unnamed index and every typed column of the reference reader)
   of 2,000 ``codegen`` pairs, half vulnerable, every 40th a
   dataflow-hard one of chain depth 30-120, and an
   ``external/linevul_splits.csv`` assigning every id; then
   ``preprocess --dataset bigvul --split fixed --workers 4`` (rows read and
   kept by each quality filter equal to a serial in-process read of the
   same file, no front-end failure, positive graphs), and a warm rebuild
   into a fresh directory (the reader's cache and every extraction a hit)
   whose shards, manifest, ``splits.json``, ``split.txt`` and
   ``vocab.json`` are byte for byte the first build's. Fit: the golden
   model in the fused layout for 3 epochs on those shards, the counts reset
   just before: ``fit`` reads as many graphs per split as ``splits.json``
   lists, B1 launches = (train steps + eval batches) × 11, B2 = train steps
   × 17, all on ``wgmma``; p50 step ms, graphs/s, the busy share of a
   profiled step, the largest graph. Devign: a 400-function
   ``external/function.json`` with ``external/codexglue_splits.csv``,
   ``preprocess --dataset devign --split fixed``, and one epoch of ``fit``
   on its graph labels with the same launch checks. Joern:
   ``tests/fixtures/sample.c``'s exported artifacts through
   ``cpg.joern.load_cpg``, encoded against the Big-Vul vocabulary and
   scored by ``ScoringEngine`` with the Big-Vul model's best checkpoint on
   B1 (11 launches, ``wgmma``), within ``PROB_LIMIT`` of a CPU engine.
19. finetune — ``LoraFinetuner`` on ``LlamaForCausalLM(codellama_7b(
   attn_impl="flash", lora_rank=16, lora_alpha=16))`` over the joint
   phase's seeded weights and a seeded LM head: one epoch over 32 seeded
   C-like functions, block 256, batch 4 (8 steps), the counts reset just
   before: steps/s, real and padded tokens/s, p50 step ms, peak memory, B6
   launches = steps × 32 and B6b launches = steps × 64, all ``wgmma``;
   the first step's
   adapter gradients against the same step with B6 and B6b on their plain
   versions (``LORA_GRAD_LIMIT``); the saved adapters loaded onto a fresh
   base bitwise, and merged into it, against the unmerged model's hidden
   states (``MERGE_LIMIT``); the device profile of one step.
20. joint_train — ``JointTrainer`` (MSIVD mode: the 7B LLM frozen under
   ``no_grad``) with a fresh fusion model (the golden GGNN encoder): one
   epoch over the same 32 functions with their eval points over 16 more,
   B6 launches = (steps + eval batches) × 32 and no B6b launch, steps/s;
   ``JointEngine.from_run_dir`` on the ``epoch_0`` it wrote scores the
   eval functions within 1e-5 of the trainer's own evaluation.
21. joint_int8 — the joint model with ``int8_runtime=True`` from
   ``to_int8_runtime_params`` of the same weights: B5 launches = batches ×
   32 × 7 with bf16 activations, all on the ``wgmma`` variant,
   probabilities against every projection on B5's plain version on the
   card (``INT8_PROB_LIMIT``), the difference from the bf16 engine,
   functions/s, and B5's share of one batch's profiled device time.

Then each phase's wall seconds, the kernel table as one JSON line, the
``nvidia-smi`` name and power limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints nothing and exits 2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import json
import logging
import multiprocessing
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deepdfa_tpu_torch import preprocess
from deepdfa_tpu_torch import utils as port_utils
from deepdfa_tpu_torch.data import ingest
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, BatchConfig,
                                      CascadeConfig, DataConfig,
                                      ExperimentConfig, FeatureConfig,
                                      FrontendConfig, GGNNConfig, OptimConfig,
                                      ServeConfig)
from deepdfa_tpu_torch.cpg import analyses as cpg_analyses
from deepdfa_tpu_torch.cpg.dataflow import ReachingDefinitions
from deepdfa_tpu_torch.cpg.features import (SOLVER_BACKENDS,
                                            add_dependence_edges,
                                            dataflow_node_features)
from deepdfa_tpu_torch.cpg.frontend import parse_functions, parse_source
from deepdfa_tpu_torch.cpg.joern import load_cpg
from deepdfa_tpu_torch.data.codegen import (demo_corpus, generate_function,
                                            generate_hard_function)
from deepdfa_tpu_torch.data.extract_cache import ExtractCache
from deepdfa_tpu_torch.data.graphs import (GraphBatcher, batch_np,
                                           derive_buckets, to_device)
from deepdfa_tpu_torch.data.materialize import corpus_hashes, corpus_vocabs
from deepdfa_tpu_torch.data.sampler import positive_weight
from deepdfa_tpu_torch.data.synthetic import random_dataset, random_graph
from deepdfa_tpu_torch.llm import llama as llama_mod
from deepdfa_tpu_torch.llm.dataset import (GraphJoin, HashTokenizer,
                                           encode_functions)
from deepdfa_tpu_torch.llm.finetune import (FinetuneConfig, LoraFinetuner,
                                            _lm_batches, lm_loss)
from deepdfa_tpu_torch.llm.fusion import build_fusion
from deepdfa_tpu_torch.llm.joint import JointConfig, JointTrainer
from deepdfa_tpu_torch.llm.joint_engine import JointEngine
from deepdfa_tpu_torch.llm.llama import LlamaModel, build_llama, codellama_7b
from deepdfa_tpu_torch.llm.lora import freeze_base, is_lora_name, merge_lora
from deepdfa_tpu_torch.llm.quant import to_int8_runtime_params
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.models.ggnn_hier import (N_SUMMARY_FEATURES,
                                                UnitCallGraph, UnitFunction,
                                                unit_call_edges)
from deepdfa_tpu_torch.ops import _build
from deepdfa_tpu_torch.ops import flash_attention as fa
from deepdfa_tpu_torch.ops import fused_ggnn as fg
from deepdfa_tpu_torch.ops import int8_matmul as i8
from deepdfa_tpu_torch.ops import megabatch as mb
from deepdfa_tpu_torch.pipeline import (encode_cpg, encode_source,
                                        vocab_content_hash)
from deepdfa_tpu_torch.predict import (Scorer, collect_sources, load_vocabs,
                                       predict_paths)
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.scan import _score_functions, scan_paths
from deepdfa_tpu_torch.serve import (FunctionEmbeddingCache, MicroBatcher,
                                     ScoringEngine, mega_bucket,
                                     serve_buckets)
from deepdfa_tpu_torch.serve.cache import ScanCache
from deepdfa_tpu_torch.serve.engine import model_revision
from deepdfa_tpu_torch.serve.frontend import encode_session_factory
from deepdfa_tpu_torch.serve.server import build_server
from deepdfa_tpu_torch.serve.warmstore import WarmStore
from deepdfa_tpu_torch.serving import (export_ggnn, exported_ops,
                                       load_exported, load_program)
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.cli import export_model
from deepdfa_tpu_torch.train.cli import main as cli_main
from deepdfa_tpu_torch.train.fit import fit, load_corpus
from deepdfa_tpu_torch.train.loop import Trainer
from deepdfa_tpu_torch.train.metrics import ConfusionState

# H100 SXM data sheet: FP32 outside the tensor cores, dense bf16 and TF32
# on the tensor cores, HBM3 bandwidth (700 W)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# 3xTF32 products on the tensor cores (FFMA in the kernels' ffma variant)
# against cuBLAS in the plain version: the 128-wide dots and the GRU
# products are summed in other orders, and the plain version's index_add_
# adds with atomics in a varying order
KERNEL_LIMIT = 1e-4
PROB_LIMIT = 1e-4
# the int8 product against its plain version, over the largest output: FFMA
# over K = 128 in order against cuBLAS's order, both in float32
INT8_LIMIT = 1e-5
# backward kernel against its plain version evaluated in float64 on the same
# inputs, relative to each gradient's largest magnitude: the kernel's float32
# sums over five reverse rounds (the float32 plain version, whose cuBLAS sums
# and index_add_ atomics err as much, is reported beside it)
GRAD_LIMIT = 1e-4
# one train step on the card (fused or megabatch layout) against the segment
# layout on the card and against the same layout on the CPU: loss and every gradient (relative
# to its largest magnitude, see compare_steps) agree to float32 rounding.
# AdamW's first step moves each parameter by lr times g/(|g| + eps): where
# |g| is at rounding level (the pooling gate's bias, whose true gradient is
# 0: softmax is shift-invariant) the two sides may move it by up to lr in
# opposite directions, so the parameters are held to STEP_PARAM_LIMIT where
# |g| is above STEP_GRAD_FLOOR, and to 2 lr everywhere
STEP_LOSS_LIMIT = 1e-5
STEP_GRAD_LIMIT = 1e-4
STEP_GRAD_FLOOR = 1e-6
STEP_PARAM_LIMIT = 1e-6
# B5 with bf16 activations and a bf16 output against its plain version
# (cuBLAS float32 sums, the same rounding to bf16), over the largest output:
# the float32 sums differ in order, so an output near a rounding boundary
# may round to the neighbouring bf16 value, one ulp, at most 2^-7 of it
INT8_BF16_LIMIT = 1e-2
# B6 against its plain version, each output row over that row's largest
# value (see row_rel_err). bf16: the JAX package's own bar for its flash
# path (tests/test_llama.py:239); the kernel rounds P to bf16 against a
# running maximum over 64-key tiles, the plain version against the row's
# maximum. float32: the same sums in other orders
FLASH_BF16_LIMIT = 2e-2
FLASH_F32_LIMIT = 1e-5
# probabilities of the 7B joint engine (bf16, seeded random weights). The
# same weights cut to 2 layers on the card against the CPU (cuBLAS against
# the CPU's bf16 products, B6 against its plain version): two layers of bf16
# roundings in other places; a probability moves by ~0.25 of its logit's
# change, a logit by ~0.6 of the final hidden state's relative change
JOINT_PROB_LIMIT = 5e-3
# probabilities of the 32-layer engines against a path of the same
# semantics that rounds to bf16 in other places; the bf16 residual stream
# carries a one-ulp difference through the layers that follow. Each limit
# is twice the larger of its own readings on an H100 at weight seeds 0 and
# 1 (PERF.md): two such paths differ by up to 2x between seeds.
# B6 against its plain version (P rounded at a running maximum against the
# row's maximum): 8.0e-3 and 8.0e-3
FLASH_PROB_LIMIT = 1.6e-2
# B6 against attn_impl="full" (the normalised weights rounded, not P):
# 1.07e-2 and 9.4e-3 (B6's plain version against full: 1.58e-2 and 8.4e-3)
FULL_PROB_LIMIT = 2.2e-2
# B5 against its plain version in the int8 engine (a projection's bf16
# output may round one ulp apart): 9.0e-3 and 5.5e-3
INT8_PROB_LIMIT = 1.8e-2
# the first LoRA step's adapter gradients at CodeLlama-7B width (bf16, 32
# layers) with B6 and B6b against the same step with both on their plain
# versions, over each adapter's largest gradient: bf16 roundings at other
# places (P and dS against running maxima, the outputs) carried back
# through 32 layers. Twice the larger of its readings on an H100 at weight
# seeds 0 and 1 (PERF.md): 2.41e-2 and 2.75e-2. At a fixed seed the
# reading repeats bitwise from call to call; an earlier lm_loss that took
# the softmax across a transposed [v, b·s] layout read 2.85e-2 at seed 1
# (its float32 loss gradient rounds otherwise). The per-row check of B6b
# against its plain version (flash_bwd_kernel) is the tight one.
LORA_GRAD_LIMIT = 5.5e-2
# hidden states of the model with the trained adapters merged into its
# projections against the unmerged model, over the largest value: the
# merged weight rounds W + A·B·scale to bf16 once, the unmerged path adds
# the adapter's bf16 output; 32 layers carry each rounding. Twice the
# larger reading at seeds 0 and 1: 2.90e-2 and 2.53e-2
MERGE_LIMIT = 5.8e-2
WIDTH, STEPS, MAX_BATCH, INPUT_DIM = 128, 5, 16, 1002
TRAIN_GRAPHS = 256
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` with the host left out: one
    call captured in a CUDA graph, replayed ``reps`` times between two CUDA
    events (a replay adds a few microseconds of its own). Unlike
    :func:`cuda_ms` it leaves out the host's time between launches, which
    bounds a call of a few microseconds of work. The profiler's device sums
    came out short of the event times for calls of a millisecond, when it
    dropped events; this does not depend on it. A call that cannot be
    captured fails the run."""
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        fail(f"graph capture failed: {exc}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (the last axis) over that row's largest
    magnitude, across every row. An attention row that sees one key has
    outputs of ~4, one that sees hundreds of ~0.1: over the whole output's
    largest value, an error confined to long rows would pass."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    top = want.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((err / top).max())


# ---------------------------------------------------------------- phase 2


def fill(bucket, rng, mean_nodes: int):
    """Synthetic requests packed into one bucket as the batcher would."""
    graphs, nn_, ne = [], 0, 0
    while len(graphs) < bucket.capacity:
        g = random_graph(rng, input_dim=INPUT_DIM, mean_nodes=mean_nodes)
        if not bucket.admits(g):
            continue
        if not bucket.spec.fits(len(graphs) + 1, nn_ + g.n_nodes,
                                ne + g.n_edges):
            break
        graphs.append(g)
        nn_ += g.n_nodes
        ne += g.n_edges
    return batch_np(graphs, bucket.spec.max_graphs, bucket.spec.max_nodes,
                    bucket.spec.max_edges)


def spread_padding(b):
    """``b`` with its padding edges turned into self-loops spread round-robin
    over the padding nodes, still sorted by receiver."""
    ne, nr = int(b.edge_mask.sum()), int(b.node_mask.sum())
    pad = np.arange(nr, b.max_nodes, dtype=np.int32)
    loops = pad[np.arange(len(b.senders) - ne) % len(pad)]
    snd = np.concatenate([b.senders[:ne], loops])
    rcv = np.concatenate([b.receivers[:ne], loops])
    order = np.argsort(rcv, kind="stable")
    return b._replace(senders=snd[order], receivers=rcv[order])


def tc_bound(products: float, adds: float, nbytes: float) -> dict:
    """The least milliseconds for a GGNN kernel's work on this card, for its
    tensor-core variant and for the FFMA one: operations (3xTF32 runs each
    product's FLOPs three times on the TF32 tensor cores, the edge sums and
    other non-product work on the FP32 units; the FFMA variant runs all of
    it on the FP32 units) or bytes (inputs once, outputs once) over HBM
    bandwidth, the larger."""
    t_bytes = nbytes / PEAK_BYTES
    t_tc = 3 * products / PEAK_TF32 + adds / PEAK_FP32
    t_ffma = (products + adds) / PEAK_FP32
    return {"bound_ms": max(t_tc, t_bytes) * 1e3,
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "ffma_bound_ms": max(t_ffma, t_bytes) * 1e3,
            "ffma_bound_by": "operations" if t_ffma >= t_bytes else "bytes"}


def kernel_bound(n: int, e: int, d: int, steps: int) -> dict:
    """B1: per round 2·N·D² for the edge linear and 2·2·N·D·3D for the two
    gate products, E·D edge adds; bytes: h in and out, the edges, the
    weights."""
    products = steps * (2 * n * d * d + 2 * 2 * n * d * 3 * d)
    nbytes = 4 * (2 * n * d + 2 * e + d * d + d + 2 * (d * 3 * d + 3 * d))
    return tc_bound(products, steps * e * d, nbytes)


def aggregates_bitwise(p) -> bool:
    """B1's tensor-core edge sum against the FFMA variant's serial one, on
    one round's messages of the prepared call ``p`` (the padding sink's
    segment of thousands of edges included): both round kernels bank their
    aggregates of the same ``msg``, which must be bitwise equal. Direct
    launches, off the main path's counts."""
    lib = fg._kernels()
    n, d, e = p.n, p.dp, p.e
    stream = torch.cuda.current_stream().cuda_stream
    msg = p.h @ p.ew + p.eb
    weights = [t.data_ptr() for t in (p.xw, p.xb, p.hw, p.hb)]
    out = torch.empty_like(p.h)
    banks = []
    for kind in fg.VARIANTS:
        row_ptr = torch.empty(n + 1, dtype=torch.int32, device="cuda")
        agg = torch.empty_like(p.h)
        if kind == "wgmma":
            heads = torch.empty(fg.heads_words(e), dtype=torch.int32,
                                device="cuda")
            # no row in the FFMA lane: the check is of the edge sum
            flags = torch.zeros(n, dtype=torch.int32, device="cuda")
            codes = [lib.ggnn_tc_prep(p.rcv.data_ptr(), p.snd.data_ptr(), e,
                                      n, row_ptr.data_ptr(), heads.data_ptr(),
                                      stream),
                     lib.ggnn_tc_round(p.h.data_ptr(), msg.data_ptr(),
                                       row_ptr.data_ptr(), p.snd.data_ptr(),
                                       heads.data_ptr(), flags.data_ptr(),
                                       *weights, out.data_ptr(),
                                       agg.data_ptr(), n, stream)]
        else:
            codes = [lib.ggnn_csr(p.rcv.data_ptr(), e, n, row_ptr.data_ptr(),
                                  stream),
                     lib.ggnn_gru_round(p.h.data_ptr(), msg.data_ptr(),
                                        row_ptr.data_ptr(), p.snd.data_ptr(),
                                        *weights, out.data_ptr(),
                                        agg.data_ptr(), n, d, stream)]
        if any(codes):
            fail(f"aggregate check: a {kind} launch failed: {codes}")
        banks.append(agg)
    torch.cuda.synchronize()
    return torch.equal(*banks)


def reset_variant_counts() -> None:
    """B1's, B2's and B3/B4's counts by variant, from zero."""
    for counts in (fg.n_variant_launches, fg.n_bwd_variant_launches,
                   mb.n_variant_launches):
        for k in counts:
            counts[k] = 0


def check_ggnn_wgmma(path: str, kernel: str, counts: dict,
                     total: int) -> None:
    """Fail unless every one of a path's ``total`` launches of ``kernel``
    (B1-B4) was on the tensor-core variant."""
    if counts.get("wgmma") != total or sum(counts.values()) != total:
        fail(f"{path}: {kernel} launches by variant {counts}, expected all "
             f"{total} on wgmma")


def per_call_launches(fn) -> dict:
    """B1's launches of one call of ``fn``, by variant."""
    before = dict(fg.n_variant_launches)
    fn()
    return {k: fg.n_variant_launches[k] - before[k] for k in fg.VARIANTS}


def phase_kernel() -> list[dict]:
    fg._kernels()
    rng = np.random.default_rng(0)
    ladder = serve_buckets(MAX_BATCH)
    shapes = [("ladder_126", ladder[0], 50), ("ladder_1022", ladder[1], 500),
              ("ladder_4094", ladder[2], 2500),
              ("mega", mega_bucket(MAX_BATCH), 50)]
    w = seeded_cuda(rng)
    d = WIDTH
    weights = ggnn_weights(w, d)
    rows = []
    for name, bucket, mean_nodes in shapes + [("mega_padding_spread", None, 0)]:
        if bucket is None:
            # diagnostic: the mega batch with its padding edges spread as
            # self-loops over all padding nodes instead of the sink alone,
            # which shows what the sink's long segment costs
            b = spread_padding(b)
        else:
            b = fill(bucket, rng, mean_nodes)
        n, e = b.max_nodes, len(b.senders)
        h0 = w(n, d, std=0.2)
        snd = torch.from_numpy(b.senders).cuda()
        rcv = torch.from_numpy(b.receivers).cuda()
        args = (h0, snd, rcv) + weights
        call = lambda: fg.fused_ggnn(*args, n_steps=STEPS)
        plain = lambda: fg.fused_ggnn_reference(*args, n_steps=STEPS)
        with torch.inference_mode():
            p = fg._Prepared(h0, snd, rcv, weights, fg._max_width)
            ffma = lambda: fg._forward_cuda(p, STEPS, bank=False, kind="ffma")
            got = call()
            want = plain()
            forced = ffma()[0]
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ffma_err = float((forced - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            launches = per_call_launches(call)
            agg_bitwise = aggregates_bitwise(p)
            ms = cuda_ms(call, 20)
            plain_ms = cuda_ms(plain, 20)
            ffma_ms = cuda_ms(ffma, 20)
            dev = {"graph_ms": graph_ms(call, 20),
                   "ffma_graph_ms": graph_ms(ffma, 20),
                   "plain_graph_ms": graph_ms(plain, 20)}
            ms_again = cuda_ms(call, 20)
            dev["graph_ms_repeat"] = graph_ms(call, 20)
        sink_edges = int((b.receivers == n - 1).sum())
        row = {"phase": "kernel", "shape": name, "n": n, "e": e, "d": d,
               "n_steps": STEPS, "real_nodes": int(b.node_mask.sum()),
               "real_edges": int(b.edge_mask.sum()),
               "sink_segment_edges": sink_edges, "variant": p.variant,
               "max_abs_err": err, "ffma_max_abs_err": ffma_err,
               "limit": KERNEL_LIMIT, "finite": finite,
               "aggregates_bitwise_vs_ffma": agg_bitwise,
               "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
               "ffma_ms": ffma_ms, **dev, **kernel_bound(n, e, d, STEPS),
               "launches_per_call": fg.launches_per_call(STEPS),
               "launches_by_variant": launches}
        emit(row)
        if not finite or not err <= KERNEL_LIMIT:
            fail(f"kernel disagrees with its plain version at {name}: {err}")
        if not ffma_err <= KERNEL_LIMIT:
            fail(f"the ffma variant disagrees with its plain version at "
                 f"{name}: {ffma_err}")
        if launches != {"wgmma": fg.launches_per_call(STEPS), "ffma": 0}:
            fail(f"B1 at {name} launched {launches}, expected "
                 f"{fg.launches_per_call(STEPS)} on wgmma")
        if not agg_bitwise:
            fail(f"B1's edge sum at {name} differs from the serial in-order "
                 f"sum")
        rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 3


def requests() -> list:
    """256 DeepDFA-sized CFGs: mostly 20-120 nodes, 16 of 300-1000."""
    small = random_dataset(240, seed=1, input_dim=INPUT_DIM, mean_nodes=50)
    rng = np.random.default_rng(2)
    large = []
    while len(large) < 16:
        g = random_graph(rng, input_dim=INPUT_DIM, mean_nodes=550)
        if 300 <= g.n_nodes <= 1000:
            large.append(g)
    reqs = small + large
    order = np.random.default_rng(3).permutation(len(reqs))
    return [reqs[i] for i in order]


def drive_batcher(engine, reqs, clients: int = 16):
    """Closed-loop clients: each submits its share one request at a time."""
    batcher = MicroBatcher(engine, max_batch=MAX_BATCH, max_wait_ms=5.0,
                           max_queue=len(reqs)).start()
    probs = np.full(len(reqs), np.nan, np.float32)
    lat = np.zeros(len(reqs))
    errors = []

    def client(k):
        try:
            for i in range(k, len(reqs), clients):
                t0 = time.perf_counter()
                probs[i] = batcher.submit(reqs[i]).result(timeout=300)
                lat[i] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batcher.stop()
    if errors:
        fail(f"batcher requests failed: {errors[:3]}")
    return probs, lat, wall


def profile_call(fn, match: str | None = None) -> dict:
    """Device time by kernel over one call of ``fn`` (made after the main
    path's counts were read), and the device's busy share of the host's
    wall time for that call; with ``match``, the device time of the kernels
    whose name holds it and their share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's own device
        # time is that of the kernels it launched, which are listed too
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            dev[ev.key] = dev.get(ev.key, 0.0) + us
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_us": wall_us, "device_us": total,
           "busy_share": total / wall_us if total else None,
           "top_kernels_us": [[k[:60], v] for k, v in top]}
    if match is not None:
        us = sum(v for k, v in dev.items() if match in k)
        out[f"{match}_us"] = us
        out[f"{match}_share"] = us / total if total else None
    return out


def phase_serve() -> dict:
    cfg = GGNNConfig(hidden_dim=32, n_steps=STEPS, num_output_layers=3,
                     concat_all_absdf=True, label_style="graph",
                     layout="fused")
    model = make_model(cfg, INPUT_DIM, device="cuda", seed=0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    engine = ScoringEngine.from_model(model, None, "graph", KEYS,
                                      max_batch=MAX_BATCH, megabatch=True,
                                      device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    reqs = requests()
    window = reqs[:48]

    # the main path: counts from zero, read right after
    fg.n_launches = 0
    reset_variant_counts()
    d0 = engine.n_dispatches
    probs, lat, wall = drive_batcher(engine, reqs)
    packed = engine.score_packed(window)
    torch.cuda.synchronize()
    launches = fg.n_launches
    by_variant = dict(fg.n_variant_launches)
    dispatches = engine.n_dispatches - d0

    # references, off the main path: the segment layout on the card and the
    # fused layout's plain version on the CPU, over the same weights
    seg_cfg = dataclasses.replace(cfg, layout="segment")
    seg = ScoringEngine.from_model(
        make_model(seg_cfg, INPUT_DIM, device="cuda"), state, "graph", KEYS,
        max_batch=MAX_BATCH, megabatch=True, device="cuda")
    seg_probs = seg.score_packed(reqs)
    cpu = ScoringEngine.from_model(
        make_model(cfg, INPUT_DIM, device="cpu"),
        {k: v.cpu() for k, v in state.items()}, "graph", KEYS,
        max_batch=MAX_BATCH, megabatch=True, device="cpu")
    cpu_probs = cpu.score_packed(reqs[:16])

    per_call = fg.launches_per_call(STEPS)
    busy = profile_call(lambda: engine.score_packed(window))
    row = {"phase": "serve", "requests": len(reqs),
           "requests_per_s": len(reqs) / wall, "wall_s": wall,
           "p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3),
           "warmup_s": warmup_s, "n_dispatches": dispatches,
           "n_launches": launches, "launches_per_forward": per_call,
           "launches_by_variant": by_variant,
           "packed_window": len(window),
           "packed_padding_efficiency": engine.last_padding_efficiency,
           "max_abs_prob_diff_vs_segment": float(np.abs(probs - seg_probs).max()),
           "max_abs_prob_diff_packed_vs_batcher": float(
               np.abs(packed - probs[:len(window)]).max()),
           "max_abs_prob_diff_vs_cpu": float(
               np.abs(probs[:16] - cpu_probs).max()),
           "limit": PROB_LIMIT, "model_rev": engine.model_rev,
           "profile_score_packed": busy}
    emit(row)
    if not (np.all(np.isfinite(probs)) and np.all((probs > 0) & (probs < 1))):
        fail("non-finite or out-of-range probabilities")
    for key in ("max_abs_prob_diff_vs_segment",
                "max_abs_prob_diff_packed_vs_batcher",
                "max_abs_prob_diff_vs_cpu"):
        if not row[key] <= PROB_LIMIT:
            fail(f"{key} = {row[key]} over {PROB_LIMIT}")
    if launches <= 0 or launches != dispatches * per_call:
        fail(f"{launches} kernel launches for {dispatches} dispatches "
             f"(expected {per_call} each)")
    check_ggnn_wgmma("serve", "B1", by_variant, launches)
    return row


# ---------------------------------------------------------------- phase 4


def train_config(layout: str = "fused") -> ExperimentConfig:
    """The golden model in ``layout``, trained on the synthetic corpus
    without undersampling at 256 graphs per batch, derived buckets."""
    return ExperimentConfig(
        model=GGNNConfig(hidden_dim=32, n_steps=STEPS, num_output_layers=3,
                         concat_all_absdf=True, label_style="graph",
                         layout=layout),
        data=DataConfig(undersample=None,
                        batch=BatchConfig(batch_graphs=TRAIN_GRAPHS,
                                          auto_buckets=True)),
        optim=OptimConfig(max_epochs=3))


def train_buckets(cfg: ExperimentConfig):
    """The corpus's training split and the buckets ``fit`` derives."""
    corpus = load_corpus(cfg)
    buckets = derive_buckets(corpus["train"] + corpus["val"], TRAIN_GRAPHS)
    return corpus["train"], buckets


def pack(graphs, bucket):
    """As many of ``graphs`` as fit ``bucket``, packed by ``batch_np``."""
    out, nn_, ne = [], 0, 0
    for g in graphs:
        if not bucket.fits(len(out) + 1, nn_ + g.n_nodes, ne + g.n_edges):
            break
        out.append(g)
        nn_ += g.n_nodes
        ne += g.n_edges
    return batch_np(out, bucket.max_graphs, bucket.max_nodes, bucket.max_edges)


def bwd_bound(n: int, e: int, d: int, steps: int) -> dict:
    """B2 from the banked states and aggregates: per reverse round 40·N·D²
    product FLOPs (both 3-gate products, dagg and dhp·hwᵀ, dmsg·ewᵀ, the
    three weight gradients) and E·D adds of the transposed edge sum; bytes:
    the two banks, g and the weights read once, dh0 and the weight
    gradients written once."""
    weights = d * d + d + 2 * (d * 3 * d + 3 * d)
    nbytes = 4 * (2 * steps * n * d + 2 * n * d + 2 * e + 2 * weights)
    return tc_bound(steps * 40 * n * d * d, steps * e * d, nbytes)


GRAD_NAMES = ("dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb")


def kernel_grads(args, g):
    """The seven gradients through the public op (forward banked, backward
    on the kernel)."""
    leaves = [a.clone().requires_grad_(True) if i not in (1, 2) else a
              for i, a in enumerate(args)]
    out = fg.fused_ggnn(*leaves, n_steps=STEPS)
    return torch.autograd.grad(out, [leaves[i] for i in (0, 3, 4, 5, 6, 7, 8)],
                               g)


def seeded_cuda(rng):
    """``(*shape, std) -> float32 tensor on the card`` drawn from ``rng``."""
    return lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).cuda()


def ggnn_weights(w, d: int) -> tuple:
    """The edge linear and the GRU's two gate products at width ``d``, with
    their biases, drawn by ``w``."""
    return (w(d, d, std=d ** -0.5), w(d, std=0.1), w(d, 3 * d, std=d ** -0.5),
            w(3 * d, std=0.1), w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1))


def bucket_kernel_row(b, d: int, weights, w) -> dict:
    """B1 and B2 at width ``d`` on the bucket batch ``b`` against their plain
    versions: the no-grad forward's largest difference, each gradient's
    against float64 over its largest magnitude (the chosen variant's, the
    FFMA variant's forced, the plain float32 version's), two calls bitwise
    equal, launches by variant of one call each, times (CUDA events and
    graph replays) and the 3xTF32 and FFMA bounds of both. ``weights``
    from :func:`ggnn_weights`; ``h0`` and the cotangent drawn by ``w``.
    Direct launches, off the main path's counts."""
    n, e = b.max_nodes, len(b.senders)
    h0 = w(n, d, std=0.2)
    # the loss's cotangent is zero on padding nodes, which the pooling
    # masks out; on the sink, whose padding edges loop back to itself
    # hundreds of times, a nonzero one would be amplified through
    # saturated gates until float32 keeps no digit of it
    mask = torch.from_numpy(b.node_mask).cuda()
    g = w(n, d, std=1e-3) * mask[:, None]
    args = (h0, torch.from_numpy(b.senders).cuda(),
            torch.from_numpy(b.receivers).cuda()) + weights
    with torch.no_grad():
        before = dict(fg.n_variant_launches)
        out = fg.fused_ggnn(*args, n_steps=STEPS)
        fwd_launches = {k: fg.n_variant_launches[k] - before[k]
                        for k in fg.VARIANTS}
        out_again = fg.fused_ggnn(*args, n_steps=STEPS)
        plain_out = fg.fused_ggnn_reference(*args, n_steps=STEPS)
    got = kernel_grads(args, g)
    again = kernel_grads(args, g)
    exact = fg.fused_ggnn_backward_reference(
        *(a.double() if a.is_floating_point() else a for a in args),
        g.double(), n_steps=STEPS)
    plain = fg.fused_ggnn_backward_reference(*args, g, n_steps=STEPS)
    torch.cuda.synchronize()

    def rel_to_exact(grads):
        return {name: float((a.double() - r).abs().max())
                / max(float(r.abs().max()), 1e-30)
                for name, a, r in zip(GRAD_NAMES, grads, exact)}

    errs = {name: float((a.double() - r).abs().max())
            for name, a, r in zip(GRAD_NAMES, got, exact)}
    rel, plain_rel = rel_to_exact(got), rel_to_exact(plain)
    bitwise = bool(torch.equal(out, out_again)) and all(
        torch.equal(a, c) for a, c in zip(got, again))
    finite = bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(a).all()) for a in got)
    p = fg._Prepared(h0, args[1], args[2], weights, fg._max_width)
    fwd = lambda kind=None: fg._forward_cuda(p, STEPS, bank=True,  # noqa: E731
                                             kind=kind)
    _, states, aggs = fwd()
    bwd = lambda kind=None: fg._backward_cuda(p, states, aggs, g,  # noqa: E731
                                              kind)
    plain_bwd = lambda: fg.fused_ggnn_backward_reference(  # noqa: E731
        *args, g, n_steps=STEPS)
    # the kept FFMA variant, forced: still right, and the yardstick
    ffma_rel = rel_to_exact(bwd("ffma"))
    before = dict(fg.n_bwd_variant_launches)
    bwd()
    launches = {k: fg.n_bwd_variant_launches[k] - before[k]
                for k in fg.VARIANTS}
    fwd_ms = cuda_ms(fwd, 10)
    bwd_ms = cuda_ms(bwd, 10)
    plain_ms = cuda_ms(plain_bwd, 10)
    bwd_again = cuda_ms(bwd, 10)
    with torch.no_grad():
        fwd_graph = graph_ms(lambda: fg.fused_ggnn(*args, n_steps=STEPS), 10)
        plain_fwd_graph = graph_ms(lambda: fg.fused_ggnn_reference(
            *args, n_steps=STEPS), 10)
    dev = {"fwd_graph_ms": fwd_graph, "plain_fwd_graph_ms": plain_fwd_graph,
           "fwd_banked_graph_ms": graph_ms(fwd, 10),
           "ffma_fwd_banked_graph_ms": graph_ms(lambda: fwd("ffma"), 10),
           "bwd_graph_ms": graph_ms(bwd, 10),
           "ffma_bwd_graph_ms": graph_ms(lambda: bwd("ffma"), 10),
           "plain_bwd_graph_ms": graph_ms(plain_bwd, 10)}
    dev["bwd_graph_ms_repeat"] = graph_ms(bwd, 10)
    fb = kernel_bound(n, e, d, STEPS)
    return {"n": n, "e": e, "d": d,
            "graphs": int(b.graph_mask.sum()),
            "real_nodes": int(b.node_mask.sum()),
            "real_edges": int(b.edge_mask.sum()),
            "sink_segment_edges": int((b.senders == n - 1).sum()),
            "variant": p.variant,
            # the padding sink's row sums thousands of looped edges into
            # saturated gates, where float32 keeps few digits; no output
            # reads it (its edges loop back to itself)
            "fwd_max_abs_err": float((out - plain_out)[mask].abs().max()),
            "fwd_max_abs_err_all_rows": float((out - plain_out).abs().max()),
            "max_abs_err": errs, "rel_err": rel, "limit": GRAD_LIMIT,
            "plain_f32_rel_err": plain_rel, "ffma_rel_err": ffma_rel,
            "bitwise_repeat": bitwise, "finite": finite,
            "fwd_banked_ms": fwd_ms, "bwd_ms": bwd_ms,
            "bwd_ms_repeat": bwd_again, "plain_bwd_ms": plain_ms, **dev,
            # B2's bounds as bound_ms / ffma_bound_ms, B1's with fwd_
            **bwd_bound(n, e, d, STEPS),
            **{f"fwd_{k}": v for k, v in fb.items()},
            "fwd_launches_per_call": fg.launches_per_call(STEPS),
            "bwd_launches_per_call": fg.bwd_launches_per_call(STEPS),
            "fwd_launches_by_variant": fwd_launches,
            "bwd_launches_by_variant": launches}


def phase_train_kernel() -> list[dict]:
    rng = np.random.default_rng(4)
    train, buckets = train_buckets(train_config())
    w = seeded_cuda(rng)
    weights = ggnn_weights(w, WIDTH)
    rows = []
    for bucket in buckets:
        row = {"phase": "train_kernel",
               **bucket_kernel_row(pack(train, bucket), WIDTH, weights, w)}
        emit(row)
        n, rel, ffma_rel = row["n"], row["rel_err"], row["ffma_rel_err"]
        launches = row["bwd_launches_by_variant"]
        if not row["finite"] or not row["bitwise_repeat"]:
            fail(f"backward kernel at n={n}: finite={row['finite']} "
                 f"bitwise={row['bitwise_repeat']}")
        if not row["fwd_max_abs_err"] <= KERNEL_LIMIT:
            fail(f"forward kernel disagrees with its plain version at n={n}: "
                 f"{row['fwd_max_abs_err']} on real nodes")
        bad = {k: v for k, v in rel.items() if not v <= GRAD_LIMIT}
        bad.update({f"ffma_{k}": v for k, v in ffma_rel.items()
                    if not v <= GRAD_LIMIT})
        if bad:
            fail(f"backward kernel disagrees with its plain version at n={n}: "
                 f"{bad}")
        if launches != {"wgmma": fg.bwd_launches_per_call(STEPS), "ffma": 0}:
            fail(f"B2 at n={n} launched {launches}, expected "
                 f"{fg.bwd_launches_per_call(STEPS)} on wgmma")
        rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 5


def one_step(cfg: ExperimentConfig, batch, pos_weight: float, device: str):
    """One train step of a freshly seeded model: (loss, grads, params)."""
    model = make_model(cfg.model, INPUT_DIM, device=device, seed=0)
    trainer = Trainer(model, cfg, pos_weight=pos_weight)
    state = trainer.init_state()
    state, _, loss, _ = trainer.train_step(
        state, to_device(batch, device), ConfusionState.zeros(device))
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    return float(loss), grads, params


def compare_steps(a, b, lr: float) -> dict:
    (la, ga, pa), (lb, gb, pb) = a, b
    # each gradient relative to its largest magnitude, floored at a
    # thousandth of the model's largest gradient: the pooling gate's bias
    # has a true gradient of 0, and its rounding noise depends on the path
    floor = 1e-3 * max(float(g.abs().max()) for g in ga.values())
    grad_rel = max(float((ga[k] - gb[k]).abs().max())
                   / max(float(ga[k].abs().max()), floor) for k in ga)
    dp = {k: (pa[k] - pb[k]).abs() for k in pa}
    large = [dp[k][ga[k].abs() > STEP_GRAD_FLOOR] for k in pa]
    out = {"loss_diff": abs(la - lb), "grad_rel_diff": grad_rel,
           "param_diff": max(float(t.max()) for t in dp.values()),
           "param_diff_where_grad_above_floor": max(
               float(t.max()) if t.numel() else 0.0 for t in large)}
    ok = (out["loss_diff"] <= STEP_LOSS_LIMIT
          and out["grad_rel_diff"] <= STEP_GRAD_LIMIT
          and out["param_diff_where_grad_above_floor"] <= STEP_PARAM_LIMIT
          and out["param_diff"] <= 2 * lr)
    return out | {"ok": ok}


def profile_train_step(cfg: ExperimentConfig, batch, pos_weight: float):
    """The profile of one train step on the card (after a warm-up step)."""
    model = make_model(cfg.model, INPUT_DIM, device="cuda", seed=0)
    trainer = Trainer(model, cfg, pos_weight=pos_weight)
    state = trainer.init_state()
    on_card = to_device(batch, "cuda")
    step = lambda: trainer.train_step(state, on_card,
                                      ConfusionState.zeros("cuda"))
    step()
    return profile_call(step)


def read_params(run_dir: Path) -> dict:
    ckpts = CheckpointManager(run_dir / "checkpoints")
    return ckpts.restore_latest(map_location="cpu")


def _resume_fit(cfg: ExperimentConfig, run_dir: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fit(cfg, Path(run_dir), resume=True, device="cuda")


def resume_in_fresh_process(cfg: ExperimentConfig, run_dir: Path) -> dict:
    """``fit(cfg, run_dir, resume=True)`` in a spawned process, which shares
    nothing with this one but the run directory, as a restarted job would
    run it; returns its final metrics."""
    proc = multiprocessing.get_context("spawn").Process(
        target=_resume_fit, args=(cfg, str(run_dir)))
    proc.start()
    proc.join(timeout=600)
    if proc.is_alive():
        proc.kill()
        proc.join()
        fail("the resumed fit did not end within 600 s")
    if proc.exitcode != 0:
        fail(f"the resumed fit exited with {proc.exitcode}")
    return json.loads((run_dir / "final_metrics.json").read_text())


def _deterministic_step(cfg: ExperimentConfig, batch,
                        pos_weight: float) -> list[str]:
    # cuBLAS reads its workspace setting when this process first uses it
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = make_model(cfg.model, INPUT_DIM, device="cuda", seed=0)
    trainer = Trainer(model, cfg, pos_weight=pos_weight)
    state = trainer.init_state()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step(state, to_device(batch, "cuda"),
                               ConfusionState.zeros("cuda"))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in caught})


def deterministic_diagnostic(cfg: ExperimentConfig, batch,
                             pos_weight: float) -> list[str]:
    """One train step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` in a spawned process (the fixed cuBLAS workspace it
    needs would slow this process's other measurements): the messages of
    the ops with no deterministic implementation on the card. A diagnostic;
    the check is the bitwise resume."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        return pool.submit(_deterministic_step, cfg, batch,
                           pos_weight).result(timeout=600)


def phase_train(layout: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        return drive_train(Path(tmp), layout)


def drive_train(work: Path, layout: str) -> dict:
    cfg = train_config(layout)

    # the main path: counts from zero, read right after
    fg.n_launches = fg.n_bwd_launches = mb.n_launches = 0
    reset_variant_counts()
    t0 = time.perf_counter()
    final = fit(cfg, work / "straight", device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fg.n_launches, fg.n_bwd_launches
    mb_launches = mb.n_launches
    by_variant = {"fwd": dict(fg.n_variant_launches),
                  "bwd": dict(fg.n_bwd_variant_launches),
                  "mb": dict(mb.n_variant_launches)}

    timing = json.loads((work / "straight" / "journal.json").read_text())["timing"]
    steps, evals = timing["train_steps"], timing["eval_batches"]
    train, buckets = train_buckets(cfg)
    graphs = len(train) * cfg.optim.max_epochs

    # one step from one seed and batch: on the card against the segment
    # layout on the card and the same layout on the CPU
    batch = pack(train, buckets[-1])
    labels = np.array([int(g.node_feats["_VULN"].max()) for g in train])
    pw = positive_weight(labels)
    on_card = one_step(cfg, batch, pw, "cuda")
    seg_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, layout="segment"))
    vs_segment = compare_steps(on_card, one_step(seg_cfg, batch, pw, "cuda"),
                               cfg.optim.lr)
    vs_cpu = compare_steps(on_card, one_step(cfg, batch, pw, "cpu"),
                           cfg.optim.lr)
    nondeterministic = deterministic_diagnostic(cfg, batch, pw)

    # resume: 2 epochs, then resume to 3, against the straight run
    two = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                             max_epochs=2))
    fit(two, work / "resumed", device="cuda")
    resumed = resume_in_fresh_process(cfg, work / "resumed")
    # and a second uninterrupted run
    fit(cfg, work / "again", device="cuda")
    pa, pb = read_params(work / "straight"), read_params(work / "resumed")
    pc = read_params(work / "again")
    resume_diff = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    resume_bitwise = all(torch.equal(pa[k], pb[k]) for k in pa)
    repeat_diff = max(float((pa[k] - pc[k]).abs().max()) for k in pa)
    repeat_bitwise = all(torch.equal(pa[k], pc[k]) for k in pa)
    step_profile = profile_train_step(cfg, batch, pw)

    fwd_per, bwd_per = fg.launches_per_call(STEPS), fg.bwd_launches_per_call(STEPS)
    if layout == "fused":
        want = {"fwd": (steps + evals) * fwd_per, "mb": 0}
    else:
        want = {"fwd": steps * fwd_per,
                "mb": (steps + evals) * mb.launches_per_call(STEPS)}
    want["bwd"] = steps * bwd_per
    got = {"fwd": fwd_launches, "bwd": bwd_launches, "mb": mb_launches}
    row = {"phase": "train" if layout == "fused" else "train_megabatch",
           "layout": layout, "epochs": cfg.optim.max_epochs,
           "train_steps": steps, "eval_batches": evals,
           "train_graphs": graphs, "train_seconds": timing["train_seconds"],
           "steps_per_s": steps / timing["train_seconds"],
           "graphs_per_s": graphs / timing["train_seconds"],
           "p50_step_ms": float(np.percentile(timing["step_ms"], 50)),
           "step_ms": timing["step_ms"], "fit_seconds": fit_s,
           "fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
           "mb_launches": mb_launches, "expected_launches": want,
           "launches_by_variant": by_variant,
           "final_metrics": final,
           "first_step_vs_segment": vs_segment, "first_step_vs_cpu": vs_cpu,
           "nondeterministic_ops": nondeterministic,
           "resume_max_abs_param_diff": resume_diff,
           "resume_bit_identical": resume_bitwise,
           "repeat_max_abs_param_diff": repeat_diff,
           "repeat_bit_identical": repeat_bitwise,
           "profile_train_step": step_profile,
           "resumed_final_metrics": resumed}
    emit(row)
    if not all(np.isfinite(v) for v in final.values()):
        fail(f"non-finite final metrics: {final}")
    if steps != 2 * cfg.optim.max_epochs:
        fail(f"{steps} train steps, expected {2 * cfg.optim.max_epochs}")
    if got != want:
        fail(f"{layout} launches {got}, expected {want} for {steps} train "
             f"steps and {evals} eval batches")
    for key, kernel in (("fwd", "B1"), ("bwd", "B2"), ("mb", "B3")):
        if got[key]:
            check_ggnn_wgmma(row["phase"], kernel, by_variant[key], got[key])
    for name, cmp in (("segment", vs_segment), ("cpu", vs_cpu)):
        if not cmp["ok"]:
            fail(f"{layout}: first train step disagrees with the {name} run: "
                 f"{cmp}")
    if not (resume_bitwise and repeat_bitwise):
        fail(f"{layout}: resumed / repeated fit not bitwise equal to the "
             f"straight run: {resume_diff} / {repeat_diff}")
    return row


# ---------------------------------------------------------------- phase 6


def model_bound(n: int, e: int, d: int, g: int, n_sub: int, rows: int,
                dims: list[int], steps: int) -> dict:
    """Least milliseconds for the whole model: the rounds' products (as
    :func:`kernel_bound`, on the tensor cores) and edge adds, plus 2·N·2D
    for the gate logits, 2·N·2D for the readout and G·Σ 2·in·out for the
    head (FP32 units); or the bytes (table, ids, edges, gidx, mask and
    weights read once, the output, ``dims[-1]`` floats per slot, written
    once) over HBM bandwidth; the larger. ``dims = [2·D]`` is the encoder
    (B4), which has no head."""
    head = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    products = steps * (2 * n * d * d + 2 * 2 * n * d * 3 * d)
    other = steps * e * d + 2 * 2 * n * 2 * d + g * 2 * head
    weights = (d * d + d + 2 * (d * 3 * d + 3 * d) + 2 * d + 1 + head
               + sum(dims[1:]))
    nbytes = 4 * (rows * (d // n_sub) + n * n_sub + 2 * e + n + weights
                  + g * dims[-1]) + n
    return tc_bound(products, other, nbytes)


def model_inputs(b, rng, d: int = WIDTH, n_layers: int = 3):
    """Seeded table and weights of the golden model's shapes, in the
    ``[in, out]`` layout, with batch ``b``'s ids, edges and slots, on the
    card: the positional arguments of ``fused_ggnn_model``."""
    ed = d // len(ALL_SUBKEYS)
    w = seeded_cuda(rng)
    ids = np.stack([b.node_feats[k] + i * INPUT_DIM for i, k in enumerate(KEYS)],
                   axis=-1)
    head = tuple((w(2 * d, o, std=(2 * d) ** -0.5), w(o, std=0.1))
                 for o in [2 * d] * (n_layers - 1) + [1])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (w(len(KEYS) * INPUT_DIM, ed, std=ed ** -0.5), put(ids),
            put(b.senders), put(b.receivers), put(b.node_gidx),
            put(b.node_mask), w(d, d, std=d ** -0.5), w(d, std=0.1),
            w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1),
            w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1),
            w(2 * d, 1, std=(2 * d) ** -0.5), w(1, std=0.1), head)


def phase_mega_kernel() -> list[dict]:
    rng = np.random.default_rng(5)
    train, buckets = train_buckets(train_config("megabatch"))
    shapes = [("mega", fill(mega_bucket(MAX_BATCH), rng, 50))]
    shapes += [(f"train_{bk.max_nodes}", pack(train, bk)) for bk in buckets]
    rows = []
    for name, b in shapes:
        args = model_inputs(b, rng)
        kw = dict(n_steps=STEPS, n_graphs=b.max_graphs)
        n, e, g = b.max_nodes, len(b.senders), b.max_graphs
        with torch.inference_mode():
            before = mb.n_launches
            got = mb.fused_ggnn_model(*args, **kw)
            torch.cuda.synchronize()
            per_call = mb.n_launches - before
            again = mb.fused_ggnn_model(*args, **kw)
            want = mb.megabatch_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            bitwise = torch.equal(got, again)
            # the kernels' time: the launches of a prepared call (the
            # public call adds its host checks, whose device read stalls
            # the launch queue; it is timed beside)
            p = mb._Prepared(*args, **kw)
            before = dict(mb.n_variant_launches)
            mb._launch(p)
            launches = {k: mb.n_variant_launches[k] - before[k]
                        for k in fg.VARIANTS}
            ms = cuda_ms(lambda: mb._launch(p), 20)
            plain_ms = cuda_ms(lambda: mb.megabatch_reference(*args, **kw), 20)
            ms_again = cuda_ms(lambda: mb._launch(p), 20)
            call_ms = cuda_ms(lambda: mb.fused_ggnn_model(*args, **kw), 20)
            dev = {"graph_ms": graph_ms(lambda: mb._launch(p), 20),
                   "ffma_graph_ms": graph_ms(lambda: mb._launch(p, "ffma"),
                                             20),
                   "plain_graph_ms": graph_ms(
                       lambda: mb.megabatch_reference(*args, **kw), 20)}
            profile = profile_call(lambda: mb._launch(p))
        dims = [2 * WIDTH, 2 * WIDTH, 2 * WIDTH, 1]
        bound = model_bound(n, e, WIDTH, g, len(KEYS), len(KEYS) * INPUT_DIM,
                            dims, STEPS)
        row = {"phase": "mega_kernel", "shape": name, "n": n, "e": e,
               "graphs": g, "d": WIDTH, "n_steps": STEPS, "head_layers": 3,
               "real_nodes": int(b.node_mask.sum()),
               "real_graphs": int(b.graph_mask.sum()),
               "sink_segment_edges": int((b.receivers == n - 1).sum()),
               "max_abs_err": err, "limit": KERNEL_LIMIT, "finite": finite,
               "bitwise_repeat": bitwise, "ms": ms, "ms_repeat": ms_again,
               "call_ms": call_ms, "plain_ms": plain_ms, **dev, **bound,
               "launches_per_call": per_call,
               "launches_by_variant": launches, "profile": profile}
        emit(row)
        check_ggnn_wgmma(f"mega_kernel {name}", "B3", launches,
                    mb.launches_per_call(STEPS))
        if per_call != mb.launches_per_call(STEPS):
            fail(f"B3 made {per_call} launches at {name}, expected "
                 f"{mb.launches_per_call(STEPS)}")
        if not (finite and bitwise and err <= KERNEL_LIMIT):
            fail(f"B3 at {name}: finite={finite} bitwise={bitwise} err={err}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 7


def ladder_dispatches(graphs) -> int:
    """Batches the per-bucket serving ladder makes of ``graphs``: each
    graph to the smallest bucket that admits it, each bucket packed
    greedily."""
    ladder = serve_buckets(MAX_BATCH)
    per: dict[int, list] = {}
    for g in graphs:
        per.setdefault(next(i for i, b in enumerate(ladder) if b.admits(g)),
                       []).append(g)
    return sum(len(list(GraphBatcher([ladder[i].spec]).batches(gs)))
               for i, gs in per.items())


def phase_packed() -> dict:
    cfg = train_config("megabatch").model
    model = make_model(cfg, INPUT_DIM, device="cuda", seed=0).eval()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reqs = requests()
    plan = model.plan_for(0, 0, 0)
    t0 = time.perf_counter()
    packed = mb.pack_megabatches(
        reqs, width=plan.width, n_steps=plan.n_steps,
        table_rows=plan.table_rows, embed_width=plan.embed_width,
        n_head_layers=plan.n_head_layers, uniform=True)
    pack_s = time.perf_counter() - t0
    if packed.oversize:
        fail(f"{len(packed.oversize)} requests too large for a megabatch")

    # the main path: counts from zero, read right after
    mb.n_launches = 0
    reset_variant_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        probs = [torch.sigmoid(model(to_device(b, "cuda", KEYS))).cpu()
                 for b in packed.batches]
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = mb.n_launches
    by_variant = dict(mb.n_variant_launches)

    # references, off the main path, on the same packed batches
    seg = make_model(dataclasses.replace(cfg, layout="segment"), INPUT_DIM,
                     device="cuda").eval()
    seg.load_state_dict(state)
    cpu = make_model(cfg, INPUT_DIM, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    diff_seg = diff_cpu = 0.0
    with torch.inference_mode():
        for i, b in enumerate(packed.batches):
            real = torch.from_numpy(b.graph_mask)
            want = torch.sigmoid(seg(to_device(b, "cuda", KEYS))).cpu()
            diff_seg = max(diff_seg, float((probs[i] - want)[real].abs().max()))
            if i == 0:
                want = torch.sigmoid(cpu(to_device(b, "cpu", KEYS)))
                diff_cpu = float((probs[i] - want)[real].abs().max())
    real_probs = torch.cat([p[torch.from_numpy(b.graph_mask)]
                            for p, b in zip(probs, packed.batches)])
    per_call = mb.launches_per_call(STEPS)
    p0 = packed.plans[0]
    row = {"phase": "packed", "requests": len(reqs),
           "batches": len(packed.batches),
           "shape": {"max_nodes": p0.max_nodes, "max_edges": p0.max_edges,
                     "max_graphs": p0.max_graphs,
                     "megabatch_bytes": mb.megabatch_bytes(p0),
                     "fits": p0.fits},
           "padding_efficiency": packed.efficiency, "pack_s": pack_s,
           "score_s": score_s, "graphs_per_s": len(reqs) / score_s,
           "ladder_dispatches": ladder_dispatches(reqs),
           "n_launches": launches, "launches_per_call": per_call,
           "launches_by_variant": by_variant,
           "max_abs_prob_diff_vs_segment": diff_seg,
           "max_abs_prob_diff_vs_cpu": diff_cpu, "limit": PROB_LIMIT}
    emit(row)
    if len(real_probs) != len(reqs) or not bool(
            ((real_probs > 0) & (real_probs < 1)).all()):
        fail("packed scoring lost requests or gave out-of-range probabilities")
    if not (diff_seg <= PROB_LIMIT and diff_cpu <= PROB_LIMIT):
        fail(f"packed probabilities differ: segment {diff_seg}, cpu {diff_cpu}")
    if launches != len(packed.batches) * per_call:
        fail(f"{launches} B3 launches for {len(packed.batches)} batches")
    check_ggnn_wgmma("packed", "B3", by_variant, launches)
    return row


# ---------------------------------------------------------------- phase 9


def golden_model(device: str, layout: str = "fused"):
    """The golden model with seeded weights (the serve phase's)."""
    cfg = GGNNConfig(hidden_dim=32, n_steps=STEPS, num_output_layers=3,
                     concat_all_absdf=True, label_style="graph",
                     layout=layout)
    return make_model(cfg, INPUT_DIM, device=device, seed=0)


def full_bin(rng) -> list:
    """64 DeepDFA-sized graphs of about 4,094 nodes in all: one full
    hierarchical level-1 bin."""
    out, total = [], 0
    while len(out) < 64:
        g = random_graph(rng, input_dim=INPUT_DIM, mean_nodes=62)
        if total + g.n_nodes + 3 * (63 - len(out)) <= 4094:
            out.append(g)
            total += g.n_nodes
    return out


def phase_hier_kernel() -> list[dict]:
    rng = np.random.default_rng(6)
    engine = ScoringEngine.from_model(golden_model("cuda"), None, "graph",
                                      KEYS, max_batch=MAX_BATCH,
                                      device="cuda")
    scorer = engine.hier
    members = full_bin(rng)
    (indices, plan), = scorer._pack(members)
    bin_batch = batch_np([members[i] for i in indices], plan.max_graphs,
                         plan.max_nodes, plan.max_edges)
    shapes = [("mega", fill(mega_bucket(MAX_BATCH), rng, 50)),
              ("hier_bin", bin_batch)]
    rows = []
    for name, b in shapes:
        args = model_inputs(b, rng)[:14]  # the golden shapes, no head
        kw = dict(n_steps=STEPS, n_graphs=b.max_graphs)
        n, e, g = b.max_nodes, len(b.senders), b.max_graphs
        with torch.inference_mode():
            before = mb.n_launches
            got = mb.fused_ggnn_encoder(*args, **kw)
            torch.cuda.synchronize()
            per_call = mb.n_launches - before
            again = mb.fused_ggnn_encoder(*args, **kw)
            want = mb.megabatch_encoder_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            bitwise = torch.equal(got, again)
            p = mb._Prepared(*args, (), STEPS, b.max_graphs)
            ms = cuda_ms(lambda: mb._launch(p), 20)
            plain_ms = cuda_ms(
                lambda: mb.megabatch_encoder_reference(*args, **kw), 20)
            ms_again = cuda_ms(lambda: mb._launch(p), 20)
            call_ms = cuda_ms(lambda: mb.fused_ggnn_encoder(*args, **kw), 20)
            dev = {"graph_ms": graph_ms(lambda: mb._launch(p), 20),
                   "ffma_graph_ms": graph_ms(lambda: mb._launch(p, "ffma"),
                                             20),
                   "plain_graph_ms": graph_ms(
                       lambda: mb.megabatch_encoder_reference(*args, **kw),
                       20)}
        bound = model_bound(n, e, WIDTH, g, len(KEYS), len(KEYS) * INPUT_DIM,
                            [2 * WIDTH], STEPS)
        row = {"phase": "hier_kernel", "shape": name, "n": n, "e": e,
               "graphs": g, "d": WIDTH, "n_steps": STEPS, "head_layers": 0,
               "real_nodes": int(b.node_mask.sum()),
               "real_graphs": int(b.graph_mask.sum()),
               "max_abs_err": err, "limit": KERNEL_LIMIT, "finite": finite,
               "bitwise_repeat": bitwise, "ms": ms, "ms_repeat": ms_again,
               "call_ms": call_ms, "plain_ms": plain_ms, **dev, **bound,
               "launches_per_call": per_call}
        if name == "hier_bin":
            # each function's row inside the full bin against its row
            # embedded alone, through the scorer's own path
            together = scorer.embed_graphs(members)
            alone = [scorer.embed_graphs([members[i]])[0]
                     for i in range(0, len(members), 4)]
            row["rows_checked_alone"] = len(alone)
            row["rows_alone_bitwise"] = all(
                np.array_equal(a, together[i])
                for a, i in zip(alone, range(0, len(members), 4)))
            row["rows_alone_max_abs_diff"] = max(
                float(np.abs(a - together[i]).max())
                for a, i in zip(alone, range(0, len(members), 4)))
        emit(row)
        if per_call != mb.launches_per_call(STEPS):
            fail(f"B4 made {per_call} launches at {name}, expected "
                 f"{mb.launches_per_call(STEPS)}")
        if not (finite and bitwise and err <= KERNEL_LIMIT):
            fail(f"B4 at {name}: finite={finite} bitwise={bitwise} err={err}")
        if name == "hier_bin" and not row["rows_alone_bitwise"]:
            fail("B4: a function's row inside a full bin differs from its "
                 "row embedded alone")
        rows.append(row)
    return rows


# --------------------------------------------------------------- phase 10


def hier_units(reqs, rng) -> list[tuple[list, UnitCallGraph]]:
    """16 units of 3-32 of ``reqs`` each, every function calling 1-3 later
    functions of its unit (a seeded DAG), with summaries drawn from a
    seeded per-node reach and taint inside each feature's range."""
    sizes = rng.integers(3, 33, size=16)
    if sizes.sum() > len(reqs):
        sizes = np.maximum(3, sizes * len(reqs) // sizes.sum())
    units, at = [], 0
    for u, n in enumerate(sizes):
        graphs = reqs[at:at + n]
        at += n
        names = [f"unit{u}_fn{i}" for i in range(n)]
        fns = [UnitFunction(name, f"int {name}(void) {{ return {at + i}; }}",
                            g) for i, (name, g) in enumerate(zip(names, graphs))]
        calls = []
        for i in range(n - 1):
            k = min(int(rng.integers(1, 4)), n - 1 - i)
            calls += [(i, int(j)) for j in rng.choice(
                np.arange(i + 1, n), size=k, replace=False)]
        sg = types.SimpleNamespace(
            callgraph=types.SimpleNamespace(edges=calls),
            method_names=dict(enumerate(names)))
        snd, rcv = unit_call_edges(sg, names)
        callers = np.bincount([b for _, b in calls], minlength=n)
        callees = np.bincount([a for a, _ in calls], minlength=n)
        summ = np.zeros((n, N_SUMMARY_FEATURES), np.float32)
        for i, g in enumerate(graphs):
            ireach = rng.integers(0, 12, size=g.n_nodes)
            itaint = rng.integers(0, 4, size=g.n_nodes)
            summ[i] = [np.log1p(g.n_nodes), np.log1p(ireach.sum()),
                       min(ireach.max(), 8) / 8.0, itaint.max() / 3.0,
                       float((itaint >= 3).any()), np.log1p(callers[i]),
                       np.log1p(callees[i])]
        units.append((fns, UnitCallGraph(snd, rcv, summ, len(calls))))
    return units


def score_units(engine, units) -> tuple[list[dict], float, list[dict]]:
    """Every unit through ``score_unit``: results, wall seconds and each
    unit's host seconds per level."""
    out, split = [], []
    t0 = time.perf_counter()
    for fns, unit in units:
        out.append(engine.score_unit(fns, unit))
        split.append(engine.hier.last_seconds)
    return out, time.perf_counter() - t0, split


def phase_hier() -> dict:
    model = golden_model("cuda")
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    engine = ScoringEngine.from_model(model, None, "graph", KEYS,
                                      max_batch=MAX_BATCH, device="cuda")
    units = hier_units(requests(), np.random.default_rng(7))
    n_fns = sum(len(fns) for fns, _ in units)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_emb_") as tmp:
        salt = dict(model_rev=engine.model_rev, vocab_hash="chip_smoke",
                    dim=engine.hier.out_dim)
        engine.hier.cache = FunctionEmbeddingCache(tmp, **salt)

        # the main path, cold: counts from zero, read right after
        engine.hier.reset_counters()
        mb.n_launches = 0
        reset_variant_counts()
        d0 = engine.n_dispatches
        cold, cold_s, split = score_units(engine, units)
        torch.cuda.synchronize()
        cold_launches = mb.n_launches
        cold_variants = dict(mb.n_variant_launches)
        cold_dispatches = engine.n_dispatches - d0
        cold_stats = engine.hier.stats()

        # warm: a fresh cache handle on the same root
        engine.hier.cache = FunctionEmbeddingCache(tmp, **salt)
        engine.hier.reset_counters()
        mb.n_launches = 0
        d0 = engine.n_dispatches
        warm, warm_s, _ = score_units(engine, units)
        warm_launches = mb.n_launches
        warm_dispatches = engine.n_dispatches - d0
        warm_stats = engine.hier.stats()

        # device time of one unit scored cold, the cache detached (after
        # the main path's counts were read)
        engine.hier.cache = None
        fns, unit = max(units, key=lambda fu: len(fu[0]))
        busy = profile_call(lambda: engine.score_unit(fns, unit))

    # the CPU engine on the same state dict, off the main path
    cpu = ScoringEngine.from_model(golden_model("cpu"), state, "graph", KEYS,
                                   max_batch=MAX_BATCH, device="cpu")
    cpu_out, _, _ = score_units(cpu, units)
    same_l2 = all(torch.equal(v.cpu(), cpu.hier.level2.state_dict()[k])
                  for k, v in engine.hier.level2.state_dict().items())
    unit_diff = max(abs(a["unit_score"] - b["unit_score"])
                    for a, b in zip(cold, cpu_out))
    fn_diff = max(abs(ra["score"] - {r["function"]: r["score"]
                                     for r in b["attribution"]}[ra["function"]])
                  for a, b in zip(cold, cpu_out) for ra in a["attribution"])
    strip = lambda rs: [{k: v for k, v in r.items() if k != "level1"}  # noqa: E731
                        for r in rs]
    per = mb.launches_per_call(STEPS)
    row = {"phase": "hier", "units": len(units), "functions": n_fns,
           "call_edges": sum(u.n_call_edges for _, u in units),
           "cold": {"seconds": cold_s, "units_per_s": len(units) / cold_s,
                    "functions_per_s": n_fns / cold_s,
                    "dispatches": cold_dispatches, "b4_launches": cold_launches,
                    "b4_launches_by_variant": cold_variants,
                    "level1": cold_stats,
                    "ms_per_unit_level1": 1e3 * float(np.mean(
                        [t["level1"] for t in split])),
                    "ms_per_unit_level2": 1e3 * float(np.mean(
                        [t["level2"] for t in split]))},
           "warm": {"seconds": warm_s, "units_per_s": len(units) / warm_s,
                    "functions_per_s": n_fns / warm_s,
                    "dispatches": warm_dispatches,
                    "b4_launches": warm_launches, "level1": warm_stats},
           "launches_per_dispatch": per,
           "warm_equals_cold": strip(warm) == strip(cold),
           "max_abs_unit_score_diff_vs_cpu": unit_diff,
           "max_abs_function_score_diff_vs_cpu": fn_diff,
           "level2_weights_equal_cpu": same_l2, "limit": PROB_LIMIT,
           "profile_cold_unit": dict(busy, functions=len(fns)),
           "unit_scores": [r["unit_score"] for r in cold]}
    emit(row)
    if not all(0.0 < r["unit_score"] < 1.0 for r in cold):
        fail("hier: unit scores out of range")
    if cold_launches <= 0 or cold_launches != cold_dispatches * per:
        fail(f"hier: {cold_launches} B4 launches for {cold_dispatches} "
             f"level-1 dispatches (expected {per} each)")
    check_ggnn_wgmma("hier", "B4", cold_variants, cold_launches)
    if cold_stats["fallback_dispatches"] or cold_stats["recompute"] != n_fns:
        fail(f"hier: cold pass {cold_stats}, expected no fallback and "
             f"{n_fns} recomputes")
    if (warm_dispatches or warm_launches or warm_stats["recompute"]
            or warm_stats["cache"]["hit_rate"] != 1.0):
        fail(f"hier: warm pass made {warm_dispatches} dispatches, "
             f"{warm_launches} launches: {warm_stats}")
    if not row["warm_equals_cold"]:
        fail("hier: warm unit scores differ from the cold pass")
    if not (same_l2 and unit_diff <= PROB_LIMIT and fn_diff <= PROB_LIMIT):
        fail(f"hier: against the CPU engine: level-2 weights equal "
             f"{same_l2}, unit {unit_diff}, function {fn_diff}")
    return row


# --------------------------------------------------------------- phase 11


def int8_bound(m: int, k: int, n: int,
               bf16: bool = False) -> tuple[float, str]:
    """Least milliseconds for the product on this card, the port's own
    yardstick: the bytes (x, q, scale read once, y written once) over HBM
    bandwidth, or the tensor-core operations over the bf16 peak, the
    larger. An int8 weight is exact in bf16 and a bf16 product is exact in
    float32, so the bf16 tensor cores can compute the same sums: 2·M·K·N
    operations for bf16 activations. A float32 activation is exactly three
    bf16 terms, so float32 activations take three bf16 passes, 3·2·M·K·N
    (at the GGNN's shapes the bytes bound then holds)."""
    flops = (1 if bf16 else 3) * 2 * m * k * n
    elt = 2 if bf16 else 4
    nbytes = elt * m * k + k * n + 4 * n + elt * m * n
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def int8_case(x, q, scale, out_dtype, reps: int, limit: float,
              main: bool) -> dict:
    """One B5 shape against its plain version: the error over the largest
    output, two calls bitwise equal, the variant both calls took, CUDA-event
    and CUDA-graph times of the kernel, the plain version and the library
    (``torch.matmul`` on the weight dequantized in advance, in x's type),
    the host's microseconds to enqueue a call, and the bound."""
    (m, k), n = x.shape, q.shape[1]
    dequant = (q.float() * scale).to(x.dtype)

    def kernel():
        return i8.int8_matmul(x, q, scale, out_dtype=out_dtype)

    def plain():
        return i8.int8_matmul_reference(x, q, scale, out_dtype)

    def library():
        return torch.matmul(x, dequant)

    before = dict(i8.n_variant_launches)
    got, again = kernel(), kernel()
    want = plain()
    torch.cuda.synchronize()
    took = {v: i8.n_variant_launches[v] - before[v] for v in i8.VARIANTS}
    variant = next((v for v, c in took.items() if c), None)
    abs_err = float((got.float() - want.float()).abs().max())
    err = abs_err / float(want.float().abs().max())
    bitwise = torch.equal(got, again)
    ms = cuda_ms(kernel, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(plain, reps)
    library_ms = cuda_ms(library, reps)
    ms_again = cuda_ms(kernel, reps)
    fns = (("", kernel), ("plain_", plain), ("library_", library))
    dev = {f"{key}graph_ms": graph_ms(f, reps) for key, f in fns}
    bf16 = x.dtype == torch.bfloat16
    bound_ms, bound_by = int8_bound(m, k, n, bf16=bf16)
    row = {"phase": "int8_kernel", "m": m, "k": k, "n": n,
           "x_dtype": "bf16" if bf16 else "float32",
           "out_dtype": "bf16" if out_dtype == torch.bfloat16 else "float32",
           "main_path": main, "variant": variant, "launches": took,
           "max_abs_err": abs_err, "max_rel_err": err, "limit": limit,
           "bitwise_repeat": bitwise, "ms": ms, "ms_repeat": ms_again,
           "host_us_per_call": host_us, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": f"torch.matmul(x, (q·scale) dequantized in advance to "
                      f"{'bf16' if bf16 else 'float32'}), TF32 off",
           **dev, "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": 2 * m * k * n / (dev["graph_ms"] * 1e9)}
    emit(row)
    if sum(took.values()) != 2 or not (bitwise and err <= limit):
        fail(f"B5 at m={m} k={k} n={n}: launches={took} bitwise={bitwise} "
             f"err={err}")
    if main and variant != "wgmma":
        fail(f"B5 at m={m} k={k} n={n}: a main-path shape took the "
             f"{variant} variant")
    return row


def phase_int8_kernel() -> list[dict]:
    rng = np.random.default_rng(8)
    rows = []
    # the GGNN's conv products: float32 activations, K = 128
    for n in (128, 384):
        w = (rng.standard_normal((WIDTH, n)) * WIDTH ** -0.5).astype(np.float32)
        q_np, s_np = i8.calibrate_int8(w)
        q, scale = torch.from_numpy(q_np).cuda(), torch.from_numpy(s_np).cuda()
        for m in (2048, 4096, 5120, 16768):
            x = torch.from_numpy(
                (rng.standard_normal((m, WIDTH)) * 0.5).astype(np.float32)).cuda()
            rows.append(int8_case(x, q, scale, torch.float32, 50, INT8_LIMIT,
                                  main=True))
    # the LLM's projections: 4 x 256 tokens, bf16 activations and outputs
    gen = torch.Generator(device="cuda").manual_seed(8)
    m = 4 * 256
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        q, scale = i8.calibrate_int8(w)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(int8_case(x, q, scale, torch.bfloat16, 10,
                              INT8_BF16_LIMIT, main=True))
    # off the main paths: the FFMA variant, at a shape TMA cannot describe
    for dt, limit in ((torch.float32, INT8_LIMIT),
                      (torch.bfloat16, INT8_BF16_LIMIT)):
        q, scale = i8.calibrate_int8(
            torch.randn(100, 130, generator=gen, device="cuda") * 0.1)
        x = torch.randn(37, 100, generator=gen, device="cuda").to(dt)
        row = int8_case(x, q, scale, dt, 50, limit, main=False)
        if row["variant"] != "ffma":
            fail(f"B5 at m=37 k=100 n=130: took {row['variant']}, not ffma")
        rows.append(row)
    return rows


# --------------------------------------------------------------- phase 12


def phase_serve_int8() -> dict:
    model = golden_model("cuda")
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    engine = ScoringEngine.from_model(model, None, "graph", KEYS,
                                      max_batch=MAX_BATCH, megabatch=True,
                                      device="cuda", precision="int8")
    if engine.precision != "int8":
        fail(f"serve_int8: the int8 gate refused (delta "
             f"{engine.int8_score_delta})")
    engine.warmup()
    reqs = requests()

    # the main path: counts from zero, read right after
    i8.n_launches = 0
    i8.n_variant_launches = dict.fromkeys(i8.VARIANTS, 0)
    d0 = engine.n_dispatches
    probs, lat, wall = drive_batcher(engine, reqs)
    torch.cuda.synchronize()
    launches = i8.n_launches
    variants = dict(i8.n_variant_launches)
    dispatches = engine.n_dispatches - d0

    # references, off the main path: the float32 engine on the card and
    # GGNNInt8's plain version on the CPU, over the same weights
    f32 = ScoringEngine.from_model(golden_model("cuda"), state, "graph", KEYS,
                                   max_batch=MAX_BATCH, megabatch=True,
                                   device="cuda")
    f32_probs = f32.score_packed(reqs)
    cpu = ScoringEngine.from_model(golden_model("cpu"), state, "graph", KEYS,
                                   max_batch=MAX_BATCH, megabatch=True,
                                   device="cpu", precision="int8")
    cpu_probs = cpu.score_packed(reqs[:16])
    busy = profile_call(lambda: engine.score_packed(reqs[:48]),
                        match="int8_matmul")
    per = 3 * STEPS
    row = {"phase": "serve_int8", "requests": len(reqs),
           # the seeded weights' device-free revision: the delta depends on
           # the weights, which a seeded init may draw differently under
           # another torch version
           "model_rev_cpu": model_revision(state, "cpu"),
           "int8_score_delta": engine.int8_score_delta,
           "cpu_int8_score_delta": cpu.int8_score_delta,
           "precision": engine.precision, "cpu_precision": cpu.precision,
           "requests_per_s": len(reqs) / wall, "wall_s": wall,
           "p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3),
           "n_dispatches": dispatches, "n_launches": launches,
           "variant_launches": variants, "launches_per_forward": per,
           "max_abs_prob_diff_vs_f32": float(np.abs(probs - f32_probs).max()),
           "f32_limit": 0.01,
           "max_abs_prob_diff_vs_cpu_int8": float(
               np.abs(probs[:16] - cpu_probs).max()),
           "limit": PROB_LIMIT, "profile_score_packed": busy}
    emit(row)
    if not (np.all(np.isfinite(probs)) and np.all((probs > 0) & (probs < 1))):
        fail("serve_int8: non-finite or out-of-range probabilities")
    if cpu.precision != "int8":
        fail("serve_int8: the CPU engine's int8 gate refused")
    if not row["max_abs_prob_diff_vs_f32"] <= 0.01:
        fail(f"serve_int8: {row['max_abs_prob_diff_vs_f32']} from float32")
    if not row["max_abs_prob_diff_vs_cpu_int8"] <= PROB_LIMIT:
        fail(f"serve_int8: {row['max_abs_prob_diff_vs_cpu_int8']} from the "
             f"CPU")
    if launches <= 0 or launches != dispatches * per:
        fail(f"serve_int8: {launches} B5 launches for {dispatches} "
             f"dispatches (expected {per} each)")
    if variants["wgmma"] != launches:
        fail(f"serve_int8: B5 launches by variant {variants}: a main-path "
             f"shape missed the tensor cores")
    return row


# --------------------------------------------------------------- phase 13

# one-subtoken words, so a function's subtoken count is its word count
_C_WORDS = ("int", "char", "unsigned", "buf", "len", "ptr", "idx", "count",
            "memcpy", "strncpy", "malloc", "free", "if", "else", "while",
            "for", "return", "struct", "node", "sockfd", "recv", "sizeof",
            "NULL", "errno", "goto", "cleanup", "out", "tmp", "flags")


def c_functions(n: int, seed: int, lo: int = 20, hi: int = 600) -> list[str]:
    """``n`` seeded C-like functions of ``lo``-``hi`` subtokens, log-uniform
    (short functions are the common case): at block 256 about a quarter are
    truncated and the rest left-padded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        body = " ".join(rng.choice(_C_WORDS, size=k - 6))
        out.append(f"int fn{i}(char *buf, int len) {{\n  {body};\n}}\n")
    return out


FLASH_SHAPES = [  # name, b, s, h, h_kv, d, dtype, the variant it must take
    ("7b_serve", 4, 256, 32, 32, 128, torch.bfloat16, "wgmma"),
    ("13b_pb_ft_pb_noexpl", 6, 1024, 40, 40, 128, torch.bfloat16, "wgmma"),
    ("13b_s2048", 4, 2048, 40, 40, 128, torch.bfloat16, "wgmma"),
    ("tiny_llama", 2, 128, 4, 2, 16, torch.float32, "ffma"),
    # off the main paths: the mma.sync variant, kept for the bf16 head
    # widths the wgmma one does not take
    ("mma_d64", 4, 256, 32, 32, 64, torch.bfloat16, "mma")]


def flash_bound(b: int, s: int, h: int, h_kv: int, d: int,
                bf16: bool) -> tuple[float, str]:
    """Least milliseconds for causal attention: 4·b·h·d·s(s+1)/2 FLOPs over
    the peak of the inputs' type (bf16 tensor cores, or FP32), or the bytes
    of q, k, v and o over HBM bandwidth, the larger."""
    flops = 4 * b * h * d * s * (s + 1) / 2
    nbytes = (2 if bf16 else 4) * (2 * b * s * h * d + 2 * b * s * h_kv * d)
    t_ops = flops / (PEAK_BF16 if bf16 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_flash_kernel() -> list[dict]:
    """B6 against its plain version at the LLM tier's shapes."""
    tok = HashTokenizer(32016)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for name, b, s, h, h_kv, d, dt, expect in FLASH_SHAPES:
        mask = torch.from_numpy(np.stack(
            [tok.encode_block(t, s)[1] for t in c_functions(b, seed=s)])).cuda()
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dt)
                   for n in (h, h_kv, h_kv))
        # the library yardstick: SDPA on its own layout with the same mask
        seg = mask.to(torch.int32)
        keep = torch.tril(torch.ones(s, s, dtype=torch.bool, device="cuda"))
        keep = keep[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])
        sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def kernel():
            return fa.flash_attention(q, k, v, mask)

        def plain():
            return fa.flash_attention_reference(q, k, v, mask)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=keep, enable_gqa=h != h_kv)

        with torch.inference_mode():
            before = fa.n_launches
            by_variant = dict(fa.n_variant_launches)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            launches = fa.n_launches - before
            took = {x: fa.n_variant_launches[x] - by_variant[x]
                    for x in fa.VARIANTS}
            variant = next((x for x, c in took.items() if c), None)
            want = plain().float()
            abs_err = float((got.float() - want).abs().max())
            rel_err = abs_err / float(want.abs().max())
            err = row_rel_err(got, want)
            lib_err = float((library().transpose(1, 2).float() - want).abs()
                            .max())
            bitwise = torch.equal(got, again)
            finite = bool(torch.isfinite(got).all())
            del want
            ms = cuda_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 3)
            library_ms = cuda_ms(library, 20)
            ms_again = cuda_ms(kernel, 20)
            fns = (("", kernel, 10), ("plain_", plain, 2),
                   ("library_", library, 10))
            if expect == "wgmma":
                # the mma variant (the kernel before wgmma) at the same
                # shape, on the same path, for the time it took before
                fns += (("mma_", lambda: fa._launch_forward(
                    q, k, v, fa._seg(mask), True, with_lse=False,
                    kind="mma"), 10),)
            dev = {f"{key}graph_ms": graph_ms(f, 2 * n) for key, f, n in fns}
        bf16 = dt == torch.bfloat16
        limit = FLASH_BF16_LIMIT if bf16 else FLASH_F32_LIMIT
        bound_ms, bound_by = flash_bound(b, s, h, h_kv, d, bf16)
        row = {"phase": "flash_kernel", "shape": name, "b": b, "s": s,
               "h": h, "h_kv": h_kv, "d": d, "dtype": str(dt).split(".")[-1],
               "variant": variant, "launches_by_variant": took,
               "real_tokens": int(mask.sum()), "max_abs_err": abs_err,
               "max_rel_err": rel_err, "max_row_rel_err": err,
               "limit": limit, "finite": finite,
               "bitwise_repeat": bitwise, "launches_per_call": launches // 2,
               "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "scaled_dot_product_attention, boolean mask",
               "library_max_abs_diff": lib_err, **dev, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "tflops": 4 * b * h * d * s * (s + 1) / 2
               / (dev["graph_ms"] * 1e9)}
        emit(row)
        if launches != 2 or not (finite and bitwise and err <= limit):
            fail(f"B6 at {name}: launches={launches} finite={finite} "
                 f"bitwise={bitwise} err={err} (limit {limit})")
        if took[expect] != 2:
            fail(f"B6 at {name}: took {took}, not two {expect} launches")
        rows.append(row)
    return rows


# ------------------------------------------------------------ phase 15, 18

JOINT_FUNCTIONS = 64


def shared_llama(cfg, state: dict) -> LlamaModel:
    """A ``LlamaModel`` of ``cfg`` over the tensors of ``state``, no copy."""
    with torch.device("meta"):
        model = LlamaModel(cfg)
    model.load_state_dict(state, assign=True)
    return model.eval()


def score_batches(engine, items) -> tuple[np.ndarray, float, list[float]]:
    """``items`` through ``JointEngine.score``, one call per batch:
    probabilities, wall seconds and each batch's seconds."""
    probs, lat = [], []
    t0 = time.perf_counter()
    for i in range(0, len(items), engine.max_batch):
        t = time.perf_counter()
        probs.append(engine.score(items[i:i + engine.max_batch]))
        lat.append(time.perf_counter() - t)
    return np.concatenate(probs), time.perf_counter() - t0, lat


def weight_gb(model) -> float:
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values()) / 1e9


def check_probs(name: str, probs: np.ndarray) -> None:
    if not (np.all(np.isfinite(probs)) and np.all((probs > 0) & (probs < 1))):
        fail(f"{name}: non-finite or out-of-range probabilities")


def reset_flash_counts() -> None:
    """B6's and B6b's launch counts, in all and by variant, to 0."""
    fa.n_launches = fa.n_bwd_launches = 0
    fa.n_variant_launches = dict.fromkeys(fa.VARIANTS, 0)
    fa.n_bwd_variant_launches = dict.fromkeys(fa.VARIANTS, 0)


def check_wgmma(phase: str, by_variant: dict, launches: int) -> None:
    """Every B6 or B6b launch of a main path (bf16 at d 128) on the
    ``wgmma`` variant."""
    if by_variant["wgmma"] != launches:
        fail(f"{phase}: flash launches by variant {by_variant}: a main-path "
             f"shape missed the wgmma variant")


def phase_joint(seed: int = 0) -> tuple[dict, dict]:
    """JointEngine over CodeLlama-7B (random weights from ``seed``, B6
    attention) and the golden GGNN encoder."""
    cfg = codellama_7b(attn_impl="flash")
    t0 = time.perf_counter()
    llm = build_llama(cfg, "cuda", seed=seed)
    fusion = build_fusion(GGNNConfig(), INPUT_DIM, cfg.hidden_size,
                          dropout_rate=0.1, device="cuda", seed=seed + 1)
    tok = HashTokenizer(cfg.vocab_size)
    jcfg = JointConfig(block_size=256)
    engine = JointEngine(llm, fusion, tok, jcfg, max_batch=4, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    items = list(zip(c_functions(JOINT_FUNCTIONS, seed=17),
                     requests()[:JOINT_FUNCTIONS]))

    # the main path: counts from zero, read right after
    fa.n_launches = 0
    fa.n_variant_launches = dict.fromkeys(fa.VARIANTS, 0)
    engine.n_batches = 0
    probs, wall, lat = score_batches(engine, items)
    torch.cuda.synchronize()
    launches, batches = fa.n_launches, engine.n_batches
    b6_variants = dict(fa.n_variant_launches)

    # off the main path: the same engine with B6 on its plain version
    saved = llama_mod.flash_attention
    llama_mod.flash_attention = fa.flash_attention_reference
    try:
        plain_probs = engine.score(items)
    finally:
        llama_mod.flash_attention = saved
    busy = profile_call(lambda: engine.score(items[:4]))
    real = int(sum(tok.encode_block(t, jcfg.block_size)[1].sum()
                   for t, _ in items))
    full = JointEngine(shared_llama(dataclasses.replace(cfg, attn_impl="full"),
                                    llm.state_dict()),
                       fusion, tok, jcfg, max_batch=4, device="cuda")
    full_probs, full_wall, _ = score_batches(full, items)
    fused = build_fusion(GGNNConfig(layout="fused"), INPUT_DIM,
                         cfg.hidden_size, dropout_rate=0.1, device="cuda")
    fused.load_state_dict(fusion.state_dict())
    fg.n_launches = 0
    fused_probs = JointEngine(llm, fused, tok, jcfg, max_batch=4,
                              device="cuda").score(items)
    b1_launches = fg.n_launches
    # the same weights cut to 2 decoder layers, one batch of 2 functions:
    # the card against the port's plain path on the CPU
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    state2 = {k: v for k, v in llm.state_dict().items()
              if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
    card2 = JointEngine(shared_llama(cfg2, state2), fusion, tok, jcfg,
                        max_batch=2, device="cuda")
    cpu_llm = build_llama(cfg2, "cpu", seed=None)
    cpu_llm.load_state_dict({k: v.cpu() for k, v in state2.items()})
    cpu_fusion = build_fusion(GGNNConfig(), INPUT_DIM, cfg.hidden_size,
                              dropout_rate=0.1, device="cpu")
    cpu_fusion.load_state_dict({k: v.cpu()
                                for k, v in fusion.state_dict().items()})
    cpu2 = JointEngine(cpu_llm, cpu_fusion, tok, jcfg, max_batch=2,
                       device="cpu")
    t0 = time.perf_counter()
    p_cpu2 = cpu2.score(items[:2])
    cpu_s = time.perf_counter() - t0
    p_card2 = card2.score(items[:2])

    tokens = batches * engine.max_batch * jcfg.block_size
    row = {"phase": "joint", "model": "codellama_7b(attn_impl='flash'), "
                                      "seeded random weights", "seed": seed,
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
           "block": jcfg.block_size, "max_batch": engine.max_batch,
           "functions": len(items), "batches": batches,
           "weight_gb": weight_gb(llm), "build_s": build_s,
           "warmup_s": warmup_s, "wall_s": wall,
           "functions_per_s": len(items) / wall,
           "real_tokens_per_s": real / wall,
           "padded_tokens_per_s": tokens / wall, "real_tokens": real,
           "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
           "max_batch_ms": float(max(lat) * 1e3),
           "b6_launches": launches, "b6_launches_per_batch":
               cfg.num_hidden_layers, "b6_variant_launches": b6_variants,
           "max_abs_prob_diff_vs_plain_b6": float(
               np.abs(probs - plain_probs).max()),
           "max_abs_prob_diff_vs_full": float(np.abs(probs - full_probs).max()),
           "max_abs_prob_diff_plain_b6_vs_full": float(
               np.abs(plain_probs - full_probs).max()),
           "full_functions_per_s": len(items) / full_wall,
           "max_abs_prob_diff_fused_vs_segment": float(
               np.abs(fused_probs - probs).max()),
           "fused_b1_launches": b1_launches,
           "max_abs_prob_diff_2_layers_vs_cpu": float(
               np.abs(p_card2 - p_cpu2).max()),
           "cpu_2_layers_s": cpu_s, "plain_b6_limit": FLASH_PROB_LIMIT,
           "full_limit": FULL_PROB_LIMIT, "cpu_limit": JOINT_PROB_LIMIT,
           "fused_limit": PROB_LIMIT,
           "model_rev": engine.model_rev,
           "probs": [round(float(p), 6) for p in probs[:8]],
           "profile_batch": busy}
    emit(row)
    check_probs("joint", probs)
    if launches <= 0 or launches != batches * cfg.num_hidden_layers:
        fail(f"joint: {launches} B6 launches for {batches} batches "
             f"(expected {cfg.num_hidden_layers} each)")
    check_wgmma("joint", b6_variants, launches)
    for key, limit in (("max_abs_prob_diff_vs_plain_b6", FLASH_PROB_LIMIT),
                       ("max_abs_prob_diff_vs_full", FULL_PROB_LIMIT),
                       ("max_abs_prob_diff_2_layers_vs_cpu",
                        JOINT_PROB_LIMIT)):
        if not row[key] <= limit:
            fail(f"joint: {key} = {row[key]} over {limit}")
    if b1_launches <= 0 or not row["max_abs_prob_diff_fused_vs_segment"] \
            <= PROB_LIMIT:
        fail(f"joint: the fused encoder ({b1_launches} B1 launches) is "
             f"{row['max_abs_prob_diff_fused_vs_segment']} from segment")
    ctx = dict(cfg=cfg, llm=llm, fusion=fusion, tok=tok, jcfg=jcfg,
               items=items, probs=probs)
    return row, ctx


def phase_joint_int8(ctx: dict) -> dict:
    """The joint model with int8-resident projections (B5, bf16
    activations), quantized from the same seeded weights."""
    cfg, fusion, tok, jcfg, items = (ctx[k] for k in (
        "cfg", "fusion", "tok", "jcfg", "items"))
    t0 = time.perf_counter()
    state8 = to_int8_runtime_params(ctx.pop("llm").state_dict())
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the bf16 projections are gone
    llm8 = shared_llama(dataclasses.replace(cfg, int8_runtime=True), state8)
    del state8
    engine = JointEngine(llm8, fusion, tok, jcfg, max_batch=4, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0

    # the main path: counts from zero, read right after
    i8.n_launches = 0
    i8.n_variant_launches = dict.fromkeys(i8.VARIANTS, 0)
    fa.n_launches = 0
    fa.n_variant_launches = dict.fromkeys(fa.VARIANTS, 0)
    engine.n_batches = 0
    probs, wall, lat = score_batches(engine, items)
    torch.cuda.synchronize()
    launches, b6, batches = i8.n_launches, fa.n_launches, engine.n_batches
    variants = dict(i8.n_variant_launches)
    b6_variants = dict(fa.n_variant_launches)

    # off the main path: every Int8Dense on B5's plain version on the card
    saved = llama_mod.int8_matmul
    llama_mod.int8_matmul = (lambda x, q, s, out_dtype:
                             i8.int8_matmul_reference(x, q, s, out_dtype))
    try:
        plain = engine.score(items)
    finally:
        llama_mod.int8_matmul = saved
    busy = profile_call(lambda: engine.score(items[:4]), match="int8_matmul")
    per = cfg.num_hidden_layers * 7
    row = {"phase": "joint_int8", "functions": len(items),
           "batches": batches, "weight_gb": weight_gb(llm8),
           "quantize_s": quant_s, "warmup_s": warmup_s, "wall_s": wall,
           "functions_per_s": len(items) / wall,
           "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
           "b5_launches": launches, "b5_launches_per_batch": per,
           "b5_variant_launches": variants,
           "b5_device_share": busy["int8_matmul_share"],
           "b6_launches": b6, "b6_variant_launches": b6_variants,
           "max_abs_prob_diff_vs_plain_int8": float(np.abs(probs - plain)
                                                    .max()),
           "limit": INT8_PROB_LIMIT,
           "max_abs_prob_diff_vs_bf16": float(np.abs(probs - ctx["probs"])
                                              .max()),
           "mean_abs_prob_diff_vs_bf16": float(np.abs(probs - ctx["probs"])
                                               .mean()),
           "probs": [round(float(p), 6) for p in probs[:8]],
           "profile_batch": busy}
    emit(row)
    check_probs("joint_int8", probs)
    if launches <= 0 or launches != batches * per:
        fail(f"joint_int8: {launches} B5 launches for {batches} batches "
             f"(expected {per} each)")
    if variants["wgmma"] != launches:
        fail(f"joint_int8: B5 launches by variant {variants}: a main-path "
             f"shape missed the tensor cores")
    if b6 != batches * cfg.num_hidden_layers:
        fail(f"joint_int8: {b6} B6 launches for {batches} batches")
    check_wgmma("joint_int8", b6_variants, b6)
    if not row["max_abs_prob_diff_vs_plain_int8"] <= INT8_PROB_LIMIT:
        fail(f"joint_int8: {row['max_abs_prob_diff_vs_plain_int8']} from the "
             f"plain int8 path")
    return row


# ------------------------------------------------------------ phase 14

FLASH_BWD_SHAPES = [  # name, b, s, h, h_kv, d, dtype, the variant
    ("7b_train", 4, 256, 32, 32, 128, torch.bfloat16, "wgmma"),
    ("13b_pb_ft_pb_noexpl", 6, 1024, 40, 40, 128, torch.bfloat16, "wgmma"),
    ("13b_s2048", 4, 2048, 40, 40, 128, torch.bfloat16, "wgmma"),
    ("gqa_f32", 4, 256, 4, 2, 16, torch.float32, "ffma"),
    # off the main paths: the mma.sync variants, grouped-query heads
    ("mma_gqa_d64", 4, 256, 8, 2, 64, torch.bfloat16, "mma")]


def flash_bwd_bound(b: int, s: int, h: int, h_kv: int, d: int,
                    bf16: bool) -> tuple[float, str]:
    """Least milliseconds for the causal attention backward: five products
    of b·h·d·s(s+1)/2 multiply-adds (S recomputed, dV, dP, dK, dQ) over the
    peak of the inputs' type, or the bytes of q, k, v, o, do, the
    logsumexp and dq, dk, dv over HBM bandwidth, the larger."""
    flops = 10 * b * h * d * s * (s + 1) / 2
    e = 2 if bf16 else 4
    nbytes = e * (4 * b * s * h * d + 4 * b * s * h_kv * d) + 4 * b * h * s
    t_ops = flops / (PEAK_BF16 if bf16 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def zero_gradient_rows(mask: torch.Tensor, s: int) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """([b, s] queries, [b, s] keys) whose causal attention gradient is 0 in
    exact arithmetic: a query that sees one key (the softmax of one score
    does not depend on it) and a key seen only by such queries. Both the
    kernel and the plain version return rounding noise there."""
    seg = mask.int()
    keep = torch.tril(torch.ones(s, s, dtype=torch.bool, device=mask.device))
    keep = keep[None] & (seg[:, :, None] == seg[:, None, :])
    q_one = keep.sum(-1) == 1
    return q_one, ~(keep & ~q_one[..., None]).any(dim=1)


def grad_row_err(got: torch.Tensor, want: torch.Tensor,
                 zero_rows: torch.Tensor) -> float:
    """:func:`row_rel_err` for a gradient: rows whose exact value is 0
    (``zero_rows``, [b, s]) are taken over the tensor's largest value."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    top = want.abs().amax(dim=-1)
    top = torch.where(zero_rows[..., None], want.abs().max(), top)
    return float((err / top.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


def phase_flash_bwd_kernel() -> list[dict]:
    """B6b against its plain version at the training shapes."""
    tok = HashTokenizer(32016)
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for name, b, s, h, h_kv, d, dt, expect in FLASH_BWD_SHAPES:
        mask = torch.from_numpy(np.stack(
            [tok.encode_block(t, s)[1] for t in c_functions(b, seed=s + 1)])
        ).cuda()
        q, k, v, do = (torch.randn(b, s, n, d, generator=gen,
                                   device="cuda").to(dt)
                       for n in (h, h_kv, h_kv, h))
        with torch.no_grad():
            o, lse = fa.flash_attention_forward(q, k, v, mask)
        # the library yardstick: the backward of SDPA with the same mask
        seg = mask.to(torch.int32)
        keep = torch.tril(torch.ones(s, s, dtype=torch.bool, device="cuda"))
        keep = keep[None, None] & (seg[:, None, :, None]
                                   == seg[:, None, None, :])
        sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        sdo = do.transpose(1, 2).contiguous()

        def kernel():
            return fa.flash_attention_backward(q, k, v, o, do, lse, mask)

        def plain():
            return fa.flash_attention_backward_reference(q, k, v, o, do, lse,
                                                         mask)

        def library_forward():
            return torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=keep, enable_gqa=h != h_kv)

        # autograd runs a backward on its forward's stream, so a CUDA graph
        # can hold SDPA's backward only with its forward: the library's
        # backward is timed as forward + backward less the forward (which
        # saves its logsumexp, as under training)
        def library():
            return torch.autograd.grad(library_forward(), (sq, sk, sv), sdo)

        before = fa.n_bwd_launches
        by_variant = dict(fa.n_bwd_variant_launches)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        launches = fa.n_bwd_launches - before
        took = {x: fa.n_bwd_variant_launches[x] - by_variant[x]
                for x in fa.VARIANTS}
        variant = next((x for x, c in took.items() if c), None)
        want = plain()
        q_one, k_zero = zero_gradient_rows(mask, s)
        zero = {"dq": q_one, "dk": k_zero, "dv": torch.zeros_like(k_zero)}
        errs, abs_errs, lib_errs = {}, {}, {}
        for i, key in enumerate(("dq", "dk", "dv")):
            errs[key] = grad_row_err(got[i], want[i], zero[key])
            abs_errs[key] = float((got[i].float() - want[i].float()).abs()
                                  .max())
        lib = library()
        for i, key in enumerate(("dq", "dk", "dv")):
            lib_errs[key] = float((lib[i].transpose(1, 2).float()
                                   - want[i].float()).abs().max())
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        del want, lib
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        library_fwd_bwd_ms = cuda_ms(library, 20)
        library_fwd_ms = cuda_ms(library_forward, 20)
        fns = (("", kernel, 10), ("plain_", plain, 2),
               ("library_fwd_bwd_", library, 10),
               ("library_fwd_", library_forward, 10))
        if expect == "wgmma":
            # the mma variants (the kernels before wgmma) at the same
            # shape, on the same path, for the time they took before
            fns += (("mma_", lambda: fa._launch_backward(
                q, k, v, o, do, lse, fa._seg(mask), True, kind="mma"), 10),)
        dev = {f"{key}graph_ms": graph_ms(f, 2 * n) for key, f, n in fns}
        dev["library_graph_ms"] = (dev["library_fwd_bwd_graph_ms"]
                                   - dev["library_fwd_graph_ms"])
        library_ms = library_fwd_bwd_ms - library_fwd_ms
        bf16 = dt == torch.bfloat16
        limit = FLASH_BF16_LIMIT if bf16 else FLASH_F32_LIMIT
        bound_ms, bound_by = flash_bwd_bound(b, s, h, h_kv, d, bf16)
        err = max(errs.values())
        row = {"phase": "flash_bwd_kernel", "shape": name, "b": b, "s": s,
               "h": h, "h_kv": h_kv, "d": d, "dtype": str(dt).split(".")[-1],
               "variant": variant, "launches_by_variant": took,
               "real_tokens": int(mask.sum()),
               "max_row_rel_err": errs, "max_abs_err": abs_errs,
               "limit": limit, "finite": finite, "bitwise_repeat": bitwise,
               "launches_per_call": launches // 2, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_fwd_bwd_ms": library_fwd_bwd_ms,
               "library_fwd_ms": library_fwd_ms,
               "library": "autograd of scaled_dot_product_attention, "
                          "boolean mask (forward + backward less forward)",
               "library_max_abs_diff": lib_errs, **dev, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "tflops": 10 * b * h * d * s * (s + 1) / 2
               / (dev["graph_ms"] * 1e9)}
        emit(row)
        if launches != 4 or not (finite and bitwise and err <= limit):
            fail(f"B6b at {name}: launches={launches} finite={finite} "
                 f"bitwise={bitwise} err={errs} (limit {limit})")
        if took[expect] != 4:
            fail(f"B6b at {name}: took {took}, not four {expect} launches")
        rows.append(row)
        del sq, sk, sv
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 16

FINETUNE_FUNCTIONS = 32
LORA_RANK = 16  # the fine-tuned preset's (deepdfa_tpu/llm/presets.py:70)


def lora_llm(cfg, base: dict, lm_head: torch.Tensor, seed: int):
    """A ``LlamaForCausalLM`` of ``cfg`` over the tensors of ``base`` (a
    ``LlamaModel`` state dict) and ``lm_head``, no copy, with fresh LoRA
    adapters drawn on the card from ``seed`` (``A`` N(0, 1/rank), ``B``
    zero: peft's start)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {f"model.{k}": v for k, v in base.items()}
    state["lm_head.weight"] = lm_head
    with torch.device("meta"):
        model = llama_mod.LlamaForCausalLM(cfg)
    for name, t in model.named_parameters():
        if name.endswith("lora_a"):
            state[name] = torch.randn(t.shape, generator=gen, device="cuda"
                                      ) * cfg.lora_rank ** -0.5
        elif name.endswith("lora_b"):
            state[name] = torch.zeros(t.shape, device="cuda")
    model.load_state_dict(state, assign=True)
    return model.eval()


class PlainFlash(torch.autograd.Function):
    """B6's plain version forward with its logsumexp saved, B6b's plain
    version (``flash_attention_backward_reference``) backward: the witness
    the kernels' path is held against."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal):
        out, lse = fa._reference_forward(q, k, v, pad_mask, causal)
        ctx.save_for_backward(q, k, v, out, lse, pad_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, pad_mask = ctx.saved_tensors
        grads = fa.flash_attention_backward_reference(
            q, k, v, out, do, lse, pad_mask, causal=ctx.causal)
        return (*grads, None, None)


def plain_flash_attention(q, k, v, pad_mask, *, causal=True):
    """``fa.flash_attention`` with both kernels on their plain versions."""
    return PlainFlash.apply(q, k, v, pad_mask, causal)


def adapter_grads(model, ids, pad, plain: bool) -> dict:
    """The adapters' gradients of one LM loss, with B6/B6b or (``plain``)
    both on their plain versions."""
    saved = llama_mod.flash_attention
    if plain:
        llama_mod.flash_attention = plain_flash_attention
    try:
        freeze_base(model)
        loss = lm_loss(model(ids, pad), ids, pad)
        loss.backward()
    finally:
        llama_mod.flash_attention = saved
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return grads


def phase_finetune(ctx: dict, seed: int = 0) -> dict:
    """LoRA fine-tuning of CodeLlama-7B width and depth (the joint phase's
    seeded weights, a seeded LM head) through ``attn_impl="flash"``: B6
    forward and B6b backward on every step."""
    cfg = codellama_7b(attn_impl="flash", lora_rank=LORA_RANK,
                       lora_alpha=16.0)
    base = ctx["llm"].state_dict()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    lm_head = (torch.randn(cfg.vocab_size, cfg.hidden_size, generator=gen,
                           device="cuda") * cfg.hidden_size ** -0.5).to(
        cfg.torch_dtype)
    model = lora_llm(cfg, base, lm_head, seed + 8)
    tok = ctx["tok"]
    examples = encode_functions(c_functions(FINETUNE_FUNCTIONS, seed=23),
                                [0] * FINETUNE_FUNCTIONS, tok, 256)
    fcfg = FinetuneConfig(epochs=1, batch_size=4, seed=seed)

    # witness: the first step's adapter gradients, kernels against plain
    ids, pad, _ = next(_lm_batches(examples, fcfg.batch_size, seed=fcfg.seed))
    ids, pad = torch.from_numpy(ids).cuda(), torch.from_numpy(pad).cuda()
    g_kernel = adapter_grads(model, ids, pad, plain=False)
    g_plain = adapter_grads(model, ids, pad, plain=True)
    witness = 0.0
    for name, want in g_plain.items():
        top = float(want.abs().max())
        err = float((g_kernel[name] - want).abs().max())
        if top == 0.0:  # lora_a: B = 0 at the start, so dL/dA = 0 exactly
            witness = max(witness, float("inf") if err else 0.0)
        else:
            witness = max(witness, err / top)
    n_zero = sum(float(g.abs().max()) == 0.0 for g in g_plain.values())
    del g_kernel, g_plain

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lora_") as tmp:
        tuner = LoraFinetuner(model, fcfg, run_dir=Path(tmp))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from zero, read right after
        reset_flash_counts()
        t0 = time.perf_counter()
        model, losses = tuner.train(examples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b6, b6b = fa.n_launches, fa.n_bwd_launches
        b6_variants = dict(fa.n_variant_launches)
        b6b_variants = dict(fa.n_bwd_variant_launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = len(tuner.step_seconds)

        # the saved adapters on a fresh base, then merged into it
        fresh = lora_llm(cfg, base, lm_head, seed + 9)
        tuner.load_adapters(fresh, "adapters_epoch_0")
        trained = {n: p for n, p in model.named_parameters()
                   if is_lora_name(n)}
        loaded_equal = all(torch.equal(p, trained[n])
                           for n, p in fresh.named_parameters()
                           if is_lora_name(n))
    moved = max(float((trained[n] - p).detach().abs().max()) for n, p in
                lora_llm(cfg, base, lm_head, seed + 8).named_parameters()
                if is_lora_name(n))
    with torch.inference_mode():
        unmerged = fresh.model(ids, pad).float()
        merged_state = merge_lora({k: v for k, v in fresh.state_dict().items()
                                   if k.startswith("model.")},
                                  alpha=cfg.lora_alpha)
        merged = shared_llama(dataclasses.replace(cfg, lora_rank=0),
                              {k[len("model."):]: v
                               for k, v in merged_state.items()})
        merged_h = merged(ids, pad).float()
        merge_err = float((merged_h - unmerged).abs().max()
                          / unmerged.abs().max())
    del merged, merged_state, merged_h, unmerged, fresh
    busy = profile_call(lambda: adapter_grads(model, ids, pad, plain=False))
    real = int(examples.pad_mask.sum())
    padded = steps * fcfg.batch_size * 256
    row = {"phase": "finetune",
           "model": "LlamaForCausalLM(codellama_7b(attn_impl='flash', "
                    "lora_rank=16, lora_alpha=16)), seeded random weights",
           "seed": seed, "layers": cfg.num_hidden_layers,
           "hidden": cfg.hidden_size, "block": 256,
           "batch": fcfg.batch_size, "functions": FINETUNE_FUNCTIONS,
           "steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
           "real_tokens_per_s": real / wall,
           "padded_tokens_per_s": padded / wall, "real_tokens": real,
           "p50_step_ms": float(np.percentile(tuner.step_seconds, 50) * 1e3),
           "max_step_ms": float(max(tuner.step_seconds) * 1e3),
           "peak_memory_gb": peak_gb, "losses": losses,
           "b6_launches": b6, "b6b_launches": b6b,
           "b6_variant_launches": b6_variants,
           "b6b_variant_launches": b6b_variants,
           "b6_launches_per_step": cfg.num_hidden_layers,
           "b6b_launches_per_step": 2 * cfg.num_hidden_layers,
           "adapters": len(trained), "zero_first_step_grads": n_zero,
           "first_step_grad_rel_err_vs_plain": witness,
           "grad_limit": LORA_GRAD_LIMIT,
           "adapter_max_change": moved, "loaded_adapters_equal":
               loaded_equal,
           "merged_hidden_rel_err": merge_err, "merge_limit": MERGE_LIMIT,
           "profile_step": busy}
    emit(row)
    if not all(np.isfinite(losses)):
        fail(f"finetune: non-finite loss {losses}")
    if steps <= 0 or b6 != steps * cfg.num_hidden_layers \
            or b6b != steps * 2 * cfg.num_hidden_layers:
        fail(f"finetune: {b6} B6 and {b6b} B6b launches for {steps} steps "
             f"(expected {cfg.num_hidden_layers} and "
             f"{2 * cfg.num_hidden_layers} each)")
    check_wgmma("finetune", b6_variants, b6)
    check_wgmma("finetune (B6b)", b6b_variants, b6b)
    if not witness <= LORA_GRAD_LIMIT:
        fail(f"finetune: first-step adapter gradients {witness} from the "
             f"plain path (limit {LORA_GRAD_LIMIT})")
    if not (loaded_equal and moved > 0 and merge_err <= MERGE_LIMIT):
        fail(f"finetune: adapters loaded equal {loaded_equal}, moved "
             f"{moved}, merged hidden states {merge_err} (limit "
             f"{MERGE_LIMIT})")
    del model
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 17

JOINT_TRAIN_EVAL = 16


def phase_joint_train(ctx: dict, seed: int = 0) -> dict:
    """JointTrainer (MSIVD mode) over the joint phase's CodeLlama-7B and a
    fresh fusion model with the golden GGNN encoder: one epoch, its eval
    points, ``epoch_0`` restored by ``JointEngine.from_run_dir``."""
    cfg, llm, tok = ctx["cfg"], ctx["llm"], ctx["tok"]
    n = FINETUNE_FUNCTIONS + JOINT_TRAIN_EVAL
    texts = c_functions(n, seed=23)
    labels = np.random.default_rng(seed + 29).integers(0, 2, n).tolist()
    graphs = requests()[:n]
    jcfg = JointConfig(block_size=256, epochs=1, seed=seed)
    train = encode_functions(texts[:FINETUNE_FUNCTIONS],
                             labels[:FINETUNE_FUNCTIONS], tok, 256)
    evals = encode_functions(texts[FINETUNE_FUNCTIONS:],
                             labels[FINETUNE_FUNCTIONS:], tok, 256,
                             indices=range(FINETUNE_FUNCTIONS, n))
    join = GraphJoin(graphs=dict(enumerate(graphs)), max_nodes=4096,
                     max_edges=8192)
    fusion = build_fusion(GGNNConfig(), INPUT_DIM, cfg.hidden_size,
                          dropout_rate=0.1, device="cuda", seed=seed + 31)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_joint_") as tmp:
        trainer = JointTrainer(llm, fusion, jcfg, join, run_dir=Path(tmp))
        # the main path: counts from zero, read right after
        reset_flash_counts()
        t0 = time.perf_counter()
        state = trainer.train(train, evals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b6, b6b = fa.n_launches, fa.n_bwd_launches
        b6_variants = dict(fa.n_variant_launches)
        evals_run = sum("eval_loss" in h for h in trainer.history)
        _, probs, _ = trainer._run_eval(state.params, evals)
        engine = JointEngine.from_run_dir(
            tmp, jcfg=jcfg, llm_cfg=cfg, llm_state=llm.state_dict(),
            max_nodes=4096, max_edges=8192, device="cuda")
        items = list(zip(texts[FINETUNE_FUNCTIONS:],
                         graphs[FINETUNE_FUNCTIONS:]))
        restored = engine.score(items)
        written = sorted(p.name for p in Path(tmp).iterdir())
    del engine
    torch.cuda.empty_cache()
    steps = state.step
    eval_batches = evals_run * -(-JOINT_TRAIN_EVAL // jcfg.eval_batch_size)
    restore_err = float(np.abs(restored - probs[:, 1]).max())
    train_loss = [h["train_loss"] for h in trainer.history
                  if "train_loss" in h]
    row = {"phase": "joint_train", "seed": seed,
           "model": "codellama_7b(attn_impl='flash') frozen + fusion "
                    "(golden GGNN encoder, segment layout), seeded weights",
           "train_functions": FINETUNE_FUNCTIONS,
           "eval_functions": JOINT_TRAIN_EVAL, "steps": steps,
           "evals": evals_run, "wall_s": wall,
           "steps_per_s": steps / wall, "train_loss": train_loss,
           "last_eval": next(h for h in reversed(trainer.history)
                             if "eval_loss" in h),
           "b6_launches": b6, "b6b_launches": b6b,
           "b6_variant_launches": b6_variants,
           "b6_launches_expected": (steps + eval_batches)
           * cfg.num_hidden_layers,
           "written": written, "restored_max_abs_diff": restore_err,
           "restore_limit": 1e-5, "updates": state.opt_state.count}
    emit(row)
    if not all(np.isfinite(train_loss)) \
            or steps != -(-FINETUNE_FUNCTIONS // jcfg.train_batch_size):
        fail(f"joint_train: {steps} steps, losses {train_loss}")
    if b6 != row["b6_launches_expected"] or b6b != 0:
        fail(f"joint_train: {b6} B6 launches (expected "
             f"{row['b6_launches_expected']}) and {b6b} B6b launches "
             f"(expected 0: the frozen LLM builds no backward)")
    check_wgmma("joint_train", b6_variants, b6)
    if written != ["epoch_0"] or not restore_err <= 1e-5:
        fail(f"joint_train: wrote {written}; from_run_dir scores "
             f"{restore_err} from the trainer's own evaluation")
    return row


# --------------------------------------------------------------- phase 16


FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
SCAN_VOCAB_FUNCTIONS = 2000
SCAN_FILES, SCAN_FNS_PER_FILE = 256, 4
SCAN_INTERPROC_FILES = 32
SCAN_BAND = 64
SCAN_CHECK_FUNCTIONS = 64


def codegen_rows(n: int, seed: int, first_id: int) -> list[dict]:
    """``n`` seeded ``codegen`` rows: the easy and the dataflow-hard
    templates in turn, half of them vulnerable."""
    rng = np.random.default_rng(seed)
    gens = (generate_function, generate_hard_function)
    return [gens[i % 2](first_id + i, (i // 2) % 2 == 0, rng)
            for i in range(n)]


def scan_vocabs(seed: int) -> tuple[dict, float]:
    """The vocabularies of a seeded training corpus of 2,000 generated
    functions, built by the port (``corpus_hashes`` + ``build_vocab``), and
    the host seconds it took."""
    t0 = time.perf_counter()
    rows = codegen_rows(SCAN_VOCAB_FUNCTIONS, seed, 100_000)
    cpgs = {r["id"]: add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    hashes = corpus_hashes(cpgs, FeatureConfig().subkeys)
    return corpus_vocabs(hashes, list(cpgs)), time.perf_counter() - t0


def write_scan_trees(root: Path, seed: int) -> tuple[Path, Path]:
    """The scan corpus (256 generated files of 4 functions, the realworld
    fixtures, ``cross_taint.c``) and the interprocedural one
    (``cross_taint.c`` + the first 32 generated files)."""
    tree, ip_tree = root / "tree", root / "interproc"
    for d in (tree / "gen", tree / "fixtures", tree / "interproc", ip_tree):
        d.mkdir(parents=True)
    rows = codegen_rows(SCAN_FILES * SCAN_FNS_PER_FILE, seed, 0)
    for i in range(SCAN_FILES):
        chunk = rows[i * SCAN_FNS_PER_FILE:(i + 1) * SCAN_FNS_PER_FILE]
        text = "\n\n".join(r["before"] for r in chunk) + "\n"
        (tree / "gen" / f"gen_{i:03d}.c").write_text(text)
        if i < SCAN_INTERPROC_FILES:
            (ip_tree / f"gen_{i:03d}.c").write_text(text)
    for p in sorted((FIXTURES / "realworld").glob("*.c")):
        (tree / "fixtures" / p.name).write_text(p.read_text())
    cross = (FIXTURES / "interproc" / "cross_taint.c").read_text()
    (tree / "interproc" / "cross_taint.c").write_text(cross)
    (ip_tree / "cross_taint.c").write_text(cross)
    return tree, ip_tree


def golden_line_facts(cpg) -> tuple[list, list, list]:
    """``goldens.json``'s facts of one dependence-edged CPG: the
    (definition line, variable, use line) triples reaching, and the data
    and control dependence line pairs."""
    in_sets, _ = ReachingDefinitions(cpg).solve()
    line = lambda n: cpg.nodes[n].line  # noqa: E731
    reaches = sorted({(line(d.node), d.var, line(n))
                      for n, defs in in_sets.items() for d in defs
                      if line(d.node) is not None and line(n) is not None})

    def pairs(etype):
        return sorted({(line(s), line(t)) for s, t, e in cpg.edges
                       if e == etype and line(s) is not None
                       and line(t) is not None})

    return reaches, pairs("REACHING_DEF"), pairs("CDG")


def check_front_end(vocabs: dict, seed: int) -> dict:
    """Off the main path: the three solver backends against each other on
    every fixture and 64 generated functions (graphs, dependence edges,
    dataflow families), and the golden line facts of the ten fixtures."""
    if not cpg_analyses.native_available():
        fail("scan: the native dataflow solver did not build")
    sources = [p.read_text() for p in sorted((FIXTURES / "realworld")
                                             .glob("*.c"))]
    sources.append((FIXTURES / "interproc" / "cross_taint.c").read_text())
    sources += [r["before"] for r in
                codegen_rows(SCAN_CHECK_FUNCTIONS, seed + 1, 200_000)]
    n_fns, mismatches = 0, []
    for k, code in enumerate(sources):
        runs = {b: encode_source(code, vocabs, backend=b)
                for b in SOLVER_BACKENDS}
        fams = {b: [dataflow_node_features(c, backend=b)
                    for _, c in parse_functions(code)]
                for b in SOLVER_BACKENDS}
        ref = runs["native"]
        n_fns += len(ref)
        for b in SOLVER_BACKENDS:
            same = (fams[b] == fams["native"] and len(runs[b]) == len(ref))
            for x, y in zip(runs[b], ref):
                same = same and (
                    x.name == y.name and x.node_ids == y.node_ids
                    and sorted(x.cpg.edges) == sorted(y.cpg.edges)
                    and np.array_equal(x.graph.senders, y.graph.senders)
                    and np.array_equal(x.graph.receivers, y.graph.receivers)
                    and x.graph.gid == y.graph.gid
                    and list(x.graph.node_feats) == list(y.graph.node_feats)
                    and all(np.array_equal(v, y.graph.node_feats[f])
                            for f, v in x.graph.node_feats.items()))
            if not same:
                mismatches.append((k, b))
    goldens = json.loads((FIXTURES / "realworld" / "goldens.json").read_text())
    golden_fail = []
    for name, gold in sorted(goldens.items()):
        cpg = add_dependence_edges(parse_source(
            (FIXTURES / "realworld" / f"{name}.c").read_text()))
        reaches, dd, cd = golden_line_facts(cpg)
        if (reaches != [tuple(r) for r in gold["reaches"]]
                or dd != [tuple(p) for p in gold["data_dep_lines"]]
                or cd != [tuple(p) for p in gold["control_dep_lines"]]
                or len(cpg.nodes) != gold["n_nodes"]):
            golden_fail.append(name)
    return {"sources": len(sources), "functions": n_fns,
            "backends": list(SOLVER_BACKENDS), "native_built": True,
            "backend_mismatches": mismatches, "goldens": len(goldens),
            "golden_failures": golden_fail}


def band_of(probs: list[float], n: int) -> tuple[float, float]:
    """The band ``[lo, hi]`` between two quantiles of ``probs`` that holds
    ``n`` of them, the one nearest the median (ties can make a window hold
    more: the nearest that holds exactly ``n`` wins when there is one)."""
    p = sorted(probs)
    mid = max(0, len(p) // 2 - n // 2)
    starts = sorted(range(len(p) - n + 1), key=lambda k: abs(k - mid))
    for k in starts:
        lo, hi = p[k], p[k + n - 1]
        if sum(lo <= x <= hi for x in p) == n:
            return lo, hi
    return p[mid], p[mid + n - 1]


def scan_rows(report: dict) -> list[tuple]:
    """A scan's rows without their cache flag: file, function, error and
    the probability."""
    return [(r["file"], r.get("function"), r.get("error"),
             r.get("vulnerable_probability")) for r in report["results"]]


def scan_core(report: dict) -> dict:
    """A scan report without its timings: the rows, the counts, the cache
    and the pool's accounting (less its steals, which follow the
    workers' timing)."""
    out = {k: report[k] for k in ("results", "n_files", "n_functions",
                                  "n_scored", "n_errors", "cache")}
    out["pool"] = {k: v for k, v in report["pool"].items() if k != "steals"}
    return out


def timed_scan(*args, **kw) -> tuple[dict, float]:
    t0 = time.perf_counter()
    report = scan_paths(*args, **kw)
    return report, time.perf_counter() - t0


def phase_scan(ctx: dict, seed: int = 0) -> dict:
    """C source → CPG → features → graphs → scores on the card: the port's
    ``scan_paths`` over the golden model, its hierarchical scorer and the
    joint phase's 7B ``JointEngine`` as tier 2."""
    import pycparser

    vocabs, vocab_s = scan_vocabs(seed)
    front = check_front_end(vocabs, seed)
    model = golden_model("cuda")
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    engine = ScoringEngine.from_model(model, None, "graph", KEYS,
                                      max_batch=MAX_BATCH, device="cuda")
    engine.warmup()
    hier = engine.hier
    tier2 = JointEngine(ctx["llm"], ctx["fusion"], ctx["tok"], ctx["jcfg"],
                        max_batch=4, device="cuda")
    tier2.warmup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_") as tmp:
        tree, ip_tree = write_scan_trees(Path(tmp), seed)
        cache = Path(tmp) / "cache"
        kw = dict(vocabs=vocabs, engine=engine, n_workers=4)

        # the main path: counts from zero, read right after
        fg.n_launches = mb.n_launches = 0
        reset_variant_counts()
        reset_flash_counts()
        tier2.n_batches = 0
        hier.reset_counters()
        d0 = engine.n_dispatches
        cold, cold_s = timed_scan([tree], cache_dir=cache / "scan", **kw)
        # the same cold scan encoded by 4 spawned frontend processes
        proc, proc_s = timed_scan([tree], cache_dir=cache / "proc",
                                  frontend=FrontendConfig(mode="process",
                                                          workers=4), **kw)
        warm, warm_s = timed_scan([tree], cache_dir=cache / "scan", **kw)
        ip_cold, ip_cold_s = timed_scan([ip_tree], cache_dir=cache / "ip",
                                        interproc=True, **kw)
        ip_cold_stats = hier.stats()
        hier.cache = None  # the warm scan attaches a fresh handle
        h0 = (hier.n_level1_dispatches, hier.n_fallback_dispatches)
        ip_warm, ip_warm_s = timed_scan([ip_tree], cache_dir=cache / "ip",
                                        interproc=True, **kw)
        ip_warm_dispatches = hier.n_level1_dispatches - h0[0]
        ip_warm_fallback = hier.n_fallback_dispatches - h0[1]
        tier1 = [r["vulnerable_probability"] for r in cold["results"]
                 if "vulnerable_probability" in r]
        band = band_of(tier1, SCAN_BAND)
        casc, casc_s = timed_scan([tree], cache_dir=cache / "scan",
                                  tier2=tier2, tier2_band=band, **kw)
        torch.cuda.synchronize()
        b1, b4, b6 = fg.n_launches, mb.n_launches, fa.n_launches
        b1_var = dict(fg.n_variant_launches)
        b4_var = dict(mb.n_variant_launches)
        b6_var = dict(fa.n_variant_launches)
        level1 = hier.n_level1_dispatches
        tier1_calls = engine.n_dispatches - d0 - level1
        tier2_batches = tier2.n_batches

        # off the main path: the scoring's device profile on the cold
        # scan's graphs (read back from the cache), and a warm scan's
        xcache = ExtractCache(cache / "scan", salt=vocab_content_hash(vocabs))
        graphs = [fn.graph for f in sorted(tree.rglob("*.c"))
                  for fn in xcache.get(xcache.key(f.read_text()))
                  if fn.graph is not None]
        rows = [{} for _ in graphs]
        prof_score = profile_call(lambda: _score_functions(engine, rows,
                                                           graphs))
        prof_warm = profile_call(lambda: scan_paths(
            [tree], cache_dir=cache / "scan", **kw))
        # what one frontend child costs to spawn (imports, vocabularies,
        # the hash handshake) from this process
        t0 = time.perf_counter()
        encode_session_factory(vocabs, FrontendConfig(mode="process"))(
            0).close()
        spawn_s = time.perf_counter() - t0

        # the CPU engine on the same state dict, the same scans uncached
        cpu = ScoringEngine.from_model(golden_model("cpu"), state, "graph",
                                       KEYS, max_batch=MAX_BATCH,
                                       device="cpu")
        cpu_scan = scan_paths([tree], vocabs, engine=cpu, n_workers=4)
        cpu_ip = scan_paths([ip_tree], vocabs, engine=cpu, n_workers=4,
                            interproc=True)

    got, want = scan_rows(cold), scan_rows(cpu_scan)
    prob_diff = max((abs(a[3] - b[3]) for a, b in zip(got, want)
                     if a[3] is not None and b[3] is not None), default=None)
    same_rows = [a[:3] for a in got] == [b[:3] for b in want]
    unit = ip_cold["interproc"].get("unit", {})
    cpu_unit = cpu_ip["interproc"].get("unit", {})
    unit_diff = (abs(unit["unit_score"] - cpu_unit["unit_score"])
                 if "unit_score" in unit and "unit_score" in cpu_unit
                 else None)
    n_fns = cold["n_functions"]
    casc_rows = [r for r in casc["results"] if r.get("tier") == 2]
    in_band = sum(band[0] <= p <= band[1] for p in tier1)
    per1, per4 = fg.launches_per_call(STEPS), mb.launches_per_call(STEPS)
    per6 = ctx["cfg"].num_hidden_layers
    row = {
        "phase": "scan", "card": nvidia_smi(),
        "pycparser": pycparser.__version__,
        "vocab": {"functions": SCAN_VOCAB_FUNCTIONS, "seconds": vocab_s,
                  "all_vocab": len(vocabs["_ABS_DATAFLOW"].all_vocab),
                  "hash": vocab_content_hash(vocabs)},
        "front_end": front,
        "files": cold["n_files"], "functions": n_fns,
        "scored": cold["n_scored"], "errors": cold["n_errors"],
        "cold": {"wall_s": cold_s, "encode_s": cold["elapsed_s"],
                 "score_s": cold["score_s"],
                 "encode_files_per_s": cold["n_files"] / cold["elapsed_s"],
                 "encode_functions_per_s": n_fns / cold["elapsed_s"],
                 "score_functions_per_s": cold["n_scored"] / cold["score_s"],
                 "functions_per_s": n_fns / cold_s,
                 "cache": cold["cache"], "pool": cold["pool"]},
        "process": {"workers": 4, "wall_s": proc_s,
                    "encode_s": proc["elapsed_s"], "score_s": proc["score_s"],
                    "encode_functions_per_s": n_fns / proc["elapsed_s"],
                    "functions_per_s": n_fns / proc_s,
                    "thread_encode_functions_per_s":
                        n_fns / cold["elapsed_s"],
                    "spawn_s_one_child": spawn_s,
                    "equal_thread": scan_core(proc) == scan_core(cold)},
        "warm": {"wall_s": warm_s, "encode_s": warm["elapsed_s"],
                 "score_s": warm["score_s"],
                 "files_per_s": warm["n_files"] / warm_s,
                 "functions_per_s": n_fns / warm_s,
                 "cache": warm["cache"],
                 "rows_equal_cold": scan_rows(warm) == scan_rows(cold)},
        "interproc": {
            "files": ip_cold["n_files"], "functions": ip_cold["n_functions"],
            "cold_wall_s": ip_cold_s, "warm_wall_s": ip_warm_s,
            "cold_pass_s": ip_cold_s - ip_cold["elapsed_s"]
            - ip_cold["score_s"],
            "call_edges": ip_cold["interproc"]["call_edges"],
            "findings": len(ip_cold["interproc"]["findings"]),
            "unit_score": unit.get("unit_score"),
            "unit_error": unit.get("unit_error"),
            "cold_level1": ip_cold_stats,
            "warm_level1_dispatches": ip_warm_dispatches,
            "warm_fallback_dispatches": ip_warm_fallback,
            "warm_unit_score": ip_warm["interproc"].get("unit", {}).get(
                "unit_score"),
            "warm_cache": ip_warm["cache"]},
        "cascade": {"band": list(band), "scores_in_band": in_band,
                    "wall_s": casc_s, **casc["cascade"],
                    "tier2_batches": tier2_batches},
        "tier1_calls": tier1_calls, "level1_dispatches": level1,
        "b1_launches": b1, "b1_launches_by_variant": b1_var,
        "b4_launches": b4, "b4_launches_by_variant": b4_var,
        "b6_launches": b6, "b6_launches_by_variant": b6_var,
        "launches_per_call": {"b1": per1, "b4": per4, "b6": per6},
        "max_abs_prob_diff_vs_cpu": prob_diff,
        "rows_equal_cpu": same_rows,
        "unit_score_diff_vs_cpu": unit_diff, "limit": PROB_LIMIT,
        "profile_scoring": prof_score, "profile_warm_scan": prof_warm,
        "device_busy_share": prof_score["busy_share"]}
    emit(row)
    if front["backend_mismatches"] or front["golden_failures"]:
        fail(f"scan: solver backends disagree on {front['backend_mismatches']}"
             f", golden facts fail on {front['golden_failures']}")
    expected = SCAN_FILES * SCAN_FNS_PER_FILE + 12
    if cold["n_errors"] or n_fns != expected or cold["n_scored"] != n_fns:
        fail(f"scan: cold scan {n_fns} functions ({expected} expected), "
             f"{cold['n_scored']} scored, {cold['n_errors']} errors")
    check_probs("scan", np.asarray(tier1))
    if not row["process"]["equal_thread"]:
        fail("scan: the process-mode cold scan's report differs from the "
             "thread mode's")
    if (warm["cache"]["hits"] != warm["n_files"] or warm["cache"]["misses"]
            or not row["warm"]["rows_equal_cold"]
            or not all(r["cache_hit"] for r in warm["results"])):
        fail(f"scan: warm scan {warm['cache']}, rows equal "
             f"{row['warm']['rows_equal_cold']}")
    if not (same_rows and prob_diff is not None and prob_diff <= PROB_LIMIT):
        fail(f"scan: against the CPU engine: rows equal {same_rows}, "
             f"probabilities {prob_diff}")
    if (unit_diff is None or unit_diff > PROB_LIMIT
            or row["interproc"]["warm_unit_score"] != unit.get("unit_score")
            or not row["interproc"]["findings"]):
        fail(f"scan: interproc unit {unit}, CPU {cpu_unit}, warm "
             f"{row['interproc']['warm_unit_score']}")
    if ip_warm_dispatches or ip_warm_fallback or \
            ip_cold_stats["fallback_dispatches"]:
        fail(f"scan: warm interproc made {ip_warm_dispatches} level-1 "
             f"dispatches, {ip_warm_fallback} fallback ones")
    if in_band != SCAN_BAND or casc["cascade"]["n_tier2"] != in_band \
            or casc["cascade"]["n_degraded"]:
        fail(f"scan: cascade band {band} holds {in_band} scores, "
             f"{casc['cascade']} rescored")
    check_probs("scan cascade", np.asarray(
        [r["vulnerable_probability"] for r in casc_rows]))
    for name, launches, calls, per in (("B1", b1, tier1_calls, per1),
                                       ("B4", b4, level1, per4),
                                       ("B6", b6, tier2_batches, per6)):
        if launches <= 0 or launches != calls * per:
            fail(f"scan: {launches} {name} launches for {calls} calls "
                 f"(expected {per} each)")
    check_ggnn_wgmma("scan", "B1", b1_var, b1)
    check_ggnn_wgmma("scan", "B4", b4_var, b4)
    check_wgmma("scan_cascade", b6_var, b6)
    return row


# --------------------------------------------------------------- phase 17


CORPUS_FUNCTIONS = 2000
CORPUS_WORKERS = 4
CORPUS_ARGS = ["--dataset", "demo", "--n", str(CORPUS_FUNCTIONS), "--seed",
               "0", "--workers", str(CORPUS_WORKERS), "--split", "random"]
# every statement is ranked, so every saliency is compared with the CPU's
ALL_STATEMENTS = 1 << 30


def corpus_config() -> ExperimentConfig:
    """The golden model in the fused layout, trained on the ``demo`` shards
    without undersampling at 256 graphs per batch, derived buckets."""
    return dataclasses.replace(
        train_config("fused"),
        data=DataConfig(dsname="demo", split="random", undersample=None,
                        batch=BatchConfig(batch_graphs=TRAIN_GRAPHS,
                                          auto_buckets=True)))


class _Records(logging.Handler):
    """Keeps the messages logged through it."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def shard_bytes(shard_dir: Path) -> dict[str, str]:
    """sha256 of every shard file, the manifest, ``splits.json`` and
    ``vocab.json`` of a shard directory."""
    names = sorted(p.name for p in shard_dir.glob("shard_*.npz"))
    names += ["manifest.json", "splits.json", "split.txt", "vocab.json"]
    return {n: hashlib.sha256((shard_dir / n).read_bytes()).hexdigest()
            for n in names}


class SizedScorer(Scorer):
    """:class:`Scorer` that keeps the largest batch it scored."""

    max_nodes = 0

    def __call__(self, batch):
        self.max_nodes = max(self.max_nodes, batch.max_nodes)
        return super().__call__(batch)


def predict_rows(report: dict) -> list[tuple]:
    """A predict report's rows: file, function, error, probability and the
    ranked (line, weight) pairs."""
    return [(r["file"], r.get("function"), r.get("error"),
             r.get("vulnerable_probability"),
             [(s["line"], s["weight"]) for s in r.get("top_statements", [])])
            for r in report["results"]]


def compare_predictions(got: dict, want: dict) -> dict:
    """The largest probability and saliency differences of two reports over
    the same files (saliencies by rank: the k-th largest of one against the
    k-th largest of the other), and whether their rows line up."""
    a, b = predict_rows(got), predict_rows(want)
    same_rows = ([r[:3] for r in a] == [r[:3] for r in b]
                 and all(len(x[4]) == len(y[4]) for x, y in zip(a, b)))
    prob = max((abs(x[3] - y[3]) for x, y in zip(a, b)
                if x[3] is not None and y[3] is not None), default=None)
    sal = max((abs(s[1] - t[1]) for x, y in zip(a, b)
               for s, t in zip(x[4], y[4])), default=None)
    return {"rows_equal": same_rows, "max_abs_prob_diff": prob,
            "max_abs_saliency_diff": sal}


def localization(report: dict, labels: dict, vul_ids: set) -> dict:
    """Top-1 localization over the vulnerable test functions: the share
    whose highest-ranked statement is on one of its labeled lines (removed
    or dependent-added)."""
    hits = total = 0
    for r in report["results"]:
        fid = Path(r["file"]).stem
        if "error" in r or not fid.isdigit() or int(fid) not in vul_ids:
            continue
        lab = labels.get(int(fid), {})
        lines = set(lab.get("removed", [])) | set(lab.get("depadd", []))
        total += 1
        hits += bool(r["top_statements"]) and \
            r["top_statements"][0]["line"] in lines
    return {"functions": total, "top1_hits": hits,
            "top1_rate": hits / total if total else None}


def fit_on_shards(cfg: ExperimentConfig, run_dir: Path) -> tuple[dict, dict]:
    """``fit`` on the card with every count from zero, read right after,
    then (off the main path) the profile of one step on its largest
    bucket. Returns the row (the ``corpus:`` log line, the graphs per split
    ``load_corpus`` reads, the launch counts by variant, the timing) and
    the corpus."""
    records = _Records()
    port_logger = logging.getLogger("deepdfa_tpu_torch")
    port_logger.addHandler(records)
    level = port_logger.level
    port_logger.setLevel(logging.INFO)
    fg.n_launches = fg.n_bwd_launches = mb.n_launches = 0
    reset_variant_counts()
    try:
        t0 = time.perf_counter()
        final = fit(cfg, run_dir, device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        port_logger.removeHandler(records)
        port_logger.setLevel(level)
    b1, b2 = fg.n_launches, fg.n_bwd_launches
    by_variant = {"fwd": dict(fg.n_variant_launches),
                  "bwd": dict(fg.n_bwd_variant_launches)}
    timing = json.loads((run_dir / "journal.json").read_text())["timing"]
    steps, evals = timing["train_steps"], timing["eval_batches"]
    per1, per2 = fg.launches_per_call(STEPS), fg.bwd_launches_per_call(STEPS)
    corpus = load_corpus(cfg)
    train = corpus["train"]
    pw = positive_weight(np.array([int(g.node_feats["_VULN"].max())
                                   for g in train]))
    bucket = derive_buckets(train + corpus["val"], TRAIN_GRAPHS)[-1]
    step_profile = profile_train_step(cfg, pack(train, bucket), pw)
    return {
        "corpus_logged": next((m for m in records.messages
                               if m.startswith("corpus:")), ""),
        "per_split": {k: len(v) for k, v in corpus.items()},
        "epochs": cfg.optim.max_epochs, "train_steps": steps,
        "eval_batches": evals, "train_seconds": timing["train_seconds"],
        "steps_per_s": steps / timing["train_seconds"],
        "graphs_per_s": len(train) * cfg.optim.max_epochs
        / timing["train_seconds"],
        "p50_step_ms": float(np.percentile(timing["step_ms"], 50)),
        "fit_seconds": fit_s, "final_metrics": final,
        "b1_launches": b1, "b2_launches": b2,
        "expected_launches": {"fwd": (steps + evals) * per1,
                              "bwd": steps * per2},
        "launches_by_variant": by_variant,
        "profile_train_step": step_profile,
        "device_busy_share": step_profile["busy_share"]}, corpus


def check_fit(name: str, run: dict, splits: dict) -> None:
    """Fail unless ``fit`` read every split as ``splits.json`` lists it,
    made calls × launches per call of B1 and B2, all on ``wgmma``, and
    ended with finite metrics."""
    want = {k: len(v) for k, v in splits.items()}
    logged = f"corpus: train={want['train']} val={want['val']} " \
             f"test={want['test']}"
    if run["per_split"] != want or \
            not run["corpus_logged"].startswith(logged):
        fail(f"{name}: fit read {run['corpus_logged']!r} / "
             f"{run['per_split']}, splits.json holds {want}")
    if not all(np.isfinite(v) for v in run["final_metrics"].values()):
        fail(f"{name}: non-finite final metrics {run['final_metrics']}")
    got = {"fwd": run["b1_launches"], "bwd": run["b2_launches"]}
    if got != run["expected_launches"] or not run["train_steps"]:
        fail(f"{name}: fit launches B1 {got['fwd']}, B2 {got['bwd']}, "
             f"expected {run['expected_launches']} for "
             f"{run['train_steps']} steps and {run['eval_batches']} eval "
             f"batches")
    check_ggnn_wgmma(name, "B1", run["launches_by_variant"]["fwd"],
                     run["b1_launches"])
    check_ggnn_wgmma(name, "B2", run["launches_by_variant"]["bwd"],
                     run["b2_launches"])


def phase_corpus(work: Path) -> dict:
    """C source → shards → ``fit`` on the card → ``predict_paths`` with
    ranked statements on the card, through the port's own entry points.
    The run (``work/run``) and the test split's sources
    (``work/test_sources``) stay for the serve_http phase."""
    out_dir = port_utils.processed_dir() / "demo" / "shards"

    # build, then rebuild into a fresh directory with the cache warm
    t0 = time.perf_counter()
    first = preprocess.main(CORPUS_ARGS)
    build_s = time.perf_counter() - t0
    first_bytes = shard_bytes(out_dir)
    out_dir.rename(out_dir.with_name("shards_first"))
    t0 = time.perf_counter()
    again = preprocess.main(CORPUS_ARGS)
    rebuild_s = time.perf_counter() - t0
    again_bytes = shard_bytes(out_dir)
    splits = json.loads((out_dir / "splits.json").read_text())
    labels = pickle.loads(next(out_dir.glob("statement_labels_*.pkl"))
                          .read_bytes())

    # fit on the shards: counts from zero, read right after
    cfg = corpus_config()
    run, _ = fit_on_shards(cfg, work / "run")

    # predict with the restored best checkpoint over the test split's
    # sources and the realworld fixtures
    ckpts = CheckpointManager(work / "run" / "checkpoints", cfg.checkpoint)
    best = ckpts.best_step()
    state = ckpts.restore(best, map_location="cpu")
    rows = {r["id"]: r for r in demo_corpus(CORPUS_FUNCTIONS, seed=0)}
    src = work / "test_sources"
    src.mkdir()
    for fid in splits["test"]:
        (src / f"{fid}.c").write_text(rows[fid]["before"])
    paths = [src, FIXTURES / "realworld"]
    vocabs = load_vocabs(out_dir)
    model = make_model(cfg.model, cfg.input_dim, device="cuda")
    model.load_state_dict(state)
    scorer = SizedScorer(model)
    fg.n_launches = 0
    reset_variant_counts()
    t0 = time.perf_counter()
    report = predict_paths(paths, cfg=cfg, model=model, vocabs=vocabs,
                           top_k=ALL_STATEMENTS, scorer=scorer)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    pred_b1, pred_var = fg.n_launches, dict(fg.n_variant_launches)
    n_files = len(collect_sources(paths))
    gate = predict_paths(paths, cfg=cfg, model=model, vocabs=vocabs,
                         top_k=ALL_STATEMENTS, saliency="gate")

    # off the main path: the same model and weights on the CPU (plain
    # B1), and the device profile of predict over the fixtures
    cpu_model = make_model(cfg.model, cfg.input_dim, device="cpu")
    cpu_model.load_state_dict(state)
    cpu = predict_paths(paths, cfg=cfg, model=cpu_model, vocabs=vocabs,
                        top_k=ALL_STATEMENTS)
    cpu_gate = predict_paths(paths, cfg=cfg, model=cpu_model,
                             vocabs=vocabs, top_k=ALL_STATEMENTS,
                             saliency="gate")
    prof = profile_call(lambda: predict_paths(
        [FIXTURES / "realworld"], cfg=cfg, model=model, vocabs=vocabs))

    vs_cpu = compare_predictions(report, cpu)
    gate_vs_cpu = compare_predictions(gate, cpu_gate)
    statements = sum(len(r.get("top_statements", []))
                     for r in report["results"])
    vul_test = {fid for fid in splits["test"] if rows[fid]["vul"] == 1}
    loc = localization(report, labels, vul_test)
    per1 = fg.launches_per_call(STEPS)
    seconds = first["seconds"]
    row = {
        "phase": "corpus", "card": nvidia_smi(),
        "build": {"functions": first["functions"], "graphs": first["graphs"],
                  "shards": first["shards"], "vul_graphs": first["vul_graphs"],
                  "failed": first["failed"], "wall_s": build_s,
                  "seconds": seconds,
                  "functions_per_s": {k: first["functions"] / v
                                      for k, v in seconds.items()},
                  "extraction": first["extraction"]},
        "rebuild": {"wall_s": rebuild_s, "seconds": again["seconds"],
                    "extraction": again["extraction"],
                    "identical": first_bytes == again_bytes,
                    "files": len(first_bytes)},
        "splits": {k: len(v) for k, v in splits.items()},
        "fit": run,
        "predict": {"files": n_files,
                    "functions": report["n_scored"] + report["n_errors"],
                    "scored": report["n_scored"], "errors": report["n_errors"],
                    "statements": statements, "wall_s": predict_s,
                    "functions_per_s": report["n_scored"] / predict_s,
                    "statements_per_s": statements / predict_s,
                    "scorer_calls": scorer.n_calls,
                    "largest_batch_nodes": scorer.max_nodes,
                    "b1_launches": pred_b1,
                    "b1_launches_by_variant": pred_var,
                    "vs_cpu": vs_cpu, "gate_vs_cpu": gate_vs_cpu,
                    "limit": PROB_LIMIT, "localization": loc,
                    "profile_fixtures": prof,
                    "device_busy_share": prof["busy_share"]}}
    emit(row)
    if not row["rebuild"]["identical"] or \
            again["extraction"]["cache_hits"] != CORPUS_FUNCTIONS:
        fail(f"corpus: the rebuild differs ({row['rebuild']}) or missed the "
             f"cache")
    if first["failed"] or first["graphs"] != CORPUS_FUNCTIONS:
        fail(f"corpus: {first['failed']} failures, {first['graphs']} graphs "
             f"of {CORPUS_FUNCTIONS}")
    check_fit("corpus_fit", run, splits)
    n_fixture_fns = sum(len(parse_functions(p.read_text())) for p in
                        sorted((FIXTURES / "realworld").glob("*.c")))
    if report["n_errors"] or report["n_scored"] != len(splits["test"]) + \
            n_fixture_fns:
        fail(f"corpus: predict scored {report['n_scored']}, "
             f"{report['n_errors']} errors")
    check_probs("corpus predict", np.asarray(
        [r["vulnerable_probability"] for r in report["results"]]))
    for name, cmp in (("occlusion", vs_cpu), ("gate", gate_vs_cpu)):
        if not (cmp["rows_equal"] and cmp["max_abs_prob_diff"] <= PROB_LIMIT
                and cmp["max_abs_saliency_diff"] <= PROB_LIMIT):
            fail(f"corpus: predict ({name}) against the CPU: {cmp}")
    if pred_b1 <= 0 or pred_b1 != scorer.n_calls * per1:
        fail(f"corpus: predict made {pred_b1} B1 launches for "
             f"{scorer.n_calls} scorer calls (expected {per1} each)")
    check_ggnn_wgmma("predict", "B1", pred_var, pred_b1)
    return row


# ------------------------------------------------------------ serve_http


REPO_ROOT = Path(__file__).resolve().parent
SERVE_HTTP_CLIENTS = 16
SERVE_HTTP_BAND = 64
SERVE_HTTP_WORKERS = 4
SERVE_HTTP_DRAIN = 64
# /healthz's keys in the JAX package's server (deepdfa_tpu/serve/server.py)
HEALTHZ_KEYS = {"status", "draining", "replica_id", "warm", "warm_buckets",
                "vocab_hash", "model_rev", "precision", "n_replicas",
                "label_style", "cascade", "tier2_model_rev", "frontend",
                "frontend_queue_wait_p99_ms", "admission", "brownout_level",
                "brownout"}
SERVE_FAMILIES = ("requests_total", "responses_total", "batches_total",
                  "batch_occupancy_mean", "queue_depth", "latency_ms",
                  "queue_wait_ms", "dispatch_ms", "padding_efficiency",
                  "cache_hits_total", "cache_hit_rate",
                  "frontend_queue_depth", "frontend_encode_ms",
                  "frontend_inline_total", "score_drift", "score",
                  "trace_spans_total", "obs_dropped_total",
                  "warmup_compile_seconds")
CASCADE_FAMILIES = ("cascade_escalated_total", "cascade_degraded_total",
                    "cascade_answered_total", "tier2_queue_depth",
                    "tier1_latency_ms", "tier2_latency_ms",
                    "tier2_queue_wait_ms", "tier2_dispatch_ms")
SLO_NAMES = ("availability", "error_rate", "latency_p99", "score_drift",
             "tier2_latency_p99", "tier2_success")


def http_call(port: int, method: str, path: str, payload=None,
              timeout: float = 300.0) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def http_pass(port: int, sources: list[str],
              clients: int = SERVE_HTTP_CLIENTS):
    """Closed-loop HTTP clients: each posts its share of ``sources`` to
    ``/score`` one at a time. Returns the (status, body) answers in source
    order, each request's seconds and the pass's wall seconds."""
    answers: list = [None] * len(sources)
    lat = np.zeros(len(sources))

    def client(k):
        for i in range(k, len(sources), clients):
            t0 = time.perf_counter()
            try:
                status, data = http_call(port, "POST", "/score",
                                         {"source": sources[i]})
                answers[i] = (status, json.loads(data))
            except OSError as exc:
                answers[i] = (None, {"error": repr(exc)})
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, lat, time.perf_counter() - t0


def raw_scores(engine, graphs: list) -> list[float]:
    """``engine``'s unrounded probability of every graph, the graphs
    grouped by serve bucket."""
    by_bucket: dict = {}
    for i, g in enumerate(graphs):
        by_bucket.setdefault(engine.assign_bucket(g), []).append(i)
    out = [0.0] * len(graphs)
    for bucket, idx in by_bucket.items():
        cap = max(int(bucket.capacity), 1)
        for k in range(0, len(idx), cap):
            chunk = idx[k:k + cap]
            for i, p in zip(chunk, engine.score([graphs[i] for i in chunk],
                                                bucket)):
                out[i] = float(p)
    return out


def pass_row(answers, lat, wall: float, n_functions: int) -> dict:
    return {"requests": len(answers), "wall_s": wall,
            "requests_per_s": len(answers) / wall,
            "functions_per_s": n_functions / wall,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "status": sorted({a[0] for a in answers if a is not None},
                             key=str),
            "errors": [a[1].get("error") for a in answers
                       if a is not None and a[0] != 200][:3]}


def families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def read_json_line(stream, status: str, timeout: float) -> dict:
    """The first line of ``stream`` that parses as a JSON object with this
    ``status``, read on a thread so a silent child cannot hang the smoke."""
    found: dict = {}

    def reader():
        for line in stream:
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and obj.get("status") == status:
                found.update(obj)
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    return found


def serve_entry_point(args: list[str], sources: list[str],
                      want: list[list[float | None]], log: Path) -> dict:
    """``python -m deepdfa_tpu_torch.serve.server`` with ``args`` (a run
    dir or an artifact, the shard dir): the ``serving`` line, 8 requests,
    SIGTERM, the ``drained`` line, rc 0."""
    cmd = [sys.executable, "-m", "deepdfa_tpu_torch.serve.server", *args,
           "--set", "serve.port=0"]
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        try:
            serving = read_json_line(proc.stdout, "serving", 300)
            start_s = time.perf_counter() - t0
            answers = []
            if serving:
                answers = [(lambda r: (r[0], json.loads(r[1])))(
                    http_call(serving["port"], "POST", "/score",
                              {"source": src})) for src in sources[:8]]
            proc.send_signal(signal.SIGTERM)
            drained = read_json_line(proc.stdout, "drained", 120)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    diff = max((abs(r["vulnerable_probability"] - w)
                for (status, body), ws in zip(answers, want)
                if status == 200
                for r, w in zip(body["results"], ws) if w is not None),
               default=None)
    return {"cmd": " ".join(cmd[1:]), "start_s": start_s,
            "serving": bool(serving), "buckets_warmed":
                serving.get("buckets_warmed"),
            "warm_store": serving.get("warm_store"),
            "answers": [a[0] for a in answers], "drained": drained,
            "rc": rc, "max_abs_prob_diff_vs_engine": diff,
            "log_tail": log.read_text()[-400:] if rc else ""}


def drain_on_sigterm(server, sources: list[str]) -> dict:
    """SIGTERM with requests in flight: clients post cold sources until
    refused; every answer that is not a drain refusal must be a 200, and
    the listener must be closed afterwards."""
    results: list = [None] * len(sources)
    inflight_at_signal = 0

    def client(k):
        for i in range(k, len(sources), SERVE_HTTP_CLIENTS):
            try:
                status, data = http_call(server.port, "POST", "/score",
                                         {"source": sources[i]})
                results[i] = (status, json.loads(data).get("error", ""))
            except OSError as exc:
                results[i] = ("refused", repr(exc))

    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    server.install_signal_handlers()
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_HTTP_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while server.metrics.inflight < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        inflight_at_signal = server.metrics.inflight
        t0 = time.perf_counter()
        signal.raise_signal(signal.SIGTERM)
        summary = server.wait()
        drain_s = time.perf_counter() - t0
        for t in threads:
            t.join()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    try:
        http_call(server.port, "GET", "/healthz", timeout=2)
        closed = False
    except OSError:
        closed = True
    codes = [r[0] for r in results]
    refused = [r for r in results
               if r[0] == "refused" or (r[0] == 503 and "draining" in r[1])]
    admitted = [r for r in results if r not in refused]
    return {"requests": len(sources), "inflight_at_signal":
                inflight_at_signal, "drain_s": drain_s,
            "answered_200": codes.count(200), "refused": len(refused),
            "admitted_not_200": [r for r in admitted if r[0] != 200],
            "listener_closed": closed,
            "requests_total": summary.get("requests_total")}


def phase_serve_http(ctx: dict, work: Path) -> dict:
    """The HTTP service on the card: the corpus phase's fit run restored
    by ``build_server`` (tier 1, B1) with the joint phase's 7B
    ``JointEngine`` as the cascade's tier 2 (B6), a process-mode frontend
    pool, 16 closed-loop clients; SIGTERM with requests in flight; the
    ``serve.server`` and ``scan`` entry points as subprocesses."""
    shard_dir = port_utils.processed_dir() / "demo" / "shards"
    run_dir = work / "run"
    vocabs = load_vocabs(shard_dir)
    sources = [p.read_text() for p in sorted((work / "test_sources")
                                             .glob("*.c"))]
    sources += [p.read_text() for p in sorted((FIXTURES / "realworld")
                                              .glob("*.c"))]
    cfg = corpus_config()

    # off the main path: every function's tier-1 score by an engine
    # restored from the same checkpoint, and the band that holds 64 of them
    ref = ScoringEngine.from_checkpoint(cfg, run_dir / "checkpoints", vocabs,
                                        device="cuda")
    encoded = [encode_source(src, vocabs) for src in sources]
    graphs = [fn.graph for enc in encoded for fn in enc
              if fn.graph is not None]
    raw = raw_scores(ref, graphs)  # the server bands on unrounded scores
    ref_probs = [round(p, 6) for p in raw]
    band = band_of(raw, SERVE_HTTP_BAND)
    n_fns = sum(len(enc) for enc in encoded)

    cfg = dataclasses.replace(cfg, serve=ServeConfig(
        port=0, max_batch=MAX_BATCH, max_queue=1024,
        frontend=FrontendConfig(mode="process", workers=SERVE_HTTP_WORKERS),
        cascade=CascadeConfig(enabled=True, band_lo=band[0], band_hi=band[1],
                              tier2_max_batch=4, tier2_max_queue=1024,
                              tier2_deadline_ms=120_000.0)))
    tier2 = JointEngine(ctx["llm"], ctx["fusion"], ctx["tok"], ctx["jcfg"],
                        max_batch=4, device="cuda")
    t0 = time.perf_counter()
    server = build_server(cfg, run_dir=run_dir, shard_dir=shard_dir,
                          tier2_engine=tier2)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.warmup()
    warmup_s = time.perf_counter() - t0
    server.start()
    port = server.port

    # the main path: counts from zero, read right after
    fg.n_launches = 0
    reset_variant_counts()
    reset_flash_counts()
    tier2.n_batches = 0
    d0 = server.engine.n_dispatches
    cold, cold_lat, cold_wall = http_pass(port, sources)
    snap_cold = server.metrics.snapshot()
    warm, warm_lat, warm_wall = http_pass(port, sources)
    torch.cuda.synchronize()
    b1, b1_var = fg.n_launches, dict(fg.n_variant_launches)
    b6, b6_var = fa.n_launches, dict(fa.n_variant_launches)
    tier1_calls = server.engine.n_dispatches - d0
    tier2_batches = tier2.n_batches
    snap = server.metrics.snapshot()
    pool = server.frontend.report()
    intervals = server.frontend.encode_intervals()
    cache = server.cache.stats()
    _, metrics_text = http_call(port, "GET", "/metrics")
    _, slo_text = http_call(port, "GET", "/slo")
    _, health = http_call(port, "GET", "/healthz")
    metrics_text, slo_text = metrics_text.decode(), slo_text.decode()
    health = json.loads(health)

    # off the main path: the answers against the engines, tier 2 against
    # JointEngine.score on each escalated function, a profiled cold pass
    rows = [r for status, body in cold if status == 200
            for r in body["results"]]
    scored = [r for r in rows if "tier1_score" in r]
    tier1_diff = max((abs(r["tier1_score"] - p)
                      for r, p in zip(scored, ref_probs)), default=None)
    cpu = ScoringEngine.from_checkpoint(cfg, run_dir / "checkpoints", vocabs,
                                        device="cpu")
    cpu_diff = max((abs(r["tier1_score"] - c) for r, c in
                    zip(scored, raw_scores(cpu, graphs))), default=None)
    items, served2 = [], []
    for src, enc, (status, body) in zip(sources, encoded, cold):
        for fn, r in zip(enc, body.get("results", [])):
            if fn.graph is not None and r.get("tier") == 2:
                items.append((src, fn.graph))
                served2.append(r["vulnerable_probability"])
    direct2 = tier2.score(items) if items else np.zeros(0)
    tier2_diff = float(np.abs(np.round(direct2, 6)
                              - np.asarray(served2)).max()) if items else None
    server.cache = ScanCache(cfg.serve.cache_entries)  # cold once more
    prof = profile_call(lambda: http_pass(port, sources))
    drained = drain_on_sigterm(
        server, [src + f"\n// drain {i}\n"
                 for i, src in enumerate(sources[:SERVE_HTTP_DRAIN])])

    # the entry points, each in a process of its own
    want8, j = [], 0
    for enc in encoded[:8]:
        want8.append([])
        for fn in enc:
            if fn.graph is None:
                want8[-1].append(None)
            else:
                want8[-1].append(ref_probs[j])
                j += 1
    entry = serve_entry_point(
        ["--run-dir", str(run_dir), "--shard-dir", str(shard_dir)], sources,
        want8, work / "serve_entry.log")
    scan_cli = scan_entry_point(cfg, run_dir, shard_dir, vocabs, work)

    encode_busy_s = sum(b - a for a, b in intervals)
    n_cold_fns = sum(len(body.get("results", [])) for _, body in cold)
    per1 = fg.launches_per_call(STEPS)
    per6 = ctx["cfg"].num_hidden_layers
    row = {
        "phase": "serve_http", "card": nvidia_smi(),
        "model": "golden GGNN (hidden 32 x 4, 5 rounds, 3 head layers) "
                 "from the corpus fit; tier 2 codellama_7b(flash) bf16",
        "sources": len(sources), "functions": n_fns,
        "band": list(band), "scores_in_band": sum(
            band[0] <= p <= band[1] for p in raw),
        "build_s": build_s, "warmup_s": warmup_s,
        "frontend": {"mode": "process", "workers": SERVE_HTTP_WORKERS,
                     "spawn_s": pool["spawn_seconds"],
                     "encoded": pool["encoded"], "steals": pool["steals"],
                     "encode_busy_s": encode_busy_s,
                     "encode_functions_per_worker_s":
                         n_cold_fns / encode_busy_s if encode_busy_s else None,
                     "encode_functions_per_s_cold_wall":
                         n_cold_fns / cold_wall,
                     "inline_total": snap["frontend_inline_total"]},
        "cold": pass_row(cold, cold_lat, cold_wall, n_cold_fns),
        "warm": pass_row(warm, warm_lat, warm_wall, n_cold_fns),
        "tier1_latency_p50_ms": snap_cold["tier1_latency_p50_ms"],
        "tier2_latency_p50_ms": snap_cold["tier2_latency_p50_ms"],
        "tier2_latency_p99_ms": snap_cold["tier2_latency_p99_ms"],
        "escalations": snap["cascade_escalated_total"],
        "tier2_answers": snap["cascade_answered"].get(2, 0),
        "tier1_answers": snap["cascade_answered"].get(1, 0),
        "degradations": snap["cascade_degraded_total"],
        "cache": cache, "mean_batch_occupancy": snap["mean_batch_occupancy"],
        "tier1_calls": tier1_calls, "tier2_batches": tier2_batches,
        "b1_launches": b1, "b1_launches_by_variant": b1_var,
        "b6_launches": b6, "b6_launches_by_variant": b6_var,
        "launches_per_call": {"b1": per1, "b6": per6},
        "max_abs_tier1_diff_vs_engine": tier1_diff,
        "max_abs_tier1_diff_vs_cpu": cpu_diff,
        "max_abs_tier2_diff_vs_joint_engine": tier2_diff,
        "tier2_limit": JOINT_PROB_LIMIT,
        "healthz": health, "metrics_families": len(families(metrics_text)),
        "profile_cold_pass": {k: prof[k] for k in ("wall_us", "device_us",
                                                   "busy_share",
                                                   "top_kernels_us")},
        "device_busy_share": prof["busy_share"],
        "sigterm": drained, "entry_point": entry, "scan_cli": scan_cli}
    emit(row)
    if any(a[0] != 200 or a[1]["cached"] for a in cold) or any(
            a[0] != 200 or not a[1]["cached"] for a in warm):
        fail(f"serve_http: cold {row['cold']['status']}, warm "
             f"{row['warm']['status']}, or a warm miss")
    if [a[1]["results"] for a in warm] != [a[1]["results"] for a in cold]:
        fail("serve_http: the warm pass answers differ from the cold one")
    if len(scored) != len(ref_probs) or tier1_diff is None or \
            tier1_diff > 1e-6 or cpu_diff is None or cpu_diff > PROB_LIMIT:
        fail(f"serve_http: tier 1 against the engine {tier1_diff}, the CPU "
             f"{cpu_diff} ({len(scored)} rows, {len(ref_probs)} scores)")
    check_probs("serve_http tier 2", np.asarray(served2))
    if not items or tier2_diff > JOINT_PROB_LIMIT:
        fail(f"serve_http: tier 2 against JointEngine.score {tier2_diff}")
    if (row["scores_in_band"] != SERVE_HTTP_BAND
            or row["escalations"] != SERVE_HTTP_BAND
            or row["tier2_answers"] != SERVE_HTTP_BAND
            or row["degradations"] != 0 or snap["frontend_inline_total"]):
        fail(f"serve_http: band holds {row['scores_in_band']}, "
             f"{row['escalations']} escalated, {row['tier2_answers']} "
             f"answered by tier 2, {row['degradations']} degraded, "
             f"{snap['frontend_inline_total']} encoded inline")
    missing = [f for f in SERVE_FAMILIES + CASCADE_FAMILIES
               if f"deepdfa_serve_{f}" not in families(metrics_text)]
    missing += [n for n in SLO_NAMES if f'slo="{n}"' not in slo_text]
    if missing or set(health) != HEALTHZ_KEYS:
        fail(f"serve_http: /metrics or /slo lack {missing}; /healthz keys "
             f"{sorted(set(health) ^ HEALTHZ_KEYS)} differ")
    for name, launches, calls, per in (("B1", b1, tier1_calls, per1),
                                       ("B6", b6, tier2_batches, per6)):
        if launches <= 0 or launches != calls * per:
            fail(f"serve_http: {launches} {name} launches for {calls} calls "
                 f"(expected {per} each)")
    check_ggnn_wgmma("serve_http", "B1", b1_var, b1)
    check_wgmma("serve_http", b6_var, b6)
    if (drained["admitted_not_200"] or not drained["answered_200"]
            or not drained["listener_closed"]
            or drained["inflight_at_signal"] < 1):
        fail(f"serve_http: SIGTERM drain {drained}")
    if not (entry["serving"] and entry["answers"] == [200] * 8
            and entry["drained"] and entry["rc"] == 0
            and entry["max_abs_prob_diff_vs_engine"] is not None
            and entry["max_abs_prob_diff_vs_engine"] <= 1e-6):
        fail(f"serve_http: the serve.server entry point {entry}")
    if not scan_cli["rows_equal"] or scan_cli["rc"] != 0 or \
            not scan_cli["unit_equal"]:
        fail(f"serve_http: the scan entry point {scan_cli}")
    for name, launches, calls, per in (
            ("B1", scan_cli["b1_launches"], scan_cli["tier1_calls"], per1),
            ("B4", scan_cli["b4_launches"], scan_cli["level1_dispatches"],
             mb.launches_per_call(STEPS))):
        if launches <= 0 or launches != calls * per:
            fail(f"serve_http scan: {launches} {name} launches for {calls} "
                 f"calls (expected {per} each)")
    check_ggnn_wgmma("serve_http scan", "B1",
                     scan_cli["b1_launches_by_variant"],
                     scan_cli["b1_launches"])
    check_ggnn_wgmma("serve_http scan", "B4",
                     scan_cli["b4_launches_by_variant"],
                     scan_cli["b4_launches"])
    return row


def scan_entry_point(cfg: ExperimentConfig, run_dir: Path, shard_dir: Path,
                     vocabs: dict, work: Path) -> dict:
    """``python -m deepdfa_tpu_torch.scan <dir> --interproc`` on the
    corpus run against ``scan_paths`` in this process on an engine restored
    the same way (B1 and B4 counted here)."""
    tree = work / "scan_tree"
    tree.mkdir()
    for p in sorted((FIXTURES / "realworld").glob("*.c")):
        shutil.copy(p, tree / p.name)
    shutil.copy(FIXTURES / "interproc" / "cross_taint.c",
                tree / "cross_taint.c")
    out = work / "scan_run"
    cmd = [sys.executable, "-m", "deepdfa_tpu_torch.scan", str(tree),
           "--run-dir", str(out), "--ckpt-dir", str(run_dir / "checkpoints"),
           "--shard-dir", str(shard_dir), "--interproc"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    cli = (json.loads((out / "scan.json").read_text())
           if proc.returncode == 0 else {"results": [], "interproc": {}})

    engine = ScoringEngine.from_checkpoint(cfg, run_dir / "checkpoints",
                                           vocabs, device="cuda")
    engine.warmup()
    hier = engine.hier
    fg.n_launches = mb.n_launches = 0
    reset_variant_counts()
    hier.reset_counters()
    d0 = engine.n_dispatches
    local = scan_paths([tree], vocabs, engine=engine, n_workers=4,
                       interproc=True)
    torch.cuda.synchronize()
    level1 = hier.n_level1_dispatches
    unit = local["interproc"].get("unit", {})
    cli_unit = cli["interproc"].get("unit", {})
    return {"cmd": " ".join(cmd[1:]), "rc": proc.returncode,
            "seconds": cli_s, "functions": local["n_functions"],
            "rows_equal": scan_rows(cli) == scan_rows(local),
            "unit_score": unit.get("unit_score"),
            "unit_equal": ("unit_score" in unit
                           and cli_unit.get("unit_score")
                           == unit["unit_score"]),
            "findings": len(local["interproc"]["findings"]),
            "tier1_calls": engine.n_dispatches - d0 - level1,
            "level1_dispatches": level1,
            "b1_launches": fg.n_launches,
            "b1_launches_by_variant": dict(fg.n_variant_launches),
            "b4_launches": mb.n_launches,
            "b4_launches_by_variant": dict(mb.n_variant_launches),
            "stderr_tail": proc.stderr[-400:] if proc.returncode else ""}


# ----------------------------------------------------------- artifact


ARTIFACT_LIMIT = 1e-6  # artifact against checkpoint: one card, two shapes


def program_ops(program) -> dict:
    """Which of the registered ops an exported program calls, and whether
    it calls ``index_add`` (float atomics on the card)."""
    ops = exported_ops(program)
    return {"fused_ggnn": "deepdfa.fused_ggnn.default" in ops,
            "segment_sum": "deepdfa.segment_sum.default" in ops,
            "int8_matmul": "deepdfa.int8_matmul.default" in ops,
            "index_add": any("index_add" in op for op in ops),
            "n_nodes": len(program.graph.nodes)}


def timed_scores(engine, graphs: list) -> tuple[list[float], float, int]:
    """``raw_scores`` with its wall seconds and the engine's dispatches."""
    d0 = engine.n_dispatches
    t0 = time.perf_counter()
    out = raw_scores(engine, graphs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, engine.n_dispatches - d0


def warm_pair(make_engine, store: WarmStore, graphs: list, kernel) -> dict:
    """Two engines from ``make_engine`` (one set of weights) join through
    ``store``: the first misses and exports every bucket, the second loads
    them. The second's scoring is the main path: ``kernel``'s count (B1's
    module or B5's) from zero, read right after."""
    reps, engines = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        eng = make_engine()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = eng.warmup(warm_store=store)
        reps.append({**rep, "build_s": build_s,
                     "warmup_s": time.perf_counter() - t0})
        engines.append(eng)
    a, b = engines
    want = raw_scores(a, graphs)
    kernel.n_launches = 0
    for k in kernel.n_variant_launches:
        kernel.n_variant_launches[k] = 0
    got, wall, dispatches = timed_scores(b, graphs)
    launches, by_variant = kernel.n_launches, dict(kernel.n_variant_launches)
    return {"precision": [a.precision, b.precision],
            "model_rev": [a.model_rev, b.model_rev],
            "first": reps[0], "joiner": reps[1],
            "entries": store.stats()["entries"],
            "joiner_dispatches": dispatches, "joiner_wall_s": wall,
            "joiner_functions_per_s": len(graphs) / wall,
            "launches": launches, "launches_by_variant": by_variant,
            "bitwise_equal": got == want, "scores": got}


def phase_artifact(work: Path) -> dict:
    """Exported artifacts and the warm store on the card, on the corpus
    phase's fit run: ``export_model`` on the card at the config's ceiling
    shapes and the same state exported on the CPU, both programs read,
    both artifacts scored on the card by ``from_artifact`` (the CPU one on
    the CPU too); two f32 and two int8 engines joining through one warm
    store; the ``serve.server --artifact``, ``serve.server`` with
    ``serve.warm_store_dir`` and ``scan --artifact`` entry points as
    subprocesses."""
    shard_dir = port_utils.processed_dir() / "demo" / "shards"
    run_dir = work / "run"
    ckpt_dir = run_dir / "checkpoints"
    vocabs = load_vocabs(shard_dir)
    cfg = corpus_config()
    sources = [p.read_text() for p in sorted((work / "test_sources")
                                             .glob("*.c"))]
    sources += [p.read_text() for p in sorted((FIXTURES / "realworld")
                                              .glob("*.c"))]
    encoded = [encode_source(src, vocabs) for src in sources]
    graphs = [fn.graph for enc in encoded for fn in enc
              if fn.graph is not None]

    # export on the card through the CLI's function, and the same state on
    # the CPU
    t0 = time.perf_counter()
    exported = export_model(cfg, run_dir, shard_dir=shard_dir,
                            device="cuda")
    export_s = time.perf_counter() - t0
    card_dir = Path(exported["export_dir"])
    ckpts = CheckpointManager(ckpt_dir, cfg.checkpoint)
    state = ckpts.restore(ckpts.best_step(), map_location="cpu")
    t0 = time.perf_counter()
    cpu_dir = export_ggnn(cfg, state, work / "export_cpu", device="cpu",
                          vocab_hash=vocab_content_hash(vocabs))
    export_cpu_s = time.perf_counter() - t0
    programs = {}
    for name, d in (("card", card_dir), ("cpu", cpu_dir)):
        t0 = time.perf_counter()
        sv = load_exported(d, device="cuda")
        programs[name] = {**program_ops(sv.program),
                          "load_s": time.perf_counter() - t0,
                          "pt2_bytes": (d / "model.pt2").stat().st_size}
    manifest = json.loads((card_dir / "manifest.json").read_text())

    # the main path: both artifacts scored on the card, counts from zero
    ref = ScoringEngine.from_checkpoint(cfg, ckpt_dir, vocabs, device="cuda")
    ref.warmup()
    engines = {}
    for name, d in (("card", card_dir), ("cpu", cpu_dir)):
        t0 = time.perf_counter()
        eng = ScoringEngine.from_artifact(d, vocabs=vocabs, device="cuda")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.warmup()
        engines[name] = (eng, {"build_s": build_s,
                               "warmup_s": time.perf_counter() - t0})
    scored = {}
    for name, (eng, row) in engines.items():
        fg.n_launches = 0
        reset_variant_counts()
        probs, wall, dispatches = timed_scores(eng, graphs)
        scored[name] = probs
        row.update(dispatches=dispatches, wall_s=wall,
                   functions_per_s=len(graphs) / wall,
                   b1_launches=fg.n_launches,
                   b1_launches_by_variant=dict(fg.n_variant_launches))

    # off the main path: the checkpoint engine on the card, the CPU artifact
    # on the CPU
    ref_probs, ref_wall, ref_dispatches = timed_scores(ref, graphs)
    cpu_eng = ScoringEngine.from_artifact(cpu_dir, vocabs=vocabs,
                                          device="cpu")
    cpu_probs = raw_scores(cpu_eng, graphs)
    diff = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))))

    # the warm store: two f32 engines restored from the checkpoint, then two
    # int8 engines, one store. The int8 gate refuses the corpus fit's
    # weights (its verdict is recorded), so the int8 pair serves the
    # golden model's seeded weights, which it accepts (serve_int8)
    store = WarmStore(work / "warm_store")
    warm = warm_pair(lambda: ScoringEngine.from_checkpoint(
        cfg, ckpt_dir, vocabs, device="cuda"), store, graphs, fg)
    cfg8 = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, precision="int8"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gate = ScoringEngine.from_checkpoint(cfg8, ckpt_dir, vocabs,
                                             device="cuda")
    warm8 = warm_pair(lambda: ScoringEngine.from_model(
        golden_model("cuda"), None, "graph", tuple(vocabs),
        max_batch=MAX_BATCH, device="cuda",
        vocab_hash=vocab_content_hash(vocabs), precision="int8"),
        store, graphs, i8)
    int8_ops = [program_ops(load_program(store.get(k).payload, "cuda")[0])
                for k in store.keys()
                if store.get(k).meta["precision"] == "int8"]

    # the entry points, each in a process of its own
    want8, j = [], 0
    card_rounded = [round(p, 6) for p in scored["card"]]
    for enc in encoded[:8]:
        want8.append([])
        for fn in enc:
            if fn.graph is None:
                want8[-1].append(None)
            else:
                want8[-1].append(card_rounded[j])
                j += 1
    entry = serve_entry_point(
        ["--artifact", str(card_dir), "--shard-dir", str(shard_dir)],
        sources, want8, work / "serve_artifact.log")
    ref_rounded = [round(p, 6) for p in ref_probs]
    want_ref, j = [], 0
    for enc in encoded[:8]:
        want_ref.append([])
        for fn in enc:
            want_ref[-1].append(None if fn.graph is None else ref_rounded[j])
            j += fn.graph is not None
    entry_store = serve_entry_point(
        ["--run-dir", str(run_dir), "--shard-dir", str(shard_dir), "--set",
         f"serve.warm_store_dir={store.root}"], sources, want_ref,
        work / "serve_store.log")
    tree = work / "artifact_scan_tree"
    tree.mkdir()
    for p in sorted((FIXTURES / "realworld").glob("*.c")):
        shutil.copy(p, tree / p.name)
    out = work / "artifact_scan"
    cmd = [sys.executable, "-m", "deepdfa_tpu_torch.scan", str(tree),
           "--run-dir", str(out), "--artifact", str(card_dir),
           "--shard-dir", str(shard_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600)
    scan_s = time.perf_counter() - t0
    cli = (json.loads((out / "scan.json").read_text())
           if proc.returncode == 0 else {"results": []})
    local = scan_paths([tree], vocabs, engine=engines["card"][0],
                       n_workers=4)
    scan_cli = {"cmd": " ".join(cmd[1:]), "rc": proc.returncode,
                "seconds": scan_s, "functions": local["n_functions"],
                "rows_equal": scan_rows(cli) == scan_rows(local),
                "stderr_tail": proc.stderr[-400:] if proc.returncode else ""}

    per1, per5 = fg.launches_per_call(STEPS), 3 * STEPS
    strip = lambda w: {k: v for k, v in w.items() if k != "scores"}
    row = {
        "phase": "artifact", "card": nvidia_smi(), "torch": torch.__version__,
        "model": "golden GGNN (hidden 32 x 4, 5 rounds, 3 head layers) "
                 "from the corpus fit",
        "shape": manifest["input_leaves"][-3]["shape"]
        + manifest["input_leaves"][-2]["shape"]
        + manifest["input_leaves"][-1]["shape"],
        "functions": len(graphs),
        "export": {"card_s": export_s, "cpu_s": export_cpu_s,
                   "pt2_bytes": exported["pt2_bytes"],
                   "restored": exported["restored"],
                   "step": exported["step"]},
        "programs": programs,
        "engines": {name: row for name, (_, row) in engines.items()},
        "checkpoint_engine": {"dispatches": ref_dispatches,
                              "wall_s": ref_wall,
                              "functions_per_s": len(graphs) / ref_wall},
        "max_abs_diff_vs_checkpoint": {
            name: diff(scored[name], ref_probs) for name in scored},
        "limit": ARTIFACT_LIMIT,
        "cpu_artifact_on_cpu_vs_card": diff(cpu_probs, scored["cpu"]),
        "cpu_limit": PROB_LIMIT,
        "warm_store": strip(warm), "warm_store_int8": strip(warm8),
        "int8_gate_on_checkpoint": {"precision": gate.precision,
                                    "int8_score_delta":
                                        gate.int8_score_delta},
        "int8_programs": int8_ops,
        "entry_point": entry, "entry_point_store": entry_store,
        "scan_cli": scan_cli}
    emit(row)
    for name, ops in programs.items():
        if not (ops["fused_ggnn"] and ops["segment_sum"]) or ops["index_add"]:
            fail(f"artifact: the {name}-exported program's ops {ops}")
    for name, d in row["max_abs_diff_vs_checkpoint"].items():
        if not d <= ARTIFACT_LIMIT:
            fail(f"artifact: the {name}-exported artifact {d} from the "
                 f"checkpoint engine")
    check_probs("artifact", np.asarray(scored["card"]))
    if not row["cpu_artifact_on_cpu_vs_card"] <= PROB_LIMIT:
        fail(f"artifact: the CPU artifact on the CPU "
             f"{row['cpu_artifact_on_cpu_vs_card']} from the card")
    for name, (_, r) in engines.items():
        if r["b1_launches"] <= 0 or r["b1_launches"] != \
                r["dispatches"] * per1:
            fail(f"artifact: {r['b1_launches']} B1 launches for "
                 f"{r['dispatches']} dispatches of the {name} artifact "
                 f"(expected {per1} each)")
        check_ggnn_wgmma(f"artifact ({name})", "B1",
                         r["b1_launches_by_variant"], r["b1_launches"])
    for name, w, per, kernel, precision in (
            ("warm_store", warm, per1, "B1", "f32"),
            ("warm_store_int8", warm8, per5, "B5", "int8")):
        first, joiner = w["first"], w["joiner"]
        if w["precision"] != [precision] * 2:
            fail(f"artifact {name}: precision {w['precision']} (the int8 "
                 f"gate's verdict)")
        if (first["hits"], first["misses"], joiner["hits"],
                joiner["misses"]) != (0, 3, 3, 0) or not w["bitwise_equal"]:
            fail(f"artifact {name}: first {first['hits']}/{first['misses']}"
                 f", joiner {joiner['hits']}/{joiner['misses']} (hits/"
                 f"misses), bitwise equal {w['bitwise_equal']}")
        if w["launches"] <= 0 or w["launches"] != \
                w["joiner_dispatches"] * per:
            fail(f"artifact {name}: {w['launches']} {kernel} launches for "
                 f"{w['joiner_dispatches']} dispatches (expected {per})")
        if w["launches_by_variant"].get("wgmma") != w["launches"]:
            fail(f"artifact {name}: {kernel} by variant "
                 f"{w['launches_by_variant']}")
    if warm["entries"] != 3 or warm8["entries"] != 6 or len(int8_ops) != 3 \
            or not all(o["int8_matmul"] and not o["index_add"]
                       for o in int8_ops):
        fail(f"artifact: store entries {warm['entries']} / "
             f"{warm8['entries']}, int8 programs {int8_ops}")
    for name, e in (("--artifact", entry), ("warm_store_dir", entry_store)):
        if not (e["serving"] and e["answers"] == [200] * 8 and e["drained"]
                and e["rc"] == 0
                and e["max_abs_prob_diff_vs_engine"] is not None
                and e["max_abs_prob_diff_vs_engine"] <= ARTIFACT_LIMIT):
            fail(f"artifact: the serve.server {name} entry point {e}")
    if (entry_store["warm_store"] or {}).get("hits") != 3:
        fail(f"artifact: serve.server with serve.warm_store_dir reported "
             f"{entry_store['warm_store']}")
    if not scan_cli["rows_equal"] or scan_cli["rc"] != 0:
        fail(f"artifact: the scan --artifact entry point {scan_cli}")
    return row


# ------------------------------------------------------------ phase 17d


TRAINER_PREEMPT_HIT = 9  # epoch 1, after two of its six steps
TRAINER_NAN_HITS = "8,9,10"  # epoch 1: patience 2 trips inside the epoch
TRAINER_HANG_HIT = 4  # epoch 0, after three steps
TRAINER_STEP_DEADLINE_S = 10.0
# from the wedge being seen to the process gone: the watchdog's deadline,
# its one-second grace to unwind, the journal, the flight dump and exit
TRAINER_ABORT_MARGIN_S = 5.0
TRAINER_SIGNAL_EPOCHS = 200  # the SIGUSR1 run lasts until it is signalled
INT8_TRAIN_STEPS = 8
INT8_TRAIN_LIMIT = 1e-4


def run_cli(argv: list[str]):
    """``train.cli.main(argv)`` in this process, the root logger's handlers
    and level restored after (``main`` points them at the run's log)."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        return cli_main(argv)
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)


def cli_command(cfg_file: Path, run_dir: Path, *extra: str) -> list[str]:
    """A ``python -m deepdfa_tpu_torch.train.cli fit`` command on the card."""
    return [sys.executable, "-m", "deepdfa_tpu_torch.train.cli", "fit",
            "--config", str(cfg_file), "--run-dir", str(run_dir),
            "--device", "cuda", *extra]


def start_cli(cmd: list[str], log: Path, faults_spec: str | None = None):
    """``cmd`` as a child of the repository root, stderr into ``log``."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    env.pop("DEEPDFA_FAULTS", None)
    if faults_spec:
        env["DEEPDFA_FAULTS"] = faults_spec
    f = open(log, "w")
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=f)
    proc.log_file = f
    proc.t0, proc.t_wall = time.perf_counter(), time.time()
    return proc


def finish_cli(proc, timeout: float = 300.0) -> dict:
    """Wait for a child; its rc, wall seconds and the tail of its log."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    proc.log_file.close()
    text = Path(proc.log_file.name).read_text()
    end = getattr(proc, "exit_at", None) or time.perf_counter()
    return {"rc": rc, "seconds": end - proc.t0,
            **log_seconds(text, proc.t_wall),
            "log_tail": text[-1500:] if rc not in (0, 75, 137) else ""}


def log_seconds(log_text: str, t_wall: float) -> dict:
    """Seconds from a child's start to its ``corpus:`` log line (imports,
    the CUDA context, the shards read) and, for a resume, to its ``resume:
    epochs`` line (the checkpoint restored: its first step is next)."""
    import datetime as dt
    import re

    out = {}
    for key, pattern in (("to_corpus_s", r"INFO corpus:"),
                         ("to_resume_s", r"INFO resume: epochs")):
        m = re.search(r"^(\S+ \S+) \S+ " + pattern, log_text, re.M)
        out[key] = (dt.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
                    .timestamp() - t_wall) if m else None
    return out


def fit_launches(run_dir: Path, b1: int, b2: int, by_variant: dict) -> dict:
    """A fit's launch counts beside what its journal's steps and eval
    batches give."""
    timing = json.loads((run_dir / "journal.json").read_text())["timing"]
    steps, evals = timing["train_steps"], timing["eval_batches"]
    return {"train_steps": steps, "eval_batches": evals,
            "b1_launches": b1, "b2_launches": b2,
            "expected": {"fwd": (steps + evals) * fg.launches_per_call(STEPS),
                         "bwd": steps * fg.bwd_launches_per_call(STEPS)},
            "launches_by_variant": by_variant,
            "p50_step_ms": float(np.percentile(timing["step_ms"], 50))
            if timing["step_ms"] else None}


def check_fit_launches(name: str, run: dict) -> None:
    got = {"fwd": run["b1_launches"], "bwd": run["b2_launches"]}
    if got != run["expected"] or not run["train_steps"]:
        fail(f"{name}: B1 {got['fwd']}, B2 {got['bwd']} launches, expected "
             f"{run['expected']} for {run['train_steps']} steps and "
             f"{run['eval_batches']} eval batches")
    check_ggnn_wgmma(name, "B1", run["launches_by_variant"]["fwd"],
                     run["b1_launches"])
    check_ggnn_wgmma(name, "B2", run["launches_by_variant"]["bwd"],
                     run["b2_launches"])


def counted_cli(argv: list[str]) -> tuple:
    """``run_cli(argv)`` with B1/B2 counts from zero, read right after:
    (result, B1, B2, by variant, seconds)."""
    fg.n_launches = fg.n_bwd_launches = 0
    reset_variant_counts()
    t0 = time.perf_counter()
    out = run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, fg.n_launches, fg.n_bwd_launches,
            {"fwd": dict(fg.n_variant_launches),
             "bwd": dict(fg.n_bwd_variant_launches)}, seconds)


def same_params(a: Path, b: Path) -> bool:
    pa, pb = read_params(a), read_params(b)
    return pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k])
                                          for k in pa)


def eval_probs(cfg: ExperimentConfig, state: dict, device: str) -> np.ndarray:
    """The probability of every row the test split's loss weighs (a graph,
    or a node for the node styles) under ``state`` on ``device``, in the
    order ``test`` scores them."""
    from deepdfa_tpu_torch.train.fit import _batch_stream, _batcher
    from deepdfa_tpu_torch.train.loop import extract_labels

    test = load_corpus(cfg)["test"]
    model = make_model(cfg.model, cfg.input_dim, device=device)
    model.load_state_dict(state)
    model.eval()
    out = []
    with torch.no_grad():
        for b in _batch_stream(_batcher(cfg, test), test):
            tb = to_device(b, device)
            _, weights = extract_labels(tb, cfg.model.label_style)
            keep = (weights > 0).cpu().numpy()
            out.append(torch.sigmoid(model(tb)).cpu().numpy()[keep])
    return np.concatenate(out)


def scrape(port: int) -> dict:
    """``/metrics``, ``/healthz`` and ``/slo`` of a trainer's endpoint."""
    import re

    out = {}
    status, body = http_call(port, "GET", "/metrics", timeout=5.0)
    out["/metrics"] = {"status": status,
                       "families": sorted(families(body.decode()))}
    status, body = http_call(port, "GET", "/healthz", timeout=5.0)
    out["healthz"] = json.loads(body) if status == 200 else None
    status, body = http_call(port, "GET", "/slo", timeout=5.0)
    text = body.decode()
    out["/slo"] = {"status": status,
                   "names": sorted(set(re.findall(r'slo="([a-z_0-9]+)"',
                                                  text))),
                   # MFU needs a FLOP count and a roofline: fit gives none
                   "mfu_floor_burn": 'burn_rate{slo="mfu_floor"' in text}
    return out


def watch_children(procs: dict, runs: dict, hang_log: Path,
                   hang_hit: int) -> tuple[dict, dict]:
    """Until every child has exited: send SIGUSR1 to the ``signal`` run
    once its first checkpoint is committed, scrape the ``hang`` run's
    endpoint (its port read from its log) once it has run the steps before
    its wedge, and note when each child exits (``proc.exit_at``). Returns
    (signal row, wedge row)."""
    import re

    sig: dict = {"signalled_s": None}
    wedge: dict = {}
    port = None
    deadline = time.perf_counter() + 300
    while time.perf_counter() < deadline:
        for p in procs.values():
            if getattr(p, "exit_at", None) is None and p.poll() is not None:
                p.exit_at = time.perf_counter()
        p = procs["signal"]
        if sig["signalled_s"] is None and p.poll() is None and \
                list((runs["signal"] / "checkpoints").glob("*/meta.json")):
            p.send_signal(signal.SIGUSR1)
            sig["signalled_s"] = time.perf_counter() - p.t0
        h = procs["hang"]
        if not wedge and h.poll() is None:
            if port is None:
                m = re.search(r"trainer telemetry on :(\d+)",
                              hang_log.read_text())
                port = int(m.group(1)) if m else None
            else:
                try:
                    status, body = http_call(port, "GET", "/healthz",
                                             timeout=5.0)
                    if status == 200 and \
                            json.loads(body)["steps"] >= hang_hit - 1:
                        wedge = {"port": port,
                                 "wedge_seen_s": time.perf_counter(),
                                 **scrape(port)}
                except OSError as exc:
                    wedge = {"error": repr(exc)}
        if all(getattr(p, "exit_at", None) is not None
               for p in procs.values()):
            break
        time.sleep(0.02)
    return sig, wedge or {"error": "the wedged run was never scraped"}


def phase_trainer(work: Path) -> dict:
    """``python -m deepdfa_tpu_torch.train.cli`` on the card over the corpus
    phase's ``demo`` shards, the golden model in the fused layout: a clean
    fit (the oracle), a crash between a checkpoint's payload and its
    ``meta.json`` and a mid-epoch preemption, each resumed; a real SIGUSR1;
    a divergence rolled back; a wedged step aborted by the watchdog while
    its telemetry is scraped; ``test``, ``predict``, ``analyze`` and
    ``trace export``; ``run_int8_train`` on B5; one frozen-encoder epoch;
    a tuning grid and one isolated trial."""
    from deepdfa_tpu_torch.config import to_json
    from deepdfa_tpu_torch.train import checkpoint as ckpt_mod
    from deepdfa_tpu_torch.train.fit import _batch_stream, _batcher
    from deepdfa_tpu_torch.train.int8_train import run_int8_train
    from deepdfa_tpu_torch.train.loop import TrainState
    from deepdfa_tpu_torch.train.tune import grid_space, run_trials

    shard_dir = port_utils.processed_dir() / "demo" / "shards"
    root = work / "trainer"
    root.mkdir()
    cfg = corpus_config()
    cfg_file = root / "config.json"
    cfg_file.write_text(to_json(cfg))
    # ``serve.obs`` of the hung run: its endpoint and two trainer SLOs
    hang_file = root / "hang_config.json"
    hang_file.write_text(to_json(dataclasses.replace(
        cfg, serve=dataclasses.replace(cfg.serve, obs=dataclasses.replace(
            cfg.serve.obs, train_port=0, slo_step_ms=1000.0,
            slo_mfu_floor=0.5)))))
    fit_argv = lambda run, *extra: ["fit", "--config", str(cfg_file),  # noqa: E731
                                    "--run-dir", str(run), "--device",
                                    "cuda", *extra]

    # 1. the clean fit, in this process: the oracle of the resumed runs
    clean = root / "clean"
    final, b1, b2, var, clean_s = counted_cli(fit_argv(clean))
    clean_row = fit_launches(clean, b1, b2, var) | {
        "seconds": clean_s, "final_metrics": final}

    # 2-4, 6. the children: a crash, a preemption, a real SIGUSR1 and a
    # wedged step, side by side
    runs = {name: root / name for name in ("crash", "preempt", "signal",
                                           "hang")}
    procs = {
        "crash": start_cli(cli_command(cfg_file, runs["crash"]),
                           root / "crash.log",
                           "ckpt.crash_between_state_and_meta@2"),
        "preempt": start_cli(cli_command(cfg_file, runs["preempt"]),
                             root / "preempt.log",
                             f"preempt.sigterm@{TRAINER_PREEMPT_HIT}"),
        "signal": start_cli(cli_command(
            cfg_file, runs["signal"], "--set",
            f"optim.max_epochs={TRAINER_SIGNAL_EPOCHS}"),
            root / "signal.log"),
        "hang": start_cli(cli_command(
            hang_file, runs["hang"], "--set",
            f"resilience.step_deadline_s={TRAINER_STEP_DEADLINE_S}"),
            root / "hang.log", f"step.hang@{TRAINER_HANG_HIT}"),
    }
    sig, wedge = watch_children(procs, runs, root / "hang.log",
                                TRAINER_HANG_HIT)
    children = {name: finish_cli(p) for name, p in procs.items()}
    hang_exit = getattr(procs["hang"], "exit_at", None)
    abort_s = (hang_exit - wedge["wedge_seen_s"]
               if "wedge_seen_s" in wedge and hang_exit else None)
    crash_tmp = sorted(p.name for p in
                       (runs["crash"] / "checkpoints").glob("*.tmp"))
    pre_journal = json.loads((runs["preempt"] / "journal.json").read_text())
    sig_journal = json.loads((runs["signal"] / "journal.json").read_text())
    hang_journal = json.loads((runs["hang"] / "journal.json").read_text())
    try:
        sig_step = CheckpointManager(runs["signal"] / "checkpoints"
                                     ).restore_resume(map_location="cpu")[0]
    except FileNotFoundError:
        sig_step = None

    # the resumes (children) and the isolated tuning trial
    resumes = {name: start_cli(cli_command(cfg_file, runs[name], "--resume"),
                               root / f"{name}_resume.log")
               for name in ("crash", "preempt")}
    iso = run_trials(iter([{"optim.max_epochs": 1}]), root / "tune_iso",
                     configs=[str(cfg_file)], isolate=True, device="cuda")
    resumed = {name: finish_cli(p) for name, p in resumes.items()}
    iso_run = root / "tune_iso" / "trial_0"
    iso_log = (iso_run / "run.log").read_text() if (
        iso_run / "run.log").exists() else ""

    # 5. a divergence rolled back, in this process
    with faults.installed(f"step.nan_grads@{TRAINER_NAN_HITS}"):
        sen_final, sb1, sb2, svar, sen_s = counted_cli(fit_argv(
            root / "sentinel", "--set", "resilience.sentinel_patience=2"))
    sentinel_row = fit_launches(root / "sentinel", sb1, sb2, svar) | {
        "seconds": sen_s, "final_metrics": sen_final}

    # 7. test, predict, analyze and trace export on the clean run
    fg.n_launches = 0
    reset_variant_counts()
    tested = run_cli(["test", "--config", str(cfg_file), "--run-dir",
                      str(root / "test"), "--ckpt-dir",
                      str(clean / "checkpoints"), "--device", "cuda"])
    torch.cuda.synchronize()
    test_b1, test_var = fg.n_launches, dict(fg.n_variant_launches)
    test_graphs = load_corpus(cfg)["test"]
    test_batches = sum(1 for _ in _batch_stream(_batcher(cfg, test_graphs),
                                                test_graphs))
    fg.n_launches = 0
    reset_variant_counts()
    predicted = run_cli(["predict", "--config", str(cfg_file), "--run-dir",
                         str(root / "predict"), "--ckpt-dir",
                         str(clean / "checkpoints"), "--shard-dir",
                         str(shard_dir), "--source",
                         str(FIXTURES / "realworld"), "--device", "cuda"])
    torch.cuda.synchronize()
    pred_b1, pred_var = fg.n_launches, dict(fg.n_variant_launches)
    analyzed = run_cli(["analyze", "--config", str(cfg_file), "--run-dir",
                        str(root / "analyze")])
    traced = run_cli(["trace", "--run-dir", str(clean), "--out",
                      str(root / "trace_events.json")])
    trace_names = {e["name"] for e in json.loads(
        (root / "trace_events.json").read_text())["traceEvents"]}
    # off the main path: the same checkpoint on the CPU, and predict_paths
    # in this process over the same fixtures
    best = CheckpointManager(clean / "checkpoints").restore_best(
        map_location="cpu")
    p_card = eval_probs(cfg, best, "cuda")
    p_cpu = eval_probs(cfg, best, "cpu")
    model = make_model(cfg.model, cfg.input_dim, device="cuda")
    model.load_state_dict(best)
    scorer = SizedScorer(model)
    in_proc = predict_paths([FIXTURES / "realworld"], cfg=cfg, model=model,
                            vocabs=load_vocabs(shard_dir), scorer=scorer)
    pred_cmp = compare_predictions(predicted, in_proc)
    pr = {name: (root / "test" / name).read_text().splitlines()
          for name in ("pr.csv", "pr_binned.csv")}

    # 8. run_int8_train on B5 over megabatch-packed corpus batches
    corpus = load_corpus(cfg)
    plan = make_model(dataclasses.replace(cfg.model, layout="megabatch"),
                      cfg.input_dim, device="cpu").plan_for(0, 0, 0)
    packed = mb.pack_megabatches(
        corpus["train"], width=plan.width, n_steps=plan.n_steps,
        table_rows=plan.table_rows, embed_width=plan.embed_width,
        n_head_layers=plan.n_head_layers, uniform=True).batches[:2]
    i8.n_launches = 0
    i8.n_variant_launches = dict.fromkeys(i8.VARIANTS, 0)
    t0 = time.perf_counter()
    int8_run = run_int8_train(packed, cfg=cfg, steps=INT8_TRAIN_STEPS,
                              device="cuda")
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    int8_b5, int8_var = i8.n_launches, dict(i8.n_variant_launches)
    # the gate alone on the CPU: a threshold of 0 refuses after the deltas
    int8_cpu = run_int8_train(packed, cfg=cfg, steps=INT8_TRAIN_STEPS,
                              device="cpu", max_score_delta=0.0)
    int8_diff = max(abs(int8_run["per_bucket_delta"][k]
                        - int8_cpu["per_bucket_delta"][k])
                    for k in int8_cpu["per_bucket_delta"])

    # 9. one epoch with the encoder frozen, from the clean run's weights
    fmodel = make_model(cfg.model, cfg.input_dim, device="cuda")
    fmodel.load_state_dict(best)
    before = {k: v.detach().clone() for k, v in fmodel.state_dict().items()}
    opt = ckpt_mod.frozen_encoder_optimizer(
        fmodel, lambda ps: torch.optim.AdamW(
            ps, lr=cfg.optim.lr, weight_decay=cfg.optim.weight_decay))
    ftrainer = Trainer(fmodel, cfg, pos_weight=positive_weight(np.array(
        [int(g.node_feats["_VULN"].max()) for g in corpus["train"]])))
    fstate = TrainState(fmodel, opt, torch.Generator().manual_seed(0), 0)
    fbatcher = _batcher(cfg, corpus["train"] + corpus["val"])
    ftrainer.train_epoch(fstate, _batch_stream(fbatcher, corpus["train"],
                                               shuffle_seed=0))
    after = fmodel.state_dict()
    mask = ckpt_mod.freeze_mask(after)
    frozen_same = all(torch.equal(after[k], before[k]) for k, v in
                      mask.items() if not v)
    head_moved = any(not torch.equal(after[k], before[k]) for k, v in
                     mask.items() if v)

    # 10. a two-point grid in this process
    grid = run_trials(grid_space({"optim.lr": [1e-3, 5e-4]}),
                      root / "tune_grid", configs=[str(cfg_file)],
                      base_overrides={"optim.max_epochs": 1}, device="cuda")

    def child_row(name):
        return {k: children[name][k] for k in ("rc", "seconds",
                                               "to_corpus_s")}

    row = {
        "phase": "trainer", "card": nvidia_smi(),
        "clean": clean_row,
        "crash": child_row("crash") | {
            "tmp_left": crash_tmp, "resume": resumed["crash"],
            "bitwise": same_params(clean, runs["crash"])},
        "preempt": child_row("preempt") | {
            "steps_done": pre_journal.get("preempted_steps_done"),
            "emergency_commit_s": pre_journal.get("emergency_commit_s"),
            "deadline_s": pre_journal.get("emergency_deadline_s"),
            "resume": resumed["preempt"],
            "bitwise": same_params(clean, runs["preempt"])},
        "signal": child_row("signal") | sig | {
            "preempted": sig_journal.get("preempted"),
            "steps_done": sig_journal.get("preempted_steps_done"),
            "emergency_commit_s": sig_journal.get("emergency_commit_s"),
            "restorable_step": sig_step},
        "sentinel": sentinel_row,
        "hang": child_row("hang") | {
            "deadline_s": TRAINER_STEP_DEADLINE_S,
            "margin_s": TRAINER_ABORT_MARGIN_S, "abort_s": abort_s,
            "watchdog_timeout": hang_journal.get("watchdog_timeout"),
            "flight_dumps": len(list(runs["hang"].glob("flight-*.json"))),
            "telemetry": {k: v for k, v in wedge.items()
                          if k != "wedge_seen_s"},
            "log_tail": children["hang"]["log_tail"]},
        "test": {"metrics": {k: v for k, v in tested.items()
                             if k.startswith(("test_F1", "test_loss",
                                              "n_graphs"))},
                 "batches": test_batches, "b1_launches": test_b1,
                 "b1_launches_by_variant": test_var,
                 "max_abs_prob_diff_vs_cpu": float(np.abs(p_card - p_cpu)
                                                   .max()),
                 "limit": PROB_LIMIT,
                 "pr_headers": {k: v[0] for k, v in pr.items()},
                 "pr_rows": {k: len(v) - 1 for k, v in pr.items()}},
        "predict": {"scored": predicted["n_scored"],
                    "b1_launches": pred_b1, "b1_launches_by_variant": pred_var,
                    "scorer_calls": scorer.n_calls, "vs_in_process": pred_cmp},
        "analyze": {"splits": {k: v["graphs"] for k, v in
                               analyzed["splits"].items()},
                    "variants": len(analyzed["variants"] or {})},
        "trace": {"records": traced["trace_records"],
                  "spans": traced["spans"], "names": sorted(trace_names)},
        "int8_train": {
            "accepted": int8_run["accepted"],
            "int8_score_delta": int8_run["int8_score_delta"],
            "per_bucket_delta": int8_run["per_bucket_delta"],
            "cpu_per_bucket_delta": int8_cpu["per_bucket_delta"],
            "max_delta_diff_vs_cpu": int8_diff,
            "loss_first": int8_run.get("loss_first"),
            "loss_last": int8_run.get("loss_last"),
            "loss_decreased": int8_run.get("loss_decreased"),
            "steps": int8_run["steps"], "gate_batches": len(packed),
            "seconds": int8_s,
            "steps_per_s": (int8_run["steps"] / int8_s if int8_s else None),
            "b5_launches": int8_b5, "b5_launches_by_variant": int8_var},
        "freeze": {"frozen_bitwise": frozen_same, "head_moved": head_moved},
        "tune": {"grid": [{"overrides": t.overrides,
                           "val_F1Score": t.metrics.get("val_F1Score"),
                           "error": t.error} for t in grid],
                 "isolated": {"error": iso[0].error,
                              "final_metrics": (iso_run /
                                                "final_metrics.json").exists(),
                              "on_cuda": "device=cuda" in iso_log}},
    }
    emit(row)

    # the gates
    check_fit_launches("trainer_fit", clean_row)
    if not all(np.isfinite(v) for v in final.values()):
        fail(f"trainer: non-finite clean metrics {final}")
    c = row["crash"]
    if c["rc"] != 137 or not crash_tmp or c["resume"]["rc"] != 0 or \
            not c["bitwise"]:
        fail(f"trainer: crash → resume {c}")
    p = row["preempt"]
    if p["rc"] != 75 or not (p["steps_done"] or 0) > 0 or \
            p["emergency_commit_s"] is None or \
            p["emergency_commit_s"] > p["deadline_s"] or \
            p["resume"]["rc"] != 0 or not p["bitwise"]:
        fail(f"trainer: preempt → resume {p}")
    s = row["signal"]
    if s["signalled_s"] is None or s["rc"] != 75 or s["restorable_step"] is \
            None or s["preempted"] != "signal SIGUSR1":
        fail(f"trainer: the SIGUSR1 run {s}")
    check_fit_launches("trainer_sentinel", sentinel_row)
    n_rb = sen_final["n_rollbacks"]
    if not sen_final or n_rb < 1 or sen_final["lr_scale"] != \
            cfg.resilience.lr_backoff ** n_rb:
        fail(f"trainer: the sentinel run {sen_final}")
    h = row["hang"]
    if not h["rc"] or abort_s is None or \
            abort_s > TRAINER_STEP_DEADLINE_S + TRAINER_ABORT_MARGIN_S or \
            h["watchdog_timeout"] is None or not h["flight_dumps"]:
        fail(f"trainer: the wedged run {h}")
    tel = h["telemetry"]
    if "error" in tel or tel["/metrics"]["status"] != 200 or \
            "deepdfa_train_steps_total" not in tel["/metrics"]["families"] or \
            not (tel["healthz"] or {}).get("ok") or \
            tel["/slo"]["names"] != ["mfu_floor", "step_time"] or \
            tel["/slo"]["mfu_floor_burn"]:
        fail(f"trainer: the wedged run's telemetry {tel}")
    t = row["test"]
    per1 = fg.launches_per_call(STEPS)
    if test_b1 != test_batches * per1 or \
            t["max_abs_prob_diff_vs_cpu"] > PROB_LIMIT or \
            t["pr_headers"] != {"pr.csv": ",precision,recall,thresholds",
                                "pr_binned.csv":
                                    ",precision,recall,thresholds"} or \
            t["pr_rows"]["pr_binned.csv"] != 101 or \
            tested["n_graphs_scored"] != len(test_graphs):
        fail(f"trainer: test {t}")
    check_ggnn_wgmma("trainer_test", "B1", test_var, test_b1)
    if pred_b1 != scorer.n_calls * per1 or not pred_b1 or \
            not pred_cmp["rows_equal"] or \
            pred_cmp["max_abs_prob_diff"] > ARTIFACT_LIMIT or \
            (pred_cmp["max_abs_saliency_diff"] or 0.0) > ARTIFACT_LIMIT:
        fail(f"trainer: predict {row['predict']}")
    check_ggnn_wgmma("trainer_predict", "B1", pred_var, pred_b1)
    if row["analyze"]["variants"] != 28 or \
            row["analyze"]["splits"] != {k: len(v) for k, v in corpus.items()}:
        fail(f"trainer: analyze {row['analyze']}")
    if "train.epoch" not in trace_names:
        fail(f"trainer: the trace holds {sorted(trace_names)}")
    i = row["int8_train"]
    per5 = 3 * STEPS
    if int8_b5 != (len(packed) + int8_run["steps"]) * per5 or \
            int8_var.get("wgmma") != int8_b5 or \
            int8_diff > INT8_TRAIN_LIMIT or int8_run["accepted"] != (
                int8_cpu["int8_score_delta"] <= int8_run["max_score_delta"]):
        fail(f"trainer: run_int8_train {i}")
    if not (frozen_same and head_moved):
        fail(f"trainer: the frozen-encoder epoch {row['freeze']}")
    if any(t.error for t in grid) or iso[0].error or \
            not row["tune"]["isolated"]["final_metrics"] or \
            not row["tune"]["isolated"]["on_cuda"]:
        fail(f"trainer: tune {row['tune']}")
    return row


# ------------------------------------------------------------ phase 17e

DATAFLOW_FUNCTIONS = 400
# scripts/dataflow_experiment.py's corpus, plus the static-analysis families
DATAFLOW_ARGS = ["--dataset", "demo_hard", "--n", str(DATAFLOW_FUNCTIONS),
                 "--seed", "0", "--workers", str(CORPUS_WORKERS),
                 "--dataflow-labels", "--dataflow-families"]
# the experiment's node-level runs: max(25 // 2, 5) epochs
DATAFLOW_EPOCHS = 12
# BASELINE.md: the JAX package's node-level dataflow_solution_out GGNN
# reached this test F1 with sum and with union_relu aggregation
BASELINE_DFA_F1 = 0.974
DATAFLOW_SERVED = 64
# the node fit's loss keeps as many non-vulnerable nodes as vulnerable ones
NODE_UNDERSAMPLE_FACTOR = 1.0


def dataflow_config(**model) -> ExperimentConfig:
    """The dataflow experiment's run: ``ExperimentConfig()``'s defaults
    (the golden model, undersampling ``v1.0``, 256 graphs a batch) on
    ``demo_hard`` for ``DATAFLOW_EPOCHS``, with ``model`` overrides."""
    base = ExperimentConfig()
    return dataclasses.replace(
        base, data=dataclasses.replace(base.data, dsname="demo_hard"),
        model=dataclasses.replace(base.model, **model),
        optim=dataclasses.replace(base.optim, max_epochs=DATAFLOW_EPOCHS))


def epoch_losses(run_dir: Path) -> list[float]:
    """Each epoch's mean train loss, from the run's log."""
    import re

    text = (run_dir / "run.log").read_text()
    return [float(v) for v in re.findall(r"epoch \d+: train_loss=(\S+)",
                                         text)]


def phase_dataflow(work: Path) -> dict:
    """The source paper's node-level and dataflow-lattice GGNN on the card,
    after the corpus phase (its ``demo`` shards and test sources): the
    dataflow experiment's corpus; node-level dataflow-solution fits in the
    segment layout with sum and ``union_relu`` aggregation; a node-label
    fit in the fused layout on B1/B2 (``wgmma``) with ``test``,
    ``predict``, a crash and its resume; one epoch each with the analysis
    families at widths 224 and 288 on B1/B2's ``ffma`` variant; the node
    model exported, loaded and served over HTTP; ``train.cli scan`` with
    the node checkpoint."""
    from deepdfa_tpu_torch.config import active_dfa_families, to_json
    from deepdfa_tpu_torch.data.graphs import save_shards
    from deepdfa_tpu_torch.data.materialize import CorpusBuilder
    from deepdfa_tpu_torch.train.fit import _batch_stream, _batcher
    from deepdfa_tpu_torch.train.loop import bce_with_logits, extract_labels

    smi = nvidia_smi()
    root = work / "dataflow"
    root.mkdir()
    demo_dir = port_utils.processed_dir() / "demo" / "shards"
    hard_dir = port_utils.processed_dir() / "demo_hard" / "shards"
    per1 = fg.launches_per_call(STEPS)
    row: dict = {"phase": "dataflow", "card": smi}

    def write_cfg(name: str, cfg: ExperimentConfig) -> Path:
        path = root / f"{name}.json"
        path.write_text(to_json(cfg))
        return path

    # 1. the experiment's corpus, with the families
    t0 = time.perf_counter()
    built = preprocess.main(DATAFLOW_ARGS)
    row["build"] = {"seconds": time.perf_counter() - t0,
                    "graphs": built.get("graphs"),
                    "vul_graphs": built.get("vul_graphs"),
                    "dataflow_families": built.get("dataflow_families")}

    # 2. node-level dataflow solutions in the segment layout (no kernel:
    # the union aggregators run on the ordered segment sums), sum and
    # union_relu, test on the card against the CPU
    solutions = {}
    for agg in ("sum", "union_relu"):
        cfg = dataflow_config(label_style="dataflow_solution_out",
                              aggregation=agg)
        cfg_file = write_cfg(f"dfa_{agg}", cfg)
        run = root / f"dfa_{agg}"
        t0 = time.perf_counter()
        final = run_cli(["fit", "--config", str(cfg_file), "--run-dir",
                         str(run), "--device", "cuda"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        timing = json.loads((run / "journal.json").read_text())["timing"]
        t0 = time.perf_counter()
        tested = run_cli(["test", "--config", str(cfg_file), "--run-dir",
                          str(root / f"test_{agg}"), "--ckpt-dir",
                          str(run / "checkpoints"), "--device", "cuda"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        cpu_tested = run_cli(["test", "--config", str(cfg_file), "--run-dir",
                              str(root / f"test_{agg}_cpu"), "--ckpt-dir",
                              str(run / "checkpoints"), "--device", "cpu"])
        best = CheckpointManager(run / "checkpoints").restore_best(
            map_location="cpu")
        p_card = eval_probs(cfg, best, "cuda")
        p_cpu = eval_probs(cfg, best, "cpu")
        losses = epoch_losses(run)
        solutions[agg] = {
            "epochs": len(losses), "train_loss_first": losses[0],
            "train_loss_last": losses[-1], "fit_seconds": fit_s,
            "train_steps": timing["train_steps"],
            "p50_step_ms": float(np.percentile(timing["step_ms"], 50)),
            "test_F1Score": tested["test_F1Score"],
            "baseline_F1Score": BASELINE_DFA_F1,
            "test_seconds": test_s,
            "test_graphs_per_s": tested["n_graphs_scored"] / test_s,
            "test_nodes": int(p_card.size),
            "max_abs_prob_diff_vs_cpu": float(np.abs(p_card - p_cpu).max()),
            "test_loss_diff_vs_cpu": abs(tested["test_loss"]
                                         - cpu_tested["test_loss"]),
            "final_metrics": final}
    row["solutions"] = solutions
    # off the main path: the product union's ordered sum of logs repeats
    # bitwise on the card (forward and every gradient)
    ucfg = dataflow_config(label_style="dataflow_solution_out",
                           aggregation="union_simple")
    umodel = make_model(ucfg.model, ucfg.input_dim, device="cuda")
    utrain = load_corpus(ucfg)["train"]
    ubatch = to_device(pack(utrain, derive_buckets(utrain,
                                                   TRAIN_GRAPHS)[-1]), "cuda")

    def union_step():
        umodel.zero_grad(set_to_none=True)
        out = umodel(ubatch)
        labels, weights = extract_labels(ubatch, "dataflow_solution_out")
        bce_with_logits(out, labels, weights).backward()
        return [out.detach().clone()] + [p.grad.clone()
                                         for p in umodel.parameters()]

    ua, ub = union_step(), union_step()
    row["union_simple_bitwise"] = all(torch.equal(a, b)
                                      for a, b in zip(ua, ub))
    row["union_simple_finite"] = all(bool(torch.isfinite(a).all())
                                     for a in ua)

    # 3. node labels in the fused layout on the corpus phase's demo shards,
    # the loss undersampled (its keep masks drawn on the host, replayed by
    # the crash's resume)
    base = corpus_config()
    ncfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, label_style="node"),
        optim=dataclasses.replace(
            base.optim,
            undersample_node_on_loss_factor=NODE_UNDERSAMPLE_FACTOR))
    ncfg_file = write_cfg("node", ncfg)
    node_run = root / "node"
    fit_argv = lambda run, *extra: ["fit", "--config", str(ncfg_file),  # noqa: E731
                                    "--run-dir", str(run), "--device",
                                    "cuda", *extra]
    final, b1, b2, var, node_s = counted_cli(fit_argv(node_run))
    node_row = fit_launches(node_run, b1, b2, var) | {
        "seconds": node_s, "final_metrics": final,
        "undersample_node_on_loss_factor": NODE_UNDERSAMPLE_FACTOR}
    fg.n_launches = 0
    reset_variant_counts()
    t0 = time.perf_counter()
    tested = run_cli(["test", "--config", str(ncfg_file), "--run-dir",
                      str(root / "node_test"), "--ckpt-dir",
                      str(node_run / "checkpoints"), "--device", "cuda"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_b1, test_var = fg.n_launches, dict(fg.n_variant_launches)
    test_graphs = load_corpus(ncfg)["test"]
    test_batches = sum(1 for _ in _batch_stream(_batcher(ncfg, test_graphs),
                                                test_graphs))
    hits = {k: v for k, v in tested.items() if k.startswith("statement_hit@")}
    sources = [str(FIXTURES / "realworld"), str(work / "test_sources")]
    vocabs = load_vocabs(demo_dir)
    fg.n_launches = 0
    reset_variant_counts()
    t0 = time.perf_counter()
    predicted = run_cli(["predict", "--config", str(ncfg_file), "--run-dir",
                         str(root / "node_predict"), "--ckpt-dir",
                         str(node_run / "checkpoints"), "--shard-dir",
                         str(demo_dir), "--top-k", str(ALL_STATEMENTS),
                         *[a for s in sources for a in ("--source", s)],
                         "--device", "cuda"])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_b1, pred_var = fg.n_launches, dict(fg.n_variant_launches)
    best = CheckpointManager(node_run / "checkpoints").restore_best(
        map_location="cpu")
    cpu_model = make_model(ncfg.model, ncfg.input_dim, device="cpu")
    cpu_model.load_state_dict(best)
    pred_cmp = compare_predictions(predicted, predict_paths(
        sources, cfg=ncfg, model=cpu_model, vocabs=vocabs,
        top_k=ALL_STATEMENTS))
    row["node"] = {
        "fit": node_row, "test": {
            "statement_hits": hits, "test_F1Score": tested["test_F1Score"],
            "seconds": test_s,
            "graphs_per_s": tested["n_graphs_scored"] / test_s,
            "b1_launches": test_b1, "batches": test_batches,
            "b1_launches_by_variant": test_var},
        "predict": {"n_scored": predicted["n_scored"], "seconds": pred_s,
                    "functions_per_s": predicted["n_scored"] / pred_s,
                    "saliency": sorted({r.get("saliency") for r in
                                        predicted["results"]
                                        if "error" not in r}),
                    "b1_launches": pred_b1,
                    "b1_launches_by_variant": pred_var, **pred_cmp}}

    # 4. the analysis families in the fused layout: 224 wide with the
    # dataflow families on the demo_hard shards (solver labels), 288 with
    # both flags on the same functions rebuilt with the interprocedural
    # columns (extraction-cache hits; graph labels)
    fg._kernels()
    fg._bwd_kernels()
    row["ffma_limits"] = {"fwd_max_width": fg._max_width,
                          "bwd_max_width": fg._max_train_width}
    records = demo_corpus(DATAFLOW_FUNCTIONS, seed=0, style="hard")
    ip_dir = port_utils.processed_dir() / "demo_hard_ip" / "shards"
    ip_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    cpgs, _, _ = preprocess.extract_streaming(
        records, ip_dir, workers=CORPUS_WORKERS, dataset="demo_hard")
    splits = json.loads((hard_dir / "splits.json").read_text())
    ip_graphs, _ = CorpusBuilder(FeatureConfig(
        dataflow_families=True, interproc_families=True)).build(
        cpgs, splits["train"],
        graph_labels={r["id"]: int(r["vul"]) for r in records})
    save_shards(ip_graphs, ip_dir)
    (ip_dir / "splits.json").write_text(json.dumps(splits))
    ip_build_s = time.perf_counter() - t0
    families = {}
    w = seeded_cuda(np.random.default_rng(7))
    for name, dsname, flags, style in (
            ("w224", "demo_hard", dict(dataflow_families=True),
             "dataflow_solution_out"),
            ("w288", "demo_hard_ip", dict(dataflow_families=True,
                                          interproc_families=True), "graph")):
        b = dataflow_config(label_style=style, layout="fused")
        cfg = dataclasses.replace(
            b, data=dataclasses.replace(
                b.data, dsname=dsname, feature=dataclasses.replace(
                    b.data.feature, **flags)),
            optim=dataclasses.replace(b.optim, max_epochs=1))
        width = cfg.model.hidden_dim * (len(ALL_SUBKEYS) + len(
            active_dfa_families(cfg.model.dataflow_families,
                                cfg.model.interproc_families)))
        cfg_file = write_cfg(name, cfg)
        final, b1, b2, var, fit_s = counted_cli([
            "fit", "--config", str(cfg_file), "--run-dir", str(root / name),
            "--device", "cuda"])
        run = fit_launches(root / name, b1, b2, var)
        run["expected"]["bwd"] = run["train_steps"] * \
            fg.bwd_launches_per_call(STEPS, "ffma")
        train = load_corpus(cfg)["train"]
        kernel = bucket_kernel_row(
            pack(train, derive_buckets(train, TRAIN_GRAPHS)[-1]), width,
            ggnn_weights(w, width), w)
        families[name] = {"width": width, "dsname": dsname,
                          "label_style": style, "fit_seconds": fit_s,
                          "final_metrics": final, **run, "kernel": kernel}
    row["families"] = families
    row["ip_build_seconds"] = ip_build_s

    # 5. the node model exported on the card, loaded, and served over HTTP
    t0 = time.perf_counter()
    exported = run_cli(["export", "--config", str(ncfg_file), "--run-dir",
                        str(node_run), "--shard-dir", str(demo_dir),
                        "--device", "cuda"])
    export_s = time.perf_counter() - t0
    art_dir = Path(exported["export_dir"])
    t0 = time.perf_counter()
    art_engine = ScoringEngine.from_artifact(art_dir, vocabs=vocabs,
                                             device="cuda")
    load_s = time.perf_counter() - t0
    ops = program_ops(load_exported(art_dir, device="cuda").program)
    served = [p.read_text() for p in sorted((work / "test_sources")
                                            .glob("*.c"))][:DATAFLOW_SERVED]
    graphs = [fn.graph for src in served
              for fn in encode_source(src, vocabs) if fn.graph is not None]
    want = raw_scores(art_engine, graphs)
    server = build_server(dataclasses.replace(ncfg, serve=ServeConfig(
        port=0, max_batch=MAX_BATCH, max_queue=1024)), artifact=art_dir,
        shard_dir=demo_dir, device="cuda")
    server.warmup()
    server.start()
    try:
        fg.n_launches = 0
        reset_variant_counts()
        d0 = server.engine.n_dispatches
        answers, lat, wall = http_pass(server.port, served)
        torch.cuda.synchronize()
        art_b1, art_var = fg.n_launches, dict(fg.n_variant_launches)
        art_dispatches = server.engine.n_dispatches - d0
    finally:
        server.shutdown()
    bodies = [r["vulnerable_probability"] for status, body in answers
              if status == 200 for r in body["results"]
              if "vulnerable_probability" in r]
    row["artifact"] = {
        "export_seconds": export_s, "load_seconds": load_s,
        "pt2_bytes": (art_dir / "model.pt2").stat().st_size,
        "label_style": art_engine.label_style, "ops": ops,
        "functions": len(graphs), "answers": len(bodies),
        "max_abs_diff_vs_engine": max((abs(a - b) for a, b in
                                       zip(bodies, want)), default=None),
        **pass_row(answers, lat, wall, len(graphs)),
        "dispatches": art_dispatches, "b1_launches": art_b1,
        "b1_launches_by_variant": art_var}

    # 6. the crash and its resume, and train.cli scan with the node
    # checkpoint: children side by side, after every timed step above
    crash_run = root / "node_crash"
    crash = start_cli(cli_command(ncfg_file, crash_run), root / "crash.log",
                      "ckpt.crash_between_state_and_meta@2")
    scan_dir = root / "scan"
    scan = start_cli([sys.executable, "-m", "deepdfa_tpu_torch.train.cli",
                      "scan", str(FIXTURES / "realworld"), "--config",
                      str(ncfg_file), "--run-dir", str(scan_dir),
                      "--ckpt-dir", str(node_run / "checkpoints"),
                      "--shard-dir", str(demo_dir), "--workers", "2",
                      "--device", "cuda"], root / "scan.log")
    crashed, scanned = finish_cli(crash), finish_cli(scan)
    crash_tmp = sorted(p.name for p in
                       (crash_run / "checkpoints").glob("*.tmp"))
    resumed = run_cli(fit_argv(crash_run, "--resume"))
    scan_json = (json.loads((scan_dir / "scan.json").read_text())
                 if (scan_dir / "scan.json").exists() else {})
    row["node"]["crash"] = {"rc": crashed["rc"], "tmp": crash_tmp,
                            "seconds": crashed["seconds"],
                            "log_tail": crashed["log_tail"],
                            "bitwise": same_params(node_run, crash_run),
                            "metrics_equal":
                                resumed == node_row["final_metrics"]}
    row["scan_cli"] = {"rc": scanned["rc"], "seconds": scanned["seconds"],
                       "n_scored": scan_json.get("n_scored"),
                       "log_tail": scanned["log_tail"]}
    emit(row)

    # the gates
    if row["build"]["graphs"] != DATAFLOW_FUNCTIONS or \
            not row["build"]["dataflow_families"]:
        fail(f"dataflow: preprocess {built}")
    for agg, s in solutions.items():
        if not s["train_loss_last"] < s["train_loss_first"] or \
                not s["max_abs_prob_diff_vs_cpu"] <= PROB_LIMIT or \
                not s["test_loss_diff_vs_cpu"] <= PROB_LIMIT:
            fail(f"dataflow: the {agg} solution fit {s}")
    if not (row["union_simple_bitwise"] and row["union_simple_finite"]):
        fail("dataflow: union_simple on the card is not a bitwise repeat")
    check_fit_launches("dataflow_node_fit", node_row)
    t = row["node"]["test"]
    if sorted(hits) != sorted(f"statement_hit@{k}" for k in range(1, 11)) \
            or test_b1 != test_batches * per1:
        fail(f"dataflow: node test {t}")
    check_ggnn_wgmma("dataflow_node_test", "B1", test_var, test_b1)
    p = row["node"]["predict"]
    if not p["rows_equal"] or not p["n_scored"] or \
            p["saliency"] != ["node_probability"] or \
            not p["max_abs_prob_diff"] <= PROB_LIMIT or \
            not (p["max_abs_saliency_diff"] or 0.0) <= PROB_LIMIT or \
            pred_b1 != p["n_scored"] * per1:
        fail(f"dataflow: node predict {p}")
    check_ggnn_wgmma("dataflow_node_predict", "B1", pred_var, pred_b1)
    c = row["node"]["crash"]
    if c["rc"] != 137 or not c["tmp"] or not c["bitwise"] or \
            not c["metrics_equal"]:
        fail(f"dataflow: node crash → resume {c}")
    limits = row["ffma_limits"]
    for name, f in families.items():
        k = f["kernel"]
        got = {"fwd": f["b1_launches"], "bwd": f["b2_launches"]}
        if got != f["expected"] or not f["train_steps"] or \
                f["launches_by_variant"]["fwd"]["ffma"] != got["fwd"] or \
                f["launches_by_variant"]["bwd"]["ffma"] != got["bwd"]:
            fail(f"dataflow: {name} fit launches {got} by variant "
                 f"{f['launches_by_variant']}, expected {f['expected']} "
                 "on ffma")
        if k["variant"] != "ffma" or not k["finite"] or \
                not k["fwd_max_abs_err"] <= KERNEL_LIMIT or \
                not max(k["rel_err"].values()) <= GRAD_LIMIT or \
                not max(k["ffma_rel_err"].values()) <= GRAD_LIMIT or \
                not k["bitwise_repeat"] or \
                k["fwd_launches_by_variant"] != {"wgmma": 0, "ffma": per1} or \
                k["bwd_launches_by_variant"] != {
                    "wgmma": 0,
                    "ffma": fg.bwd_launches_per_call(STEPS, "ffma")}:
            fail(f"dataflow: {name} kernels {k}")
        if f["width"] > min(limits.values()):
            fail(f"dataflow: width {f['width']} over the limits {limits}")
    a = row["artifact"]
    if not a["ops"]["fused_ggnn"] or a["ops"]["index_add"] or \
            a["label_style"] != "node" or a["answers"] != a["functions"] or \
            a["max_abs_diff_vs_engine"] is None or \
            a["max_abs_diff_vs_engine"] > ARTIFACT_LIMIT or \
            art_b1 != art_dispatches * per1 or not art_b1:
        fail(f"dataflow: node artifact {a}")
    check_ggnn_wgmma("dataflow_artifact", "B1", art_var, art_b1)
    if scanned["rc"] != 0 or not row["scan_cli"]["n_scored"]:
        fail(f"dataflow: train.cli scan {row['scan_cli']}")
    return row


# --------------------------------------------------------------- phase 18


BIGVUL_FUNCTIONS = 2000
BIGVUL_TAIL = 40  # every 40th function dataflow-hard: Big-Vul's heavy tail
DEVIGN_FUNCTIONS = 400
BIGVUL_WORKERS = 4
BIGVUL_ARGS = ["--dataset", "bigvul", "--split", "fixed", "--workers",
               str(BIGVUL_WORKERS)]
DEVIGN_ARGS = ["--dataset", "devign", "--split", "fixed", "--workers",
               str(BIGVUL_WORKERS)]
# the reference reader's typed columns (DDFA/sastvd/helpers/datasets.py:
# 161-196), in the order of scripts/rehearse_bigvul.py
MSR_COLUMNS = [
    "commit_id", "del_lines", "file_name", "lang", "lines_before",
    "lines_after", "Access Gained", "Attack Origin",
    "Authentication Required", "Availability", "CVE ID", "CVE Page",
    "CWE ID", "Complexity", "Confidentiality", "Integrity",
    "Known Exploits", "Score", "Summary", "Vulnerability Classification",
    "add_lines", "codeLink", "commit_message", "files_changed", "parentID",
    "patch", "project", "project_after", "project_before",
    "vul_func_with_fix", "Publish Date", "Update Date", "func_before",
    "func_after", "vul"]
SPLIT_OF = ["train"] * 7 + ["valid", "test", "test"]


def write_msr_csv(path: Path, n: int, seed: int) -> None:
    """A full-schema ``MSR_data_cleaned.csv`` of ``n`` generated pairs (half
    vulnerable; every ``BIGVUL_TAIL``-th a dataflow-hard function of chain
    depth 30-120) in ``DataFrame.to_csv``'s layout: a leading unnamed index
    column, quoted fields across lines."""
    import csv

    rng = np.random.default_rng(seed)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + MSR_COLUMNS)
        for i in range(n):
            vul = i % 2 == 0
            if i % BIGVUL_TAIL == BIGVUL_TAIL - 1:
                r = generate_hard_function(
                    i, vul, rng, chain_depth=int(rng.integers(30, 120)))
            else:
                r = generate_function(i, vul, rng)
            removed, added = r["removed"], r["added"]
            row = {
                "commit_id": f"c{i:010x}", "del_lines": len(removed),
                "file_name": f"src/mod_{i % 17}.c", "lang": "C",
                "lines_before": ",".join(map(str, removed)),
                "lines_after": ",".join(map(str, added)),
                "Access Gained": "None", "Attack Origin": "Remote",
                "Authentication Required": "Not required",
                "Availability": "Partial", "CVE ID": f"CVE-2020-{100000 + i}",
                "CVE Page": "https://example/cve", "CWE ID": "CWE-787",
                "Complexity": "Low", "Confidentiality": "Partial",
                "Integrity": "Partial", "Known Exploits": "",
                "Score": float(rng.uniform(2, 9)), "Summary": "generated",
                "Vulnerability Classification": "Overflow",
                "add_lines": len(added), "codeLink": "https://example/commit",
                "commit_message": "fix", "files_changed": f"src/mod_{i % 17}.c",
                "parentID": f"p{i:010x}", "patch": "@@",
                "project": f"proj{i % 5}", "project_after": f"proj{i % 5}",
                "project_before": f"proj{i % 5}",
                "vul_func_with_fix": r["after"], "Publish Date": "2020-01-01",
                "Update Date": "2020-06-01", "func_before": r["before"],
                "func_after": r["after"], "vul": int(vul)}
            writer.writerow([i] + [row[c] for c in MSR_COLUMNS])


def write_split_csv(path: Path, key: str, ids) -> None:
    """A split file (``key,split``) assigning every id 70/10/20, each
    pair ``2k, 2k + 1`` (one vulnerable, one not) to the same split."""
    path.write_text(f"{key},split\n" + "".join(
        f"{i},{SPLIT_OF[(i // 2) % 10]}\n" for i in ids))


def write_devign_json(path: Path, n: int, seed: int) -> None:
    """A Devign ``function.json``: ``project``, ``commit_id``, ``target``,
    ``func`` for ``n`` generated functions (a third vulnerable)."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n):
        r = generate_function(i, i % 3 == 0, rng)
        objs.append({"project": "qemu" if i % 2 else "FFmpeg",
                     "commit_id": f"{i:040x}", "target": r["vul"],
                     "func": r["before"]})
    path.write_text(json.dumps(objs))


def phase_bigvul() -> dict:
    """Big-Vul and Devign files → the port's readers → shards → ``fit`` on
    the card, and a Joern export scored on the card."""
    external = port_utils.external_dir()
    out_dir = port_utils.processed_dir() / "bigvul" / "shards"
    csv_path = external / "MSR_data_cleaned.csv"
    write_msr_csv(csv_path, BIGVUL_FUNCTIONS, seed=0)
    write_split_csv(external / "linevul_splits.csv", "index",
                    range(BIGVUL_FUNCTIONS))
    # the counts a serial in-process read of the same file gives
    ref_stats: dict = {}
    ref_rows = ingest.bigvul(csv_path, cache=False, workers=1,
                             stats=ref_stats)

    t0 = time.perf_counter()
    first = preprocess.main(BIGVUL_ARGS)
    build_s = time.perf_counter() - t0
    first_bytes = shard_bytes(out_dir)
    out_dir.rename(out_dir.with_name("shards_first"))
    t0 = time.perf_counter()
    again = preprocess.main(BIGVUL_ARGS)
    rebuild_s = time.perf_counter() - t0
    again_bytes = shard_bytes(out_dir)
    splits = json.loads((out_dir / "splits.json").read_text())

    cfg = dataclasses.replace(
        corpus_config(),
        data=DataConfig(dsname="bigvul", split="fixed", undersample=None,
                        batch=BatchConfig(batch_graphs=TRAIN_GRAPHS,
                                          auto_buckets=True)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bigvul_") as tmp:
        work = Path(tmp)
        run, corpus = fit_on_shards(cfg, work / "run")
        largest = max(g.n_nodes for part in corpus.values() for g in part)
        ckpts = CheckpointManager(work / "run" / "checkpoints",
                                  cfg.checkpoint)
        state = ckpts.restore(ckpts.best_step(), map_location="cpu")

        # Devign: graph labels, one epoch
        write_devign_json(external / "function.json", DEVIGN_FUNCTIONS, 1)
        write_split_csv(external / "codexglue_splits.csv", "example_index",
                        range(DEVIGN_FUNCTIONS))
        t0 = time.perf_counter()
        devign = preprocess.main(DEVIGN_ARGS)
        devign_build_s = time.perf_counter() - t0
        dcfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, dsname="devign"),
            optim=dataclasses.replace(cfg.optim, max_epochs=1))
        dsplits = json.loads((Path(devign["out"]) / "splits.json")
                             .read_text())
        drun, _ = fit_on_shards(dcfg, work / "devign")

    # Joern: an exported artifact set, encoded against the Big-Vul
    # vocabulary, scored with the trained weights on B1 and on the CPU
    jcpg = load_cpg(FIXTURES / "sample.c")
    graph, _ = encode_cpg(jcpg, 0, load_vocabs(out_dir))
    engines = {}
    for device in ("cuda", "cpu"):
        model = make_model(cfg.model, cfg.input_dim, device=device)
        engines[device] = ScoringEngine.from_model(
            model, state, "graph", KEYS, max_batch=MAX_BATCH, device=device)
    fg.n_launches = 0
    reset_variant_counts()
    engine = engines["cuda"]
    p_card = engine.score([graph], engine.assign_bucket(graph))
    torch.cuda.synchronize()
    joern_b1, joern_var = fg.n_launches, dict(fg.n_variant_launches)
    cpu = engines["cpu"]
    p_cpu = cpu.score([graph], cpu.assign_bucket(graph))
    joern_diff = float(np.abs(p_card - p_cpu).max())

    seconds = first["seconds"]
    n_read = first["functions"]
    row = {
        "phase": "bigvul", "card": nvidia_smi(),
        "reader": {"csv_bytes": csv_path.stat().st_size, **first["ingest"],
                   "serial_reference": ref_stats},
        "build": {"functions": n_read, "cpgs": first["cpgs"],
                  "graphs": first["graphs"], "shards": first["shards"],
                  "vul_graphs": first["vul_graphs"], "failed": first["failed"],
                  "wall_s": build_s, "seconds": seconds,
                  "functions_per_s": {
                      "read_and_label": first["ingest"]["rows"]
                      / seconds["ingest"],
                      **{k: n_read / v for k, v in seconds.items()
                         if k != "ingest"}},
                  "extraction": first["extraction"]},
        "rebuild": {"wall_s": rebuild_s, "seconds": again["seconds"],
                    "extraction": again["extraction"],
                    "identical": first_bytes == again_bytes,
                    "files": len(first_bytes)},
        "splits": {k: len(v) for k, v in splits.items()},
        "fit": {**run, "largest_graph_nodes": largest},
        "devign": {"functions": devign["functions"], "graphs": devign["graphs"],
                   "vul_graphs": devign["vul_graphs"],
                   "failed": devign["failed"], "wall_s": devign_build_s,
                   "splits": {k: len(v) for k, v in dsplits.items()},
                   "fit": drun},
        "joern": {"cpg_nodes": len(jcpg), "cpg_edges": len(jcpg.edges),
                  "graph_nodes": graph.n_nodes,
                  "probability": float(p_card[0]),
                  "max_abs_diff_vs_cpu": joern_diff, "limit": PROB_LIMIT,
                  "b1_launches": joern_b1, "b1_launches_by_variant": joern_var}}
    emit(row)
    check_fit("bigvul_fit", run, splits)
    check_fit("devign_fit", drun, dsplits)
    counts = ("functions", "cpgs", "graphs", "failed", "vul_graphs", "shards")
    if first["ingest"] != ref_stats or n_read != len(ref_rows) or \
            {k: again[k] for k in counts} != {k: first[k] for k in counts}:
        fail(f"bigvul: stage counts {first['ingest']} / {n_read} rows, the "
             f"serial read {ref_stats} / {len(ref_rows)}, the rebuild's "
             f"{ {k: again[k] for k in counts} }")
    if first["failed"] or first["graphs"] != n_read or \
            first["vul_graphs"] <= 0:
        fail(f"bigvul: {first['failed']} failures, {first['graphs']} graphs "
             f"of {n_read}, {first['vul_graphs']} vulnerable")
    if not row["rebuild"]["identical"] or \
            again["extraction"]["cache_hits"] != n_read:
        fail(f"bigvul: the rebuild differs ({row['rebuild']}) or missed the "
             f"cache")
    if devign["failed"] or devign["graphs"] != DEVIGN_FUNCTIONS or \
            devign["vul_graphs"] <= 0:
        fail(f"bigvul: devign built {devign}")
    per1 = fg.launches_per_call(STEPS)
    if joern_b1 != per1:
        fail(f"bigvul: the Joern graph's score made {joern_b1} B1 launches, "
             f"expected {per1}")
    check_ggnn_wgmma("joern_score", "B1", joern_var, joern_b1)
    if not (joern_diff <= PROB_LIMIT and 0.0 <= p_card[0] <= 1.0):
        fail(f"bigvul: the Joern graph scored {p_card} on the card, "
             f"{p_cpu} on the CPU")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a storage root of this run's own: the train phases find no shards
    # (the synthetic corpus), the corpus phase builds and reads its own
    storage = tempfile.mkdtemp(prefix="chip_smoke_storage_")
    os.environ["DEEPDFA_STORAGE"] = storage
    try:
        return drive()
    finally:
        shutil.rmtree(storage, ignore_errors=True)


def drive() -> int:
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # the CUDA sources of the main paths, one nvcc each, in parallel
    log = _build.build("fused_ggnn", "fused_ggnn_bwd", "megabatch",
                       "int8_matmul", "flash_attention", "flash_attention_bwd")
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    shapes = timed("kernel", phase_kernel)
    serve = timed("serve", phase_serve)
    train_rows = timed("train_kernel", phase_train_kernel)
    train = timed("train", phase_train, "fused")
    mega_rows = timed("mega_kernel", phase_mega_kernel)
    packed = timed("packed", phase_packed)
    train_mb = timed("train_megabatch", phase_train, "megabatch")
    hier_rows = timed("hier_kernel", phase_hier_kernel)
    hier = timed("hier", phase_hier)
    int8_rows = timed("int8_kernel", phase_int8_kernel)
    serve8 = timed("serve_int8", phase_serve_int8)
    flash_rows = timed("flash_kernel", phase_flash_kernel)
    bwd_rows = timed("flash_bwd_kernel", phase_flash_bwd_kernel)
    joint, ctx = timed("joint", phase_joint)
    scan = timed("scan", phase_scan, ctx)
    corpus_work = Path(tempfile.mkdtemp(prefix="chip_smoke_corpus_"))
    try:
        corpus = timed("corpus", phase_corpus, corpus_work)
        serve_http = timed("serve_http", phase_serve_http, ctx, corpus_work)
        artifact = timed("artifact", phase_artifact, corpus_work)
        trainer = timed("trainer", phase_trainer, corpus_work)
        dataflow = timed("dataflow", phase_dataflow, corpus_work)
    finally:
        shutil.rmtree(corpus_work, ignore_errors=True)
    bigvul = timed("bigvul", phase_bigvul)
    finetune = timed("finetune", phase_finetune, ctx)
    joint_train = timed("joint_train", phase_joint_train, ctx)
    joint8 = timed("joint_int8", phase_joint_int8, ctx)
    emit({"phase": "seconds", **seconds})

    mega = next(r for r in shapes if r["shape"] == "mega")
    full = max(train_rows, key=lambda r: r["n"])
    mega_b3 = next(r for r in mega_rows if r["shape"] == "mega")
    b4 = next(r for r in hier_rows if r["shape"] == "hier_bin")
    b5 = next(r for r in int8_rows if (r["m"], r["n"]) == (5120, 384))
    b5_llm = next(r for r in int8_rows if (r["k"], r["n"]) == (4096, 11008))
    b6 = next(r for r in flash_rows if r["shape"] == "7b_serve")
    b6b = next(r for r in bwd_rows if r["shape"] == "7b_train")
    sum_variants = lambda *cs: {v: sum(c[v] for c in cs) for v in fg.VARIANTS}
    # the bigvul path: the Big-Vul and Devign fits and the Joern score
    bigvul_b1 = (bigvul["fit"]["b1_launches"]
                 + bigvul["devign"]["fit"]["b1_launches"]
                 + bigvul["joern"]["b1_launches"])
    bigvul_b2 = (bigvul["fit"]["b2_launches"]
                 + bigvul["devign"]["fit"]["b2_launches"])
    # the HTTP service's tier 1 and the scan entry point's check
    http_b1 = (serve_http["b1_launches"]
               + serve_http["scan_cli"]["b1_launches"])
    # the exported artifacts (card- and CPU-exported) and the warm-store
    # joiners (f32 on B1, int8 on B5)
    art_b1 = sum(r["b1_launches"] for r in artifact["engines"].values())
    art_var = [r["b1_launches_by_variant"]
               for r in artifact["engines"].values()]
    store_b1 = artifact["warm_store"]["launches"]
    store_b5 = artifact["warm_store_int8"]["launches"]
    # the trainer's command line: the clean and the rolled-back fits, test
    # and predict on B1 (B2 in the fits), run_int8_train on B5
    tr_fit, tr_sen = trainer["clean"], trainer["sentinel"]
    tr_b1 = {"trainer_fit": tr_fit["b1_launches"],
             "trainer_sentinel": tr_sen["b1_launches"],
             "trainer_test": trainer["test"]["b1_launches"],
             "trainer_predict": trainer["predict"]["b1_launches"]}
    tr_b1_var = [tr_fit["launches_by_variant"]["fwd"],
                 tr_sen["launches_by_variant"]["fwd"],
                 trainer["test"]["b1_launches_by_variant"],
                 trainer["predict"]["b1_launches_by_variant"]]
    tr_b2 = {"trainer_fit": tr_fit["b2_launches"],
             "trainer_sentinel": tr_sen["b2_launches"]}
    tr_b5 = trainer["int8_train"]["b5_launches"]
    # the node-level and dataflow-lattice GGNN: the node fit, test, predict
    # and artifact on wgmma, the families' fits on ffma
    df_node, df_fams = dataflow["node"], list(dataflow["families"].values())
    df_b1 = {"dataflow_node_fit": df_node["fit"]["b1_launches"],
             "dataflow_node_test": df_node["test"]["b1_launches"],
             "dataflow_node_predict": df_node["predict"]["b1_launches"],
             "dataflow_artifact": dataflow["artifact"]["b1_launches"],
             "dataflow_families": sum(f["b1_launches"] for f in df_fams)}
    df_b1_var = [df_node["fit"]["launches_by_variant"]["fwd"],
                 df_node["test"]["b1_launches_by_variant"],
                 df_node["predict"]["b1_launches_by_variant"],
                 dataflow["artifact"]["b1_launches_by_variant"],
                 *[f["launches_by_variant"]["fwd"] for f in df_fams]]
    df_b2 = {"dataflow_node_fit": df_node["fit"]["b2_launches"],
             "dataflow_families": sum(f["b2_launches"] for f in df_fams)}
    df_b2_var = [df_node["fit"]["launches_by_variant"]["bwd"],
                 *[f["launches_by_variant"]["bwd"] for f in df_fams]]
    # B1 and B2 at the families' widths, on ffma: graph ms, the 3xTF32
    # bound as at width 128 and the FFMA one beside it
    df_widths = {str(f["width"]): {
        "n": k["n"], "e": k["e"], "fwd_max_abs_err": k["fwd_max_abs_err"],
        "bwd_max_rel_err": max(k["rel_err"].values()),
        "graph_ms": k["fwd_graph_ms"], "plain_graph_ms": k["plain_fwd_graph_ms"],
        "bound_ms": k["fwd_bound_ms"], "bound_by": k["fwd_bound_by"],
        "ffma_bound_ms": k["fwd_ffma_bound_ms"],
        "bwd_graph_ms": k["bwd_graph_ms"],
        "plain_bwd_graph_ms": k["plain_bwd_graph_ms"],
        "bwd_bound_ms": k["bound_ms"], "bwd_bound_by": k["bound_by"],
        "bwd_ffma_bound_ms": k["ffma_bound_ms"]}
        for f in df_fams for k in [f["kernel"]]}
    emit({"kernels": [{
        "name": "fused_ggnn", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/fused_ggnn.cu",
        "replaces": "deepdfa_tpu/ops/fused_ggnn.py:169",
        "launches": (serve["n_launches"] + train["fwd_launches"]
                     + train_mb["fwd_launches"] + scan["b1_launches"]
                     + corpus["fit"]["b1_launches"]
                     + corpus["predict"]["b1_launches"] + bigvul_b1
                     + http_b1 + art_b1 + store_b1 + sum(tr_b1.values())
                     + sum(df_b1.values())),
        "launches_by_path": {"serve": serve["n_launches"],
                             "train": train["fwd_launches"],
                             "train_megabatch": train_mb["fwd_launches"],
                             "scan": scan["b1_launches"],
                             "corpus_fit": corpus["fit"]["b1_launches"],
                             "predict": corpus["predict"]["b1_launches"],
                             "bigvul": bigvul_b1,
                             "serve_http": serve_http["b1_launches"],
                             "serve_http_scan":
                                 serve_http["scan_cli"]["b1_launches"],
                             "artifact": art_b1, "warm_store": store_b1,
                             **tr_b1, **df_b1},
        "variant": mega["variant"],
        "launches_by_variant": sum_variants(
            serve["launches_by_variant"],
            train["launches_by_variant"]["fwd"],
            train_mb["launches_by_variant"]["fwd"],
            scan["b1_launches_by_variant"],
            corpus["fit"]["launches_by_variant"]["fwd"],
            corpus["predict"]["b1_launches_by_variant"],
            bigvul["fit"]["launches_by_variant"]["fwd"],
            bigvul["devign"]["fit"]["launches_by_variant"]["fwd"],
            bigvul["joern"]["b1_launches_by_variant"],
            serve_http["b1_launches_by_variant"],
            serve_http["scan_cli"]["b1_launches_by_variant"], *art_var,
            artifact["warm_store"]["launches_by_variant"], *tr_b1_var,
            *df_b1_var),
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        # CUDA-graph replay times (the host's 11 launches a call show in
        # CUDA-event times: kept as call_ms and the like); ffma_ms is the
        # kept FFMA variant at the same shape, in the same run
        "ms": mega["graph_ms"], "plain_ms": mega["plain_graph_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        "library_ms": None,
        "ffma_ms": mega["ffma_graph_ms"],
        "ffma_bound_ms": mega["ffma_bound_ms"],
        "call_ms": mega["ms"], "plain_call_ms": mega["plain_ms"],
        "ffma_call_ms": mega["ffma_ms"],
        "ffma_widths": df_widths, "ffma_limits": dataflow["ffma_limits"],
        "shape": f"mega n={mega['n']} e={mega['e']} d={mega['d']} "
                 f"n_steps={mega['n_steps']}"}, {
        "name": "fused_ggnn_backward", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/fused_ggnn_bwd.cu",
        "replaces": "deepdfa_tpu/ops/fused_ggnn.py:221",
        "launches": (train["bwd_launches"] + train_mb["bwd_launches"]
                     + corpus["fit"]["b2_launches"] + bigvul_b2
                     + sum(tr_b2.values()) + sum(df_b2.values())),
        "launches_by_path": {"train": train["bwd_launches"],
                             "train_megabatch": train_mb["bwd_launches"],
                             "corpus_fit": corpus["fit"]["b2_launches"],
                             "bigvul": bigvul_b2, **tr_b2, **df_b2},
        "variant": full["variant"],
        "launches_by_variant": sum_variants(
            train["launches_by_variant"]["bwd"],
            train_mb["launches_by_variant"]["bwd"],
            corpus["fit"]["launches_by_variant"]["bwd"],
            bigvul["fit"]["launches_by_variant"]["bwd"],
            bigvul["devign"]["fit"]["launches_by_variant"]["bwd"],
            tr_fit["launches_by_variant"]["bwd"],
            tr_sen["launches_by_variant"]["bwd"], *df_b2_var),
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in train_rows),
        "max_rel_err": max(max(r["rel_err"].values()) for r in train_rows),
        "ms": full["bwd_graph_ms"], "plain_ms": full["plain_bwd_graph_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None,
        "ffma_ms": full["ffma_bwd_graph_ms"],
        "ffma_bound_ms": full["ffma_bound_ms"],
        "call_ms": full["bwd_ms"], "plain_call_ms": full["plain_bwd_ms"],
        "ffma_widths": df_widths,
        "shape": f"train n={full['n']} e={full['e']} d={full['d']} "
                 f"n_steps={STEPS}"}, {
        "name": "megabatch_model", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/megabatch.cu",
        "replaces": "deepdfa_tpu/ops/megabatch.py:308",
        "launches": packed["n_launches"] + train_mb["mb_launches"],
        "launches_by_path": {"packed": packed["n_launches"],
                             "train_megabatch": train_mb["mb_launches"]},
        "launches_by_variant": sum_variants(
            packed["launches_by_variant"],
            train_mb["launches_by_variant"]["mb"]),
        "max_abs_err": max(r["max_abs_err"] for r in mega_rows),
        "ms": mega_b3["graph_ms"], "plain_ms": mega_b3["plain_graph_ms"],
        "bound_ms": mega_b3["bound_ms"], "bound_by": mega_b3["bound_by"],
        "library_ms": None,
        "ffma_ms": mega_b3["ffma_graph_ms"],
        "ffma_bound_ms": mega_b3["ffma_bound_ms"],
        "call_ms": mega_b3["ms"], "plain_call_ms": mega_b3["plain_ms"],
        "shape": f"mega n={mega_b3['n']} e={mega_b3['e']} "
                 f"graphs={mega_b3['graphs']} d={WIDTH} n_steps={STEPS} "
                 f"head_layers=3"}, {
        "name": "megabatch_encoder", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/megabatch.cu",
        "replaces": "deepdfa_tpu/ops/megabatch.py:569",
        "launches": (hier["cold"]["b4_launches"] + scan["b4_launches"]
                     + serve_http["scan_cli"]["b4_launches"]),
        "launches_by_path": {"hier": hier["cold"]["b4_launches"],
                             "scan": scan["b4_launches"],
                             "serve_http_scan":
                                 serve_http["scan_cli"]["b4_launches"]},
        "launches_by_variant": sum_variants(
            hier["cold"]["b4_launches_by_variant"],
            scan["b4_launches_by_variant"],
            serve_http["scan_cli"]["b4_launches_by_variant"]),
        "max_abs_err": max(r["max_abs_err"] for r in hier_rows),
        "ms": b4["graph_ms"], "plain_ms": b4["plain_graph_ms"],
        "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
        "library_ms": None,
        "ffma_ms": b4["ffma_graph_ms"], "ffma_bound_ms": b4["ffma_bound_ms"],
        "call_ms": b4["ms"], "plain_call_ms": b4["plain_ms"],
        "shape": f"hier_bin n={b4['n']} e={b4['e']} graphs={b4['graphs']} "
                 f"d={WIDTH} n_steps={STEPS} head_layers=0"}, {
        "name": "int8_matmul", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "deepdfa_tpu/ops/int8_matmul.py:44",
        "launches": (serve8["n_launches"] + joint8["b5_launches"]
                     + store_b5 + tr_b5),
        "launches_by_path": {"serve_int8": serve8["n_launches"],
                             "joint_int8": joint8["b5_launches"],
                             "warm_store_int8": store_b5,
                             "int8_train": tr_b5},
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows
                           if r["x_dtype"] == "float32"),
        "max_rel_err": max(r["max_rel_err"] for r in int8_rows
                           if r["x_dtype"] == "float32"),
        "variant": b5["variant"],
        "launches_by_variant": {
            v: (serve8["variant_launches"][v]
                + joint8["b5_variant_launches"][v]
                + artifact["warm_store_int8"]["launches_by_variant"][v]
                + trainer["int8_train"]["b5_launches_by_variant"][v])
            for v in i8.VARIANTS},
        # CUDA-graph replay times: CUDA-event times of a call this short
        # measure the host's per-call cost (the row's "ms", "plain_ms",
        # "library_ms", kept as call_ms and the like)
        "ms": b5["graph_ms"], "plain_ms": b5["plain_graph_ms"],
        "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
        "library_ms": b5["library_graph_ms"],
        "library": b5["library"],
        "call_ms": b5["ms"], "plain_call_ms": b5["plain_ms"],
        "library_call_ms": b5["library_ms"],
        "shape": f"m={b5['m']} k={b5['k']} n={b5['n']}",
        "bf16": {  # the LLM's projections: bf16 activations and output
            "shape": f"m={b5_llm['m']} k={b5_llm['k']} n={b5_llm['n']} "
                     f"bf16",
            "max_abs_err": max(r["max_abs_err"] for r in int8_rows
                               if r["x_dtype"] == "bf16"),
            "max_rel_err": max(r["max_rel_err"] for r in int8_rows
                               if r["x_dtype"] == "bf16"),
            "variant": b5_llm["variant"],
            "ms": b5_llm["graph_ms"], "plain_ms": b5_llm["plain_graph_ms"],
            "bound_ms": b5_llm["bound_ms"], "bound_by": b5_llm["bound_by"],
            "library_ms": b5_llm["library_graph_ms"],
            "library": b5_llm["library"]}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepdfa_tpu/llm/llama.py:222",
        "stock_kernel": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        ":758 (body :342-481)",
        "launches": (joint["b6_launches"] + joint8["b6_launches"]
                     + finetune["b6_launches"] + joint_train["b6_launches"]
                     + scan["b6_launches"] + serve_http["b6_launches"]),
        "launches_by_path": {"joint": joint["b6_launches"],
                             "joint_int8": joint8["b6_launches"],
                             "finetune": finetune["b6_launches"],
                             "joint_train": joint_train["b6_launches"],
                             "scan_cascade": scan["b6_launches"],
                             "serve_http": serve_http["b6_launches"]},
        "variant": b6["variant"],
        "launches_by_variant": {
            v: sum(r["b6_variant_launches"][v]
                   for r in (joint, joint8, finetune, joint_train))
            + scan["b6_launches_by_variant"][v]
            + serve_http["b6_launches_by_variant"][v]
            for v in fa.VARIANTS},
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "max_rel_err": max(r["max_rel_err"] for r in flash_rows),
        "max_row_rel_err": max(r["max_row_rel_err"] for r in flash_rows),
        # CUDA-graph replay times, as for B5: a call at the serving shape is
        # tens of microseconds
        "ms": b6["graph_ms"], "plain_ms": b6["plain_graph_ms"],
        "bound_ms": b6["bound_ms"], "bound_by": b6["bound_by"],
        "library_ms": b6["library_graph_ms"],
        "library": b6["library"],
        "mma_ms": b6["mma_graph_ms"],  # the kept mma variant, same shape
        "call_ms": b6["ms"], "plain_call_ms": b6["plain_ms"],
        "library_call_ms": b6["library_ms"],
        "shape": f"7b_serve b={b6['b']} s={b6['s']} h={b6['h']} "
                 f"d={b6['d']} bf16"}, {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                    ":1121,1456",
        "stock_kernel": "_flash_attention_bwd (:254): dkv body :796, dq "
                        "body :1146; reached by jax.grad through "
                        "deepdfa_tpu/llm/llama.py:222",
        "launches": finetune["b6b_launches"],
        "launches_by_path": {"finetune": finetune["b6b_launches"],
                             "joint_train": joint_train["b6b_launches"]},
        "variant": b6b["variant"],
        "launches_by_variant": finetune["b6b_variant_launches"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in bwd_rows),
        "max_row_rel_err": max(max(r["max_row_rel_err"].values())
                               for r in bwd_rows),
        # CUDA-graph replay times, as for B6
        "ms": b6b["graph_ms"], "plain_ms": b6b["plain_graph_ms"],
        "bound_ms": b6b["bound_ms"], "bound_by": b6b["bound_by"],
        "library_ms": b6b["library_graph_ms"],
        "library": b6b["library"],
        "mma_ms": b6b["mma_graph_ms"],  # the kept mma variants, same shape
        "call_ms": b6b["ms"], "plain_call_ms": b6b["plain_ms"],
        "library_call_ms": b6b["library_ms"],
        "shape": f"7b_train b={b6b['b']} s={b6b['s']} h={b6b['h']} "
                 f"d={b6b['d']} bf16"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
