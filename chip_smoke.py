#!/usr/bin/env python3
"""Drive the PyTorch port (deepdfa_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints one JSON line; any failure exits non-zero.

1. device — the card's name and power limit, and the build of every CUDA
   source of the port with ``nvcc`` for ``sm_90a`` (with ptxas's register
   and spill report).
2. kernel — the fused GGNN kernel against its plain torch version at width
   128 and 5 rounds, at the serving ladder's three shapes and the megabatch
   shape, on padded batches of synthetic requests: max abs difference of
   the node states (limit ``KERNEL_LIMIT``), CUDA-event times, and the
   least time the card could take (the bound). One more row times the
   megabatch shape with its padding edges spread over all padding nodes, to
   show what the padding sink's long edge segment costs.
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
   difference is reported beside it), bitwise
   equality of two runs, CUDA-event times of the banked training forward,
   the backward and the plain backward, the bound and the launches per
   call.
5. train — ``train.fit.fit`` of the golden model in the fused layout on the
   card: the synthetic corpus, no undersampling, 256 graphs per batch,
   derived buckets, 3 epochs (6 train steps at N = 16,768), with every
   launch count reset just before: steps/s, graphs/s, p50 step ms, launch
   counts (forward launches = (train steps + eval batches) × 11, backward
   launches = train steps × 32), finite final metrics. Then one train step
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
   calls bitwise equal, CUDA-event times, the bound and launches per call.
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
   banked recompute), B2 = train steps × 32; the first step against the
   segment layout on the card and the megabatch layout on the CPU; the
   resumed and the repeated fit bitwise equal to the straight one.

Then each phase's wall seconds, the kernel table as one JSON line, the
``nvidia-smi`` name and power limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints nothing and exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deepdfa_tpu_torch.config import (ALL_SUBKEYS, BatchConfig, DataConfig,
                                      ExperimentConfig, GGNNConfig,
                                      OptimConfig)
from deepdfa_tpu_torch.data.graphs import (GraphBatcher, batch_np,
                                           derive_buckets, to_device)
from deepdfa_tpu_torch.data.sampler import positive_weight
from deepdfa_tpu_torch.data.synthetic import random_dataset, random_graph
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.ops import _build
from deepdfa_tpu_torch.ops import fused_ggnn as fg
from deepdfa_tpu_torch.ops import megabatch as mb
from deepdfa_tpu_torch.serve import (MicroBatcher, ScoringEngine, mega_bucket,
                                     serve_buckets)
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.fit import fit, load_corpus
from deepdfa_tpu_torch.train.loop import Trainer
from deepdfa_tpu_torch.train.metrics import ConfusionState

# H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth (700 W)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FFMA in the kernel against cuBLAS in the plain version: the 128-wide dots
# and the GRU products are summed in other orders, and the plain version's
# index_add_ adds with atomics in a varying order
KERNEL_LIMIT = 1e-4
PROB_LIMIT = 1e-4
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


def kernel_bound(n: int, e: int, d: int, steps: int) -> tuple[float, str]:
    """Least milliseconds for the function: FLOPs over the FP32 peak, or
    bytes (inputs once, output once) over HBM bandwidth, the larger."""
    flops = steps * (2 * n * d * d + 2 * 2 * n * d * 3 * d + e * d)
    nbytes = 4 * (2 * n * d + 2 * e + d * d + d + 2 * (d * 3 * d + 3 * d))
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel() -> list[dict]:
    rng = np.random.default_rng(0)
    ladder = serve_buckets(MAX_BATCH)
    shapes = [("ladder_126", ladder[0], 50), ("ladder_1022", ladder[1], 500),
              ("ladder_4094", ladder[2], 2500),
              ("mega", mega_bucket(MAX_BATCH), 50)]
    w = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).cuda()
    d = WIDTH
    weights = (w(d, d, std=d ** -0.5), w(d, std=0.1), w(d, 3 * d, std=d ** -0.5),
               w(3 * d, std=0.1), w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1))
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
        with torch.inference_mode():
            got = fg.fused_ggnn(*args, n_steps=STEPS)
            want = fg.fused_ggnn_reference(*args, n_steps=STEPS)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            ms = cuda_ms(lambda: fg.fused_ggnn(*args, n_steps=STEPS), 20)
            plain_ms = cuda_ms(
                lambda: fg.fused_ggnn_reference(*args, n_steps=STEPS), 20)
            ms_again = cuda_ms(lambda: fg.fused_ggnn(*args, n_steps=STEPS), 20)
        bound_ms, bound_by = kernel_bound(n, e, d, STEPS)
        sink_edges = int((b.receivers == n - 1).sum())
        row = {"phase": "kernel", "shape": name, "n": n, "e": e, "d": d,
               "n_steps": STEPS, "real_nodes": int(b.node_mask.sum()),
               "real_edges": int(b.edge_mask.sum()),
               "sink_segment_edges": sink_edges,
               "max_abs_err": err, "limit": KERNEL_LIMIT, "finite": finite,
               "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "launches_per_call": fg.launches_per_call(STEPS)}
        emit(row)
        if not finite or not err <= KERNEL_LIMIT:
            fail(f"kernel disagrees with its plain version at {name}: {err}")
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


def profile_call(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (made after the main
    path's counts were read), and the device's busy share of the host's
    wall time for that call."""
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
    return {"wall_us": wall_us, "device_us": total,
            "busy_share": total / wall_us if total else None,
            "top_kernels_us": [[k[:60], v] for k, v in top]}


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
    d0 = engine.n_dispatches
    probs, lat, wall = drive_batcher(engine, reqs)
    packed = engine.score_packed(window)
    torch.cuda.synchronize()
    launches = fg.n_launches
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


def bwd_bound(n: int, e: int, d: int, steps: int) -> tuple[float, str]:
    """Least milliseconds for the backward from the banked states and
    aggregates: per reverse round 40·N·D² FLOPs (both 3-gate products,
    dagg and dhp·hwᵀ, dmsg·ewᵀ, the three weight gradients) and E·D adds of
    the transposed edge sum; bytes: the two banks, g and the weights read
    once, dh0 and the weight gradients written once."""
    flops = steps * (40 * n * d * d + e * d)
    weights = d * d + d + 2 * (d * 3 * d + 3 * d)
    nbytes = 4 * (2 * steps * n * d + 2 * n * d + 2 * e + 2 * weights)
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


GRAD_NAMES = ("dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb")


def kernel_grads(args, g):
    """The seven gradients through the public op (forward banked, backward
    on the kernel)."""
    leaves = [a.clone().requires_grad_(True) if i not in (1, 2) else a
              for i, a in enumerate(args)]
    out = fg.fused_ggnn(*leaves, n_steps=STEPS)
    return torch.autograd.grad(out, [leaves[i] for i in (0, 3, 4, 5, 6, 7, 8)],
                               g)


def phase_train_kernel() -> list[dict]:
    rng = np.random.default_rng(4)
    train, buckets = train_buckets(train_config())
    d = WIDTH
    w = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).cuda()
    weights = (w(d, d, std=d ** -0.5), w(d, std=0.1), w(d, 3 * d, std=d ** -0.5),
               w(3 * d, std=0.1), w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1))
    rows = []
    for bucket in buckets:
        b = pack(train, bucket)
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
        bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        p = fg._Prepared(h0, args[1], args[2], weights, fg._max_width)
        _, states, aggs = fg._forward_cuda(p, STEPS, bank=True)
        fwd_ms = cuda_ms(lambda: fg._forward_cuda(p, STEPS, bank=True), 10)
        bwd_ms = cuda_ms(lambda: fg._backward_cuda(p, states, aggs, g), 10)
        plain_ms = cuda_ms(lambda: fg.fused_ggnn_backward_reference(
            *args, g, n_steps=STEPS), 10)
        bwd_again = cuda_ms(lambda: fg._backward_cuda(p, states, aggs, g), 10)
        bound_ms, bound_by = bwd_bound(n, e, d, STEPS)
        row = {"phase": "train_kernel", "n": n, "e": e, "d": d,
               "graphs": int(b.graph_mask.sum()),
               "real_nodes": int(b.node_mask.sum()),
               "real_edges": int(b.edge_mask.sum()),
               "sink_segment_edges": int((b.senders == n - 1).sum()),
               "max_abs_err": errs, "rel_err": rel, "limit": GRAD_LIMIT,
               "plain_f32_rel_err": plain_rel,
               "bitwise_repeat": bitwise, "finite": finite,
               "fwd_banked_ms": fwd_ms, "bwd_ms": bwd_ms,
               "bwd_ms_repeat": bwd_again, "plain_bwd_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fwd_launches_per_call": fg.launches_per_call(STEPS),
               "bwd_launches_per_call": fg.bwd_launches_per_call(STEPS)}
        emit(row)
        if not finite or not bitwise:
            fail(f"backward kernel at n={n}: finite={finite} bitwise={bitwise}")
        bad = {k: v for k, v in rel.items() if not v <= GRAD_LIMIT}
        if bad:
            fail(f"backward kernel disagrees with its plain version at n={n}: "
                 f"{bad}")
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
    t0 = time.perf_counter()
    final = fit(cfg, work / "straight", device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fg.n_launches, fg.n_bwd_launches
    mb_launches = mb.n_launches

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
                dims: list[int], steps: int) -> tuple[float, str]:
    """Least milliseconds for the whole model: the rounds' FLOPs (as
    :func:`kernel_bound`) plus 2·N·2D for the gate logits, 2·N·2D for the
    readout and G·Σ 2·in·out for the head, over the FP32 peak; or the
    bytes (table, ids, edges, gidx, mask and weights read once, the logits
    written once) over HBM bandwidth; the larger."""
    head = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    flops = (steps * (2 * n * d * d + 2 * 2 * n * d * 3 * d + e * d)
             + 2 * 2 * n * 2 * d + g * 2 * head)
    weights = (d * d + d + 2 * (d * 3 * d + 3 * d) + 2 * d + 1 + head
               + sum(dims[1:]))
    nbytes = 4 * (rows * (d // n_sub) + n * n_sub + 2 * e + n + weights
                  + g) + n
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def model_inputs(b, rng, d: int = WIDTH, n_layers: int = 3):
    """Seeded table and weights of the golden model's shapes, in the
    ``[in, out]`` layout, with batch ``b``'s ids, edges and slots, on the
    card: the positional arguments of ``fused_ggnn_model``."""
    ed = d // len(ALL_SUBKEYS)
    w = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).cuda()
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
            ms = cuda_ms(lambda: mb._launch(p), 20)
            plain_ms = cuda_ms(lambda: mb.megabatch_reference(*args, **kw), 20)
            ms_again = cuda_ms(lambda: mb._launch(p), 20)
            call_ms = cuda_ms(lambda: mb.fused_ggnn_model(*args, **kw), 20)
            profile = profile_call(lambda: mb._launch(p))
        dims = [2 * WIDTH, 2 * WIDTH, 2 * WIDTH, 1]
        bound_ms, bound_by = model_bound(n, e, WIDTH, g, len(KEYS),
                                         len(KEYS) * INPUT_DIM, dims, STEPS)
        row = {"phase": "mega_kernel", "shape": name, "n": n, "e": e,
               "graphs": g, "d": WIDTH, "n_steps": STEPS, "head_layers": 3,
               "real_nodes": int(b.node_mask.sum()),
               "real_graphs": int(b.graph_mask.sum()),
               "sink_segment_edges": int((b.receivers == n - 1).sum()),
               "max_abs_err": err, "limit": KERNEL_LIMIT, "finite": finite,
               "bitwise_repeat": bitwise, "ms": ms, "ms_repeat": ms_again,
               "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "launches_per_call": per_call,
               "profile": profile}
        emit(row)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        probs = [torch.sigmoid(model(to_device(b, "cuda", KEYS))).cpu()
                 for b in packed.batches]
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = mb.n_launches

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
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # the CUDA sources of the main paths, one nvcc each, in parallel
    log = _build.build("fused_ggnn", "fused_ggnn_bwd", "megabatch")
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
    emit({"phase": "seconds", **seconds})

    mega = next(r for r in shapes if r["shape"] == "mega")
    full = max(train_rows, key=lambda r: r["n"])
    mega_b3 = next(r for r in mega_rows if r["shape"] == "mega")
    emit({"kernels": [{
        "name": "fused_ggnn", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/fused_ggnn.cu",
        "replaces": "deepdfa_tpu/ops/fused_ggnn.py:169",
        "launches": (serve["n_launches"] + train["fwd_launches"]
                     + train_mb["fwd_launches"]),
        "launches_by_path": {"serve": serve["n_launches"],
                             "train": train["fwd_launches"],
                             "train_megabatch": train_mb["fwd_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": mega["ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        "library_ms": None,
        "shape": f"mega n={mega['n']} e={mega['e']} d={mega['d']} "
                 f"n_steps={mega['n_steps']}"}, {
        "name": "fused_ggnn_backward", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/fused_ggnn_bwd.cu",
        "replaces": "deepdfa_tpu/ops/fused_ggnn.py:221",
        "launches": train["bwd_launches"] + train_mb["bwd_launches"],
        "launches_by_path": {"train": train["bwd_launches"],
                             "train_megabatch": train_mb["bwd_launches"]},
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in train_rows),
        "ms": full["bwd_ms"], "plain_ms": full["plain_bwd_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None,
        "shape": f"train n={full['n']} e={full['e']} d={full['d']} "
                 f"n_steps={STEPS}"}, {
        "name": "megabatch_model", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/megabatch.cu",
        "replaces": "deepdfa_tpu/ops/megabatch.py:308",
        "launches": packed["n_launches"] + train_mb["mb_launches"],
        "launches_by_path": {"packed": packed["n_launches"],
                             "train_megabatch": train_mb["mb_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in mega_rows),
        "ms": mega_b3["ms"], "plain_ms": mega_b3["plain_ms"],
        "bound_ms": mega_b3["bound_ms"], "bound_by": mega_b3["bound_by"],
        "library_ms": None,
        "shape": f"mega n={mega_b3['n']} e={mega_b3['e']} "
                 f"graphs={mega_b3['graphs']} d={WIDTH} n_steps={STEPS} "
                 f"head_layers=3"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
