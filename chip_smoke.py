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

Then the kernel table as one JSON line, the ``nvidia-smi`` name and power
limit line, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints nothing and exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
from deepdfa_tpu_torch.data.graphs import batch_np
from deepdfa_tpu_torch.data.synthetic import random_dataset, random_graph
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.ops import _build
from deepdfa_tpu_torch.ops import fused_ggnn as fg
from deepdfa_tpu_torch.serve import (MicroBatcher, ScoringEngine, mega_bucket,
                                     serve_buckets)

# H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth (700 W)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FFMA in the kernel against cuBLAS in the plain version: the 128-wide dots
# and the GRU products are summed in other orders, and the plain version's
# index_add_ adds with atomics in a varying order
KERNEL_LIMIT = 1e-4
PROB_LIMIT = 1e-4
WIDTH, STEPS, MAX_BATCH, INPUT_DIM = 128, 5, 16, 1002
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


def profile_window(engine, window) -> dict:
    """Device time by kernel over one ``score_packed`` of ``window`` (after
    the main path's counts were read), and the device's busy share of the
    host's wall time for that call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.score_packed(window)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for ev in prof.key_averages():
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
    busy = profile_window(engine, window)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # the one CUDA source of the main path
    log = _build.build("fused_ggnn")
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    shapes = phase_kernel()
    serve = phase_serve()

    mega = next(r for r in shapes if r["shape"] == "mega")
    emit({"kernels": [{
        "name": "fused_ggnn", "route": "cuda",
        "source": "deepdfa_tpu_torch/csrc/fused_ggnn.cu",
        "replaces": "deepdfa_tpu/ops/fused_ggnn.py:169",
        "launches": serve["n_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": mega["ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        "library_ms": None,
        "shape": f"mega n={mega['n']} e={mega['e']} d={mega['d']} "
                 f"n_steps={mega['n_steps']}"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
