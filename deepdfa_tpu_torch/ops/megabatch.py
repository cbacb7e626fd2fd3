"""Cross-bucket megabatch packing and the whole-model GGNN forward.

The port of ``deepdfa_tpu/ops/megabatch.py``:

- :func:`pack_megabatches` first-fit-decreasing packs graphs of many sizes
  into a few block-diagonal segment batches (plain
  :class:`~deepdfa_tpu_torch.data.graphs.BatchedGraphs`, one padding-sink
  slot per bin), admitting a bin only while :func:`megabatch_bytes` of its
  padded shape stays within :data:`MEGABATCH_CAP_BYTES`. A copy of the JAX
  package's packer: same signature, same order, same bins.
- :func:`fused_ggnn_model` runs embed → ``n_steps`` message rounds →
  attention pooling → head, one logit per graph slot. On CUDA tensors it
  launches the hand-written kernels of ``csrc/megabatch.cu`` (kernel B3,
  built for ``sm_90a`` at first use: an embedding gather, two row-pointer
  builds, B1's two launches per round on B1's variant for the width (the
  tensor-core ``"wgmma"`` one at ``fused_ggnn.TC_WIDTHS``) and one
  pooling + head launch)
  or raises; on CPU tensors it runs :func:`megabatch_reference`, the same
  math in plain torch. ``n_launches`` counts the CUDA launches
  (:func:`launches_per_call` per call), ``n_variant_launches`` them by
  the variant of the call's rounds. A CUDA call reports its FLOPs to an
  active ``FlopCounterMode`` (:mod:`.flops`).
- :func:`fused_ggnn_encoder` is the same model stopped at the pooled
  embedding (kernel B4, the hierarchical scorer's level 1): on CUDA tensors
  B3's launches with a head of 0 layers, whose pooling launch then writes
  the pooled ``[h | h0]`` row of each slot; on CPU tensors
  :func:`megabatch_encoder_reference`. Inference only.

Gradients: on the CPU autograd differentiates :func:`megabatch_reference`.
On the card a ``torch.autograd.Function`` runs B3 forward, and its backward
recomputes the same math through the port's differentiable fused path (the
embedding gather, :func:`~deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn` on
B1 banked and B2, the ordered segment pooling and the head) and
differentiates that, as the JAX package's ``custom_vjp`` differentiates its
reference.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from deepdfa_tpu_torch.data.graphs import (BatchedGraphs, Graph, _round_up,
                                           batch_np, padding_efficiency)
from deepdfa_tpu_torch.ops import _build, flops
from deepdfa_tpu_torch.ops.fused_ggnn import (VARIANTS, fused_ggnn,
                                              fused_ggnn_reference,
                                              heads_words, variant)
from deepdfa_tpu_torch.ops.segment import segment_softmax, segment_sum

__all__ = ["MEGABATCH_CAP_BYTES", "MegabatchPlan", "PackResult",
           "fused_ggnn_encoder", "fused_ggnn_model", "launches_per_call",
           "megabatch_bytes", "megabatch_encoder_reference",
           "megabatch_reference", "n_launches", "n_variant_launches",
           "pack_megabatches"]

# The packer's admission limit on megabatch_bytes: the H100's 50 MB L2
# cache. A bin whose working buffers fit stays L2-resident across its
# message rounds (each round re-reads the node states and messages); the
# kernel itself takes larger shapes, which only the packer refuses.
MEGABATCH_CAP_BYTES = 50 * 2**20

# CUDA kernel launches made by fused_ggnn_model (B3) and fused_ggnn_encoder
# (B4, the same launches) since the last reset, in all and by the variant
# of B1's rounds the call took (fused_ggnn.variant of the width)
n_launches = 0
n_variant_launches = dict.fromkeys(VARIANTS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None
_max_width = 0
_max_layers = 0


def _kernels() -> ctypes.CDLL:
    global _lib, _max_width, _max_layers
    if _lib is None:
        lib = _build.load("megabatch")
        lib.mb_embed.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.mb_csr.argtypes = [_P, _I, _I, _P, _P]
        lib.mb_linear.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.mb_gru_round.argtypes = [_P] * 9 + [_I, _I, _P]
        lib.mb_pool_head.argtypes = [_P] * 7 + [_I, _P, _P, _P, _I, _I, _P]
        lib.mb_tc_prep.argtypes = [_P, _P, _I, _I, _P, _P, _I, _P]
        lib.mb_tc_linear.argtypes = [_P] * 8 + [_I, _I, _P]
        lib.mb_tc_round.argtypes = [_P] * 11 + [_I, _I, _P]
        for fn in (lib.mb_embed, lib.mb_csr, lib.mb_linear, lib.mb_gru_round,
                   lib.mb_pool_head, lib.mb_tc_prep, lib.mb_tc_linear,
                   lib.mb_tc_round):
            fn.restype = _I
        for fn in (lib.mb_max_width, lib.mb_max_layers):
            fn.argtypes = []
            fn.restype = _I
        lib.mb_error_string.argtypes = [_I]
        lib.mb_error_string.restype = ctypes.c_char_p
        _max_width = lib.mb_max_width()
        _max_layers = lib.mb_max_layers()
        _lib = lib
    return _lib


def launches_per_call(n_steps: int) -> int:
    """CUDA launches one :func:`fused_ggnn_model` or
    :func:`fused_ggnn_encoder` forward makes: the embedding gather, the two
    row-pointer builds, two per round and the pooling + head (whatever the
    head's depth, none for the encoder)."""
    return 4 + 2 * n_steps


# ------------------------------------------------------------------ plan


def _head_dims(width: int, n_head_layers: int) -> list[int]:
    d2 = 2 * width
    return [d2] + [d2] * max(n_head_layers - 1, 0) + [1] * (n_head_layers > 0)


def _buffers(n: int, e: int, d: int, g: int, n_sub: int,
             n_head_layers: int) -> dict[str, tuple[torch.dtype, int]]:
    """Every device buffer the CUDA wrapper allocates for one call, as
    ``name -> (dtype, elements)``: what :func:`megabatch_bytes` counts and
    what the wrapper allocates are this one dict."""
    dims = _head_dims(d, n_head_layers)
    head = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    f32, i32 = torch.float32, torch.int32
    return {
        "h0": (f32, n * d), "msg": (f32, n * d),
        "h_a": (f32, n * d), "h_b": (f32, n * d),
        "gate": (f32, n), "out": (f32, g * dims[-1]),
        "row_ptr": (i32, n + 1), "graph_ptr": (i32, g + 1),
        "heads": (i32, heads_words(e)), "flags": (i32, n),
        "ids": (i32, n * n_sub), "senders": (i32, e), "receivers": (i32, e),
        "gidx": (i32, n), "mask": (torch.uint8, n),
        "weights": (f32, d * d + d + 2 * (3 * d * d + 3 * d) + 2 * d + 1
                    + head),
    }


@dataclasses.dataclass(frozen=True)
class MegabatchPlan:
    """Static shape of one megabatch: the packer's admission record and the
    model's :meth:`~deepdfa_tpu_torch.models.ggnn_megabatch.GGNNMegabatch.
    plan_for`."""

    max_graphs: int
    max_nodes: int
    max_edges: int
    width: int
    n_steps: int
    table_rows: int
    embed_width: int
    n_head_layers: int

    @property
    def fits(self) -> bool:
        return megabatch_bytes(self) <= MEGABATCH_CAP_BYTES


def megabatch_bytes(plan: MegabatchPlan) -> int:
    """Bytes of the device buffers :func:`fused_ggnn_model`'s CUDA wrapper
    allocates at ``plan``'s shape: node states, messages, the ping-pong
    pair, the gate scratch, the logits, both row pointers, the int32 copies
    of ids and edges, the mask and the packed weights."""
    n_sub = max(plan.width // max(plan.embed_width, 1), 1)
    bufs = _buffers(plan.max_nodes, plan.max_edges, plan.width,
                    plan.max_graphs, n_sub, plan.n_head_layers)
    return sum(dt.itemsize * k for dt, k in bufs.values())


@dataclasses.dataclass
class PackResult:
    """Output of :func:`pack_megabatches`: the packed batches, one
    :class:`MegabatchPlan` per batch (same order), graphs too large for even
    a single-graph plan, and the overall padding efficiency."""

    batches: list[BatchedGraphs]
    plans: list[MegabatchPlan]
    oversize: list[Graph]
    efficiency: dict[str, float]


def pack_megabatches(
    graphs: Sequence[Graph],
    *,
    width: int,
    n_steps: int,
    table_rows: int,
    embed_width: int,
    n_head_layers: int,
    max_batch_graphs: int = 256,
    node_round: int = 8,
    edge_round: int = 128,
    uniform: bool = False,
) -> PackResult:
    """Greedy first-fit-decreasing packer with byte-exact admission.

    Graphs are sorted by node count (decreasing) and each goes into the
    first open bin whose grown padded shape still ``fits``; otherwise a new
    bin opens. A bin holding n graphs has ``max_graphs = n + 1`` (one
    padding-sink slot); node and edge budgets round up to ``node_round`` /
    ``edge_round``.

    ``uniform=True`` re-packs for one shared shape: graphs are snake-dealt
    in decreasing size order across the smallest bin count whose
    elementwise-max union plan fits, so bins differ by at most one graph;
    ``plans`` repeats the union plan. When no balanced dealing fits, the FFD
    bins are kept at their union plan. Graphs whose single-graph plan does
    not fit come back in ``oversize``.
    """
    order = sorted(graphs, key=lambda g: (-g.n_nodes, -g.n_edges, g.gid))
    bins: list[dict] = []
    oversize: list[Graph] = []

    def _plan(n_real_graphs: int, nodes: int, edges: int) -> MegabatchPlan:
        return MegabatchPlan(
            max_graphs=n_real_graphs + 1,
            max_nodes=_round_up(nodes + 1, node_round),
            max_edges=_round_up(max(edges, 1), edge_round),
            width=width, n_steps=n_steps, table_rows=table_rows,
            embed_width=embed_width, n_head_layers=n_head_layers)

    for g in order:
        if not _plan(1, g.n_nodes, g.n_edges).fits:
            oversize.append(g)
            continue
        for b in bins:
            if len(b["graphs"]) + 1 > max_batch_graphs:
                continue
            if _plan(len(b["graphs"]) + 1, b["nodes"] + g.n_nodes,
                     b["edges"] + g.n_edges).fits:
                b["graphs"].append(g)
                b["nodes"] += g.n_nodes
                b["edges"] += g.n_edges
                break
        else:
            bins.append({"graphs": [g], "nodes": g.n_nodes, "edges": g.n_edges})

    batches: list[BatchedGraphs] = []
    plans: list[MegabatchPlan] = []
    if uniform and bins:
        placed = [g for b in bins for g in b["graphs"]]
        placed.sort(key=lambda g: (-g.n_nodes, -g.n_edges, g.gid))
        ffd_union = _plan(max(len(b["graphs"]) for b in bins),
                          max(b["nodes"] for b in bins),
                          max(b["edges"] for b in bins))

        def _deal(n_bins: int) -> list[list[Graph]]:
            dealt: list[list[Graph]] = [[] for _ in range(n_bins)]
            for i, g in enumerate(placed):
                row, col = divmod(i, n_bins)
                dealt[col if row % 2 == 0 else n_bins - 1 - col].append(g)
            return dealt

        n_min = max(1, -(-len(placed) // max_batch_graphs))
        chosen = union = None
        for nb in range(n_min, len(placed) + 1):
            if nb > len(bins) and ffd_union.fits:
                break  # FFD already admits with fewer bins
            cand = _deal(nb)
            u = _plan(max(len(d) for d in cand),
                      max(sum(g.n_nodes for g in d) for d in cand),
                      max(sum(g.n_edges for g in d) for d in cand))
            if u.fits:
                chosen, union = cand, u
                break
        if chosen is None:
            chosen = [b["graphs"] for b in bins]
            union = ffd_union
        for d in chosen:
            batches.append(batch_np(d, union.max_graphs, union.max_nodes,
                                    union.max_edges))
            plans.append(union)
    else:
        for b in bins:
            plan = _plan(len(b["graphs"]), b["nodes"], b["edges"])
            batches.append(batch_np(b["graphs"], plan.max_graphs,
                                    plan.max_nodes, plan.max_edges))
            plans.append(plan)
    eff = padding_efficiency(batches) if batches else {
        "nodes": 0.0, "edges": 0.0, "graphs": 0.0}
    return PackResult(batches=batches, plans=plans, oversize=oversize,
                      efficiency=eff)


# ----------------------------------------------------------------- model


def _pooled(conv, table, ids, senders, receivers, gidx, mask, ew, eb, xw, xb,
            hw, hb, gw, gb, n_steps: int, n_graphs: int):
    """The model up to the pooled ``[h | h0]`` row of each graph slot, with
    the message rounds run by ``conv``."""
    h0 = torch.nn.functional.embedding(ids, table).reshape(ids.shape[0], -1)
    h = conv(h0, senders, receivers, ew, eb, xw, xb, hw, hb, n_steps=n_steps)
    hcat = torch.cat([h, h0], dim=-1)
    gate_logit = (hcat @ gw + gb)[:, 0]
    gate = segment_softmax(gate_logit, gidx, n_graphs, mask=mask)
    return segment_sum(gate[:, None] * hcat, gidx, n_graphs)


def _model_math(conv, table, ids, senders, receivers, gidx, mask, ew, eb, xw,
                xb, hw, hb, gw, gb, head, n_steps: int, n_graphs: int):
    """The whole model with the message rounds run by ``conv``."""
    a = _pooled(conv, table, ids, senders, receivers, gidx, mask, ew, eb, xw,
                xb, hw, hb, gw, gb, n_steps, n_graphs)
    for i, (w, b) in enumerate(head):
        a = a @ w + b
        if i != len(head) - 1:
            a = torch.relu(a)
    return a[..., 0].to(torch.float32)


def megabatch_reference(table, ids, senders, receivers, gidx, mask, ew, eb,
                        xw, xb, hw, hb, gw, gb, head, *, n_steps: int,
                        n_graphs: int) -> torch.Tensor:
    """The whole model in plain torch: the stacked-table gather,
    :func:`~deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn_reference`,
    ``[h | h0]``, ``segment_softmax`` / ``segment_sum`` pooling and the head
    (the segment layout's math, as the JAX package's reference)."""
    return _model_math(fused_ggnn_reference, table, ids, senders, receivers,
                       gidx, mask, ew, eb, xw, xb, hw, hb, gw, gb, head,
                       n_steps, n_graphs)


def megabatch_encoder_reference(table, ids, senders, receivers, gidx, mask,
                                ew, eb, xw, xb, hw, hb, gw, gb, *,
                                n_steps: int, n_graphs: int) -> torch.Tensor:
    """:func:`megabatch_reference` stopped at the pooled embedding: the
    ``[n_graphs, 2·D]`` float32 rows ``Σ gate · [h | h0]`` of each slot, in
    plain torch."""
    return _pooled(fused_ggnn_reference, table, ids, senders, receivers, gidx,
                   mask, ew, eb, xw, xb, hw, hb, gw, gb, n_steps,
                   n_graphs).to(torch.float32)


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.mb_error_string(code).decode()
        raise RuntimeError(f"fused_ggnn_model: {what} launch failed: {msg} "
                           f"({code})")


def _check_indices(table, ids, senders, receivers, gidx, n_graphs) -> None:
    """Host checks of the indices the kernels read, with one device read:
    ids inside the table (``nn.Embedding`` raises on others), edges inside
    the batch and sorted by receiver, ``gidx`` sorted inside the slots."""
    n, rows = ids.shape[0], table.shape[0]
    flags = [ids.min() < 0, ids.max() >= rows, gidx[0] < 0,
             gidx[-1] >= n_graphs, (gidx[1:] < gidx[:-1]).any()]
    if senders.numel():
        flags += [torch.minimum(senders.min(), receivers.min()) < 0,
                  torch.maximum(senders.max(), receivers.max()) >= n,
                  (receivers[1:] < receivers[:-1]).any()]
    bad = torch.stack(flags).tolist()
    what = ("ids below 0", f"ids at or above the table's {rows} rows",
            "graph slots below 0", f"graph slots at or above {n_graphs}",
            "node_gidx not sorted", "edge endpoints below 0",
            f"edge endpoints at or above {n} nodes",
            "edges not sorted by receiver")
    found = [w for w, b in zip(what, bad) if b]
    if found:
        raise ValueError(f"fused_ggnn_model: {', '.join(found)}")


class _Prepared:
    """One CUDA call's checked inputs and buffers: int32 / uint8 copies of
    the indices and mask, every weight packed into one float32 buffer, and
    the working buffers, all from :func:`_buffers`."""

    def __init__(self, table, ids, senders, receivers, gidx, mask, ew, eb, xw,
                 xb, hw, hb, gw, gb, head, n_steps: int, n_graphs: int):
        _kernels()
        n, n_sub = ids.shape
        e, d = senders.shape[0], ew.shape[0]
        if n == 0:
            raise ValueError("fused_ggnn_model: a batch has at least one "
                             "node (the padding sink)")
        if d % 4 != 0 or d > _max_width:
            raise ValueError(f"fused_ggnn_model: width {d} must be a "
                             f"multiple of 4 and at most {_max_width} on the "
                             "card")
        if len(head) > _max_layers:
            raise ValueError(f"fused_ggnn_model: at most {_max_layers} head "
                             f"layers, got {len(head)}")
        self.dims = _head_dims(d, len(head))
        for (w, b), din, dout in zip(head, self.dims[:-1], self.dims[1:]):
            if tuple(w.shape) != (din, dout) or tuple(b.shape) != (dout,):
                raise ValueError(f"fused_ggnn_model: head layer shapes "
                                 f"{tuple(w.shape)}/{tuple(b.shape)}, "
                                 f"expected ({din}, {dout})/({dout},)")
        _check_indices(table, ids, senders, receivers, gidx, n_graphs)
        dev = table.device
        self.buf = buf = {
            name: torch.empty(k, dtype=dt, device=dev)
            for name, (dt, k) in _buffers(n, e, d, n_graphs, n_sub,
                                          len(head)).items()}
        buf["ids"].copy_(ids.reshape(-1))
        buf["senders"].copy_(senders)
        buf["receivers"].copy_(receivers)
        buf["gidx"].copy_(gidx)
        buf["mask"].copy_(mask != 0)
        parts = [ew, eb, xw, xb, hw, hb, gw, gb] + [t for wb in head for t in wb]
        torch.cat([t.reshape(-1).to(torch.float32) for t in parts],
                  out=buf["weights"])
        sizes = [t.numel() for t in parts]
        self.weights = buf["weights"].split(sizes[:8] + [sum(sizes[8:])])
        self.table = table.to(torch.float32).contiguous()
        self.n, self.n_sub, self.e, self.d = n, n_sub, e, d
        self.ed, self.g, self.n_steps = table.shape[1], n_graphs, n_steps


def _launch(p: _Prepared, kind: str | None = None) -> torch.Tensor:
    """B3's launches for a prepared call: ``[n_graphs]`` logits (the
    buffer's rows of the last layer's width in general). The rounds take
    B1's variant for the width (``fused_ggnn.variant``) unless ``kind``
    names the other; ``"wgmma"`` takes ``fused_ggnn.TC_WIDTHS`` only."""
    flops.count(flops.megabatch_flops(p.n, p.d, p.n_steps, p.g, p.dims),
                p.table)
    lib = _kernels()
    buf, n, d = p.buf, p.n, p.d
    kind = kind or variant(d)
    if kind not in VARIANTS or (kind == "wgmma" and variant(d) != kind):
        raise ValueError(f"fused_ggnn_model: no {kind!r} rounds at width {d}")
    # the stream current at the call (a captured call's is the capture's)
    stream = torch.cuda.current_stream(p.table.device).cuda_stream

    def run(what, fn, *args):
        global n_launches
        _check(lib, fn(*args, stream), what)
        n_launches += 1
        n_variant_launches[kind] += 1

    ew, eb, xw, xb, hw, hb, gw, gb, head_w = (t.data_ptr() for t in p.weights)
    h0, row_ptr, graph_ptr = buf["h0"], buf["row_ptr"], buf["graph_ptr"]
    senders, heads = buf["senders"].data_ptr(), buf["heads"].data_ptr()
    run("embed", lib.mb_embed, p.table.data_ptr(), buf["ids"].data_ptr(),
        h0.data_ptr(), n, p.n_sub, p.ed)
    flags = buf["flags"].data_ptr()
    if kind == "wgmma":
        run("tc_prep", lib.mb_tc_prep, buf["receivers"].data_ptr(), senders,
            p.e, n, row_ptr.data_ptr(), heads, d)
    else:
        run("csr", lib.mb_csr, buf["receivers"].data_ptr(), p.e, n,
            row_ptr.data_ptr())
    run("graph csr", lib.mb_csr, buf["gidx"].data_ptr(), n, p.g,
        graph_ptr.data_ptr())
    cur, spare = h0, (buf["h_a"], buf["h_b"])
    msg = buf["msg"].data_ptr()
    for t in range(p.n_steps):
        nxt = spare[t % 2]
        if kind == "wgmma":
            run("tc_linear", lib.mb_tc_linear, cur.data_ptr(), ew, eb,
                row_ptr.data_ptr(), senders, heads, flags, msg, n, d)
            run("tc_round", lib.mb_tc_round, cur.data_ptr(), msg,
                row_ptr.data_ptr(), senders, heads, flags, xw, xb, hw, hb,
                nxt.data_ptr(), n, d)
        else:
            run("linear", lib.mb_linear, cur.data_ptr(), ew, eb, msg, n, d, d)
            run("gru_round", lib.mb_gru_round, cur.data_ptr(), msg,
                row_ptr.data_ptr(), senders, xw, xb, hw, hb, nxt.data_ptr(),
                n, d)
        cur = nxt
    dims = (ctypes.c_int * len(p.dims))(*p.dims)
    run("pool_head", lib.mb_pool_head, cur.data_ptr(), h0.data_ptr(),
        graph_ptr.data_ptr(), buf["mask"].data_ptr(), gw, gb, head_w,
        len(p.dims) - 1, dims, buf["gate"].data_ptr(), buf["out"].data_ptr(),
        p.g, d)
    return buf["out"]


def _forward_cuda(*args) -> torch.Tensor:
    """B3 on the card: ``[n_graphs]`` logits."""
    return _launch(_Prepared(*args))


class _MegabatchModel(torch.autograd.Function):
    """B3 forward; the backward recomputes the model through the port's
    differentiable fused path and differentiates it (the ``custom_vjp`` of
    the JAX package, whose backward differentiates its reference)."""

    @staticmethod
    def forward(ctx, n_steps, n_graphs, n_head, *args):
        ctx.n_steps, ctx.n_graphs, ctx.n_head = n_steps, n_graphs, n_head
        ctx.save_for_backward(*args)
        return _forward_cuda(*_unflatten(args, n_head), n_steps, n_graphs)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(a.requires_grad)
                      for a in args]
            out = _model_math(fused_ggnn, *_unflatten(leaves, ctx.n_head),
                              ctx.n_steps, ctx.n_graphs)
            wanted = [a for a in leaves if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g,
                                             allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if a.requires_grad else None for a in leaves)


def _unflatten(args, n_head: int):
    """``(table, ..., gb, head)`` from the flat tensors the Function
    takes."""
    fixed, flat = list(args[:14]), args[14:]
    return fixed + [tuple((flat[2 * i], flat[2 * i + 1])
                          for i in range(n_head))]


def _check_args(name: str, tensors) -> torch.device:
    """The one device every argument lies on, after the width check."""
    table, ids, ew = tensors[0], tensors[1], tensors[6]
    n_sub, ed, d = ids.shape[1], table.shape[1], ew.shape[0]
    if n_sub * ed != d:
        raise ValueError(
            f"embed width {n_sub}·{ed} != conv width {d} — the whole-model "
            "kernel requires the concat-subkey config (embed == hidden)")
    if any(t.device != table.device for t in tensors):
        raise ValueError(f"{name}: every argument must be on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {table.device}")
    return table.device


def fused_ggnn_model(table, ids, senders, receivers, gidx, mask, ew, eb, xw,
                     xb, hw, hb, gw, gb, head: tuple, *, n_steps: int,
                     n_graphs: int) -> torch.Tensor:
    """The whole model: embed → ``n_steps`` message rounds → attention
    pooling → head, one logit per graph slot (``[n_graphs]`` float32).

    ``table``: ``[n_sub·input_dim, embed]`` stacked per-subkey embedding
    tables; ``ids``: ``[n_nodes, n_sub]`` integer ids already offset into
    their table slice. ``senders``/``receivers``: receiver-sorted edges;
    ``gidx``/``mask``: ``node_gidx`` (sorted) / ``node_mask`` of the batch.
    ``ew..hb``: the conv's weights in ``[in, out]`` layout, r|z|n gates;
    ``gw [2D, 1]``/``gb [1]``: the attention gate; ``head``: a tuple of
    ``(w [in, out], b [out])`` per classifier layer, relu between them.
    ``n_sub · embed`` must equal the conv width ``D``.

    CUDA tensors launch B3 (a width that is a multiple of 4, indices checked
    on the host) or raise; CPU tensors run :func:`megabatch_reference`.
    Differentiable with respect to the table and every weight.
    """
    tensors = (table, ids, senders, receivers, gidx, mask, ew, eb, xw, xb,
               hw, hb, gw, gb) + tuple(t for wb in head for t in wb)
    if _check_args("fused_ggnn_model", tensors).type == "cpu":
        return megabatch_reference(table, ids, senders, receivers, gidx, mask,
                                   ew, eb, xw, xb, hw, hb, gw, gb, head,
                                   n_steps=n_steps, n_graphs=n_graphs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _MegabatchModel.apply(n_steps, n_graphs, len(head), *tensors)
    return _forward_cuda(table, ids, senders, receivers, gidx, mask, ew, eb,
                         xw, xb, hw, hb, gw, gb, head, n_steps, n_graphs)


def fused_ggnn_encoder(table, ids, senders, receivers, gidx, mask, ew, eb, xw,
                       xb, hw, hb, gw, gb, *, n_steps: int,
                       n_graphs: int) -> torch.Tensor:
    """The whole model without the classifier head: embed → ``n_steps``
    message rounds → attention pooling, one pooled ``[h | h0]`` row per
    graph slot (``[n_graphs, 2·D]`` float32). The arguments are
    :func:`fused_ggnn_model`'s without ``head``.

    CUDA tensors launch B3's kernels with a head of 0 layers (kernel B4:
    the same launches, so a pooled row is bit for bit the one the whole
    model pools) or raise; CPU tensors run
    :func:`megabatch_encoder_reference`. Inference only, as the JAX
    package's encoder, which has no VJP: a call that would need a gradient
    raises.
    """
    tensors = (table, ids, senders, receivers, gidx, mask, ew, eb, xw, xb,
               hw, hb, gw, gb)
    dev = _check_args("fused_ggnn_encoder", tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("fused_ggnn_encoder is inference only (no "
                         "gradient); call it under torch.no_grad() or with "
                         "detached weights")
    if dev.type == "cpu":
        return megabatch_encoder_reference(*tensors, n_steps=n_steps,
                                           n_graphs=n_graphs)
    out = _launch(_Prepared(*tensors, (), n_steps, n_graphs))
    return out.reshape(n_graphs, 2 * ew.shape[0])
