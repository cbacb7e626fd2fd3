"""CodeLlama (LLaMA architecture) in PyTorch.

The port of ``deepdfa_tpu/llm/llama.py`` for one card. Parameters carry
HF's names (``embed_tokens.weight``, ``layers.{i}.self_attn.q_proj.weight``,
``norm.weight``; ``model.`` in front and ``lm_head.weight`` for
:class:`LlamaForCausalLM`), so an HF state dict loads with no renaming
(:mod:`deepdfa_tpu_torch.llm.convert`), and :mod:`deepdfa_tpu_torch.bridge`
carries the JAX package's Flax tree across.

Types follow the JAX package, where Flax keeps float32 parameters and casts
them to ``cfg.dtype`` at each use:

- projections and the embedding table are stored in ``cfg.dtype`` (a
  round-to-nearest-even cast once, the same values as the cast at each use);
- RMSNorm weights stay float32: the normed value is cast to ``cfg.dtype``,
  multiplied by the float32 weight and cast again;
- rotary embeddings are computed in float32 and cast back to the input's
  type;
- LoRA adapters stay float32 and are cast at use.

``attn_impl="flash"`` runs attention on kernel B6
(:func:`~deepdfa_tpu_torch.ops.flash_attention.flash_attention`) when the
sequence is a multiple of 128, else :func:`~deepdfa_tpu_torch.ops.
ring_attention.full_attention`, as the JAX package does; the two differ on
padding query rows (B6 lets them attend to earlier padding, ``full``
zeroes them) and agree on real rows. ``int8_runtime=True`` holds every
projection as int8 weights with per-channel scales (:class:`Int8Dense`, on
kernel B5), made from a float checkpoint by
:func:`~deepdfa_tpu_torch.llm.quant.to_int8_runtime_params`; its backward
gives the activation gradient, so LoRA adapters train over an int8 base.
``remat=True`` recomputes each decoder layer in the backward
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``).

``decode=True`` runs against a :class:`KVCache` the caller makes
(:meth:`KVCache.empty`), passes in and gets back: keys, values and the
validity of each slot, per layer, updated in place. Where the JAX package's
cache is ``max_position_embeddings`` long, the port's is as long as the
caller asks (prompt + new tokens for generation): masked slots add exact
zeros, so the tokens are the same, and each step reads only that many
slots. Decode attention is plain torch, as it is plain jnp in the JAX
package.

``mesh=`` (a :class:`~deepdfa_tpu_torch.parallel.mesh.Mesh` over a process
group, one device per rank) shards the model by the JAX package's
:data:`LOGICAL_RULES`: each rank holds the shard of every parameter that
:func:`mesh_shardings` names (:func:`shard_state` cuts it from a full state
dict and :func:`gather_state` joins the shards back; :func:`init_llama_params`
draws the full tensors and keeps the shard, so a sharded model holds the
unsharded one's values), and the model runs on the shards with explicit
collectives (:mod:`deepdfa_tpu_torch.parallel.comm`):

- ``fsdp``: the ``embed`` dimension of each weight is split; a layer's
  weights are gathered just before use;
- ``tp``: q/k/v and gate/up column-parallel (each rank its heads and its
  slice of the MLP, behind one ``comm.copy`` of the block's input), o and
  down row-parallel (the partial products summed over ``tp`` in float32,
  one all-reduce each), the embedding and ``lm_head`` vocabulary-parallel
  (logits gathered over ``tp``);
- ``sp``: each rank runs its block of the sequence; ``attn_impl="ring"``
  attends through :func:`~deepdfa_tpu_torch.ops.ring_attention.
  ring_attention`, ``"full"`` over the keys gathered from the ``sp`` group
  (plain torch), and ``"flash"`` raises (kernel B6 attends within one
  block);
- ``dp``: each rank runs its block of the batch.

Inputs are whole on every rank. ``forward`` gives every rank the whole
output; :meth:`LlamaModel.sharded_hidden` and
:meth:`LlamaForCausalLM.sharded_logits` give this rank's block, which is
what training reads. The backward runs through every collective (the
gradient convention is in :mod:`~deepdfa_tpu_torch.parallel.comm`), the
ring's included, and ``remat`` recomputes a sharded layer with its
collectives. ``decode`` refuses a mesh, ``int8_runtime`` refuses one as in
the JAX package, and ``attn_impl="ring"`` needs one.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.llm.lora import LoRAAdapter
from deepdfa_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from deepdfa_tpu_torch.ops.int8_matmul import int8_matmul
from deepdfa_tpu_torch.ops.ring_attention import (full_attention,
                                                  ring_attention)
from deepdfa_tpu_torch.parallel import comm

__all__ = ["Attention", "DecoderLayer", "Int8Dense", "KVCache",
           "LOGICAL_RULES", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "MLP", "RMSNorm", "ShardedEmbedding", "ShardedLinear",
           "ShardedLoRA", "apply_rope", "build_llama", "codellama_13b",
           "codellama_7b", "gather_state", "init_llama_params",
           "logical_axes", "mesh_shardings", "rope_cos_sin", "shard_state",
           "tiny_llama"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# logical param/activation axis -> mesh axis. None = replicated.
LOGICAL_RULES = (
    ("batch", "dp"),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("norm", None),
)

# the logical axes of each weight in torch's layout ([out, in] for a
# projection: the JAX kernel's [in, out] reversed)
_WEIGHT_AXES = {
    "q_proj": ("heads", "embed"), "k_proj": ("kv_heads", "embed"),
    "v_proj": ("kv_heads", "embed"), "o_proj": ("embed", "heads"),
    "gate_proj": ("mlp", "embed"), "up_proj": ("mlp", "embed"),
    "down_proj": ("embed", "mlp"), "lm_head": ("vocab", "embed"),
    "embed_tokens": ("vocab", "embed"),
}
_LEAF_AXES = {"lora_a": ("embed", "norm"), "lora_b": ("norm", "heads")}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters (HF ``LlamaConfig`` field parity where
    the names overlap, so an HF ``config.json`` reads directly)."""

    vocab_size: int = 32016
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rope_theta: float = 1_000_000.0  # CodeLlama uses 1e6 (LLaMA-2 1e4)
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 16384
    dtype: str = "bfloat16"
    attn_impl: str = "full"  # "full" | "flash" | "ring"
    remat: bool = False  # recompute each decoder layer in the backward
    lora_rank: int = 0  # 0 = disabled; >0 adds LoRA to q_proj/v_proj
    lora_alpha: float = 16.0
    # int8-resident projection weights on kernel B5 (Int8Dense)
    int8_runtime: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype]

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlamaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def codellama_7b(**kw) -> LlamaConfig:
    """codellama/CodeLlama-7b-* shapes."""
    return LlamaConfig(**kw)


def codellama_13b(**kw) -> LlamaConfig:
    """codellama/CodeLlama-13b-* shapes."""
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40, **kw)


def tiny_llama(**kw) -> LlamaConfig:
    """Test-size config."""
    defaults = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32")
    defaults.update(kw)
    return LlamaConfig(**defaults)


def _check_config(cfg: LlamaConfig, mesh=None) -> None:
    cfg.torch_dtype  # noqa: B018 — validates the name
    if cfg.attn_impl == "ring" and mesh is None:
        raise ValueError("attn_impl='ring' requires a mesh")
    if cfg.int8_runtime and mesh is not None:
        raise ValueError(
            "int8_runtime is the single-chip inference path — the pallas "
            "dequant-matmul is not GSPMD-partitionable; use bf16 + mesh "
            "sharding for multi-chip")
    if cfg.attn_impl not in ("full", "flash", "ring"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} (full | "
                         f"flash | ring)")
    if (cfg.attn_impl == "flash" and mesh is not None
            and mesh.shape["sp"] > 1):
        raise ValueError("attn_impl='flash' does not take a sequence split "
                         "over sp (kernel B6 attends within one block); use "
                         "attn_impl='ring' (or 'full')")
    if cfg.attn_impl == "flash" and cfg.head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_impl='flash' takes head widths {HEAD_DIMS}, "
                         f"not {cfg.head_dim}")
    if cfg.num_attention_heads % cfg.num_key_value_heads:
        raise ValueError("num_attention_heads must be a multiple of "
                         "num_key_value_heads")


class Int8Dense(nn.Module):
    """Inference-only projection with int8-resident weights on kernel B5:
    ``q`` int8 ``[in, out]`` and the per-output-channel float32 ``scale``
    (buffers, so they sit in the state dict), output in ``dtype``. Made from
    a float checkpoint by ``quant.to_int8_runtime_params``; construction
    only fixes shapes (``q`` zeros, ``scale`` ones, as the JAX init)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("q", torch.zeros(in_features, features,
                                              dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.q, self.scale, out_dtype=self.dtype)


def logical_axes(name: str) -> tuple:
    """The logical axes of the llama parameter ``name`` (torch layout)."""
    *path, leaf = name.split(".")
    if leaf in _LEAF_AXES:
        return _LEAF_AXES[leaf]
    if leaf == "weight" and path and path[-1] in _WEIGHT_AXES:
        return _WEIGHT_AXES[path[-1]]
    if leaf == "weight" and path and path[-1].endswith("norm"):
        return ("norm",)
    raise KeyError(f"no logical axes for {name!r} (int8 weights take no "
                   f"mesh)")


def mesh_shardings(model, rules=LOGICAL_RULES) -> dict:
    """Parameter name → the mesh axis (or None, replicated) of each of its
    dimensions, from the logical axes by ``rules``: the port of the JAX
    package's ``mesh_shardings`` (its ``PartitionSpec``s, for the torch
    layout; an axis is named whatever its size). ``model`` is a llama
    module or its state dict."""
    rule = dict(rules)
    names = model.keys() if isinstance(model, dict) else [
        n for n, _ in model.named_parameters()]
    return {n: tuple(rule[a] for a in logical_axes(n)) for n in names}


def _shard(t: torch.Tensor, spec: tuple, mesh, name: str) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.axes[axis] > 1:
            block = mesh.block(t.shape[dim], axis, name)
            t = t.narrow(dim, block.start, block.stop - block.start)
    return t


def shard_state(state: dict, mesh, rules=LOGICAL_RULES) -> dict:
    """This rank's shard of every tensor of a full llama state dict (the
    shards a sharded model of the same names loads)."""
    specs = mesh_shardings(state, rules)
    return {n: _shard(t, specs[n], mesh, n).clone() for n, t in state.items()}


@torch.no_grad()
def gather_state(state: dict, mesh, rules=LOGICAL_RULES) -> dict:
    """The whole tensors of a sharded llama state dict: each entry
    gathered over the axes that split it (every rank of the mesh calls
    this, in one order, and every rank gets the whole state). The inverse
    of :func:`shard_state`."""
    specs = mesh_shardings(state, rules)
    out = {}
    for name, t in state.items():
        for dim, axis in enumerate(specs[name]):
            if axis is not None and mesh.axes[axis] > 1:
                t = comm.all_gather(t, mesh.groups[axis], dim)
        out[name] = t
    return out


class _Shards:
    """What the sharded modules read of a mesh: each axis's size, this
    rank's place on it and the group of its line."""

    def __init__(self, mesh):
        missing = [a for a, n in mesh.axes.items()
                   if n > 1 and a not in mesh.groups]
        if missing:
            raise ValueError(f"mesh axes {missing} need one process per "
                             f"device (a mesh over a process group)")
        self.mesh = mesh
        self.size = dict(mesh.axes)
        self.coord = mesh.coords
        self.groups = dict(mesh.groups)

    def split(self, length: int, axis: str, what: str) -> int:
        """This rank's share of ``length`` split over ``axis``."""
        block = self.mesh.block(length, axis, what)
        return block.stop - block.start

    def gather(self, x: torch.Tensor, axis: str, dim: int,
               grad: str = "slice") -> torch.Tensor:
        return comm.all_gather(x, self.groups.get(axis), dim, grad)

    def reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return comm.all_reduce(x, self.groups.get(axis))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel block: its gradient is summed
        over ``tp``."""
        return comm.copy(x, self.groups.get("tp"))

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """``[b_loc, s_loc, ...]`` blocks back to ``[b, s, ...]``."""
        return self.gather(self.gather(x, "sp", 1), "dp", 0)


class _F32MM(torch.autograd.Function):
    """``x @ wᵀ`` of bf16 operands on the card, summed and returned in
    float32; the backward's products take the operands' type, as the
    unsharded bf16 projection's do."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g2, w).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(g2.t(), x.reshape(-1, x.shape[-1]))
        return dx, dw


def _f32_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ`` summed and returned in float32 (bf16 operands: their
    exact products, float32 sums)."""
    if x.dtype == torch.float32:
        return torch.nn.functional.linear(x, w)
    if x.is_cuda:
        return _F32MM.apply(x, w)
    return torch.nn.functional.linear(x.to(torch.float32),
                                      w.to(torch.float32))


class ShardedLinear(nn.Module):
    """A bias-free projection whose ``weight`` ``[out, in]`` is this rank's
    shard. Column-parallel (``row=False``, spec ``(tp, fsdp)``): the output
    keeps its ``tp`` split. Row-parallel (``row=True``, spec ``(fsdp,
    tp)``): the input comes split over ``tp`` and the partial products are
    summed over ``tp`` in float32, then rounded to the input's type once.
    The ``fsdp`` split is gathered before each use."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 shards: _Shards, row: bool = False):
        super().__init__()
        self.shards, self.row = shards, row
        if row:
            shape = (shards.split(features, "fsdp", "out features"),
                     shards.split(in_features, "tp", "in features"))
        else:
            shape = (shards.split(features, "tp", "out features"),
                     shards.split(in_features, "fsdp", "in features"))
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.row:
            w = self.shards.gather(self.weight, "fsdp", 0)
            return self.shards.reduce(_f32_linear(x, w), "tp").to(x.dtype)
        w = self.shards.gather(self.weight, "fsdp", 1)
        return torch.nn.functional.linear(x, w)


class ShardedEmbedding(nn.Module):
    """The token table ``[vocab, hidden]``, this rank's rows (``tp``) and
    columns (``fsdp``): a token outside this rank's rows looks up zeros,
    and the sum over ``tp`` (one nonzero row each, exact) is the lookup."""

    def __init__(self, vocab: int, hidden: int, dtype: torch.dtype,
                 shards: _Shards):
        super().__init__()
        self.shards = shards
        self.weight = nn.Parameter(torch.empty(
            shards.split(vocab, "tp", "the vocabulary"),
            shards.split(hidden, "fsdp", "the hidden width"), dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        w = self.shards.gather(self.weight, "fsdp", 1)
        rows = w.shape[0]
        local = ids - self.shards.coord["tp"] * rows
        inside = (local >= 0) & (local < rows)
        x = torch.nn.functional.embedding(local.clamp(0, rows - 1), w)
        x = torch.where(inside[..., None], x, torch.zeros_like(x))
        if self.shards.size["tp"] == 1:
            return x
        return self.shards.reduce(x.to(torch.float32), "tp").to(w.dtype)


class ShardedLoRA(nn.Module):
    """A LoRA adapter over a sharded projection: ``lora_a`` ``[in, rank]``
    split over ``fsdp`` (gathered at use), ``lora_b`` ``[rank, features]``
    over ``tp`` (this rank's output columns, as its projection's). Each
    ``tp`` rank uses the whole ``lora_a`` for its own columns, so its
    gradient is summed over ``tp`` (``comm.copy``)."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float, dtype: torch.dtype, shards: _Shards):
        super().__init__()
        self.shards, self.rank, self.alpha, self.dtype = (shards, rank,
                                                          alpha, dtype)
        self.lora_a = nn.Parameter(torch.empty(
            shards.split(in_features, "fsdp", "in features"), rank))
        self.lora_b = nn.Parameter(torch.zeros(
            rank, shards.split(features, "tp", "features")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.shards.copy(self.shards.gather(self.lora_a, "fsdp", 0))
        y = (x.to(self.dtype) @ a.to(self.dtype)) @ self.lora_b.to(self.dtype)
        return y * (self.alpha / self.rank)


def _dense(in_features: int, features: int, dtype: torch.dtype,
           int8: bool, shards: _Shards | None = None,
           row: bool = False) -> nn.Module:
    if int8:
        return Int8Dense(in_features, features, dtype)
    if shards is not None:
        return ShardedLinear(in_features, features, dtype, shards, row)
    return nn.Linear(in_features, features, bias=False, dtype=dtype)


def _lora(in_features: int, features: int, cfg: LlamaConfig,
          shards: _Shards | None) -> nn.Module:
    if shards is not None:
        return ShardedLoRA(in_features, features, cfg.lora_rank,
                           cfg.lora_alpha, cfg.torch_dtype, shards)
    return LoRAAdapter(in_features, features, cfg.lora_rank, cfg.lora_alpha,
                       dtype=cfg.torch_dtype)


class RMSNorm(nn.Module):
    """LLaMA RMSNorm: float32 variance, a float32 learned scale."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (self.weight * y.to(self.dtype)).to(self.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer ``positions`` [..., s] -> cos/sin
    [..., s, d/2], float32: the float32 angles of the JAX package, their
    cos and sin taken in float64 and rounded once. (torch's float32 cos on
    the CPU returned values up to 1.5e-4 off on one worker thread's share
    of the table in about 1 process in 60, which moved every LoRA gradient
    by 1e-4 to 5e-4 of its largest; the float64 functions are exact to
    float32's last bit on every device.)"""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    angles = (positions.to(torch.float32)[..., None] * inv_freq).double()
    return (torch.cos(angles).to(torch.float32),
            torch.sin(angles).to(torch.float32))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """HF llama rotary convention: rotate_half over a [d/2, d/2] split, in
    float32, cast back to ``x``'s type. x: [b, s, h, d]; cos/sin:
    [b, s, d/2]."""
    d2 = x.shape[-1] // 2
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :d2], xf[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """The decode cache: per layer, keys and values ``[b, max_len, h_kv,
    d]`` in the model's type and the validity of each slot ``[b, max_len]``
    (False for left padding and for slots not written yet); ``pos`` is the
    next slot to write. A decode call writes its tokens at ``pos`` and
    advances it, in place, and returns the cache."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    valid: list[torch.Tensor]
    pos: int = 0

    @classmethod
    def empty(cls, cfg: LlamaConfig, batch: int, max_len: int,
              device=None) -> "KVCache":
        """A zero cache of ``max_len`` slots for ``batch`` rows."""
        dev = resolve_device(device)
        shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        n = cfg.num_hidden_layers
        return cls(
            k=[torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
               for _ in range(n)],
            v=[torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
               for _ in range(n)],
            valid=[torch.zeros(batch, max_len, dtype=torch.bool, device=dev)
                   for _ in range(n)])

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.k, *self.v, *self.valid))


def _decode_attend(q, k, v, step_valid, cache: KVCache, layer: int):
    """Write this step's keys, values and validity at ``cache.pos`` and
    attend over every written, valid slot: causal by slot index, so a
    several-token step sees its own earlier tokens and not its later ones
    (``_decode_attend`` of the JAX package, for its one-token steps)."""
    b, s = q.shape[:2]
    pos = cache.pos
    if pos + s > cache.max_len:
        raise ValueError(f"decode: {pos + s} tokens overflow a cache of "
                         f"{cache.max_len} slots")
    cache.k[layer][:, pos:pos + s] = k
    cache.v[layer][:, pos:pos + s] = v
    cache.valid[layer][:, pos:pos + s] = (
        True if step_valid is None else step_valid.bool())
    slots = torch.arange(cache.max_len, device=q.device)
    return full_attention(q, cache.k[layer], cache.v[layer], causal=True,
                          kv_mask=cache.valid[layer],
                          q_positions=slots[pos:pos + s], kv_positions=slots)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, shards: _Shards | None = None):
        super().__init__()
        self.cfg, self.shards = cfg, shards
        h, h_kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        # this rank's heads: each tp rank holds whole query heads and their
        # key/value heads
        self.heads = (h, h_kv) if shards is None else (
            shards.split(h, "tp", "the attention heads"),
            shards.split(h_kv, "tp", "the key/value heads"))
        dt, i8 = cfg.torch_dtype, cfg.int8_runtime
        self.q_proj = _dense(cfg.hidden_size, h * d, dt, i8, shards)
        self.k_proj = _dense(cfg.hidden_size, h_kv * d, dt, i8, shards)
        self.v_proj = _dense(cfg.hidden_size, h_kv * d, dt, i8, shards)
        self.o_proj = _dense(h * d, cfg.hidden_size, dt, i8, shards,
                             row=True)
        if cfg.lora_rank > 0:
            self.lora_q = _lora(cfg.hidden_size, h * d, cfg, shards)
            self.lora_v = _lora(cfg.hidden_size, h_kv * d, cfg, shards)

    def forward(self, x, attn_mask, cos, sin, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        cfg, sh = self.cfg, self.shards
        (h, h_kv), d = self.heads, cfg.head_dim
        b, s, _ = x.shape
        if sh is not None:
            x = sh.copy(x)
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        if cfg.lora_rank > 0:
            q = q + self.lora_q(x)
            v = v + self.lora_v(x)
        q = apply_rope(q.reshape(b, s, h, d), cos, sin)
        k = apply_rope(k.reshape(b, s, h_kv, d), cos, sin)
        v = v.reshape(b, s, h_kv, d)
        if cache is not None:
            out = _decode_attend(q, k, v, attn_mask, cache, layer)
        elif cfg.attn_impl == "ring":
            out = ring_attention(q, k, v, group=sh.groups.get("sp"),
                                 causal=True, kv_mask=attn_mask)
        elif sh is not None and sh.size["sp"] > 1:
            out = _gathered_attention(q, k, v, attn_mask, sh)
        elif cfg.attn_impl == "flash" and s % 128 == 0:
            out = flash_attention(q, k, v, attn_mask, causal=True)
        else:  # "full", and "flash" off the kernel's block multiple
            out = full_attention(q, k, v, causal=True, kv_mask=attn_mask)
        return self.o_proj(out.reshape(b, s, h * d))


def _gathered_attention(q, k, v, attn_mask, sh: _Shards) -> torch.Tensor:
    """``"full"`` over a sequence split over ``sp``: this
    rank's queries against the keys and values gathered from the group,
    causal by global position. Each rank attends with its own queries, so
    the keys' and values' gradients are summed over ``sp``."""
    k, v = sh.gather(k, "sp", 1, "sum"), sh.gather(v, "sp", 1, "sum")
    if attn_mask is not None:
        attn_mask = sh.gather(attn_mask.to(torch.uint8), "sp", 1).bool()
    s_loc = q.shape[1]
    q_pos = sh.coord["sp"] * s_loc + torch.arange(s_loc, device=q.device)
    return full_attention(q, k, v, causal=True, kv_mask=attn_mask,
                          q_positions=q_pos)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, shards: _Shards | None = None):
        super().__init__()
        dt, i8 = cfg.torch_dtype, cfg.int8_runtime
        hid, mid = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(hid, mid, dt, i8, shards)
        self.up_proj = _dense(hid, mid, dt, i8, shards)
        self.down_proj = _dense(mid, hid, dt, i8, shards, row=True)
        self.shards = shards

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shards is not None:
            x = self.shards.copy(x)
        g = self.gate_proj(x)
        # silu as the JAX package computes it, x * sigmoid(x): in bf16 each
        # op rounds, where F.silu would round once
        return self.down_proj(g * torch.sigmoid(g) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, shards: _Shards | None = None):
        super().__init__()
        dt = cfg.torch_dtype
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.self_attn = Attention(cfg, shards)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, dt)
        self.mlp = MLP(cfg, shards)

    def forward(self, x, attn_mask, cos, sin, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), attn_mask, cos, sin,
                               cache, layer)
        return x + self.mlp(self.post_attention_layernorm(x))


def _remat(layer, x, attn_mask, cos, sin) -> torch.Tensor:
    """``layer`` recomputed whole in the backward: torch's early stop left
    out other projections on the card than on the CPU."""
    with set_checkpoint_early_stop(False):
        return checkpoint(layer, x, attn_mask, cos, sin, use_reentrant=False)


class LlamaModel(nn.Module):
    """Decoder stack -> final-norm hidden states [b, s, hidden] in
    ``cfg.dtype`` (what the fusion head reads); with ``decode=True``,
    ``(hidden states, cache)``. ``mesh``: run sharded over it (module
    docstring)."""

    def __init__(self, cfg: LlamaConfig, mesh=None):
        super().__init__()
        _check_config(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.shards = sh = None if mesh is None else _Shards(mesh)
        if sh is None:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                             dtype=cfg.torch_dtype)
        else:
            self.embed_tokens = ShardedEmbedding(
                cfg.vocab_size, cfg.hidden_size, cfg.torch_dtype, sh)
        self.layers = nn.ModuleList(DecoderLayer(cfg, sh)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            cfg.torch_dtype)

    def sharded_hidden(self, input_ids: torch.Tensor,
                       attn_mask: torch.Tensor | None = None,
                       positions: torch.Tensor | None = None
                       ) -> torch.Tensor:
        """This rank's block ``[b/dp, s/sp, hidden]`` of the final hidden
        states of a sharded model (whole inputs in). Under grad, the
        backward runs through the collectives; ``remat`` recomputes each
        layer, its collectives included."""
        sh = self.shards
        b, s = input_ids.shape
        rows = sh.mesh.block(b, "dp", "the batch")
        cols = sh.mesh.block(s, "sp", "the sequence")
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        cos, sin = rope_cos_sin(positions[rows, cols], self.cfg.head_dim,
                                self.cfg.rope_theta)
        mask = None if attn_mask is None else attn_mask[rows, cols]
        x = self.embed_tokens(input_ids[rows, cols])
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = _remat(layer, x, mask, cos, sin) if remat else layer(
                x, mask, cos, sin)
        return self.norm(x)

    def forward(self, input_ids: torch.Tensor,
                attn_mask: torch.Tensor | None = None,
                positions: torch.Tensor | None = None,
                decode: bool = False, cache: KVCache | None = None):
        """Without ``decode``, hidden states of the whole sequence. With
        ``decode``, ``input_ids`` ``[b, s]`` are the next ``s`` tokens,
        ``attn_mask`` ``[b, s]`` their validity, and ``cache`` is written
        at its ``pos`` (positions default to ``pos ..``); returns
        ``(hidden states, cache)``."""
        if self.shards is not None:
            if decode:
                raise ValueError("decode runs on one device: a sharded "
                                 "model scores whole sequences")
            return self.shards.gather_tokens(
                self.sharded_hidden(input_ids, attn_mask, positions))
        if decode and cache is None:
            raise ValueError("decode=True takes the cache to read and write "
                             "(KVCache.empty(cfg, batch, max_len))")
        if positions is None:
            start = cache.pos if decode else 0
            positions = torch.arange(
                start, start + input_ids.shape[1],
                device=input_ids.device).expand(input_ids.shape)
        cos, sin = rope_cos_sin(positions, self.cfg.head_dim,
                                self.cfg.rope_theta)
        x = self.embed_tokens(input_ids)
        remat = self.cfg.remat and torch.is_grad_enabled() and not decode
        for i, layer in enumerate(self.layers):
            if remat:
                x = _remat(layer, x, attn_mask, cos, sin)
            else:
                x = layer(x, attn_mask, cos, sin, cache if decode else None,
                          i)
        if decode:
            cache.pos += input_ids.shape[1]
            return self.norm(x), cache
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """The LM head on top, logits in float32 (with ``decode=True``,
    ``(logits, cache)``)."""

    def __init__(self, cfg: LlamaConfig, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.model = LlamaModel(cfg, mesh)
        self.lm_head = _dense(cfg.hidden_size, cfg.vocab_size,
                              cfg.torch_dtype, cfg.int8_runtime,
                              self.model.shards)

    def sharded_logits(self, input_ids, attn_mask=None,
                       positions=None) -> torch.Tensor:
        """This rank's block ``[b/dp, s/sp, vocab]`` of a sharded model's
        float32 logits: the vocabulary-parallel logits of its tokens,
        gathered over ``tp``."""
        sh = self.model.shards
        hidden = self.model.sharded_hidden(input_ids, attn_mask, positions)
        logits = self.lm_head(sh.copy(hidden))
        return sh.gather(logits, "tp", -1).to(torch.float32)

    def forward(self, input_ids, attn_mask=None, positions=None,
                decode=False, cache: KVCache | None = None):
        sh = self.model.shards
        if sh is not None and not decode:
            return sh.gather_tokens(self.sharded_logits(input_ids, attn_mask,
                                                        positions))
        if decode:
            hidden, cache = self.model(input_ids, attn_mask, positions, True,
                                       cache)
            return self.lm_head(hidden).to(torch.float32), cache
        hidden = self.model(input_ids, attn_mask, positions)
        return self.lm_head(hidden).to(torch.float32)


@torch.no_grad()
def init_llama_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise ``model`` in place from ``seed`` with the JAX package's
    initialisers in distribution, drawn on the model's device by a
    ``torch.Generator`` there: projections lecun-normal (a normal of
    variance 1/fan_in truncated at two deviations), the embedding
    N(0, 0.02²), norms at one, LoRA ``A`` N(0, 1/rank) and ``B`` zero,
    int8 weights zero with scales at one. Draws are float32, then cast to
    the parameter's type. A sharded model draws each whole tensor, one at a
    time, and keeps its shard: the unsharded model's values. Returns the
    model."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    mesh = getattr(model, "mesh", None)
    specs = {} if mesh is None else mesh_shardings(model)

    def drawn(name, t, draw):
        spec = specs.get(name, ())
        shape = tuple(n * (mesh.axes[a] if a is not None else 1)
                      for n, a in zip(t.shape, spec)) or tuple(t.shape)
        w = draw(torch.empty(shape, device=dev))
        return w if not spec else _shard(w, spec, mesh, name)

    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("norm.weight"):
            t.fill_(1.0)
        elif name.endswith("embed_tokens.weight"):
            t.copy_(drawn(name, t, lambda w: w.normal_(0.0, 0.02,
                                                        generator=gen)))
        elif leaf == "weight":  # a projection [out, in]

            def lecun(w):
                std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
                return nn.init.trunc_normal_(w, std=std, a=-2 * std,
                                             b=2 * std, generator=gen)

            t.copy_(drawn(name, t, lecun))
        elif leaf == "lora_a":
            t.copy_(drawn(name, t, lambda w: w.normal_(
                0.0, w.shape[1] ** -0.5, generator=gen)))
        elif leaf in ("lora_b", "q"):
            t.zero_()
        elif leaf == "scale":
            t.fill_(1.0)
        else:
            raise KeyError(f"init_llama_params: no initialiser for {name}")
    return model


def build_llama(cfg: LlamaConfig, device=None, seed: int | None = 0,
                cls: type = LlamaModel, mesh=None) -> nn.Module:
    """``cls(cfg)`` allocated straight on ``device`` (``cuda`` unless the
    caller names another; no host copy of the weights is made) and, unless
    ``seed`` is None, initialised there by :func:`init_llama_params`. With
    ``seed=None`` the weights are left unset, for a state dict to load
    (through :func:`shard_state` for a sharded one). ``mesh``: this rank's
    shards of ``cls(cfg, mesh=mesh)``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = cls(cfg) if mesh is None else cls(cfg, mesh=mesh)
    model = model.to_empty(device=dev)
    if seed is not None:
        init_llama_params(model, seed)
    return model.eval()
