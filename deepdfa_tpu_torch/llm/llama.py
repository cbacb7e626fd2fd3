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

Not ported yet: ``attn_impl="ring"`` (multi-GPU, ROADMAP A11b), which raises
``NotImplementedError``, and ``mesh_shardings``.
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
from deepdfa_tpu_torch.ops.ring_attention import full_attention

__all__ = ["Attention", "DecoderLayer", "Int8Dense", "KVCache", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "MLP", "RMSNorm", "apply_rope",
           "build_llama", "codellama_13b", "codellama_7b", "init_llama_params",
           "rope_cos_sin", "tiny_llama"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def _check_config(cfg: LlamaConfig) -> None:
    cfg.torch_dtype  # noqa: B018 — validates the name
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (sequence-sharded ring attention) is not "
            "ported yet: it needs several GPUs (ROADMAP A11b)")
    if cfg.attn_impl not in ("full", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} (full | "
                         f"flash | ring)")
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


def _dense(in_features: int, features: int, dtype: torch.dtype,
           int8: bool) -> nn.Module:
    if int8:
        return Int8Dense(in_features, features, dtype)
    return nn.Linear(in_features, features, bias=False, dtype=dtype)


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
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, h_kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        dt, i8 = cfg.torch_dtype, cfg.int8_runtime
        self.q_proj = _dense(cfg.hidden_size, h * d, dt, i8)
        self.k_proj = _dense(cfg.hidden_size, h_kv * d, dt, i8)
        self.v_proj = _dense(cfg.hidden_size, h_kv * d, dt, i8)
        self.o_proj = _dense(h * d, cfg.hidden_size, dt, i8)
        if cfg.lora_rank > 0:
            self.lora_q = LoRAAdapter(cfg.hidden_size, h * d, cfg.lora_rank,
                                      cfg.lora_alpha, dtype=dt)
            self.lora_v = LoRAAdapter(cfg.hidden_size, h_kv * d,
                                      cfg.lora_rank, cfg.lora_alpha, dtype=dt)

    def forward(self, x, attn_mask, cos, sin, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        cfg = self.cfg
        h, h_kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        b, s, _ = x.shape
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
        elif cfg.attn_impl == "flash" and s % 128 == 0:
            out = flash_attention(q, k, v, attn_mask, causal=True)
        else:  # "full", and "flash" off the kernel's block multiple
            out = full_attention(q, k, v, causal=True, kv_mask=attn_mask)
        return self.o_proj(out.reshape(b, s, h * d))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        dt, i8 = cfg.torch_dtype, cfg.int8_runtime
        self.gate_proj = _dense(cfg.hidden_size, cfg.intermediate_size, dt, i8)
        self.up_proj = _dense(cfg.hidden_size, cfg.intermediate_size, dt, i8)
        self.down_proj = _dense(cfg.intermediate_size, cfg.hidden_size, dt, i8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate_proj(x)
        # silu as the JAX package computes it, x * sigmoid(x): in bf16 each
        # op rounds, where F.silu would round once
        return self.down_proj(g * torch.sigmoid(g) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        dt = cfg.torch_dtype
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, dt)
        self.mlp = MLP(cfg)

    def forward(self, x, attn_mask, cos, sin, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), attn_mask, cos, sin,
                               cache, layer)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """Decoder stack -> final-norm hidden states [b, s, hidden] in
    ``cfg.dtype`` (what the fusion head reads); with ``decode=True``,
    ``(hidden states, cache)``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.torch_dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            cfg.torch_dtype)

    def forward(self, input_ids: torch.Tensor,
                attn_mask: torch.Tensor | None = None,
                positions: torch.Tensor | None = None,
                decode: bool = False, cache: KVCache | None = None):
        """Without ``decode``, hidden states of the whole sequence. With
        ``decode``, ``input_ids`` ``[b, s]`` are the next ``s`` tokens,
        ``attn_mask`` ``[b, s]`` their validity, and ``cache`` is written
        at its ``pos`` (positions default to ``pos ..``); returns
        ``(hidden states, cache)``."""
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
                # the whole layer is recomputed: torch's early stop left
                # out other projections on the card than on the CPU
                with set_checkpoint_early_stop(False):
                    x = checkpoint(layer, x, attn_mask, cos, sin,
                                   use_reentrant=False)
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

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = _dense(cfg.hidden_size, cfg.vocab_size,
                              cfg.torch_dtype, cfg.int8_runtime)

    def forward(self, input_ids, attn_mask=None, positions=None,
                decode=False, cache: KVCache | None = None):
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
    the parameter's type. Returns the model."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("norm.weight"):
            t.fill_(1.0)
        elif name.endswith("embed_tokens.weight"):
            t.copy_(torch.empty(t.shape, device=dev).normal_(
                0.0, 0.02, generator=gen))
        elif leaf == "weight":  # an nn.Linear [out, in]
            std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
            w = torch.empty(t.shape, device=dev)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            t.copy_(w)
        elif leaf == "lora_a":
            t.copy_(torch.empty(t.shape, device=dev).normal_(
                0.0, t.shape[1] ** -0.5, generator=gen))
        elif leaf in ("lora_b", "q"):
            t.zero_()
        elif leaf == "scale":
            t.fill_(1.0)
        else:
            raise KeyError(f"init_llama_params: no initialiser for {name}")
    return model


def build_llama(cfg: LlamaConfig, device=None, seed: int | None = 0,
                cls: type = LlamaModel) -> nn.Module:
    """``cls(cfg)`` allocated straight on ``device`` (``cuda`` unless the
    caller names another; no host copy of the weights is made) and, unless
    ``seed`` is None, initialised there by :func:`init_llama_params`. With
    ``seed=None`` the weights are left unset, for a state dict to load."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device=dev)
    if seed is not None:
        init_llama_params(model, seed)
    return model.eval()
