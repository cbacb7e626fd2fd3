"""RoBERTa-family bidirectional encoder (CodeBERT): the LineVul side of
BASELINE config #3.

The port of ``deepdfa_tpu/llm/roberta.py``:

- :class:`RobertaConfig` (HF ``RobertaConfig`` field parity),
  :func:`codebert_base` (``microsoft/codebert-base`` shapes) and
  :func:`tiny_roberta`;
- :func:`roberta_position_ids`: real tokens count up from
  ``pad_token_id + 1`` and pads sit at ``pad_token_id``, driven by the
  explicit pad mask, so the framework's left padding works;
- :class:`RobertaEncoder`: embeddings (word + position + token type 0,
  LayerNorm, dropout) and ``num_hidden_layers`` post-LN blocks, returning
  the final hidden states ``[b, s, h]``, the contract of
  :class:`~deepdfa_tpu_torch.llm.llama.LlamaModel`, so the joint trainer
  drives either stack (the fusion head reads the CLS row, ``pool="cls"``);
- :func:`convert_hf_roberta`: an HF RoBERTa / CodeBERT state dict (bare or
  ``roberta.``-prefixed, as LineVul publishes it) for the encoder.

Numerics follow the JAX package: parameters are float32 and cast to
``cfg.dtype`` at each use (Flax's ``dtype`` on a float32 parameter), every
LayerNorm computes in float32 with Flax's statistics (``E[x²] - E[x]²``),
attention scores are float32 with a -1e9 bias on padded keys (plain einsum
and softmax, as the JAX package computes them; no fused attention), and
GELU is the exact erf form. Dropout (the HF rates, 0.1) is on only in
``train()`` mode; it draws from torch's generator, which the joint trainer
seeds for each step.

Parameter names are HF's (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ...), so conversion
renames nothing, and :mod:`deepdfa_tpu_torch.bridge` carries the JAX
package's Flax tree across (``roberta_flax_to_torch``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch import resolve_device

__all__ = ["RobertaConfig", "RobertaEncoder", "build_roberta",
           "codebert_base", "convert_hf_roberta", "init_roberta_params",
           "roberta_position_ids", "tiny_roberta"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    """HF ``RobertaConfig`` field parity where the names overlap (an HF
    ``config.json`` reads through :meth:`from_hf_dict`)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    # HF's training regularisation (LineVul fine-tunes CodeBERT with these):
    # applied only in train() mode
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    dtype: str = "float32"

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
    def from_hf_dict(cls, d: dict) -> "RobertaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def codebert_base(**kw) -> RobertaConfig:
    """microsoft/codebert-base shapes (RoBERTa-base, the LineVul
    encoder)."""
    return RobertaConfig(**kw)


def tiny_roberta(**kw) -> RobertaConfig:
    """Test-size config."""
    defaults = dict(vocab_size=320, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=260)
    defaults.update(kw)
    return RobertaConfig(**defaults)


def roberta_position_ids(pad_mask: torch.Tensor,
                         pad_token_id: int) -> torch.Tensor:
    """Real tokens count up from ``pad_token_id + 1`` in sequence order;
    pads sit at ``pad_token_id`` (HF's ``create_position_ids_from_input_
    ids``, driven by the mask: pads share the eos id, so values cannot tell
    them)."""
    m = pad_mask.to(torch.long)
    return torch.cumsum(m, dim=1) * m + pad_token_id


class _Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _LayerNorm(nn.Module):
    """Flax's ``LayerNorm`` in float32: ``var = E[x²] - E[x]²`` (clipped
    at 0), ``(x - mean) · rsqrt(var + eps) · weight + bias``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class _SelfAttention(nn.Module):
    """``attention.self``: Q/K/V projections and the bidirectional masked
    softmax, scores in float32."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.torch_dtype
        self.query = _Dense(h, h, dt)
        self.key = _Dense(h, h, dt)
        self.value = _Dense(h, h, dt)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x: torch.Tensor,
                pad_mask: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = cfg.num_attention_heads, cfg.head_dim
        q = self.query(x).reshape(b, s, h, d)
        k = self.key(x).reshape(b, s, h, d)
        v = self.value(x).reshape(b, s, h, d)
        # pads are masked on the key axis only: a pad query row is never
        # read (the head pools the CLS row)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        scores = scores / math.sqrt(d)
        if pad_mask is not None:
            bias = torch.where(pad_mask[:, None, None, :].bool(), 0.0, -1e9)
            scores = scores + bias
        probs = self.dropout(torch.softmax(scores, dim=-1).to(
            cfg.torch_dtype))
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * d)


class _Output(nn.Module):
    """``dense → dropout → LayerNorm(· + residual)``: ``attention.output``
    and the block's ``output``."""

    def __init__(self, cfg: RobertaConfig, in_features: int):
        super().__init__()
        self.dtype = cfg.torch_dtype
        self.dense = _Dense(in_features, cfg.hidden_size, cfg.torch_dtype)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.LayerNorm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, y: torch.Tensor,
                residual: torch.Tensor) -> torch.Tensor:
        y = self.dropout(self.dense(y))
        return self.LayerNorm(y + residual).to(self.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _Output(cfg, cfg.hidden_size)

    def forward(self, x, pad_mask):
        return self.output(self.self(x, pad_mask), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = _Dense(cfg.hidden_size, cfg.intermediate_size,
                            cfg.torch_dtype)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")  # HF's "gelu"


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _Output(cfg, cfg.intermediate_size)

    def forward(self, x, pad_mask):
        x = self.attention(x, pad_mask)
        return self.output(self.intermediate(x), x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dtype = cfg.torch_dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, positions):
        dt = self.dtype
        x = F.embedding(input_ids, self.word_embeddings.weight.to(dt))
        x = x + F.embedding(positions, self.position_embeddings.weight.to(dt))
        # token type 0 everywhere (RoBERTa never uses segment B)
        x = x + self.token_type_embeddings.weight[0].to(dt)
        return self.dropout(self.LayerNorm(x).to(dt))


class _Layers(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class RobertaEncoder(nn.Module):
    """Embeddings + ``num_hidden_layers`` post-LN blocks → final hidden
    states ``[b, s, h]`` in ``cfg.dtype``. ``pad_mask`` ``[b, s]`` (True =
    real token) masks padded keys and places the positions."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        cfg.torch_dtype  # noqa: B018 — validates the name
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, input_ids: torch.Tensor,
                pad_mask: torch.Tensor | None = None,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            if pad_mask is None:
                positions = (torch.arange(input_ids.shape[1],
                                          device=input_ids.device)
                             .expand(input_ids.shape) + cfg.pad_token_id + 1)
            else:
                positions = roberta_position_ids(pad_mask, cfg.pad_token_id)
        x = self.embeddings(input_ids, positions)
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x


@torch.no_grad()
def init_roberta_params(model: RobertaEncoder, seed: int = 0
                        ) -> RobertaEncoder:
    """Initialise ``model`` in place from ``seed`` with the JAX package's
    initialisers in distribution (drawn by a ``torch.Generator`` on the
    model's device): dense weights lecun-normal (a normal of variance
    1/fan_in truncated at two deviations) and biases zero, embeddings
    N(0, 0.02²), LayerNorms at one and zero. Returns the model."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, t in model.named_parameters():
        if "LayerNorm" in name:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif "_embeddings" in name:
            t.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("bias"):
            t.zero_()
        else:  # a dense weight [out, in]
            std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
    return model


def build_roberta(cfg: RobertaConfig, device=None,
                  seed: int | None = 0) -> RobertaEncoder:
    """A :class:`RobertaEncoder` allocated on ``device`` (``cuda`` unless
    the caller names another) and, unless ``seed`` is None, initialised
    there by :func:`init_roberta_params`. In eval mode."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RobertaEncoder(cfg)
    model = model.to_empty(device=dev)
    if seed is not None:
        init_roberta_params(model, seed)
    return model.eval()


_SKIPPED = ("pooler", "classifier", "lm_head", "qa_outputs")


def convert_hf_roberta(state_dict: dict) -> dict:
    """An HF RoBERTa / CodeBERT state dict for :class:`RobertaEncoder`:
    bare ``RobertaModel`` names or ``roberta.``-prefixed classifier ones;
    the pooler, classifier and LM heads are dropped (the fusion head
    classifies), and so are buffers (``position_ids``, ``token_type_ids``:
    recomputed). Values are float32."""
    names = {n for n, _ in RobertaEncoder(tiny_roberta(num_hidden_layers=1))
             .named_parameters()}
    suffixes = {n.split(".", 3)[-1] if n.startswith("encoder.") else n
                for n in names}
    out = {}
    for name, t in state_dict.items():
        name = name.removeprefix("roberta.")
        if name.split(".")[0] in _SKIPPED:
            continue
        key = name.split(".", 3)[-1] if name.startswith("encoder.") else name
        if key not in suffixes:
            continue
        out[name] = torch.as_tensor(t).detach().to("cpu", torch.float32)
    return out
