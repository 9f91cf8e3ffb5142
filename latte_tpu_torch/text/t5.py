"""The frozen T5 text encoder of the T2V pipeline (port of
``latte_tpu/text/t5.py``, which wraps transformers' ``FlaxT5EncoderModel``).

:class:`T5EncoderModel` is T5's encoder stack in plain PyTorch with Hugging
Face's state-dict names (``shared``, ``encoder.block.{i}.layer.0.SelfAttention
.{q,k,v,o}``, ``relative_attention_bias`` in block 0 alone,
``layer.0.layer_norm``, ``layer.1.DenseReluDense.{wi_0,wi_1,wo}`` (gated) or
``{wi,wo}``, ``layer.1.layer_norm``, ``encoder.final_layer_norm``), so a
reference checkpoint loads by name. It computes as the Flax model does:

- The relative position bias is computed once, from block 0's table, and
  every layer adds it. The buckets are bidirectional (half of them for each
  sign): exact below ``num_buckets / 4``, logarithmic up to
  ``max_distance``; they are computed on the host in float64, which gives
  Flax's float32 buckets to the bit at every distance a 300-token input
  has (``tests/test_torch_text.py``).
- Attention has no 1/sqrt(d) scale. The padding mask is an additive
  ``finfo(float32).min`` on the fp32 logits, so a row whose keys are all
  masked is Flax's uniform row, not NaN. It is plain torch: T5's attention
  is no Pallas kernel in the JAX package either, and it takes an additive
  bias and no scale, which the flash kernel does not.
- The RMS norm takes its variance in fp32, subtracts no mean and has no
  bias; its output is fp32 (Flax multiplies by an fp32 weight), and the
  projections after it cast to the model's type. The last norm's output,
  the features, is fp32.
- Gated-gelu is ``gelu_new`` (the tanh approximation) times the linear
  branch.

The model computes in the type of its parameters: ``.to(torch.bfloat16)``
holds and runs bf16 weights (the JAX wrapper keeps fp32 parameters and
computes in bf16; the port's bf16 is held to it by the VAE's rule in the
tests).

:class:`T5TextEncoder` is the JAX wrapper's interface: ``tokenize``,
``encode`` and ``encode_with_negative`` (captions cleaned by
:func:`latte_tpu_torch.text.preprocess.text_preprocessing`, padded to
``max_length`` 120), returning tensors on the model's device, and
``from_pretrained(path, dtype, device)``, which reads ``config.json``, the
weights (``model.safetensors``, the sharded ``model-*-of-*.safetensors``
with ``model.safetensors.index.json``, or ``pytorch_model.bin`` and its
shards) and ``spiece.model`` from one directory, as the JAX
``from_pretrained(path)`` does. The weights go to the device one shard at a
time, straight into the model's type.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.models.layers import _Fp32Scales
from latte_tpu_torch.text.preprocess import text_preprocessing
from latte_tpu_torch.vae.autoencoder_kl import Linear

__all__ = ["T5Config", "T5EncoderModel", "T5TextEncoder", "relative_position_bucket"]


@dataclasses.dataclass
class T5Config:
    """The encoder's part of Hugging Face's ``T5Config``; the defaults are
    T5 v1.1-XXL's."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    initializer_factor: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "T5Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "T5Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def dense_act_fn(self) -> str:
        act = self.feed_forward_proj.split("-")[-1]
        # Hugging Face maps gated-gelu to the tanh approximation
        return "gelu_new" if self.feed_forward_proj == "gated-gelu" else act


_ACTS = {
    "relu": F.relu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 buckets of ``memory - query`` positions (int64)."""
    num_buckets //= 2
    buckets = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(n.astype(np.float64) / max_exact) / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)
        )
    large = np.minimum(np.where(n < max_exact, 0, large).astype(np.int64), num_buckets - 1)
    return buckets + np.where(n < max_exact, n, large)


class T5LayerNorm(_Fp32Scales):
    """RMS norm: fp32 variance, no mean, no bias; fp32 output. Its weight
    stays fp32 when the model is cast, as Flax keeps it."""

    FP32_BUFFERS = ("weight",)

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return self.weight.float() * (x32 / torch.sqrt(var + self.eps))


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False):
        super().__init__()
        self.n_heads, self.d_kv = config.num_heads, config.d_kv
        inner = config.num_heads * config.d_kv
        self.q = Linear(config.d_model, inner, bias=False)
        self.k = Linear(config.d_model, inner, bias=False)
        self.v = Linear(config.d_model, inner, bias=False)
        self.o = Linear(inner, config.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(config.relative_attention_num_buckets, config.num_heads)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x (B, L, D); bias (B|1, H, L, L) fp32, added to the logits."""
        B, L = x.shape[:2]

        def heads(t):
            return t.view(B, L, self.n_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, self.n_heads * self.d_kv)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False):
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x + self.SelfAttention(self.layer_norm(x).to(x.dtype), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.wi = Linear(config.d_model, config.d_ff, bias=False)
        self.wo = Linear(config.d_ff, config.d_model, bias=False)
        self.act = _ACTS[config.dense_act_fn]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.wi_0 = Linear(config.d_model, config.d_ff, bias=False)
        self.wi_1 = Linear(config.d_model, config.d_ff, bias=False)
        self.wo = Linear(config.d_ff, config.d_model, bias=False)
        self.act = _ACTS[config.dense_act_fn]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.DenseReluDense = (T5DenseGatedActDense if config.is_gated_act else T5DenseActDense)(config)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DenseReluDense(self.layer_norm(x).to(x.dtype))


class T5Block(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(config, has_relative_attention_bias), T5LayerFF(config)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(config, i == 0) for i in range(config.num_layers)])
        self.final_layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """T5's encoder: ``(input_ids (B, L), attention_mask (B, L)) ->
    last_hidden_state (B, L, d_model)``, fp32."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Hugging Face's T5 init (``T5PreTrainedModel._init_weights``) at
        ``initializer_factor``: N(0, f) embeddings, q at (d_model·d_kv)^-1/2,
        k, v and the bias table at d_model^-1/2, o at (heads·d_kv)^-1/2, wi
        at d_model^-1/2, wo at d_ff^-1/2, norm weights f."""
        c, f = self.config, self.config.initializer_factor
        nn.init.normal_(self.shared.weight, std=f, generator=generator)
        for blk in self.encoder.block:
            attn = blk.layer[0].SelfAttention
            nn.init.normal_(attn.q.weight, std=f * (c.d_model * c.d_kv) ** -0.5, generator=generator)
            for lin in (attn.k, attn.v):
                nn.init.normal_(lin.weight, std=f * c.d_model**-0.5, generator=generator)
            nn.init.normal_(attn.o.weight, std=f * (c.num_heads * c.d_kv) ** -0.5, generator=generator)
            if hasattr(attn, "relative_attention_bias"):
                nn.init.normal_(attn.relative_attention_bias.weight, std=f * c.d_model**-0.5, generator=generator)
            ff = blk.layer[1].DenseReluDense
            for name in ("wi", "wi_0", "wi_1"):
                if hasattr(ff, name):
                    nn.init.normal_(getattr(ff, name).weight, std=f * c.d_model**-0.5, generator=generator)
            nn.init.normal_(ff.wo.weight, std=f * c.d_ff**-0.5, generator=generator)
        for m in self.modules():
            if isinstance(m, T5LayerNorm):
                m.weight.fill_(f)

    def position_bias(self, length: int) -> torch.Tensor:
        """(1, H, L, L) fp32: block 0's table at the (query, key) buckets."""
        pos = np.arange(length)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.config.relative_attention_num_buckets,
                                           self.config.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(table.device)
        return table.float()[idx].permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        L = input_ids.shape[1]
        bias = self.position_bias(L)
        if attention_mask is not None:
            keep = attention_mask[:, None, None, :].to(bias.device) > 0
            bias = bias + torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        h = self.shared(input_ids.to(self.shared.weight.device))
        for blk in self.encoder.block:
            h = blk(h, bias)
        return self.encoder.final_layer_norm(h)


class T5TextEncoder:
    """The JAX wrapper's interface over a :class:`T5EncoderModel` and a
    tokenizer with the Hugging Face call signature (the port's
    :class:`latte_tpu_torch.text.spiece.T5Tokenizer`, or any such)."""

    def __init__(self, model: T5EncoderModel, tokenizer, max_length: int = 120):
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length

    @property
    def device(self) -> torch.device:
        return self.model.shared.weight.device

    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 120, dtype: torch.dtype = torch.bfloat16,
                        device: Union[str, torch.device] = "cuda") -> "T5TextEncoder":
        """The encoder of a Hugging Face T5 directory (``config.json``, the
        weights, ``spiece.model``) on ``device`` in ``dtype``. A checkpoint
        of the whole T5 loads too: its decoder and ``lm_head`` are skipped."""
        from latte_tpu_torch.convert import load_hf_weights
        from latte_tpu_torch.text.spiece import T5Tokenizer

        config = T5Config.from_json(os.path.join(path, "config.json"))
        with torch.device("meta"):
            model = T5EncoderModel(config)
        model = model.to(dtype).to_empty(device=device)
        load_hf_weights(model, path, rename={"encoder.embed_tokens.weight": "shared.weight"},
                        skip=("decoder.", "lm_head."))
        return cls(model, T5Tokenizer.from_pretrained(path), max_length=max_length)

    def tokenize(self, prompts: Sequence[str], clean: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        prompts = [text_preprocessing(p, clean=clean) for p in prompts]
        enc = self.tokenizer(list(prompts), padding="max_length", max_length=self.max_length,
                             truncation=True, add_special_tokens=True, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    @torch.inference_mode()
    def encode(self, prompts: Union[str, Sequence[str]], clean: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts -> (features (B, L, D) fp32, mask (B, L) int64), on the
        model's device."""
        if isinstance(prompts, str):
            prompts = [prompts]
        ids, mask = self.tokenize(prompts, clean=clean)
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        mask = torch.as_tensor(np.asarray(mask, np.int64), device=self.device)
        return self.model(ids, mask), mask

    def encode_with_negative(self, prompts: Union[str, Sequence[str]], negative_prompt: str = "",
                             clean: bool = True):
        """(cond, cond_mask, uncond, uncond_mask): the prompts and the
        negative prompt once per prompt, cleaned with the same flag."""
        if isinstance(prompts, str):
            prompts = [prompts]
        cond, cond_mask = self.encode(prompts, clean=clean)
        uncond, uncond_mask = self.encode([negative_prompt] * len(prompts), clean=clean)
        return cond, cond_mask, uncond, uncond_mask
