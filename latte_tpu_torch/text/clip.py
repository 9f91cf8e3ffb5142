"""Frozen CLIP text embedder for the ``extras: 78`` conditioning (port of
``latte_tpu/text/clip.py``, which wraps transformers' ``FlaxCLIPTextModel``).

:class:`CLIPTextModel` is CLIP's text tower in plain PyTorch with Hugging
Face's state-dict names (``text_model.embeddings.{token,position}_embedding``,
``text_model.encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm1,
layer_norm2, mlp.fc1, mlp.fc2}``, ``text_model.final_layer_norm``); it returns
``last_hidden_state``. Position ids run 0..L-1. The causal mask is combined
with the padding mask into one additive ``finfo(float32).min`` on the fp32
logits (a row with every key masked is Flax's uniform row); the logits are
scaled by head_dim^-1/2, the MLP is fc1, ``quick_gelu`` (x·σ(1.702x)), fc2,
and every LayerNorm takes fp32 statistics. The defaults are ViT-L/14's text
tower (hidden 768, 12 layers of 12 heads, 77 positions, vocabulary 49408).

:class:`FrozenCLIPEmbedder` tokenizes to ``max_length`` (77) with a
tokenizer of the Hugging Face call signature and returns the (B, 77, 768)
features on the model's device; :class:`TextEmbedder` drops prompts to the
empty string for classifier-free guidance with ``random.Random(seed)``, as
the JAX one does. CLIP's BPE tokenizer (``vocab.json``, ``merges.txt``) is not
ported: no vocabulary is in the repo, so :meth:`FrozenCLIPEmbedder.from_pretrained`
needs the caller's tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.models.layers import _Fp32Scales
from latte_tpu_torch.vae.autoencoder_kl import Linear

__all__ = ["CLIPTextConfig", "CLIPTextModel", "FrozenCLIPEmbedder", "TextEmbedder"]


@dataclasses.dataclass
class CLIPTextConfig:
    """Hugging Face's ``CLIPTextConfig`` fields this model reads; the
    defaults are ViT-L/14's text tower."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    initializer_factor: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPTextConfig":
        d = d.get("text_config", d)  # a whole CLIPConfig holds the text tower's
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


_ACTS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


class LayerNorm(_Fp32Scales, nn.LayerNorm):
    """LayerNorm with fp32 statistics, output in the input's type; its
    weight and bias stay fp32 when the model is cast, as Flax keeps them."""

    FP32_BUFFERS = ("weight", "bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        d = config.hidden_size
        self.num_heads, self.head_dim = config.num_attention_heads, d // config.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape

        def heads(t):
            return t.view(B, L, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.matmul(q.float() / float(np.sqrt(np.float32(self.head_dim))),
                              k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D))


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.fc1 = Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = Linear(config.intermediate_size, config.hidden_size)
        self.act = _ACTS[config.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(config)
        self.layer_norm1 = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.mlp = CLIPMLP(config)
        self.layer_norm2 = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config) for _ in range(config.num_hidden_layers)])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_position_embeddings, config.hidden_size)


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """``(input_ids (B, L), attention_mask (B, L)) -> last_hidden_state
    (B, L, hidden)`` in the type of the parameters."""

    def __init__(self, config: Optional[CLIPTextConfig] = None):
        super().__init__()
        self.config = config = config or CLIPTextConfig()
        self.text_model = CLIPTextTransformer(config)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Hugging Face's CLIP text init: N(0, 0.02) embeddings; q, k, v and
        fc2 at hidden^-1/2 · (2·layers)^-1/2, out_proj at hidden^-1/2, fc1 at
        (2·hidden)^-1/2; zero biases, LayerNorms 1 and 0."""
        c, f = self.config, self.config.initializer_factor
        emb = self.text_model.embeddings
        for e in (emb.token_embedding, emb.position_embedding):
            nn.init.normal_(e.weight, std=0.02 * f, generator=generator)
        in_std = c.hidden_size**-0.5 * (2 * c.num_hidden_layers) ** -0.5 * f
        for layer in self.text_model.encoder.layers:
            a, m = layer.self_attn, layer.mlp
            for lin, std in ((a.q_proj, in_std), (a.k_proj, in_std), (a.v_proj, in_std),
                             (a.out_proj, c.hidden_size**-0.5 * f), (m.fc1, (2 * c.hidden_size) ** -0.5 * f),
                             (m.fc2, in_std)):
                nn.init.normal_(lin.weight, std=std, generator=generator)
                nn.init.zeros_(lin.bias)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tm = self.text_model
        device = tm.embeddings.token_embedding.weight.device
        input_ids = input_ids.to(device)
        L = input_ids.shape[1]
        pos = torch.arange(L, device=device)
        h = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)[None]
        keep = torch.ones(L, L, dtype=torch.bool, device=device).tril()[None, None]
        if attention_mask is not None:
            keep = keep & (attention_mask.to(device)[:, None, None, :] > 0)
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        for layer in tm.encoder.layers:
            h = layer(h, bias)
        return tm.final_layer_norm(h)


class FrozenCLIPEmbedder:
    """CLIP text features (B, ``max_length``, hidden) of prompts, on the
    model's device."""

    def __init__(self, model: CLIPTextModel, tokenizer, max_length: int = 77):
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, max_length: int = 77, dtype: torch.dtype = torch.float32,
                        device: Union[str, torch.device] = "cuda") -> "FrozenCLIPEmbedder":
        """The text tower of a Hugging Face CLIP directory (``config.json``
        and its weights) on ``device``; ``tokenizer`` is the caller's, with
        the Hugging Face call signature."""
        if tokenizer is None:
            raise NotImplementedError(
                "CLIP's BPE tokenizer is not ported: it waits for a vocabulary (vocab.json and "
                "merges.txt) in the repo; pass a tokenizer with the Hugging Face call signature"
            )
        from latte_tpu_torch.convert import load_hf_weights

        with open(os.path.join(path, "config.json")) as f:
            config = CLIPTextConfig.from_dict(json.load(f))
        with torch.device("meta"):
            model = CLIPTextModel(config)
        model = model.to(dtype).to_empty(device=device)
        load_hf_weights(model, path, skip=("vision_model.", "visual_projection.", "text_projection.",
                                           "logit_scale", "text_model.embeddings.position_ids"))
        return cls(model, tokenizer, max_length=max_length)

    @torch.inference_mode()
    def encode(self, prompts: Union[str, Sequence[str]]) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts]
        enc = self.tokenizer(list(prompts), truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        device = self.model.text_model.embeddings.token_embedding.weight.device
        ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64), device=device)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"], np.int64), device=device)
        return self.model(ids, mask)


class TextEmbedder:
    """Prompt embedding with CFG dropout: under ``train`` each prompt
    becomes "" with ``dropout_prob``, drawn from ``random.Random(seed)``;
    ``force_drop_ids`` (1 = drop) decides instead when given."""

    def __init__(self, encoder: FrozenCLIPEmbedder, dropout_prob: float = 0.1, seed: int = 0):
        self.encoder = encoder
        self.dropout_prob = dropout_prob
        self.rng = random.Random(seed)

    def token_drop(self, prompts: List[str], force_drop_ids: Optional[np.ndarray] = None) -> List[str]:
        if force_drop_ids is not None:
            return ["" if d == 1 else p for p, d in zip(prompts, force_drop_ids)]
        return ["" if self.rng.random() < self.dropout_prob else p for p in prompts]

    def __call__(self, prompts: Union[str, Sequence[str]], train: bool = False,
                 force_drop_ids: Optional[np.ndarray] = None) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts]
        prompts = list(prompts)
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            prompts = self.token_drop(prompts, force_drop_ids)
        return self.encoder.encode(prompts)
