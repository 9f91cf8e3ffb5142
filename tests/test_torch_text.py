"""The port's text encoders (latte_tpu_torch/text) against the JAX
package's (latte_tpu/text, which wraps transformers' Flax models) on the
CPU: caption cleaning, the SentencePiece reader, T5 and CLIP at tiny sizes,
and the wrappers.

Tolerances: caption cleaning and token ids exact; the relative position
buckets to the bit; fp32 models within 1e-5 relative L2 and 1e-4 of the
largest magnitude elementwise (``close``); bf16 T5 by the VAE's rule
(``check_bf16``: within 5e-2 of the Flax model computing in bf16, and its
error against Flax fp32 at most 1.25x that model's own + 1e-3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    check_bf16,
    close,
    hf_unigram_tokenizer,
    randomize,
    spiece_model_bytes,
    spiece_pieces,
)

from latte_tpu.text import T5TextEncoder as JaxT5TextEncoder
from latte_tpu.text.clip import FrozenCLIPEmbedder as JaxFrozenCLIPEmbedder
from latte_tpu.text.clip import TextEmbedder as JaxTextEmbedder
from latte_tpu.utils import clean_caption as jax_clean_caption
from latte_tpu_torch.convert import flax_clip_to_state_dict, flax_t5_to_state_dict
from latte_tpu_torch.text import (
    CLIPTextConfig,
    CLIPTextModel,
    FrozenCLIPEmbedder,
    SentencePieceUnigram,
    T5Config,
    T5EncoderModel,
    T5TextEncoder,
    T5Tokenizer,
    TextEmbedder,
    clean_caption,
)
from latte_tpu_torch.text.spiece import read_model_proto
from latte_tpu_torch.text.t5 import relative_position_bucket
from tests.test_text import FakeTokenizer

REL, ELEM = 1e-5, 1e-4
T5_TINY = dict(vocab_size=100, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=2)
CLIP_TINY = dict(vocab_size=100, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2, max_position_embeddings=12)


# ---- caption cleaning ---------------------------------------------------------

CAPTIONS = [
    "A Beautiful SUNSET over the Beach!!",
    "check https://example.com/a/b?c=1 and www.site.org now",
    "Tom &amp; Jerry &quot;cartoon&quot; &lt;b&gt;bold&lt;/b&gt;",
    "一只猫 a cat 在 the garden 中",
    "dash — en – minus − and hyphen-ated ‐ words",
    "«quoted» “curly” ‘single’ `tick` text",
    "@user posted #123 photo.jpg at 12:30  ",
    "  multiple   spaces\tand\\nnewlines... end.",
    "'a dog jumping over fences'",
    "id 1234567 and file IMG_0001.png and <person> walking",
]


@pytest.mark.parametrize("caption", CAPTIONS, ids=range(len(CAPTIONS)))
def test_clean_caption_equals_jax(caption):
    assert clean_caption(caption) == jax_clean_caption(caption)


# ---- the SentencePiece reader ------------------------------------------------

PIECES = spiece_pieces()
TEXTS = [
    "a cat walking on the beach",
    "A Dog Jumping Over Fences!",
    "the   sunset  is    beautiful",  # runs of spaces (clean=False keeps them)
    "quiz zzz the qqq cat: xyz",  # characters no piece covers
    "héllo wörld 猫 cat",
    "",
    " ".join(["the beautiful sunset"] * 60),  # truncated to 119 pieces + </s>
    "the sunset is beautiful. 12, 345 red cars in the city at night",
]


@pytest.fixture(scope="module")
def tiny_t5():
    """A tiny Flax T5 encoder (gated-gelu) with N(0, 0.2²) params."""
    from transformers import FlaxT5EncoderModel
    from transformers import T5Config as HFT5Config

    model = FlaxT5EncoderModel(HFT5Config(**T5_TINY, feed_forward_proj="gated-gelu"), seed=0)
    return model, randomize(model.params, seed=1)


@pytest.fixture(scope="module")
def tokenizers_pair(tmp_path_factory):
    """The port's tokenizer from a written spiece.model, and ``tokenizers``'
    Unigram on the same pieces and scores."""
    folder = tmp_path_factory.mktemp("spiece")
    (folder / "spiece.model").write_bytes(spiece_model_bytes(PIECES))
    return T5Tokenizer.from_pretrained(str(folder)), hf_unigram_tokenizer(PIECES)


def test_model_proto_reads_back():
    proto = read_model_proto(spiece_model_bytes(PIECES))
    assert proto["pieces"] == PIECES
    assert proto["normalizer"]["name"] == "nmt_nfkc" and proto["normalizer"]["add_dummy_prefix"]
    sp = SentencePieceUnigram(proto)
    assert sp.unk_id == 2 and sp.unk_score == min(s for _, s, k in PIECES if k == 1) - 10.0


@pytest.mark.parametrize("clean", [True, False], ids=["clean", "raw"])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_tokenize_equals_tokenizers_unigram(tiny_t5, tokenizers_pair, text, clean):
    """Ids and masks at max_length 120, through both wrappers' ``tokenize``
    (the JAX one calling ``tokenizers``' Unigram), exact."""
    ours, theirs = tokenizers_pair
    model, params = tiny_t5
    jax_enc = JaxT5TextEncoder(model, params, theirs, max_length=120)
    enc = T5TextEncoder(T5EncoderModel(T5Config(**T5_TINY)), ours, max_length=120)
    want_ids, want_mask = jax_enc.tokenize([text], clean=clean)
    ids, mask = enc.tokenize([text], clean=clean)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    if len(text) > 500:  # truncation keeps the </s>
        assert mask.sum() == 120 and ids[0, -1] == 1
    if "q" in text:
        assert 2 in ids  # <unk>


# ---- T5 ------------------------------------------------------------------------


@pytest.mark.parametrize("length", [12, 120, 300])
def test_relative_position_buckets_equal_flax(length):
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    pos = np.arange(length)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(FlaxT5Attention._relative_position_bucket(jnp.asarray(rel, jnp.int32)))
    np.testing.assert_array_equal(relative_position_bucket(rel), want)


def _t5_pair(act, dtype=jnp.float32, seed=1):
    from transformers import FlaxT5EncoderModel
    from transformers import T5Config as HFT5Config

    jm = FlaxT5EncoderModel(HFT5Config(**T5_TINY, feed_forward_proj=act), seed=0, dtype=dtype)
    params = randomize(jm.params, seed=seed)
    model = T5EncoderModel(T5Config(**T5_TINY, feed_forward_proj=act))
    model.load_state_dict(flax_t5_to_state_dict(params), strict=True)
    return jm, params, model.eval()


def _ids_and_mask(B=3, L=10, seed=2):
    """Random ids; rows: partly masked, all zero (a stub-style empty
    negative), full."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, T5_TINY["vocab_size"], (B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.int32)
    mask[0, :6] = 1
    mask[2] = 1
    return ids, mask


@pytest.mark.parametrize("act", ["gated-gelu", "relu"])
def test_t5_matches_flax(act):
    jm, params, model = _t5_pair(act)
    ids, mask = _ids_and_mask()
    want = jm.module.apply({"params": params}, input_ids=jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask)).last_hidden_state
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    close(got, want, REL, ELEM)


def test_t5_bf16_by_the_vae_rule():
    """The port's bf16 T5 (bf16 weights, fp32 norms and logits) against
    Flax computing in bf16 over fp32 params, as the JAX wrapper does."""
    jm16, params, model = _t5_pair("gated-gelu", dtype=jnp.bfloat16)
    jm32, _, _ = _t5_pair("gated-gelu")
    ids, mask = _ids_and_mask()
    kw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    want16 = np.asarray(jm16.module.apply({"params": params}, **kw).last_hidden_state, np.float32)
    want32 = np.asarray(jm32.module.apply({"params": params}, **kw).last_hidden_state)
    model.to(torch.bfloat16)
    assert model.encoder.final_layer_norm.weight.dtype == torch.float32
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    check_bf16(got, want16, want32)


def test_t5_text_encoder_matches_the_jax_wrapper(tiny_t5):
    """``encode`` and ``encode_with_negative`` with tests/test_text.py's
    FakeTokenizer on both sides (captions cleaned; the empty negative is a
    fully masked row)."""
    model, params = tiny_t5
    jax_enc = JaxT5TextEncoder(model, params, FakeTokenizer(), max_length=12)
    port = T5EncoderModel(T5Config(**T5_TINY))
    port.load_state_dict(flax_t5_to_state_dict(params), strict=True)
    enc = T5TextEncoder(port, FakeTokenizer(), max_length=12)
    prompts = ["A Cat", "a dog jumping over fences"]
    want, want_mask = jax_enc.encode(prompts)
    got, mask = enc.encode(prompts)
    close(got, want, REL, ELEM)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    for g, w in zip(enc.encode_with_negative(prompts, ""), jax_enc.encode_with_negative(prompts, "")):
        close(g.float(), np.asarray(w, np.float32), REL, ELEM) if g.is_floating_point() else \
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _save_t5_dir(path, params, config: dict, files: str):
    """A Hugging Face T5 directory: config.json, spiece.model and the
    weights as one safetensors file, two bf16 shards with their index, a
    pytorch_model.bin of the whole T5 (tied embed_tokens, a decoder key), or
    two .bin shards with their index (the layout of the T5 v1.1-XXL
    checkpoints Latte's reference uses)."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "spiece.model"), "wb") as f:
        f.write(spiece_model_bytes(PIECES))
    sd = flax_t5_to_state_dict(params)
    if files == "single":
        save_file(sd, os.path.join(path, "model.safetensors"))
    elif files == "sharded":
        keys = sorted(sd)
        halves = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
                  "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
        for name, ks in halves.items():
            save_file({k: sd[k].to(torch.bfloat16) for k in ks}, os.path.join(path, name))
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {k: n for n, ks in halves.items() for k in ks}}, f)
    elif files == "bin":
        full = dict(sd, **{"encoder.embed_tokens.weight": sd["shared.weight"],
                           "decoder.final_layer_norm.weight": torch.ones(16)})
        torch.save(full, os.path.join(path, "pytorch_model.bin"))
    else:
        keys = sorted(sd)
        halves = {"pytorch_model-00001-of-00002.bin": keys[::2], "pytorch_model-00002-of-00002.bin": keys[1::2]}
        for name, ks in halves.items():
            torch.save({k: sd[k] for k in ks}, os.path.join(path, name))
        with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
            json.dump({"weight_map": {k: n for n, ks in halves.items() for k in ks}}, f)
    return sd


@pytest.mark.parametrize("files", ["single", "sharded", "bin", "bin_sharded"])
def test_t5_from_pretrained(tiny_t5, tmp_path, files):
    """``from_pretrained`` reads config.json, the weights (in the asked
    type, bf16 shards converted as they load) and spiece.model."""
    _, params = tiny_t5
    cfg = dict(T5_TINY, feed_forward_proj="gated-gelu", model_type="t5", d_model=16)
    sd = _save_t5_dir(tmp_path, params, cfg, files)
    enc = T5TextEncoder.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    got = enc.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        want = v.to(torch.bfloat16).float() if files == "sharded" else v
        assert torch.equal(got[k], want), k
    assert isinstance(enc.tokenizer, T5Tokenizer)
    feats, mask = enc.encode(["a cat"])
    assert feats.shape == (1, 120, 16) and mask.sum() == 3  # ▁a ▁cat </s>


def test_t5_from_pretrained_refuses_unknown_keys(tiny_t5, tmp_path):
    from safetensors.torch import save_file

    _, params = tiny_t5
    sd = _save_t5_dir(tmp_path, params, dict(T5_TINY, feed_forward_proj="gated-gelu"), "single")
    save_file(dict(sd, **{"encoder.block.0.extra.weight": torch.ones(2)}), str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="does not have"):
        T5TextEncoder.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    del sd["encoder.final_layer_norm.weight"]
    save_file(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="final_layer_norm"):
        T5TextEncoder.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")


# ---- CLIP ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_clip():
    from transformers import CLIPTextConfig as HFCLIPTextConfig
    from transformers import FlaxCLIPTextModel

    jm = FlaxCLIPTextModel(HFCLIPTextConfig(**CLIP_TINY), seed=0)
    params = randomize(jm.params, seed=3)
    model = CLIPTextModel(CLIPTextConfig(**CLIP_TINY))
    model.load_state_dict(flax_clip_to_state_dict(params), strict=True)
    return jm, params, model.eval()


def test_clip_matches_flax(tiny_clip):
    """Causal and padding masks combined (a partly masked row, an all-zero
    row, a full row), quick_gelu, the final LayerNorm."""
    jm, params, model = tiny_clip
    ids, mask = _ids_and_mask(L=12, seed=4)
    pos = jnp.broadcast_to(jnp.arange(12)[None], ids.shape)
    want = jm.module.apply({"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           position_ids=pos).last_hidden_state
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    close(got, want, REL, ELEM)


def test_frozen_clip_and_text_embedder_match_jax(tiny_clip):
    """``FrozenCLIPEmbedder.encode`` against the JAX embedder with the
    FakeTokenizer, and ``TextEmbedder``'s drops: the same prompts dropped
    for the same seed, and ``force_drop_ids``."""
    jm, params, model = tiny_clip
    jax_emb = JaxFrozenCLIPEmbedder(jm, params, FakeTokenizer(), max_length=12)
    emb = FrozenCLIPEmbedder(model, FakeTokenizer(), max_length=12)
    prompts = ["a cat", "a dog jumping over fences", ""]
    close(emb.encode(prompts), jax_emb.encode(prompts), REL, ELEM)
    jte, te = JaxTextEmbedder(jax_emb, dropout_prob=0.5, seed=3), TextEmbedder(emb, dropout_prob=0.5, seed=3)
    many = [f"prompt {i}" for i in range(40)]
    assert te.token_drop(list(many)) == jte.token_drop(list(many))
    close(te(prompts, train=True), jte(prompts, train=True), REL, ELEM)
    force = np.array([1, 0, 1])
    close(te(prompts, force_drop_ids=force), jte(prompts, force_drop_ids=force), REL, ELEM)


def test_clip_from_pretrained(tiny_clip, tmp_path):
    """config.json (a whole CLIPConfig's text_config) and model.safetensors
    with the vision tower's keys skipped; no tokenizer: NotImplementedError
    naming the BPE vocabulary."""
    from safetensors.torch import save_file

    _, params, model = tiny_clip
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"text_config": CLIP_TINY, "vision_config": {}}, f)
    sd = flax_clip_to_state_dict(params)
    save_file(dict(sd, **{"vision_model.post_layernorm.weight": torch.ones(3), "logit_scale": torch.ones(())}),
              str(tmp_path / "model.safetensors"))
    with pytest.raises(NotImplementedError, match="vocab.json"):
        FrozenCLIPEmbedder.from_pretrained(str(tmp_path), device="cpu")
    emb = FrozenCLIPEmbedder.from_pretrained(str(tmp_path), tokenizer=FakeTokenizer(), max_length=12, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(emb.model.state_dict()[k], v), k
