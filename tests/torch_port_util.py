"""Shared helpers of the port's parity tests (tests/test_torch_*.py): random
Flax params from a numpy seed, and their carry-over into torch modules."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from latte_tpu_torch.convert import qkv_to_reference
from latte_tpu_torch.models.moe import MoEMlp

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def randomize(params, seed=0, std=0.2):
    """Replace every leaf with N(0, std²) noise from a numpy seed, so the
    zero-initialised adaLN and output layers carry signal too."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    new = [(std * rng.standard_normal(np.shape(x))).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, new)


def load_linear(lin: torch.nn.Linear, p) -> None:
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))


def load_qkv(lin: torch.nn.Linear, p, num_heads: int) -> None:
    w, b = qkv_to_reference(p["kernel"], p["bias"], num_heads)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))


def load_block(blk, p, num_heads: int) -> None:
    load_qkv(blk.attn.qkv, p["attn"]["qkv"], num_heads)
    load_linear(blk.attn.proj, p["attn"]["proj"])
    load_linear(blk.mlp.fc1, p["mlp"]["fc1"])
    load_linear(blk.mlp.fc2, p["mlp"]["fc2"])
    load_linear(blk.adaLN_modulation[1], p["adaLN_modulation"])


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(got, want, rel=1e-5, elem=1e-4):
    """``got`` within ``rel`` of ``want`` in relative L2 norm, and no element
    off by more than ``elem`` of ``want``'s largest magnitude."""
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rel, f"relative L2 error {err:.3g} > {rel:.3g}"
    np.testing.assert_allclose(got, want, rtol=0, atol=elem * np.abs(want).max())


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# A bf16 port against the JAX module in bf16, which rounds at other places:
# within BF16_REL / BF16_ELEM of it (``close``), and its error against the
# JAX module's fp32 result at most 1.25x the JAX bf16 result's own + 1e-3
BF16_REL, BF16_ELEM = 5e-2, 5e-2


def check_bf16(got, want_bf16, want_f32):
    got = got.float() if isinstance(got, torch.Tensor) else got
    close(got, want_bf16, BF16_REL, BF16_ELEM)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert rel_l2(got, want_f32) <= 1.25 * rel_l2(want_bf16, want_f32) + 1e-3


# The int8 attention against the Pallas int8 kernel: (relative L2, and an
# elementwise cap over the largest magnitude); tests/test_torch_int8_kernels.py
# says why.
INT8_TOL = {jnp.float32: (1e-5, 2e-3), jnp.bfloat16: (1e-3, 2.0**-7)}
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def qkv_views(B, N, H, D, dtype, offset=0):
    """(q, k, v) as views of one 16-byte aligned (B, N, 3, H, D) tensor of
    zeros, ``offset`` elements into its storage, as the model hands them
    over."""
    numel = B * N * 3 * H * D
    buf = torch.zeros(numel + 8 + offset, dtype=dtype)
    shift = (16 - buf.data_ptr() % 16) % 16 // buf.element_size() + offset
    return buf[shift:shift + numel].view(B, N, 3, H, D).unbind(2)


def int8_inputs(shape, dtype, seed):
    """q, k, v of ``shape`` (B, N, H, D) as JAX arrays in ``dtype`` and as
    torch tensors of the same values, and their per-head amax (fp32 numpy)
    shrunk by 10% so that some values clip at ±127."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype) for _ in range(3)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(TORCH_DTYPE[dtype]) for x in jx]
    amax = [(0.9 * np.abs(np.asarray(x, np.float32)).max(axis=(0, 1, 3))).astype(np.float32) for x in jx]
    return jx, tx, amax


def close_int8(got, want, dtype):
    """``close`` at INT8_TOL[dtype]. In fp32 the L2 limit holds over the rows
    that no rounding of P to int8 moved (each within 1e-5 of the largest
    magnitude), and at most 1% of the rows may be moved: where XLA's exp and
    torch's differ by an ulp at a p·127/p_max on a half-integer, P rounds to
    the neighbouring int8 value on one side, and one such row moves the
    relative L2 of a small case by ~3e-5 while staying inside the
    elementwise cap."""
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = got.double().numpy()
    rel, elem = INT8_TOL[dtype]
    if dtype == jnp.float32:
        moved = (np.abs(got - want) > 1e-5 * np.abs(want).max()).any(axis=-1)
        assert moved.mean() <= 0.01, f"{moved.sum()} of {moved.size} rows moved"
        close(np.where(moved[..., None], want, got), want, rel, elem)
    close(got, want, 1.0 if dtype == jnp.float32 else rel, elem)


def top_k_margin(probs, k) -> float:
    """The smallest gap between a token's j-th and (j+1)-th largest router
    probability over j < k: below fp32 rounding a choice could reorder."""
    p = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    k = min(k, p.shape[-1] - 1)
    return float((p[:, :k] - p[:, 1:k + 1]).min()) if k else float("inf")


class RouterMargins:
    """Context: prints the smallest top-k margin of the tokens that every
    port ``MoEMlp`` router call inside it saw (``MoEMlp.route`` patched), so
    a test records how near its inputs come to a routing flip."""

    def __init__(self, label: str):
        self.label, self.margins = label, []

    def __enter__(self):
        self.route = route = MoEMlp.route

        def recording(mod, xf):
            out = route(mod, xf)
            self.margins.append(top_k_margin(out[0].detach().float().numpy(), mod.top_k))
            return out

        MoEMlp.route = recording
        return self

    def __exit__(self, *exc):
        MoEMlp.route = self.route
        if self.margins:
            print(f"{self.label}: smallest top-k margin over {len(self.margins)} router calls "
                  f"{min(self.margins):.3e}")


# ---- a synthetic SentencePiece vocabulary -------------------------------------

SPIECE_CONTROL = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
# whole words, word starts, subwords and single characters; no piece for q, x,
# z, accented letters or CJK, which become <unk>. "▁" alone is a piece, as in
# T5's vocabulary, so a run of unknowns never spans a word boundary
SPIECE_WORDS = (
    "▁a ▁the ▁cat ▁cats ▁dog ▁dogs ▁is ▁on ▁in ▁of ▁and ▁sun ▁sunset ▁beautiful ▁beach ▁water "
    "▁walk ▁walking ▁jump ▁jumping ▁over ▁fence ▁fences ▁red ▁blue ▁car ▁city ▁night ▁light ▁ "
    "▁b ▁c ▁d ▁f ▁h ▁l ▁m ▁p ▁s ▁t ▁w ▁y ▁1 ▁2 ing ed er es ly s t n r l e a o i u "
    "b c d f g h j k m p v w y th he an in on at ▁wh ▁sh ch un re . , ! ? ' - : ; 0 1 2 3 4 5 6 7 8 9"
).split(" ")


def spiece_pieces(seed: int = 0):
    """(piece, score, type) rows of a small unigram vocabulary: <pad>,
    </s>, <unk>, then SPIECE_WORDS with negative scores from a numpy seed
    (longer pieces score higher, so that whole words win), rounded to fp32
    as the model file stores them."""
    rng = np.random.default_rng(seed)
    rows = list(SPIECE_CONTROL)
    for w in dict.fromkeys(w for w in SPIECE_WORDS if w):
        score = float(np.float32(-12.0 + 1.5 * len(w) - rng.uniform(0.0, 2.0)))
        rows.append((w, score, 1))
    return rows


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(field: int, wire: int, payload: bytes) -> bytes:
    key = _pb_varint((field << 3) | wire)
    if wire == 2:
        return key + _pb_varint(len(payload)) + payload
    return key + payload


def spiece_model_bytes(pieces, normalizer: str = "nmt_nfkc") -> bytes:
    """A serialized ModelProto: the pieces, a unigram TrainerSpec and a
    NormalizerSpec (``normalizer``, no precompiled map, the dummy prefix,
    whitespace removal and escaping on)."""
    import struct

    out = b""
    for piece, score, kind in pieces:
        msg = (_pb_field(1, 2, piece.encode("utf-8")) + _pb_field(2, 5, struct.pack("<f", score))
               + _pb_field(3, 0, _pb_varint(kind)))
        out += _pb_field(1, 2, msg)
    out += _pb_field(2, 2, _pb_field(3, 0, _pb_varint(1)))
    norm = (_pb_field(1, 2, normalizer.encode()) + _pb_field(3, 0, _pb_varint(1))
            + _pb_field(4, 0, _pb_varint(1)) + _pb_field(5, 0, _pb_varint(1)))
    return out + _pb_field(3, 2, norm)


def hf_unigram_tokenizer(pieces):
    """The same vocabulary through ``tokenizers``' Unigram (NFKC, strip,
    runs of spaces collapsed, a Metaspace pre-tokenizer that prepends ``▁``,
    ``</s>`` appended), wrapped in transformers' ``PreTrainedTokenizerFast``:
    the tokenizer the JAX ``T5TextEncoder.tokenize`` calls, built without a
    ``spiece.model`` reader."""
    from tokenizers import Regex, Tokenizer, normalizers, pre_tokenizers
    from tokenizers.models import Unigram
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(Unigram([(p, s) for p, s, _ in pieces], unk_id=2))
    tok.normalizer = normalizers.Sequence(
        [normalizers.NFKC(), normalizers.Strip(), normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    return PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>", pad_token="<pad>",
                                   unk_token="<unk>")
