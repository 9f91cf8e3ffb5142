"""T5's SentencePiece tokenizer in plain Python: the port's own copy of what
``transformers.AutoTokenizer`` does for a T5 checkpoint (the JAX wrapper's
tokenizer, ``latte_tpu/text/t5.py:52-55, 62-74``). The machine with the card
has neither ``transformers``, ``sentencepiece`` nor ``tokenizers``.

- :func:`read_model_proto` reads a ``spiece.model`` (protobuf wire format,
  ``sentencepiece_model.proto``): ``ModelProto.pieces`` (piece, score, type),
  the trainer spec's model type and the normalizer spec's flags.
- :class:`SentencePieceUnigram` segments text as SentencePiece's unigram
  model does: whitespace removal (leading, trailing, runs of spaces), the
  dummy prefix, spaces escaped as ``▁``, then the Viterbi path of the
  highest total piece score; a character no piece covers becomes ``<unk>``
  at the smallest normal score minus 10 (SentencePiece's unknown penalty),
  and runs of unknowns fuse into one ``<unk>``. Ties keep the path found
  first, as SentencePiece and ``tokenizers`` do.
- :class:`T5Tokenizer` adds T5's post-processing with the call signature
  ``T5TextEncoder.tokenize`` uses: ``</s>`` (id 1) appended, truncation to
  ``max_length`` that keeps the ``</s>``, padding with ``<pad>`` (id 0) to
  ``max_length``, and the attention mask.

Known gap: T5's ``spiece.model`` normalizes with a precompiled character
map (``nmt_nfkc``); this reader applies ``unicodedata``'s NFKC in its place
(and a case fold for the ``*_cf`` rules), which agrees on text NFKC leaves
alone. The extra ids ``<extra_id_*>`` that Hugging Face appends to T5's
vocabulary are not split out of the text. Pieces of type ``USER_DEFINED``
and byte fallback raise ``NotImplementedError`` (T5's model has neither).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["read_model_proto", "SentencePieceUnigram", "T5Tokenizer"]

# SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM = 1  # TrainerSpec.ModelType
UNK_PENALTY = 10.0
SPACE = "▁"  # ▁


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message: an int
    for varints, bytes for length-delimited fields and fixed-width ones."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"spiece.model: unsupported protobuf wire type {wire}")
        yield field, wire, value


def read_model_proto(data: bytes) -> dict:
    """A serialized ``ModelProto`` -> ``{"pieces": [(piece, score, type)],
    "model_type", "byte_fallback", "normalizer": {"name",
    "precompiled_charsmap", "add_dummy_prefix", "remove_extra_whitespaces",
    "escape_whitespaces"}}`` with the proto's defaults where a field is
    absent."""
    pieces, model_type, byte_fallback = [], UNIGRAM, False
    norm = dict(name="", precompiled_charsmap=b"", add_dummy_prefix=True,
                remove_extra_whitespaces=True, escape_whitespaces=True)
    for field, _, value in _fields(data):
        if field == 1:  # SentencePiece
            piece, score, kind = "", 0.0, NORMAL
            for f, _, v in _fields(value):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2:
                    score = struct.unpack("<f", v)[0]
                elif f == 3:
                    kind = v
            pieces.append((piece, score, kind))
        elif field == 2:  # TrainerSpec
            for f, _, v in _fields(value):
                if f == 3:
                    model_type = v
                elif f == 35:
                    byte_fallback = bool(v)
        elif field == 3:  # NormalizerSpec
            for f, _, v in _fields(value):
                if f == 1:
                    norm["name"] = v.decode("utf-8")
                elif f == 2:
                    norm["precompiled_charsmap"] = bytes(v)
                elif f == 3:
                    norm["add_dummy_prefix"] = bool(v)
                elif f == 4:
                    norm["remove_extra_whitespaces"] = bool(v)
                elif f == 5:
                    norm["escape_whitespaces"] = bool(v)
    return dict(pieces=pieces, model_type=model_type, byte_fallback=byte_fallback, normalizer=norm)


class SentencePieceUnigram:
    """A unigram ``spiece.model``: ``encode(text) -> ids``."""

    def __init__(self, proto: dict):
        if proto["model_type"] != UNIGRAM:
            raise NotImplementedError(f"spiece.model of model type {proto['model_type']}: only unigram (1)")
        if proto["byte_fallback"]:
            raise NotImplementedError("spiece.model with byte_fallback")
        self.pieces = [p for p, _, _ in proto["pieces"]]
        self.normalizer = proto["normalizer"]
        self.vocab: Dict[str, Tuple[int, float]] = {}
        self.unk_id: Optional[int] = None
        normal_scores = []
        for i, (piece, score, kind) in enumerate(proto["pieces"]):
            if kind == NORMAL:
                self.vocab[piece] = (i, score)
                normal_scores.append(score)
            elif kind == UNKNOWN:
                self.unk_id = i
            elif kind == USER_DEFINED:
                raise NotImplementedError(f"spiece.model piece {piece!r} is USER_DEFINED")
        if self.unk_id is None:
            raise ValueError("spiece.model has no piece of type UNKNOWN")
        self.unk_score = min(normal_scores, default=0.0) - UNK_PENALTY
        self.max_len = max((len(p) for p in self.vocab), default=1)

    def piece_to_id(self, piece: str) -> int:
        return self.pieces.index(piece)

    def normalize(self, text: str) -> str:
        spec = self.normalizer
        name = spec["name"]
        if spec["precompiled_charsmap"] or "nfkc" in name:
            text = unicodedata.normalize("NFKC", text)
            if name.endswith("_cf"):
                text = text.casefold()
        if spec["remove_extra_whitespaces"]:
            text = " ".join(w for w in text.split(" ") if w)
        if not text:
            return ""
        if spec["add_dummy_prefix"]:
            text = " " + text
        if spec["escape_whitespaces"]:
            text = text.replace(" ", SPACE)
        return text

    def encode(self, text: str) -> List[int]:
        """The ids of the best segmentation of ``normalize(text)``."""
        s = self.normalize(text)
        n = len(s)
        # best[e] = (score of the best path to position e, its last piece's start, id)
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)
        best[0] = (0.0, -1, -1)
        for start in range(n):
            base = best[start][0]
            single = False
            for length in range(1, min(self.max_len, n - start) + 1):
                hit = self.vocab.get(s[start:start + length])
                if hit is None:
                    continue
                single |= length == 1
                score = base + hit[1]
                end = start + length
                if best[end] is None or score > best[end][0]:
                    best[end] = (score, start, hit[0])
            if not single:
                score = base + self.unk_score
                if best[start + 1] is None or score > best[start + 1][0]:
                    best[start + 1] = (score, start, self.unk_id)
        ids: List[int] = []
        end = n
        while end > 0:
            _, start, pid = best[end]
            ids.append(pid)
            end = start
        ids.reverse()
        fused = []  # runs of unknowns fuse into one
        for pid in ids:
            if not (pid == self.unk_id and fused and fused[-1] == self.unk_id):
                fused.append(pid)
        return fused


class T5Tokenizer:
    """T5's tokenizer over a :class:`SentencePieceUnigram`, callable with
    the Hugging Face signature that ``T5TextEncoder.tokenize`` uses:
    ``tok(texts, padding="max_length", max_length=120, truncation=True,
    add_special_tokens=True, return_tensors="np")`` -> ``{"input_ids",
    "attention_mask"}``, int64 arrays of (B, max_length)."""

    def __init__(self, sp: SentencePieceUnigram, eos_token: str = "</s>", pad_token: str = "<pad>"):
        self.sp = sp
        self.eos_token_id = sp.piece_to_id(eos_token)
        self.pad_token_id = sp.piece_to_id(pad_token)

    @classmethod
    def from_pretrained(cls, folder: str) -> "T5Tokenizer":
        """The ``spiece.model`` of a Hugging Face T5 directory."""
        import os

        with open(os.path.join(folder, "spiece.model"), "rb") as f:
            return cls(SentencePieceUnigram(read_model_proto(f.read())))

    def __call__(self, texts: Sequence[str], padding="max_length", max_length: int = 120,
                 truncation: bool = True, add_special_tokens: bool = True, return_tensors: str = "np"):
        if padding != "max_length" or return_tensors != "np":
            raise ValueError(f"padding={padding!r}, return_tensors={return_tensors!r}: the port's "
                             "tokenizer pads to max_length and returns numpy")
        rows = []
        for text in texts:
            ids = self.sp.encode(text)
            if truncation:
                ids = ids[: max_length - int(add_special_tokens)]
            rows.append(ids + ([self.eos_token_id] if add_special_tokens else []))
        ids = np.full((len(rows), max_length), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), max_length), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}
