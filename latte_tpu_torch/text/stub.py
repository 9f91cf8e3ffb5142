"""Hash-embedding caption stub: the port's own copy of the fallback encoder
of ``latte_tpu/sample/sample_t2x.py:107-126``.

Each whitespace-separated word of a prompt (at most ``max_length`` of them)
gets 0.02 · N(0, 1) features from numpy's ``default_rng`` seeded with
``zlib.crc32(word) % 2**31``, and mask 1; the rest of the row is zeros with
mask 0, so the empty negative prompt has a mask of all zeros. The
embeddings are numpy arrays made exactly as the JAX package makes them, so
both packages get them bit for bit. No vocabulary, no weights: it stands in
for T5 so the T2X path runs end to end.
"""

from __future__ import annotations

import zlib
from typing import Sequence, Tuple

import numpy as np


class StubTextEncoder:
    """``encode_with_negative`` returns numpy (features, mask) pairs for the
    prompts and for the negative prompt repeated per prompt."""

    def __init__(self, dim: int, max_length: int = 120):
        self.dim, self.max_length = dim, max_length

    def _embed(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        f = np.zeros((len(prompts), self.max_length, self.dim), np.float32)
        m = np.zeros((len(prompts), self.max_length), np.int32)
        for i, p in enumerate(prompts):
            for j, w in enumerate(p.split()[: self.max_length]):
                rng = np.random.default_rng(zlib.crc32(w.encode()) % 2**31)
                f[i, j] = rng.standard_normal(self.dim) * 0.02
                m[i, j] = 1
        return f, m

    def encode_with_negative(self, prompts: Sequence[str], negative_prompt: str = "", clean: bool = True):
        """(cond, cond_mask, uncond, uncond_mask); ``clean`` is accepted for
        the T5 encoder's interface and does nothing here."""
        c, cm = self._embed(prompts)
        u, um = self._embed([negative_prompt] * len(prompts))
        return c, cm, u, um
