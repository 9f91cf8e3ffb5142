"""Text encoders of the port (counterpart of ``latte_tpu/text``): T5 for the
T2V pipeline (with its SentencePiece tokenizer), CLIP's text tower for
``extras: 78``, the caption cleaning both apply, and the hash-embedding stub
the T2X sampler falls back to without a T5 checkpoint."""

from latte_tpu_torch.text.clip import CLIPTextConfig, CLIPTextModel, FrozenCLIPEmbedder, TextEmbedder
from latte_tpu_torch.text.preprocess import clean_caption, text_preprocessing
from latte_tpu_torch.text.spiece import SentencePieceUnigram, T5Tokenizer
from latte_tpu_torch.text.stub import StubTextEncoder
from latte_tpu_torch.text.t5 import T5Config, T5EncoderModel, T5TextEncoder

__all__ = [
    "CLIPTextConfig",
    "CLIPTextModel",
    "FrozenCLIPEmbedder",
    "TextEmbedder",
    "clean_caption",
    "text_preprocessing",
    "SentencePieceUnigram",
    "T5Tokenizer",
    "StubTextEncoder",
    "T5Config",
    "T5EncoderModel",
    "T5TextEncoder",
]
