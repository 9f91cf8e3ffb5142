"""Text encoders of the port: the hash-embedding stub the T2X sampler falls
back to without a T5 checkpoint (the T5 and CLIP encoders are not ported
yet, ROADMAP M5.2)."""

from latte_tpu_torch.text.stub import StubTextEncoder

__all__ = ["StubTextEncoder"]
