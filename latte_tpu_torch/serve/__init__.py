"""Serving artifacts: one sampler step exported through ``torch.export``
(:mod:`.aot`) and its CLI (:mod:`.export_aot`)."""

from latte_tpu_torch.serve.aot import AOT_SUFFIX, export_sampler, load_sampler, save_sampler

__all__ = ["AOT_SUFFIX", "export_sampler", "load_sampler", "save_sampler"]
