"""Training data on the host: the video datasets and their transforms, the
latent cache and the threaded loader."""

from latte_tpu_torch.data.datasets import get_dataset
from latte_tpu_torch.data.latents import LatentCacheDataset, is_latent_cache
from latte_tpu_torch.data.loader import DataLoader, quantize_video_u8

__all__ = ["DataLoader", "LatentCacheDataset", "get_dataset", "is_latent_cache", "quantize_video_u8"]
