"""Training data on the host: the latent cache and the threaded loader."""

from latte_tpu_torch.data.latents import LatentCacheDataset, is_latent_cache
from latte_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "LatentCacheDataset", "is_latent_cache"]
