"""Offline tools of the port: ``cache_latents`` writes a latent cache."""
