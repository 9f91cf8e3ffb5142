"""Offline tools of the port: ``cache_latents`` writes a latent cache,
``convert_videos_to_frames`` turns mp4s into frame folders for the metrics."""
