from latte_tpu_torch.config.loader import Config, apply_overrides, load_config, save_config

__all__ = ["Config", "apply_overrides", "load_config", "save_config"]
