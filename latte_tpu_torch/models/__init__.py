from latte_tpu_torch.models.dit import Latte
from latte_tpu_torch.models.dit_img import LatteIMG
from latte_tpu_torch.models.registry import Latte_models, get_model, get_models

__all__ = ["Latte", "LatteIMG", "Latte_models", "get_model", "get_models"]
