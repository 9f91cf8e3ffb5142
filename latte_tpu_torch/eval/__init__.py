"""Evaluation (port of ``latte_tpu/eval``): the I3D, Inception and C3D
detectors as torch modules, fp64 feature statistics, the Fréchet, KID and
IS math, the metric datasets, the seven metric protocols, ``calc_metric``
and the ``calc_metrics`` CLI."""

from latte_tpu_torch.eval.feature_stats import FeatureStats  # noqa: F401
from latte_tpu_torch.eval.metrics import calc_metric, list_metrics  # noqa: F401
