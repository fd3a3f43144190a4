"""The 16 depth metrics of the eval protocol (objcavit_tpu.metrics)."""

from objcavit_torch.metrics.metrics import (
    METRIC_NAMES,
    MetricsPreprocessConfig,
    metrics_compute,
    metrics_init,
    metrics_preprocess,
    metrics_update,
)

__all__ = [
    "METRIC_NAMES",
    "MetricsPreprocessConfig",
    "metrics_compute",
    "metrics_init",
    "metrics_preprocess",
    "metrics_update",
]
