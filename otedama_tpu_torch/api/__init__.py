"""The REST, WebSocket and Prometheus API (counterpart of
``otedama_tpu/api``)."""

from otedama_tpu_torch.api.metrics import MetricsRegistry
from otedama_tpu_torch.api.server import ApiConfig, ApiServer

__all__ = ["ApiConfig", "ApiServer", "MetricsRegistry"]
