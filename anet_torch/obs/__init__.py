"""Observability: metrics registry + status indicator."""

from anet_torch.obs.metrics import MetricsRegistry
from anet_torch.obs.status import StatusIndicator, SystemState

__all__ = ["MetricsRegistry", "StatusIndicator", "SystemState"]
