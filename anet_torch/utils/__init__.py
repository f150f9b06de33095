"""Host-side utilities: pacing, error aggregation."""

from anet_torch.utils.pacing import LeakyBucket, SimulatedClock
from anet_torch.utils.errors import CombinedError, do_all_and_raise_combined

__all__ = [
    "LeakyBucket",
    "SimulatedClock",
    "CombinedError",
    "do_all_and_raise_combined",
]
