"""Shared utilities: backoff, debounce, throttle, counters and histograms.

Port copies of the JAX package's utils/{backoff,async_util}.py (the
asyncio equivalents of openr/common/{ExponentialBackoff,AsyncDebounce,
AsyncThrottle}.h) beside the counters mixins; `ownership` and
`serializer` are imported as submodules.
"""

from openr_tpu_torch.utils.async_util import AsyncDebounce, AsyncThrottle
from openr_tpu_torch.utils.backoff import ExponentialBackoff
from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin

__all__ = [
    "AsyncDebounce",
    "AsyncThrottle",
    "CountersMixin",
    "ExponentialBackoff",
    "HistogramsMixin",
]
