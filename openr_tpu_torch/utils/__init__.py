"""Shared utilities (counters and histograms mixins)."""

from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin

__all__ = ["CountersMixin", "HistogramsMixin"]
