"""Observability: structured event logs, counters + histogram aggregation,
convergence spans, watchdog, and the device-memory ledger.

Port copies of the JAX package's monitor/{monitor,spans,watchdog}.py and
monitor/memledger.py (its `reconcile` reads `torch.cuda.memory_stats`).
The exporter, the convergence report and profiling come with the daemon
shell (ROADMAP queue 1 item 12), and with them `Monitor`, which folds
its spans into the report's rollup.
"""

from openr_tpu_torch.monitor.monitor import LogSample, merge_module_histograms
from openr_tpu_torch.monitor.spans import SPAN_EVENT, Span
from openr_tpu_torch.monitor.watchdog import Watchdog, WatchdogConfig

__all__ = [
    "LogSample",
    "Span",
    "SPAN_EVENT",
    "Watchdog",
    "WatchdogConfig",
    "merge_module_histograms",
]
