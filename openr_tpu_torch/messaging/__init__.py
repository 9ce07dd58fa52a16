"""In-process inter-module pub/sub bus.

Equivalent of openr/messaging/{Queue.h,ReplicateQueue.h}: RWQueue is a
multi-producer/multi-consumer blocking queue (folly fiber batons → asyncio
futures), RQueue is its read-only facade handed to consumer modules, and
ReplicateQueue fans every pushed message out to all registered readers — the
bus that connects Spark → LinkMonitor → KvStore → Decision → Fib.
"""

from openr_tpu_torch.messaging.queue import (
    QueueClosedError,
    RQueue,
    RWQueue,
    ReplicateQueue,
)

__all__ = ["QueueClosedError", "RQueue", "RWQueue", "ReplicateQueue"]
