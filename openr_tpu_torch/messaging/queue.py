"""MPMC queues with close semantics and fan-out replication.

Reference semantics (openr/messaging/Queue.h:72 RWQueue, ReplicateQueue.h:23):
  - push(item) -> bool: False once closed (push after close is dropped).
  - get() awaits until an item is available; raises QueueClosedError when the
    queue is closed and drained.
  - try_get() non-blocking.
  - close() wakes all pending readers with QueueClosedError.
  - ReplicateQueue.get_reader() registers a new reader queue; each push is
    replicated to every open reader; closing the replicate queue closes all
    readers. Reader count and replication stats are exposed like
    ReplicateQueue::getNumReaders / getNumWrites.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Any, Deque, Generic, List, Optional, TypeVar

T = TypeVar("T")


class QueueClosedError(RuntimeError):
    """Raised by get() on a closed, drained queue."""


class RWQueue(Generic[T]):
    def __init__(self) -> None:
        self._items: Deque[T] = collections.deque()
        self._waiters: Deque[asyncio.Future] = collections.deque()
        self._closed = False
        self._num_writes = 0
        self._num_reads = 0

    def push(self, item: T) -> bool:
        if self._closed:
            return False
        self._num_writes += 1
        self._items.append(item)
        self._wake_one()
        return True

    def _wake_one(self) -> None:
        # wake-up futures carry no payload: the woken reader pops from
        # _items itself, so a reader cancelled mid-wakeup never swallows data
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    async def get(self) -> T:
        while not self._items:
            if self._closed:
                raise QueueClosedError("queue is closed")
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            try:
                await fut
            except asyncio.CancelledError:
                # pass the wakeup on if it raced with our cancellation
                if fut.done() and not fut.cancelled():
                    self._wake_one()
                raise
            finally:
                if fut in self._waiters:
                    self._waiters.remove(fut)
        self._num_reads += 1
        return self._items.popleft()

    def try_get(self) -> Optional[T]:
        if self._items:
            self._num_reads += 1
            return self._items.popleft()
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)  # woken readers observe closed state

    @property
    def closed(self) -> bool:
        return self._closed

    def size(self) -> int:
        return len(self._items)

    def __len__(self) -> int:
        return len(self._items)

    @property
    def num_writes(self) -> int:
        return self._num_writes

    @property
    def num_reads(self) -> int:
        return self._num_reads


class RQueue(Generic[T]):
    """Read-only facade over an RWQueue (openr/messaging/Queue.h:35).

    close() detaches this reader from its ReplicateQueue: the producer drops
    closed readers on the next push (the reference GCs readers by shared_ptr
    use-count, ReplicateQueue-inl.h).
    """

    def __init__(self, queue: RWQueue[T]) -> None:
        self._queue = queue

    def close(self) -> None:
        self._queue.close()

    async def get(self) -> T:
        return await self._queue.get()

    def try_get(self) -> Optional[T]:
        return self._queue.try_get()

    def size(self) -> int:
        return self._queue.size()

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def closed(self) -> bool:
        return self._queue.closed


class ReplicateQueue(Generic[T]):
    """Fan-out queue: every push is replicated to all readers."""

    def __init__(self) -> None:
        self._readers: List[RWQueue[T]] = []
        self._closed = False
        self._num_writes = 0

    def get_reader(self) -> RQueue[T]:
        if self._closed:
            raise QueueClosedError("replicate queue is closed")
        q: RWQueue[T] = RWQueue()
        self._readers.append(q)
        return RQueue(q)

    def push(self, item: T) -> bool:
        if self._closed:
            return False
        self._num_writes += 1
        # drop readers that were closed individually
        self._readers = [r for r in self._readers if not r.closed]
        for reader in self._readers:
            reader.push(item)
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for reader in self._readers:
            reader.close()
        self._readers.clear()

    def get_num_readers(self) -> int:
        self._readers = [r for r in self._readers if not r.closed]
        return len(self._readers)

    @property
    def num_writes(self) -> int:
        return self._num_writes
