"""Micro-batching request dispatcher.

Counterpart of ``imcui_tpu/parallel/dispatch.py:MicroBatcher``: concurrent
requests are collected for up to ``max_wait_ms``, run as one fixed-size
batch on a dedicated worker thread, and fanned back out to the waiting
callers.
"""

import logging
import queue
import threading
import time

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Collects concurrent submissions into batches of up to
    ``batch_size``.

    run_batch: callable(list_of_items) -> list_of_results, called on the
    worker thread with 1..batch_size items (it pads to its fixed batch
    itself)."""

    def __init__(self, run_batch, batch_size=4, max_wait_ms=5.0):
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item, timeout=600.0):
        """Blocking submit; returns the item's result."""
        p = _Pending(item)
        self._queue.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("matching request timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self.run_batch([p.item for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()
            except Exception as e:  # the worker must outlive a bad batch
                logger.exception("micro-batch execution failed")
                for p in batch:
                    p.error = e
                    p.event.set()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
