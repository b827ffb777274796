"""Background batch prefetching (port of rnr_tpu/data/prefetch.py): a
host thread assembles the next batches into a bounded queue while the
card runs the current step."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class PrefetchIterator:
    """Wraps an iterable of batches with an N-deep background queue."""

    _STOP = object()

    def __init__(self, source: Iterable, depth: int = 2,
                 transform: Callable | None = None):
        self._source = source
        self._depth = depth
        self._transform = transform

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err: list[BaseException] = []

        def worker():
            try:
                for item in self._source:
                    if self._transform is not None:
                        item = self._transform(item)
                    q.put(item)
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(self._STOP)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is self._STOP:
                if err:
                    raise err[0]
                return
            yield item


def prefetch(source: Iterable, depth: int = 2,
             transform: Callable | None = None) -> PrefetchIterator:
    """prefetch(loader, transform=make_batch) -> iterator of batches."""
    return PrefetchIterator(source, depth, transform)
