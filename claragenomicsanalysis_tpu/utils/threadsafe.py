"""Host pipelining helpers (reference:
common/utils/.../threadsafe_containers.hpp [U]).

Here most of the reference's producer/consumer machinery is replaced by
JAX's async dispatch (the host thread runs ahead of the device); what remains
useful is a bounded prefetch pipeline for overlapping host-side I/O/packing
with device compute, used by the mapper's (query-batch x target-batch) loop.
"""

import queue
import threading
from collections.abc import Callable, Iterable, Iterator
from typing import Any

_SENTINEL = object()


class ThreadsafeProducerConsumerQueue:
    """Bounded MPMC queue with close() semantics."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def put(self, item: Any) -> None:
        self._q.put(item)

    def close(self) -> None:
        self._closed.set()
        self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                self._q.put(_SENTINEL)  # wake sibling consumers
                return
            yield item


def prefetch_map(fn: Callable[[Any], Any], items: Iterable[Any],
                 depth: int = 2) -> Iterator[Any]:
    """Run `fn` over `items` on a producer thread, keeping up to `depth`
    results in flight — the host-side double-buffer that lets FASTA parsing /
    batch packing overlap device compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for it in items:
                q.put(("ok", fn(it)))
        except BaseException as e:  # propagate to consumer
            err.append(e)
            q.put(("err", e))
            return
        q.put(("done", None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        kind, val = q.get()
        if kind == "ok":
            yield val
        elif kind == "err":
            raise val
        else:
            return
