"""Background batch prefetching: overlap host-side decode/augment (and,
when safe, the host->device transfer) with device compute.

The reference trainers load batches synchronously on the training thread
(torch DataLoader with num_workers=0, lecturenet_train_00:92-93,
train_01:99-100, train_02:157-158), so every step pays
decode+augment+upload before the device can start. JAX dispatch is
async (as is CUDA's), so the only thing serializing our step loop the same way is batch
preparation — this module moves it to one producer thread with a bounded
queue. (A copy of the JAX package's module: it imports nothing of JAX.)

Design constraints:
  * The producer runs the EXACT sequential iterator the caller passes —
    same RNG draw order, same batch stream — so training trajectories
    (and the torch step-parity tests) are unchanged with prefetch on.
  * One producer thread, bounded queue (depth small): at most ``depth``
    prepared batches of extra host memory, backpressure beyond that.
  * Exceptions in the producer re-raise at the consumer's next pull.
  * ``transform`` (the Trainer's upload to the card) runs in the
    producer, so the host-to-device copy overlaps the step too.

The consumer's blocked time in ``__next__`` is the span ``train.wait``
(core/timing.py), one a pull: each item's and the one that finds the end.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from ..core.timing import span


class PrefetchIterator:
    """Iterate ``source`` on a background thread, ``depth`` items ahead.

    Always drain it or call ``close()`` (it is also a context manager):
    an abandoned iterator is otherwise kept alive by its producer thread
    blocking on a full queue. The thread is a daemon, so process exit is
    never held up either way.
    """

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        # the _DONE sentinel is enqueued exactly once; remember having seen
        # it so a second next() after exhaustion raises StopIteration again
        # instead of blocking forever on the empty queue
        self._finished = False
        self._stop = threading.Event()
        self._transform = transform
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),),
            name="lm-batch-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, source: Iterator) -> None:
        try:
            for item in source:
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as exc:  # re-raised at the consumer
            self._error = exc
        # _error must be visible before the consumer sees DONE
        while not self._stop.is_set():
            try:
                self._queue.put(self._DONE, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        with span("train.wait"):
            item = self._queue.get()
        if item is self._DONE:
            self._finished = True
            if self._error is not None:
                error, self._error = self._error, None
                raise error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and release its queue slot."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def prefetch(source: Iterable, depth: int = 2,
             transform: Optional[Callable] = None) -> Iterable:
    """Wrap an iterable with background prefetching; ``depth=0`` returns
    it unchanged (with ``transform`` applied inline, preserving the
    caller's contract)."""
    if depth == 0:
        if transform is None:
            return source
        return (transform(item) for item in source)
    return PrefetchIterator(source, depth, transform)
