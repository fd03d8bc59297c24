"""Background batch prefetching for the training loop.

Counterpart of ``admm_deconv_tpu/train/prefetch.py``, unchanged: a bounded
background thread runs the loader and the ``transform`` (the trainer's
host-to-device copy), so input work overlaps the device step.  Depth 2
suffices: one batch in flight on the device, one staged.  Exceptions in
the loader thread are re-raised at the consuming ``next()``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_DONE = object()


class Prefetcher:
    """Iterate ``loader`` on a background thread, applying ``transform``
    (e.g. the trainer's shard/device_put) before handing batches over."""

    def __init__(
        self,
        loader: Iterable,
        transform: Callable | None = None,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._loader = loader
        self._transform = transform
        self._depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)

        def worker() -> None:
            try:
                for item in self._loader:
                    if self._transform is not None:
                        item = (
                            self._transform(*item)
                            if isinstance(item, tuple)
                            else self._transform(item)
                        )
                    q.put(item)
                q.put(_DONE)
            except BaseException as exc:  # noqa: BLE001 — relayed to consumer
                q.put(exc)

        t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # A consumer breaking early must not leave the worker blocked on
            # a full queue forever: drain until it can finish.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
