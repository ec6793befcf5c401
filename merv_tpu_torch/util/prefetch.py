"""Host-side prefetching: overlap video decode with device compute (a copy of
``merv_tpu/util/prefetch.py``, which the port may not import).

The evaluation drivers decode each group's videos on the host; ``prefetch_map``
runs that work a bounded number of items ahead in a thread pool (the decoders
release the GIL while they decode), so group N+1's videos decode while group N
runs on the card.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Tuple


def prefetch_map(
    items: Iterable[Any],
    fn: Callable[[Any], Any],
    lookahead: int = 2,
    max_workers: int = 4,
) -> Iterator[Tuple[Any, Any]]:
    """Yield ``(item, fn(item))`` in order, computing up to ``lookahead``
    items ahead in background threads.

    A raised exception is RETURNED as the result (not raised), so one bad
    item cannot kill the stream — callers check ``isinstance(res, Exception)``
    and take their per-item fallback path.
    """
    items_iter = iter(items)
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        pending: collections.deque = collections.deque()

        def _submit_next() -> None:
            try:
                item = next(items_iter)
            except StopIteration:
                return

            def _safe(item=item):
                try:
                    return fn(item)
                except Exception as e:  # surfaced to the caller, never raised here
                    return e

            pending.append((item, pool.submit(_safe)))

        for _ in range(max(1, lookahead)):
            _submit_next()
        while pending:
            item, fut = pending.popleft()
            _submit_next()  # keep the pipeline full before blocking on result
            yield item, fut.result()
