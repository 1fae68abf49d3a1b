"""Prefetching frame-pair iterators: the odometry loop streams frames, so
decoding should overlap the device's work, never serialise with it. A copy
of the JAX package's `data/prefetch.py`: a Python thread stays `depth`
items ahead. Its decode overlaps the loop because the heavy parts of a PNG
run outside the interpreter lock: the inflate in `zlib`, the row filters
in C (`tpustereo_torch.native`, the counterpart of the JAX package's
native loader), the gray conversion in whole-array numpy. (`chip_smoke.py`
step 21 times the CLI's odometry over libpng adaptive files with prefetch
0 and 2, beside the same frames as arrays.)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np


def _thread_prefetch(it: Iterable, depth: int) -> Iterator:
    """Generic lookahead: a daemon thread keeps up to `depth` decoded items
    queued; exceptions propagate to the consumer at the failing position."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def feeder():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            q.put(e)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def prefetch_pairs(pairs, depth: int = 2) -> Iterator[
        Tuple[np.ndarray, np.ndarray]]:
    """Iterate (left, right) uint8 frames with decode running ahead of the
    consumer. `pairs`: either a sequence of (left_path, right_path) tuples
    or any iterable yielding decoded (left, right) arrays."""
    seq: Iterable
    if isinstance(pairs, (list, tuple)) and pairs and isinstance(
            pairs[0], (list, tuple)) and isinstance(pairs[0][0], str):
        from tpustereo_torch.data.io import read_image_gray

        def decode_all(ps: Sequence) -> Iterator:
            for lp, rp in ps:
                yield read_image_gray(lp), read_image_gray(rp)

        seq = decode_all(pairs)
    else:
        seq = pairs
    return _thread_prefetch(seq, depth)
