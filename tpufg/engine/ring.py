"""Device-resident frame ring: prefetched host->HBM ingest.

The reference allocates a fresh HOST_VISIBLE staging buffer, memcpys into
it, submits a copy, and waits — every frame (window_capture.cpp:483-566;
SURVEY.md §2.3.8).  Here ingest is a small ring: the next ``depth`` frames
are dispatched to the device ahead of consumption (jax.device_put is
asynchronous), so the host->HBM transfer of frame n+1..n+depth overlaps the
device compute of frame n.  Combined with the native prefetch ring
(tpufg/io/native.py) the whole path disk -> decode -> pinned slot -> HBM is
pipelined.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import jax
import numpy as np


class DeviceIngestRing:
    """Wraps a frame iterator; yields device arrays uploaded ahead of time.

    ``sync_upload``: wait for each host->device copy before advancing the
    source iterator.  Required for zero-copy slot sources (NativeRawSource:
    advancing releases the slot for the reader thread to overwrite while an
    async transfer may still be reading it).  The upload still overlaps
    device *compute* — only the overlap with the next host-side read is
    given up, and that read is already hidden by the native reader thread.
    """

    def __init__(self, frames: Iterable[np.ndarray], depth: int = 2,
                 sync_upload: bool = False):
        if depth < 1:
            raise ValueError("ring depth must be >= 1")
        self._it: Iterator[np.ndarray] = iter(frames)
        self._depth = depth
        self._sync = sync_upload
        self._host_backend = jax.default_backend() == "cpu"
        self._q: collections.deque = collections.deque()

    def _fill(self):
        while len(self._q) < self._depth:
            try:
                frame = next(self._it)
            except StopIteration:
                return
            # async dispatch: upload starts now, overlaps device compute
            # (ascontiguousarray is a no-op for contiguous slot views)
            frame = np.ascontiguousarray(frame)
            if self._sync and self._host_backend:
                # the CPU backend may alias a host view instead of copying
                # it, and the slot is reused for a later frame
                frame = frame.copy()
            dev = jax.device_put(frame)
            if self._sync:
                # the upload must land before the host slot is reused: a
                # stale slot read is silent corruption
                jax.block_until_ready(dev)
            self._q.append(dev)

    def __iter__(self):
        self._fill()
        while self._q:
            out = self._q.popleft()
            self._fill()
            yield out
