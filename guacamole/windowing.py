"""Sliding windows over sorted reads, and sorted-stream demultiplexing.

Host-side streaming utilities kept for API completeness and as the
skip-empty fast-forward oracle (cf. upstream
.../windowing/SlidingWindow.scala:40-187, SplitIterator.scala:16-61). The
device path replaces per-locus window advance with tile packing, but tools
and tests that want per-locus streaming semantics use these.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Deque, Iterable, Iterator, List, Optional, Sequence, Tuple


class SlidingWindow:
    """A window over sorted regions (reads) on one contig.

    setCurrentLocus drops regions that fall out of the window and admits new
    ones; regions are kept in a heap by end locus.
    """

    def __init__(
        self, reference_name: str, half_window_size: int, sorted_regions
    ):
        self.reference_name = reference_name
        self.half_window_size = half_window_size
        self.current_locus = -1
        self.new_regions: List = []
        self._heap: List[Tuple[int, int, object]] = []  # (end, seq, region)
        self._seq = 0
        self._iter = iter(sorted_regions)
        self._peek = None
        self._most_recent_start = 0

    def _head(self):
        if self._peek is None:
            for region in self._iter:
                if region.reference_contig != self.reference_name:
                    raise ValueError("Regions must have the same reference name")
                if region.start < self._most_recent_start:
                    raise ValueError("Regions must be sorted by start locus")
                self._most_recent_start = region.start
                self._peek = region
                break
        return self._peek

    def _pop_head(self):
        region = self._peek
        self._peek = None
        return region

    def current_regions(self) -> List:
        return [entry[2] for entry in self._heap]

    def set_current_locus(self, locus: int) -> List:
        assert locus >= self.current_locus, (
            "Pileup window can only move forward in locus"
        )
        self.current_locus = locus
        while self._heap and self._heap[0][0] <= locus - self.half_window_size:
            heapq.heappop(self._heap)
        new_regions = []
        while (
            self._head() is not None
            and self._head().start <= locus + self.half_window_size
        ):
            region = self._pop_head()
            if region.overlaps_locus(locus, self.half_window_size):
                new_regions.append(region)
        for region in new_regions:
            heapq.heappush(self._heap, (region.end, self._seq, region))
            self._seq += 1
        self.new_regions = new_regions
        return new_regions

    def next_locus_with_regions(self) -> Optional[int]:
        if any(
            entry[2].overlaps_locus(self.current_locus + 1, self.half_window_size)
            for entry in self._heap
        ):
            return self.current_locus + 1
        head = self._head()
        if head is not None:
            result = max(0, head.start - self.half_window_size)
            assert result > self.current_locus
            return result
        return None


def advance_multiple_windows(
    windows: Sequence[SlidingWindow], loci_iterator, skip_empty: bool = True
) -> Optional[int]:
    """Advance N per-sample windows to the next locus (optionally skipping
    loci where all windows are empty). Returns the locus, or None when done.
    (cf. SlidingWindow.advanceMultipleWindows, :149-187)"""
    if skip_empty:
        while loci_iterator.has_next():
            candidates = [
                n
                for n in (w.next_locus_with_regions() for w in windows)
                if n is not None
            ]
            if not candidates:
                return None
            next_non_empty = min(candidates)
            if next_non_empty <= loci_iterator.head:
                next_locus = next(loci_iterator)
                for w in windows:
                    w.set_current_locus(next_locus)
                if any(w.current_regions() for w in windows):
                    return next_locus
            else:
                loci_iterator.skip_to(next_non_empty)
        return None
    if loci_iterator.has_next():
        next_locus = next(loci_iterator)
        for w in windows:
            w.set_current_locus(next_locus)
        return next_locus
    return None


def split_iterator(num: int, source: Iterator[Tuple[int, object]]):
    """Demultiplex one sorted (sample_index, item) iterator into per-sample
    iterators with minimal buffering (cf. SplitIterator.scala:16-61)."""
    buffers: List[Deque] = [deque() for _ in range(num)]
    source_iter = iter(source)

    class _Split:
        def __init__(self, index: int):
            self.index = index

        def _advance(self) -> bool:
            try:
                index, element = next(source_iter)
            except StopIteration:
                return False
            buffers[index].append(element)
            return True

        def has_next(self) -> bool:
            while not buffers[self.index]:
                if not self._advance():
                    return False
            return True

        @property
        def head(self):
            while not buffers[self.index]:
                if not self._advance():
                    raise StopIteration
            return buffers[self.index][0]

        def __next__(self):
            value = self.head
            buffers[self.index].popleft()
            return value

        def __iter__(self):
            return self

    return [_Split(i) for i in range(num)]
