"""The kernels' launch counters under CUDA graphs.

Each kernel's wrapper counts ``launches`` and ``rows`` where it launches.
A launch made while a graph is captured does not run then but at each
replay, so the graph's owner (``train/step_graph.py``,
``train/frame_graph.py``, ``train/grid_graph.py``) takes the counts of
its capture off the counters and adds them back at every replay.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Sequence

from .fused_head import fused_field_head
from .hash_encode import hash_encode_cuda
from .nearest_vertex import nearest_vertex_cuda, nearest_warp_cuda

__all__ = ["COUNTED", "captured_counts", "add_replay"]

# every wrapper with launch counters
COUNTED = (fused_field_head, hash_encode_cuda, nearest_vertex_cuda,
           nearest_warp_cuda)


@contextmanager
def captured_counts(kernels: Sequence = COUNTED) -> Iterator[list]:
    """Around a capture: yields a list that, once the block is left,
    holds each kernel's (launches, rows) counted inside it; the counters
    are then set back to what they were before the block."""
    before = [(k.launches, k.rows) for k in kernels]
    counts: list = []
    try:
        yield counts
    finally:
        for k, (launches, rows) in zip(kernels, before):
            counts.append((k.launches - launches, k.rows - rows))
            k.launches, k.rows = launches, rows


def add_replay(counts: Sequence, kernels: Sequence = COUNTED) -> None:
    """One replay of a graph whose capture counted ``counts``."""
    for k, (launches, rows) in zip(kernels, counts, strict=True):
        k.launches += launches
        k.rows += rows
