"""Launch counts of the hand-written kernels, CUDA graphs included.

Each kernel wrapper keeps a ``launches`` attribute that counts executions
of its kernel on the card.  A wrapper called while its thread records a
CUDA graph launches nothing: the call is added to the recording's tally
instead, and every replay of the graph adds the tally
(``engine/graphs.py``).  So the counts stay executions, whether a kernel
runs eagerly or from a graph.
"""

import contextlib
import threading
from typing import Callable, Dict, Iterator

_lock = threading.Lock()
_local = threading.local()


def count(kernel: Callable) -> None:
    """One call of ``kernel``'s wrapper reached the card."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[kernel] = tally.get(kernel, 0) + 1
        return
    with _lock:
        kernel.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[Callable, int]]:
    """Within the block, this thread's wrapper calls are tallied by kernel
    into the yielded dict instead of counted."""
    outer = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = outer


def replayed(tally: Dict[Callable, int]) -> None:
    """A graph recorded with ``tally`` ran once on the card."""
    with _lock:
        for kernel, n in tally.items():
            kernel.launches += n
