"""The funnel every engine reports its compiled programs through.

Port of ``kfserving_tpu/engine/compile_cache.py``.  On the card a
compiled program is a CUDA graph: the predict engine captures one per
(batch, seq) bucket and the generator one per decode-wave variant, and
each reports the first capture of a shape here (``note_compilation``).
An engine declares its warmup grid complete once it has captured it
(``declare_warmup_complete``); a note for that source after the
declaration is a program outside the warmed grid, which is counted
(``late_notes``) and logged.  Turning that into an assertion is the
sanitizer's work, which the port does not have yet.

There is no ``enable()``: the JAX package points XLA's persistent
compilation cache at a directory so that a restart skips its compiles,
but a CUDA graph lives in its process and dies with it.  What persists
across processes here is the nvcc build directory of the kernels
(``csrc/build.py``).
"""

import logging
import threading
from typing import Any, Dict, Set

logger = logging.getLogger("kfserving_tpu_torch.compile_cache")

_lock = threading.Lock()
_warmed: Set[str] = set()
# source -> notes after its declared warmup.
late_notes: Dict[str, int] = {}


def note_compilation(source: str, key: Any) -> None:
    """An engine compiled (captured) the program ``key`` for the first
    time.  After ``source`` declared its warmup complete, the note is
    counted in ``late_notes`` and logged."""
    with _lock:
        if source not in _warmed:
            return
        late_notes[source] = late_notes.get(source, 0) + 1
    logger.warning("%s compiled %r after its declared warmup", source, key)


def declare_warmup_complete(source: str) -> None:
    """``source`` has compiled its warmup grid; later notes for it are
    programs outside the grid."""
    with _lock:
        _warmed.add(source)
