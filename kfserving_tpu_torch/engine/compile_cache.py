"""The funnel every engine reports its compiled programs through.

Port of ``kfserving_tpu/engine/compile_cache.py``.  On the card a
compiled program is a CUDA graph: the predict engine captures one per
(batch, seq) bucket and the generator one per decode-wave variant, and
each reports the first capture of a shape here (``note_compilation``).
An engine declares its warmup grid complete once it has captured it
(``declare_warmup_complete``).  Both go to the device-discipline
sanitizer (``reliability/sanitizer.py``): under ``KFS_SANITIZE=1`` a
capture noted for a source after its declaration is a ``recompile``
violation; with the sanitizer off each call is one env read.

There is no ``enable()``: the JAX package points XLA's persistent
compilation cache at a directory so that a restart skips its compiles,
but a CUDA graph lives in its process and dies with it.  What persists
across processes here is the nvcc build directory of the kernels
(``csrc/build.py``).
"""

from typing import Any

from kfserving_tpu_torch.reliability import sanitizer


def note_compilation(source: str, key: Any) -> None:
    """An engine compiled (captured) the program ``key`` for the first
    time; after ``source`` declared its warmup complete this is a
    sanitizer violation."""
    sanitizer.note_compilation(source, key)


def declare_warmup_complete(source: str) -> None:
    """``source`` has compiled its warmup grid; later notes for it are
    programs outside the grid."""
    sanitizer.declare_warmup_complete(source)
