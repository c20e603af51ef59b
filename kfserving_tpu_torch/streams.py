"""Async-stream lifecycle utilities (port of ``kfserving_tpu/streams.py``).

A plain async generator's ``finally`` only runs if the generator was
*started*: ``aclose()`` on a never-iterated generator marks it closed
without executing the body, so cleanup that lives in the body leaks
when the consumer abandons the stream before the first ``__anext__``
(e.g. a client that disconnects between submitting a generate_stream
request and the first response write).  Resource-holding streams
(admission slots, engine decode slots) wrap themselves in
``GuardedStream`` so their cleanup runs exactly once on every exit
path: exhaustion, mid-iteration error, ``aclose()`` after partial
iteration, and ``aclose()`` before any iteration at all.
"""

import inspect
import logging
from typing import Any, AsyncIterator, Callable

logger = logging.getLogger("kfserving_tpu_torch.streams")


async def aclose_quietly(stream: Any, what: str = "stream") -> None:
    """Close an async iterator if it supports aclose(), swallowing (but
    logging) failures — the shared cleanup step for every consumer that
    must release a producer on an abnormal exit path."""
    aclose = getattr(stream, "aclose", None)
    if aclose is None:
        return
    try:
        await aclose()
    except Exception:
        logger.exception("closing %s failed", what)


class GuardedStream:
    """Wraps an async iterator; ``on_close`` runs exactly once when the
    stream ends for any reason.  ``on_close`` may be sync or async."""

    def __init__(self, gen: AsyncIterator[Any],
                 on_close: Callable[[], Any]):
        self._gen = gen
        self._on_close = on_close
        self._closed = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self._gen.__anext__()
        except StopAsyncIteration:
            await self._run_close()
            raise
        except BaseException:
            # The inner generator is already finalized by its own
            # exception propagation; run cleanup now rather than
            # relying on the consumer to aclose() a broken stream.
            await self._run_close()
            raise

    async def aclose(self):
        try:
            aclose = getattr(self._gen, "aclose", None)
            if aclose is not None:
                await aclose()
        finally:
            await self._run_close()

    async def _run_close(self):
        if self._closed:
            return
        self._closed = True
        try:
            result = self._on_close()
            if inspect.isawaitable(result):
                await result
        except Exception:
            logger.exception("stream on_close callback failed")
