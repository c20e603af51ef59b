"""kfslint golden fixture: await-under-lock must NOT fire (never
executed)."""
import asyncio
import threading


class Engine:
    def __init__(self):
        self._lock = asyncio.Lock()
        self._mu = threading.Lock()

    async def guarded(self):
        async with self._lock:          # async lock, async with: fine
            await self.fetch()

    async def classified_asyncio(self):
        with self._lock:                # asyncio.Lock classified:
            await self.fetch()          # not this rule's problem

    async def sync_work_under_lock(self):
        with self._mu:                  # thread lock, but no await
            self.recompute()
        await self.fetch()              # await AFTER release: fine

    def sync_method(self):
        with self._mu:                  # sync code: out of scope
            self.recompute()

    async def suppressed(self):
        # kfslint: disable=await-under-lock — fixture: justified.
        with self._mu:
            await self.fetch()
