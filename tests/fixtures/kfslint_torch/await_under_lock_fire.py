"""kfslint golden fixture: await-under-lock MUST fire (never
executed)."""
import threading
from threading import RLock


class Engine:
    def __init__(self):
        self._block_lock = threading.Lock()
        self._table_lock = RLock()

    async def grow(self):
        with self._block_lock:          # FIRE: thread lock held
            await self.fetch()

    async def rehash(self):
        with self._table_lock:          # FIRE: from-import RLock
            data = await self.collect()
        return data

    async def unknown_lockish(self, chain_mutex):
        # Unclassified but lock-named: a sync `with` on an asyncio
        # lock raises at runtime, so this is a thread lock in
        # practice.
        with chain_mutex:               # FIRE: lockish name heuristic
            await self.fetch()
