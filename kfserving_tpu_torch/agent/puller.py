"""Model puller: watcher events -> download -> repository load/unload.

Port of ``kfserving_tpu/agent/puller.py``.  One event queue in, one
worker per model, so ops on the same model serialize while different
models pull in parallel; a worker retires when its queue drains.  Loaded
artifacts go straight to the server's repository (the reference POSTs
``/v2/repository/models/{m}/load``; same contract, minus the HTTP hop).
"""

import asyncio
import logging
from typing import Dict, Optional

from kfserving_tpu_torch.agent.downloader import Downloader
from kfserving_tpu_torch.reliability import RetryPolicy

logger = logging.getLogger("kfserving_tpu_torch.agent.puller")


class Puller:
    def __init__(self, repository, downloader: Downloader,
                 events: Optional[asyncio.Queue] = None,
                 retry: Optional[RetryPolicy] = None):
        self.repository = repository
        self.downloader = downloader
        self.events: asyncio.Queue = events or asyncio.Queue()
        # Model pulls retry with backoff (KFS_PULLER_RETRY_* knobs).  The
        # storage layer retries each download itself (3 by default), so
        # this outer policy defaults to 2: at worst 2 x 3 attempts.
        self.retry = retry or RetryPolicy.from_env(
            "KFS_PULLER", default_max_attempts=2)
        self._per_model: Dict[str, asyncio.Queue] = {}
        self._workers: Dict[str, asyncio.Task] = {}
        self._task: Optional[asyncio.Task] = None
        self.ops_ok = 0
        self.ops_failed = 0

    async def start(self):
        self._task = asyncio.create_task(self._dispatch())

    async def stop(self):
        tasks = list(self._workers.values())
        if self._task is not None:
            tasks.append(self._task)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._workers.clear()
        self._per_model.clear()
        self._task = None

    async def _dispatch(self):
        """Fan events out to per-model workers."""
        while True:
            op, name, spec = await self.events.get()
            q = self._per_model.get(name)
            if q is None:
                q = asyncio.Queue()
                self._per_model[name] = q
                self._workers[name] = asyncio.create_task(
                    self._model_worker(name, q))
            await q.put((op, spec))
            self.events.task_done()

    async def _model_worker(self, name: str, q: asyncio.Queue):
        while True:
            op, spec = await q.get()
            try:
                if op == "load":
                    await self._load(name, spec)
                elif op == "unload":
                    await self._unload(name)
                self.ops_ok += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                self.ops_failed += 1
                logger.exception("%s of model %s failed", op, name)
            finally:
                q.task_done()
                if q.empty():
                    # Retire the idle worker; a later event spawns a
                    # fresh one.
                    self._per_model.pop(name, None)
                    self._workers.pop(name, None)
                    return

    async def _load(self, name: str, spec: dict):
        loop = asyncio.get_running_loop()

        def pull():
            return loop.run_in_executor(
                None, self.downloader.download, name, spec)

        # The pull is idempotent (a partial generation is wiped, the
        # marker lands last); backoff sleeps yield the loop.
        await self.retry.acall(pull)
        ok = await self.repository.load(name)
        if not ok:
            raise RuntimeError(f"repository refused to load {name}")
        logger.info("model %s loaded", name)

    async def _unload(self, name: str):
        try:
            await self.repository.unload(name)
        except KeyError:
            # A model whose load failed, removed from the config: nothing
            # to unload.
            logger.info("model %s was not loaded; nothing to unload", name)
            return
        logger.info("model %s unloaded", name)

    def stats(self) -> dict:
        return {"ops_ok": self.ops_ok, "ops_failed": self.ops_failed,
                "active_models": len(self._workers)}
