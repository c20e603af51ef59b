"""kfslint golden fixture: spin-loop must NOT fire (never executed)."""
import asyncio


async def polite_wait(engine):
    while engine.hold:
        await asyncio.sleep(0.01)   # yields: not a spin


async def async_with_counts(lock, engine):
    while engine.hold:
        async with lock:            # suspension point: not a spin
            engine.step()


def sync_loop(engine):
    # While loops in sync code are out of scope.
    while engine.hold:
        engine.poll()


async def await_in_condition(q):
    while await q.fetch():          # yields in the test: not a spin
        handle()


async def suppressed(chunks):
    # kfslint: disable=spin-loop — fixture: bounded drain.
    while chunks:
        chunks.pop()
