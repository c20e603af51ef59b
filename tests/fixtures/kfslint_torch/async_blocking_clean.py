"""kfslint golden fixture: async-blocking must NOT fire anywhere
here (never executed, only parsed)."""
import asyncio
import time


async def handler():
    await asyncio.sleep(0.1)        # async sleep is the point

    def helper():
        # Sync def nested in an async def runs wherever it's called
        # (typically an executor) — not this frame.
        time.sleep(1)

    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, helper)


def sync_path():
    # Blocking calls in plain sync code are fine.
    time.sleep(0.5)
    with open("/tmp/x") as f:
        return f.read()


async def suppressed():
    # kfslint: disable=async-blocking — fixture: justified one-off.
    time.sleep(0.01)
    time.sleep(0.02)  # kfslint: disable=async-blocking — trailing form


def _persist_payload(path, data):
    # Unique blocking sync helper: flagged only when CALLED on the
    # loop, never when passed by reference to an offload.
    with open(path, "w") as f:
        f.write(data)


async def offloads(loop, data):
    import functools

    # Blocking callables PASSED to executor offloads are safe — the
    # loop never runs them.
    await loop.run_in_executor(None, _persist_payload, "/tmp/x", data)
    await asyncio.to_thread(_persist_payload, "/tmp/x", data)
    # functools.partial only binds arguments; partial(...) itself
    # never blocks.
    await loop.run_in_executor(
        None, functools.partial(_persist_payload, "/tmp/x", data))
    await loop.run_in_executor(
        None, functools.partial(time.sleep, 1))


class _FakeLoop:
    # A test double whose run_in_executor calls fn INLINE: it must
    # not reclassify every real offload in the tree as blocking
    # (offload names are exempt from the unique-helper pass).
    def run_in_executor(self, executor, fn, *args):
        time.sleep(0)
        return fn(*args)


async def awaited_local_callable(call, payload):
    # `await call(...)` proves the callee is a coroutine function —
    # never the same-named sync RetryPolicy.call elsewhere in a tree.
    return await call(payload)
