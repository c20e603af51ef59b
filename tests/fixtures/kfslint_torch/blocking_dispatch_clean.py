"""kfslint golden fixture (port): blocking-dispatch must NOT fire
(never executed)."""
import asyncio


async def serve(loop, executor, module, batch, registry):
    # Offloaded: the executor runs the forward.
    out = await loop.run_in_executor(executor, module, batch)
    # Accessors and classes named after models are not forwards.
    model = registry.get_model("m")
    spec = registry.TrainedModel("m")
    lock = asyncio.Lock()
    async with lock:
        await asyncio.sleep(0)
    return out, model, spec


def run(engine, batch):
    # No lock held, not async: the enqueue thread's dispatch.
    return engine.module(batch)
