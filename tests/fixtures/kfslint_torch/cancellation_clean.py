"""kfslint golden fixture: cancellation-safety must NOT fire (never
executed)."""
import asyncio


async def promote(pool):
    standby = await pool.pop_standby()
    try:                                # immediately protected
        await activate(standby)
    finally:
        pool.release(standby)


async def cancelled_handler(pool):
    standby = await pool.pop_standby()
    t0 = now()                          # sync work before the try: ok
    try:
        await activate(standby)
    except asyncio.CancelledError:
        pool.release(standby)
        raise


async def enclosing_finally(pool):
    conn = None
    try:
        conn = await pool.acquire()     # inside a protective try
        await use(conn)
    finally:
        if conn is not None:
            pool.release(conn)


async def no_await_after(workqueue):
    item = await workqueue.get()
    return transform(item)              # nothing to cancel through


async def not_pooled(client):
    body = await client.get("http://x")  # plain HTTP GET, no pool
    await log(body)


async def suppressed(pool):
    # kfslint: disable=cancellation-safety — fixture: justified.
    s = await pool.pop_standby()
    await warm(s)
