"""kfslint golden fixture: cancellation-safety MUST fire (never
executed)."""


async def promote(pool):
    standby = await pool.pop_standby()  # FIRE: await before the try
    await warm(standby)
    try:
        await activate(standby)
    finally:
        pool.release(standby)


async def no_protection(workqueue):
    item = await workqueue.get()        # FIRE: no try at all
    await preprocess(item)
    return item


async def private_acquire(self_pool):
    # Leading underscores must not hide an acquire.
    s = await self_pool._obtain_standby()   # FIRE
    await self_pool.activate(s)


async def wrong_handler(pool):
    conn = await pool.acquire()         # FIRE: except ValueError
    try:                                # does not cover cancellation
        await use(conn)
    except ValueError:
        pool.release(conn)
