"""kfslint golden fixture: spin-loop MUST fire (never executed)."""


async def growth_hold(engine):
    # The growth-HOLD livelock shape: the exit condition is flipped by
    # another coroutine, but this loop never yields to let it run.
    while engine.hold:              # FIRE: await-free spin
        engine.poll()


async def nested_in_sync_host():
    pass


def sync_wrapper():
    async def inner(flag):
        while not flag.is_set():    # FIRE: nested async def spin
            pass
