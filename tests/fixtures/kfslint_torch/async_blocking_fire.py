"""kfslint golden fixture: async-blocking MUST fire on every marked
line (never executed, only parsed)."""
import subprocess
import time
from time import sleep as snooze

import requests


async def handler():
    time.sleep(0.1)                 # FIRE: time.sleep
    requests.get("http://example")  # FIRE: requests verb
    subprocess.run(["ls"])          # FIRE: subprocess wait
    snooze(1)                       # FIRE: aliased time.sleep
    with open("/tmp/x") as f:       # FIRE: blocking file I/O
        return f.read()


def sync_wrapper():
    # Nested async def inside a sync function is still an event-loop
    # frame: checked.
    async def inner():
        time.sleep(1)               # FIRE: nested async def


def _read_config():
    with open("/etc/cfg") as f:
        return f.read()


async def via_helper():
    return _read_config()           # FIRE: unique sync helper blocks


async def offload_arg_evaluated(loop):
    # The offload itself is exempt, but its ARGUMENTS evaluate on the
    # loop before the submit — a call expression there still blocks.
    await loop.run_in_executor(None, _read_config())  # FIRE: evaluated
