"""kfslint golden fixture (port): host-sync must NOT fire (never
executed)."""
import numpy as np
import torch


async def decode_step(loop, executor, fetch, feed):
    toks = torch.argmax(feed, -1)
    # Host metadata is free: shapes, dtypes, sizes.
    n = int(toks.shape[0])
    width = toks.size(1)
    count = toks.numel()
    # The executor fetches; the awaited result is a host value.
    host = await loop.run_in_executor(executor, fetch, toks)
    return n, width, count, float(host[0]), host.tolist()


def fetch_wave(handle):
    # Not a device handle by name: the fetch path's pinned arrays.
    return [h.numpy() for h in handle.host]


def tally_dispatch(values):
    # Pure-host values: no torch op, forward or replay feeds them.
    arr = np.asarray(values)
    return int(arr.sum()), arr.tolist()


def helper(module, x):
    # Not a scoped function (no hot-path name, not async).
    return module(x).cpu().item()
