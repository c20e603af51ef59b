"""kfslint golden fixture (port): blocking-dispatch MUST fire on every
marked line (never executed, only parsed)."""
import threading

import torch

from kfserving_tpu_torch.engine import graphs

_lock = threading.Lock()


async def serve(module, graph, batch, stream, pool, fn):
    out = module(batch)                        # FIRE: forward on loop
    graph.replay()                             # FIRE: replay on loop
    graphs.capture(fn, stream, pool)           # FIRE: capture on loop
    torch.cuda.synchronize()                   # FIRE: wait on loop
    return out


def run(engine, batch):
    with _lock:
        return engine.module(batch)            # FIRE: forward under lock


def replay_locked(self, program):
    with self._replay_lock:
        graphs.replay(program.graph, program.launches)  # FIRE: under lock
