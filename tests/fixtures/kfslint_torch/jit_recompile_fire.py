"""kfslint golden fixture (port): jit-recompile-hazard MUST fire on
every marked line (never executed, only parsed)."""
import torch

from kfserving_tpu_torch.engine import graphs


class Engine:
    def enqueue(self, ids, fn):
        n = len(ids)
        self._run_program(("prefill", n), fn)           # FIRE: raw len
        key = ("chunk", ids.shape[1])
        self._compile_program(key, fn)                  # FIRE: via a key
        self._run_program(("rows", ids.size(0)), fn)    # FIRE: .size(i)

    def capture(self, ids, fn, stream, pool):
        static = torch.zeros(len(ids))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=(len(ids), pool)):  # FIRE: capture
            fn(static)
        return graphs.capture(lambda: fn(static), stream,
                              ids.numel())              # FIRE: graphs.capture
