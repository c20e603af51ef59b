"""kfslint golden fixture (port): jit-recompile-hazard must NOT fire
(never executed)."""
from kfserving_tpu_torch.engine import graphs


class Engine:
    def enqueue(self, ids, fn):
        # Bucketed: the key takes the bucket, never the raw length.
        bucket = self._bucket_for(len(ids))
        self._run_program(("prefill", bucket), fn)
        key = ("decode", self.max_slots, self.steps_per_call)
        self._compile_program(key, fn)
        # A raw size that reaches no key or capture is fine.
        self.rows = len(ids)

    def capture(self, fn, stream, pool):
        return graphs.capture(fn, stream, pool)
