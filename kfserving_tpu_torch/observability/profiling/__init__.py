"""Device-time observability of the port: the engine event timeline,
its Chrome-trace export and the roofline gauges.

- ``timeline``     -- the bounded engine event ring ``TIMELINE``;
- ``trace_export`` -- Chrome-trace/Perfetto rendering of the ring
                      (``GET /debug/profile``), fleet merge and the
                      dispatch-gap/HOLD summary;
- ``roofline``     -- the engines' FLOP / padding / bandwidth
                      accounting as registry gauges.

Nothing here imports ``server/``, ``engine/`` or ``reliability/``: the
engines record into this layer, never the reverse.
"""

from kfserving_tpu_torch.observability.profiling.timeline import (
    TIMELINE,
    EngineTimeline,
)
from kfserving_tpu_torch.observability.profiling.trace_export import (
    merge_traces,
    summarize,
    to_chrome_trace,
)

__all__ = ["TIMELINE", "EngineTimeline", "to_chrome_trace",
           "merge_traces", "summarize"]
