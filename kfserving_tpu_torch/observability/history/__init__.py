"""Continuous telemetry history: the time axis beside metrics, traces
and profiles.

Port of ``kfserving_tpu/observability/history/``.  The registry answers
"what is true right now"; this package keeps, bounded and in process,
"when did TTFT p99 start degrading":

- ``store``    -- ``HistoryStore``, a ring TSDB: fixed-size per-series
                  rings with downsampled retention tiers (default
                  1 s x 10 min -> 10 s x 2 h);
- ``sampler``  -- ``HistorySampler``, the background tick
                  (``KFS_HISTORY_TICK_S``, default 1 s) that walks every
                  registry family: counters as per-second rates, gauges
                  as values, histograms as derived ``_p50``/``_p99``/
                  ``_count`` series, plus the synthetic
                  ``kfserving_tpu_history_error_ratio`` and
                  ``_prefix_hit_ratio``; scrape-time publishers run on
                  the tick so live scrapes and history agree;
- ``detector`` -- ``TrendDetector``, EWMA + z-score change points per
                  watched series (``KFS_HISTORY_WATCH*``), pinning a
                  ``trend_<series>`` flight-recorder entry with the
                  pre/post frames and exporting trend-slope gauges.

Served per replica at ``GET /debug/history?series=&labels=&window_s=&
step_s=``; ``KFS_HISTORY=0`` disables it.

Nothing here imports ``server/``, ``engine/`` or ``reliability/``: the
fault-site hook and the publishers are injected by the owning server.
"""

from kfserving_tpu_torch.observability.history.detector import (
    DEFAULT_WATCHES,
    TrendDetector,
)
from kfserving_tpu_torch.observability.history.sampler import (
    DEFAULT_TICK_S,
    ENV_ENABLE,
    ENV_TICK,
    HistorySampler,
    history_enabled,
)
from kfserving_tpu_torch.observability.history.store import (
    DEFAULT_TIERS,
    HistoryStore,
)

__all__ = [
    "HistoryStore", "HistorySampler", "TrendDetector",
    "DEFAULT_TIERS", "DEFAULT_TICK_S", "DEFAULT_WATCHES",
    "ENV_ENABLE", "ENV_TICK", "history_enabled",
]
