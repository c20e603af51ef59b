"""Deterministic fault injection.

Port of ``kfserving_tpu/reliability/faults.py``: a process-global
``faults`` injector that an edge calls with a stable site name
(``fault_sites``) before doing real work.  The port calls these sites:

    storage.download        Storage.download's remote pull, keyed by
                            URI
    agent.pull              the agent Downloader's model pull, keyed by
                            model name
    client.request          KFServingClient's HTTP calls, keyed by URL
    dataplane.infer         DataPlane.infer, keyed by model name (and
                            " revision:<hash>" on an in-process
                            orchestrator's replica)
    engine.residency_swap   ResidencyManager fault-in, keyed by
                            "<model> source:cold|warm"
    engine.spec_draft       a speculative wave's draft seam, keyed by
                            engine name
    engine.spec_verify      a speculative wave's verify seam, keyed by
                            engine name
    engine.kv_spill         the host KV tier's spill, keyed by engine
                            name (and kv_faultback, kv_export,
                            kv_import: its fault-back, drain export and
                            peer import)
    router.dispatch         the ingress router's upstream attempts,
                            keyed by "<url> revision:<hash>" (and
                            router.admission, router.affinity_pick:
                            its brownout gate and ring pick)
    orchestrator.standby_activate
                            a standby's activation, keyed by "<host>
                            <cid> revision:<hash>"
    autoscaler.tick         one component's scaling evaluation, keyed
                            by "<isvc>/<component>"

A site with no configuration costs one dict lookup.  Configuration comes
from the ``KFS_FAULTS`` env var (JSON object keyed by site) or
programmatically (``faults.configure({...})``, tests):

    KFS_FAULTS='{"engine.residency_swap": {"fail_first": 1, "match": "m3"}}'

Per-site knobs, as the JAX module's:

    error_rate   probability in [0, 1] of raising FaultInjected
    fail_first   deterministically fail the first N matching calls
    latency_ms   added delay before the call proceeds
    hang_s       added sleep (a hung dependency; callers' timeouts fire)
    match        whitespace-separated terms that must ALL appear in the
                 call's key
    seed         RNG seed for error_rate draws (default 0)

``FaultInjected`` subclasses ConnectionError, so retry policies classify
an injected fault as transient, as they would a real network flake.
"""

import asyncio
import json
import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

logger = logging.getLogger("kfserving_tpu_torch.reliability.faults")

ENV_VAR = "KFS_FAULTS"


class FaultInjected(ConnectionError):
    """An injected failure (classified transient by retry policies)."""

    def __init__(self, site: str, key: str = ""):
        detail = f" ({key})" if key else ""
        super().__init__(f"injected fault at {site}{detail}")
        self.site = site


@dataclass
class FaultSpec:
    error_rate: float = 0.0
    fail_first: int = 0
    latency_ms: float = 0.0
    hang_s: float = 0.0
    match: str = ""
    seed: int = 0
    # Per-spec mutable state.
    calls: int = 0
    injected: int = 0
    rng: random.Random = field(default_factory=random.Random,
                               repr=False)

    def __post_init__(self):
        self.rng = random.Random(self.seed)


class FaultInjector:
    """Process-global registry of per-site fault specs."""

    def __init__(self):
        self._sites: Dict[str, FaultSpec] = {}
        self._env_loaded = False

    # Config-surface knobs (name -> coercion); the dataclass's
    # bookkeeping fields (calls/injected/rng) are NOT settable —
    # accepting them would silently disable fail_first counting.
    # Values coerce at CONFIG time: a JSON string "0.5" from KFS_FAULTS
    # must fail here, not as a TypeError inside the serving path.
    _KNOBS = {"error_rate": float, "fail_first": int,
              "latency_ms": float, "hang_s": float,
              "match": str, "seed": int}

    # -- configuration -------------------------------------------------------
    def configure(self, config: Dict[str, Dict]) -> None:
        """Install per-site specs (replaces those sites; other sites
        keep their existing spec).  Unknown keys are rejected loudly —
        a typo'd knob must not silently disable a chaos test — and
        validation is all-or-nothing: a bad spec for one site installs
        NOTHING (a half-applied fault config is the worst kind of
        lie)."""
        specs = {}
        for site, raw in config.items():
            unknown = set(raw) - set(self._KNOBS)
            if unknown:
                raise TypeError(
                    f"unknown fault knob(s) {sorted(unknown)} for "
                    f"site {site!r} (valid: {sorted(self._KNOBS)})")
            coerced = {}
            for knob, value in raw.items():
                try:
                    coerced[knob] = self._KNOBS[knob](value)
                except (TypeError, ValueError):
                    raise TypeError(
                        f"fault knob {knob}={value!r} for site "
                        f"{site!r} is not "
                        f"{self._KNOBS[knob].__name__}-coercible")
            specs[site] = FaultSpec(**coerced)
        self._sites.update(specs)
        self._env_loaded = True  # explicit config wins over env

    def reset(self) -> None:
        """Drop all fault specs (tests call this in teardown)."""
        self._sites.clear()
        self._env_loaded = False

    def _load_env(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        raw = os.environ.get(ENV_VAR)
        if not raw:
            return
        try:
            config = json.loads(raw)
        except ValueError:
            logger.error("malformed %s (not JSON); no faults active",
                         ENV_VAR)
            return
        try:
            self.configure(config)
        except TypeError as e:
            logger.error("bad fault spec in %s: %s", ENV_VAR, e)
        else:
            logger.warning("fault injection ACTIVE at sites: %s",
                           ", ".join(sorted(config)))

    def configured(self, site: str) -> bool:
        """Cheap hot-path guard: is any spec installed for `site`?
        Lets latency-critical callers skip wrapper machinery (e.g. a
        wait_for envelope) in the no-faults production case."""
        self._load_env()
        return site in self._sites

    def _spec(self, site: str, key: str) -> Optional[FaultSpec]:
        self._load_env()
        spec = self._sites.get(site)
        if spec is None:
            return None
        # Every whitespace-separated term must match (conjunction):
        # "revision:ab12 :9001" scopes a fault to one revision ON one
        # replica.  A single term without spaces behaves exactly as
        # the original substring match.
        if spec.match and any(term not in key
                              for term in spec.match.split()):
            return None
        return spec

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {site: {"calls": s.calls, "injected": s.injected}
                for site, s in self._sites.items()}

    # -- injection -----------------------------------------------------------
    def _decide(self, spec: FaultSpec, site: str, key: str
                ) -> Optional[FaultInjected]:
        spec.calls += 1
        if spec.fail_first and spec.calls <= spec.fail_first:
            spec.injected += 1
            return FaultInjected(site, key)
        if spec.error_rate > 0 and spec.rng.random() < spec.error_rate:
            spec.injected += 1
            return FaultInjected(site, key)
        return None

    def inject_sync(self, site: str, key: str = "") -> None:
        """Executor-thread edges (storage, the host KV tier): blocking
        sleeps."""
        spec = self._spec(site, key)
        if spec is None:
            return
        if spec.latency_ms:
            time.sleep(spec.latency_ms / 1000.0)
        if spec.hang_s:
            time.sleep(spec.hang_s)
        err = self._decide(spec, site, key)
        if err is not None:
            raise err

    async def inject(self, site: str, key: str = "") -> None:
        """Event-loop edges (client, router): async sleeps."""
        spec = self._spec(site, key)
        if spec is None:
            return
        if spec.latency_ms:
            await asyncio.sleep(spec.latency_ms / 1000.0)
        if spec.hang_s:
            await asyncio.sleep(spec.hang_s)
        err = self._decide(spec, site, key)
        if err is not None:
            raise err


faults = FaultInjector()
