"""InferenceService reconciler: spec -> replicas + routes + status.

Reference shape (pkg/controller/v1beta1/inferenceservice/
controller.go:68-161): per-component reconcile, then ingress, then status
conditions; canary is two revisions with a traffic split
(ksvc_reconciler.go:84-118); status tracks previous-ready revision for
rollback (inference_service_status.go:47-70).

The TPU reconciler is the same loop without Kubernetes: revisions are
content hashes of the component spec; the previous revision's replicas
are kept alive while canary_traffic_percent routes a slice of traffic to
the new one; promoting (canary=None) or rolling back (reverting the spec)
garbage-collects the losing revision.
"""

import copy
import hashlib
import json
import logging
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from kfserving_tpu_torch.control.defaults import apply_defaults
from kfserving_tpu_torch.control.spec import ComponentSpec, InferenceService
from kfserving_tpu_torch.control.topology import select_topology
from kfserving_tpu_torch.control.validation import validate

logger = logging.getLogger("kfserving_tpu_torch.control.reconciler")


# Fields that configure traffic/scaling policy, not the served artifact:
# changing them must not mint a new revision (Knative hashes the pod spec;
# traffic split and autoscaling bounds live outside it).  The rollout
# policy is pure traffic policy too — retuning a step schedule must not
# re-roll the model.
_POLICY_FIELDS = ("canary_traffic_percent", "min_replicas", "max_replicas",
                  "rollout")


def revision_of(component: ComponentSpec) -> str:
    """Content-addressed revision id (replaces Knative revision names)."""
    d = asdict(component)
    for f in _POLICY_FIELDS:
        d.pop(f, None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


@dataclass
class TrafficTarget:
    revision: str
    percent: int
    tag: str = ""  # "prev" for the canary's stable side


@dataclass
class ComponentStatus:
    ready: bool = False
    latest_revision: str = ""
    previous_revision: str = ""
    traffic: List[TrafficTarget] = field(default_factory=list)
    replicas: int = 0
    placement: Optional[object] = None  # latest revision's SlicePlacement
    # Placement per revision: during a canary the previous revision keeps
    # the slice shape it was resolved with (its parallelism may differ
    # from the latest spec's).
    placements: Dict[str, object] = field(default_factory=dict)
    # Spec snapshot per live revision: a canary's previous revision (and
    # a rollback's stable revision) must scale with the spec it was
    # APPLIED with — creating a "previous-revision" replica from the
    # latest spec would serve the new artifact under the old label.
    specs: Dict[str, ComponentSpec] = field(default_factory=dict)
    # Set when the applied spec's revision is quarantined and traffic is
    # being substituted to the stable revision instead.
    quarantined_revision: str = ""


@dataclass
class IsvcStatus:
    components: Dict[str, ComponentStatus] = field(default_factory=dict)
    conditions: Dict[str, bool] = field(default_factory=dict)

    @property
    def ready(self) -> bool:
        return bool(self.conditions) and all(self.conditions.values())


class InferenceServiceReconciler:
    def __init__(self, orchestrator):
        self.orchestrator = orchestrator
        self.status: Dict[str, IsvcStatus] = {}
        # Quarantine: component_id -> {bad revision: {stable, reason,
        # ts}}.  A quarantined revision's spec re-applied verbatim is
        # substituted with its recorded stable revision instead of
        # silently re-rolling the exact bytes that just failed a gate.
        self.quarantine: Dict[str, Dict[str, Dict[str, Any]]] = {}

    @staticmethod
    def component_id(isvc: InferenceService, component: str) -> str:
        return f"{isvc.namespace}/{isvc.name}/{component}"

    async def reconcile(self, isvc: InferenceService) -> IsvcStatus:
        apply_defaults(isvc)
        validate(isvc)
        key = f"{isvc.namespace}/{isvc.name}"
        status = self.status.setdefault(key, IsvcStatus())

        for cname, comp in isvc.components().items():
            cstatus = status.components.setdefault(cname, ComponentStatus())
            await self._reconcile_component(isvc, cname, comp, cstatus)
            status.conditions[f"{cname}Ready"] = cstatus.ready
        # Drop components removed from the spec.
        for gone in set(status.components) - set(isvc.components()):
            await self._scale_revisions(
                self.component_id(isvc, gone), {}, None)
            del status.components[gone]
            status.conditions.pop(f"{gone}Ready", None)
        return status

    async def delete(self, isvc: InferenceService) -> None:
        """Finalizer: tear down all components (reference
        controller.go:208-223 deletes child resources)."""
        for cname in list(isvc.components()):
            cid = self.component_id(isvc, cname)
            await self._scale_revisions(cid, {}, None)
            self.quarantine.pop(cid, None)
        self.status.pop(f"{isvc.namespace}/{isvc.name}", None)

    def quarantine_report(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Serializable copy of the quarantine ledger (the single
        shape GET /v2/rollouts serves, manager-wired or not)."""
        return {cid: {rev: dict(info) for rev, info in revs.items()}
                for cid, revs in self.quarantine.items()}

    async def promote(self, isvc: InferenceService, cname: str) -> None:
        """Terminal canary promotion: the latest revision becomes the
        only traffic target and the previous revision is GC'd in one
        reconcile.  Needed as an explicit verb for rollout-managed
        components: their defaulting pins canary_traffic_percent to a
        managed 0, so a plain re-reconcile would read as a fresh 0%
        canary instead of a finished one."""
        key = f"{isvc.namespace}/{isvc.name}"
        status = self.status.get(key)
        cstatus = status.components.get(cname) if status else None
        if cstatus is None:
            return
        latest = cstatus.latest_revision
        cstatus.previous_revision = ""
        cstatus.traffic = [TrafficTarget(latest, 100)]
        spec = cstatus.specs.get(latest, isvc.components().get(cname))
        current = sum(1 for r in self.orchestrator.replicas(
            self.component_id(isvc, cname)) if r.revision == latest)
        floor = max(getattr(spec, "min_replicas", 1) or 1, 1)
        desired = {latest: max(current, floor)}
        for rev in set(cstatus.placements) - set(desired):
            del cstatus.placements[rev]
        for rev in set(cstatus.specs) - set(desired):
            del cstatus.specs[rev]
        cid = self.component_id(isvc, cname)
        await self._scale_revisions(cid, desired, spec,
                                    placements=cstatus.placements,
                                    specs=cstatus.specs)
        cstatus.placement = cstatus.placements.get(latest)
        cstatus.replicas = len(self.orchestrator.replicas(cid))
        cstatus.ready = cstatus.replicas > 0
        status.conditions[f"{cname}Ready"] = cstatus.ready

    async def rollback(self, isvc: InferenceService, cname: str,
                       reason: str = "gate_failed") -> Optional[str]:
        """Auto-rollback: revert ALL traffic to the stable (previous)
        revision in one reconcile and quarantine the losing revision's
        content hash.  Returns the quarantined revision, or None when
        there is no canary pair to roll back.

        The reference models this as re-routing to the
        previous-ready revision (inference_service_status.go:47-70);
        here the quarantine additionally pins the decision: re-applying
        the identical spec resolves to the stable revision instead of
        silently re-rolling the bytes that just failed."""
        key = f"{isvc.namespace}/{isvc.name}"
        status = self.status.get(key)
        cstatus = status.components.get(cname) if status else None
        if cstatus is None:
            return None
        bad = cstatus.latest_revision
        stable = cstatus.previous_revision
        if not stable or stable == bad:
            return None
        cid = self.component_id(isvc, cname)
        self.quarantine.setdefault(cid, {})[bad] = {
            "stable": stable, "reason": reason, "ts": time.time()}
        stable_spec = cstatus.specs.get(stable)
        cstatus.latest_revision = stable
        cstatus.previous_revision = ""
        cstatus.quarantined_revision = bad
        cstatus.traffic = [TrafficTarget(stable, 100)]
        desired = {stable: max(getattr(stable_spec, "min_replicas", 1)
                               or 1, 1)}
        for rev in set(cstatus.placements) - set(desired):
            del cstatus.placements[rev]
        for rev in set(cstatus.specs) - set(desired):
            del cstatus.specs[rev]
        await self._scale_revisions(cid, desired, stable_spec,
                                    placements=cstatus.placements,
                                    specs=cstatus.specs)
        cstatus.placement = cstatus.placements.get(stable)
        replicas = self.orchestrator.replicas(cid)
        cstatus.replicas = len(replicas)
        cstatus.ready = cstatus.replicas > 0
        status.conditions[f"{cname}Ready"] = cstatus.ready
        logger.warning("rolled back %s: revision %s quarantined (%s), "
                       "traffic reverted to %s", cid, bad, reason,
                       stable)
        return bad

    # -- internals ---------------------------------------------------------
    async def _reconcile_component(self, isvc: InferenceService,
                                   cname: str, comp: ComponentSpec,
                                   cstatus: ComponentStatus) -> None:
        cid = self.component_id(isvc, cname)
        new_rev = revision_of(comp)
        quarantined = self.quarantine.get(cid, {}).get(new_rev)
        cstatus.quarantined_revision = ""
        if quarantined is not None:
            # Re-apply of a rolled-back revision: serve a known-good
            # spec instead (content hash remembered — the identical
            # bytes do not re-roll).  A genuinely NEW revision clears
            # this path by hashing differently.  Preferred substitute
            # is the rollback's recorded stable; when its snapshot has
            # since been GC'd (a fixed revision promoted in between),
            # whatever is live now is the stable — the quarantine must
            # outlive any one snapshot.
            substitute = quarantined["stable"]
            if substitute not in cstatus.specs:
                substitute = cstatus.latest_revision
            sub_spec = cstatus.specs.get(substitute)
            if sub_spec is not None:
                logger.warning(
                    "revision %s of %s is quarantined (%s); keeping "
                    "revision %s", new_rev, cid,
                    quarantined.get("reason", "rolled back"),
                    substitute)
                cstatus.quarantined_revision = new_rev
                comp = copy.deepcopy(sub_spec)
                comp.canary_traffic_percent = None
                new_rev = substitute
            else:
                logger.error(
                    "revision %s of %s is quarantined but no live "
                    "spec snapshot exists to substitute; serving it "
                    "anyway", new_rev, cid)
        # Slice topology resolution (the accelerator-injector step,
        # reference mutator.go:113-117 chain): chip-owning predictors get
        # a placement, everything else None.
        cstatus.placement = select_topology(comp, isvc.annotations)
        cstatus.placements[new_rev] = cstatus.placement
        cstatus.specs[new_rev] = copy.deepcopy(comp)

        if cstatus.latest_revision and cstatus.latest_revision != new_rev:
            cstatus.previous_revision = cstatus.latest_revision
        cstatus.latest_revision = new_rev

        canary = comp.canary_traffic_percent
        base = (max(comp.min_replicas, 1)
                if comp.min_replicas > 0 or canary is not None
                else comp.min_replicas)
        # Re-applying an unchanged revision must not undo autoscaling: the
        # reconciler owns the floor, the autoscaler owns anything above it
        # (clamped to max_replicas).
        current = sum(1 for r in self.orchestrator.replicas(cid)
                      if r.revision == new_rev)
        desired: Dict[str, int] = {
            new_rev: min(max(base, current), max(comp.max_replicas, base))}
        if canary is not None and cstatus.previous_revision and \
                cstatus.previous_revision != new_rev:
            # Canary: previous revision keeps serving (reference keeps the
            # `prev` TrafficTarget, ksvc_reconciler.go:92-118), sized by
            # ITS spec snapshot, not the canary's.
            prev_spec = cstatus.specs.get(cstatus.previous_revision, comp)
            desired[cstatus.previous_revision] = \
                max(prev_spec.min_replicas, 1)
            cstatus.traffic = [
                TrafficTarget(new_rev, canary),
                TrafficTarget(cstatus.previous_revision, 100 - canary,
                              tag="prev"),
            ]
        else:
            cstatus.traffic = [TrafficTarget(new_rev, 100)]
            if canary is None:
                cstatus.previous_revision = ""

        # Revisions no longer desired also drop their recorded placement
        # and spec snapshot.
        for rev in set(cstatus.placements) - set(desired):
            del cstatus.placements[rev]
        for rev in set(cstatus.specs) - set(desired):
            del cstatus.specs[rev]
        await self._scale_revisions(cid, desired, comp,
                                    placements=cstatus.placements,
                                    specs=cstatus.specs)
        replicas = self.orchestrator.replicas(cid)
        cstatus.replicas = len(replicas)
        cstatus.ready = all(
            desired.get(rev, 0) <= sum(
                1 for r in replicas if r.revision == rev)
            for rev in desired) and cstatus.replicas > 0

    async def _scale_revisions(self, cid: str,
                               desired: Dict[str, int],
                               comp: Optional[ComponentSpec],
                               placements: Optional[Dict] = None,
                               specs: Optional[Dict] = None) -> None:
        """Converge the orchestrator's replicas to `desired` (rev->count).

        placements maps revision -> SlicePlacement and specs maps
        revision -> ComponentSpec snapshot: a canary's previous (or a
        rollback's stable) revision scales with the slice shape AND the
        spec it was applied with, never the latest spec's — a replica
        labeled with the old revision must serve the old artifact.
        """
        placements = placements or {}
        specs = specs or {}
        current = self.orchestrator.replicas(cid)
        by_rev: Dict[str, List] = {}
        for r in current:
            by_rev.setdefault(r.revision, []).append(r)
        # scale down / remove dead revisions — including any armed
        # warm standby of a revision that stops serving entirely (a
        # retired canary's standby surviving to be crash-promoted
        # later would resurrect the exact revision this scale-down
        # removes).
        reap = getattr(self.orchestrator, "reap_standbys", None)
        for rev, replicas in by_rev.items():
            want = desired.get(rev, 0)
            for replica in replicas[want:]:
                await self.orchestrator.delete_replica(replica)
            if want == 0 and reap is not None:
                await reap(cid, rev)
        if not desired and reap is not None:
            await reap(cid)
        # scale up — counting creates already in flight (an orchestrator
        # swapping/recycling a replica registers it only when ready; a
        # second spawn in that window would double-own a TPU chip).
        # Orchestrators with an armed-standby pool satisfy the
        # increment by ACTIVATING a standby first (one-tick promotion,
        # the warm-standby actuator the predictive autoscaler pre-arms for) —
        # only when the pool is dry does the cold spawn pay its price.
        pending = getattr(self.orchestrator, "pending_creates",
                          lambda cid_, rev_: 0)
        adopt = getattr(self.orchestrator, "adopt_standby", None)
        for rev, want in desired.items():
            have = len(by_rev.get(rev, [])) + pending(cid, rev)
            for _ in range(max(0, want - have)):
                if adopt is not None and \
                        await adopt(cid, rev) is not None:
                    continue
                await self.orchestrator.create_replica(
                    cid, rev, specs.get(rev, comp),
                    placement=placements.get(rev))

    async def scale(self, isvc: InferenceService, cname: str,
                    replicas: int) -> None:
        """Autoscaler entry: resize the latest revision within bounds."""
        comp = isvc.components()[cname]
        replicas = max(comp.min_replicas,
                       min(comp.max_replicas, replicas))
        cid = self.component_id(isvc, cname)
        key = f"{isvc.namespace}/{isvc.name}"
        cstatus = self.status[key].components[cname]
        desired = {t.revision: replicas for t in cstatus.traffic
                   if t.percent > 0}
        # Any 0% traffic target keeps a floor of replicas: a
        # warmup-gated canary is waiting to become ready (scaling it
        # away deadlocks the first step), and the stable side of a
        # 100% final step is the rollback target (scaling it away
        # turns a last-gate rollback into a cold-start outage).
        for t in cstatus.traffic:
            if t.percent == 0:
                spec = cstatus.specs.get(t.revision, comp)
                desired.setdefault(t.revision,
                                   max(spec.min_replicas, 1))
        await self._scale_revisions(cid, desired, comp,
                                    placements=cstatus.placements,
                                    specs=cstatus.specs)
        cstatus.replicas = len(self.orchestrator.replicas(cid))
