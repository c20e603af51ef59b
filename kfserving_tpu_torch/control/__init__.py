"""Control plane of the port: declarative serving specs reconciled into
running replicas, with routing, canary, autoscaling, and multi-model
sharding.

Port of ``kfserving_tpu/control``.  The reference's control plane is a
Kubernetes operator (reference pkg/controller/v1beta1/inferenceservice/
controller.go:68-161) that delegates actuation to Knative/Istio.  This
package keeps the same layering with explicit, swappable backends:

- spec.py:        the InferenceService/TrainedModel schema (reference
                  pkg/apis/serving/v1beta1/) plus the slice fields
                  (mesh parallelism, HBM budget, shape buckets).
- defaults.py:    defaulting webhook equivalent.
- validation.py:  validating webhook equivalent (it also refuses what
                  the port does not serve yet).
- topology.py:    slice-shape selection for a predictor's mesh.
- modelconfig.py: models.json shard-config codec (reference
                  pkg/modelconfig/configmap.go).
- sharding.py:    HBM-aware bin-packing shard strategy (reference
                  pkg/controller/v1alpha1/trainedmodel/sharding/memory/
                  strategy.go:29-39).
- reconciler.py:  spec -> desired replica set -> Orchestrator actuation,
                  with revision tracking for canary (reference
                  ksvc_reconciler.go:64-151); controller.py holds the
                  store around it.
- orchestrator.py, subprocess_orchestrator.py: replicas in this process
                  or as processes of their own, on the card unless the
                  caller asks for the CPU; recycles, warm standbys and
                  crash promotion.
- router.py:      HTTP ingress: transformer->predictor chain,
                  :predict/:explain split, canary weighted routing
                  (reference ingress_reconciler.go:164-236), the
                  activator, affinity, failover.
- autoscaler.py:  concurrency-based replica autoscaling with
                  scale-to-zero (Knative KPA equivalent).
- predictive.py:  feed-forward sizing from burn rates, standby
                  pre-arming and brownout entry/exit.
- rollout.py:     SLO-gated progressive delivery: canary stepping with
                  warmup gating, per-revision health gates, auto-rollback
                  with quarantine.
- api.py, manager.py, __main__.py: the control API (the apiserver
                  surface), the ServingManager that wires it all into one
                  process, and ``python -m kfserving_tpu_torch.control``.
"""

from kfserving_tpu_torch.control.spec import (  # noqa: F401
    BatcherSpec,
    ComponentSpec,
    InferenceService,
    LoggerSpec,
    ParallelismSpec,
    PredictorSpec,
    RolloutPolicy,
    TrainedModel,
)
