"""Multi-device parallelism: device meshes, sharding rules, ring attention.

Port of ``kfserving_tpu/parallel/``.  The reference scales only at
replica granularity (Knative KPA over ``minReplicas/maxReplicas``) and
never touches model internals; this layer adds the within-replica
dimension: a replica is a mesh of ranks, one process each, on one card
each (NCCL over NVLink) or sharing a card or the CPU (gloo), and one
served model is sharded over it.

- mesh.py:     mesh construction over dp/sp/tp dims (a
               ``torch.distributed`` DeviceMesh; replicas stay plain HTTP
               peers exactly like the reference's) and the collectives
               the models issue.
- sharding.py: parameter/activation partition rules for the model zoo
               (Megatron-style tensor parallelism for transformer blocks)
               and ``shard_params``/``shard_module`` placement helpers.
- ring_attention.py: sequence-parallel attention — K/V blocks rotate
               around the ``sp`` ranks (``batch_isend_irecv``) while each
               rank keeps an online-softmax accumulator, so attention over
               sequences longer than one card's memory rides the links.
- multihost.py: ``torch.distributed`` bring-up across hosts and the
               ("dcn", dp, sp, tp) hybrid mesh.
- follower.py: the ranks other than the serving process, which mirror
               its device work (torch has no single controller).
"""

from kfserving_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    build_mesh,
    single_device_mesh,
)
from kfserving_tpu_torch.parallel.multihost import (  # noqa: F401
    hybrid_mesh,
    initialize as initialize_distributed,
)
from kfserving_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicate_params,
    shard_params,
    transformer_rules,
)
