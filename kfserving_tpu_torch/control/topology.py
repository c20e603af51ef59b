"""TPU slice topology selector — the GKE accelerator injector analogue.

The reference copies the `serving.kubeflow.org/gke-accelerator`
annotation into the pod's nodeSelector when (and only when) a GPU
resource is requested (reference
pkg/webhook/admission/pod/accelerator_injector.go:30-47).  The TPU
equivalent has to do more than label-matching: a replica that wants
`dp*tp*sp` chips must land on a slice whose physical topology actually
provides them, slices only come in fixed shapes per generation, and a
JAX process discovers its slice through environment variables
(TPU_ACCELERATOR_TYPE / TPU_TOPOLOGY), not a node selector.

So the selector is a small solver over the published slice shapes:

    placement = select_topology(predictor_spec, isvc.annotations)

- gate: only chip-owning predictors (framework "jax"/"generative", or "custom" with
  an explicit generation annotation) get a placement — CPU frameworks
  return None, mirroring the reference's "GPU requested" gate;
- the mesh size `parallelism.chips_per_replica` picks the smallest
  slice shape that fits (spare chips are recorded, not hidden);
- annotations override: `tpu.kfserving.dev/generation` selects the
  hardware generation, `tpu.kfserving.dev/topology` forces an exact
  shape (validated against the generation's table).

The reconciler threads the placement into the orchestrator; the
subprocess backend exports `placement.env()` into the replica process
exactly where the reference's injector wrote the nodeSelector.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

ANNOTATION_GENERATION = "tpu.kfserving.dev/generation"
ANNOTATION_TOPOLOGY = "tpu.kfserving.dev/topology"

DEFAULT_GENERATION = "v5e"


class TopologyError(ValueError):
    """No slice shape satisfies the requested mesh/annotations."""


@dataclass(frozen=True)
class SlicePlacement:
    """A resolved slice assignment for one replica."""

    generation: str        # "v5e" | "v4" | "v5p"
    topology: str          # e.g. "2x4" (2D) or "2x2x2" (3D)
    chips: int             # chips the slice provides
    hosts: int             # worker VMs in the slice
    accelerator_type: str  # cloud accelerator name, e.g. "v5litepod-8"
    mesh_chips: int        # chips the replica's mesh actually uses

    @property
    def spare_chips(self) -> int:
        return self.chips - self.mesh_chips

    def env(self) -> Dict[str, str]:
        """Replica process environment (how JAX discovers the slice —
        the TPU analogue of the injected nodeSelector)."""
        return {
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            "TPU_TOPOLOGY": self.topology,
            "TPU_CHIPS_PER_REPLICA": str(self.mesh_chips),
            "TPU_WORKER_HOSTS": str(self.hosts),
        }


# Published slice shapes per generation: (topology, chips, hosts).
# v5e slices are 2D; single-host up to 8 chips, multi-host VMs carry 4
# chips each.  v4/v5p are 3D with 4 chips per host.  The accelerator
# name counts chips for v5e (v5litepod-N) and TensorCores (2/chip) for
# v4/v5p (v4-2N).
_V5E: Sequence[Tuple[str, int, int]] = (
    ("1x1", 1, 1), ("2x2", 4, 1), ("2x4", 8, 1), ("4x4", 16, 4),
    ("4x8", 32, 8), ("8x8", 64, 16), ("8x16", 128, 32),
    ("16x16", 256, 64),
)
_3D: Sequence[Tuple[str, int, int]] = (
    ("2x2x1", 4, 1), ("2x2x2", 8, 2), ("2x2x4", 16, 4),
    ("2x4x4", 32, 8), ("4x4x4", 64, 16), ("4x4x8", 128, 32),
    ("4x8x8", 256, 64), ("8x8x8", 512, 128),
)

GENERATIONS: Dict[str, Sequence[Tuple[str, int, int]]] = {
    "v5e": _V5E,
    "v4": _3D,
    "v5p": _3D,
}


def _accelerator_type(generation: str, chips: int) -> str:
    if generation == "v5e":
        return f"v5litepod-{chips}"
    return f"{generation}-{2 * chips}"


def _placement(generation: str, shape: Tuple[str, int, int],
               mesh_chips: int) -> SlicePlacement:
    topology, chips, hosts = shape
    return SlicePlacement(
        generation=generation, topology=topology, chips=chips,
        hosts=hosts, accelerator_type=_accelerator_type(generation, chips),
        mesh_chips=mesh_chips)


def select_topology(predictor_spec,
                    annotations: Optional[Dict[str, str]] = None
                    ) -> Optional[SlicePlacement]:
    """Resolve the slice placement for a predictor component.

    Returns None for components that don't own chips.  Raises
    TopologyError when the mesh cannot be placed or an annotation names
    an unknown generation/topology.
    """
    annotations = annotations or {}
    generation = annotations.get(ANNOTATION_GENERATION)
    framework = getattr(predictor_spec, "framework", None)
    if framework not in ("jax", "generative") and not (
            framework == "custom" and generation):
        return None
    generation = generation or DEFAULT_GENERATION
    shapes = GENERATIONS.get(generation)
    if shapes is None:
        raise TopologyError(
            f"unknown TPU generation {generation!r}; known: "
            f"{sorted(GENERATIONS)}")

    par = getattr(predictor_spec, "parallelism", None)
    mesh_chips = par.chips_per_replica if par is not None else 1

    forced = annotations.get(ANNOTATION_TOPOLOGY)
    if forced:
        for shape in shapes:
            if shape[0] == forced:
                if shape[1] < mesh_chips:
                    raise TopologyError(
                        f"topology {forced} has {shape[1]} chips but the "
                        f"mesh needs {mesh_chips} (dp*tp*sp)")
                return _placement(generation, shape, mesh_chips)
        raise TopologyError(
            f"unknown {generation} topology {forced!r}; known: "
            f"{[s[0] for s in shapes]}")

    for shape in shapes:  # tables are sorted ascending by chips
        if shape[1] >= mesh_chips:
            return _placement(generation, shape, mesh_chips)
    largest = shapes[-1]
    raise TopologyError(
        f"mesh needs {mesh_chips} chips but the largest {generation} "
        f"slice is {largest[0]} ({largest[1]} chips); shard across "
        f"replicas (dp) instead")
