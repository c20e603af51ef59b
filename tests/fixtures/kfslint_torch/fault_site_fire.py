"""kfslint golden fixture: fault-site MUST fire (never executed)."""
from kfserving_tpu_torch.reliability.faults import faults


async def probes(name):
    await faults.inject("router.dispatc", key="x")     # FIRE: typo
    await faults.inject(f"dataplane.{name}")           # FIRE: dynamic
    faults.inject_sync("storage.downlaod", key="uri")  # FIRE: typo
    await faults.inject(NOT_A_MANIFEST_CONSTANT)       # FIRE: unknown
    if faults.configured("dataplane.infr"):            # FIRE: guard typo
        pass
