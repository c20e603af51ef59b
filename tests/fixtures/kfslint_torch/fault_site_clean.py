"""kfslint golden fixture: fault-site must NOT fire (never
executed)."""
from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.reliability.faults import faults


async def probes(model, uri):
    # Manifest constants are the house style, in guards too.
    if faults.configured(fault_sites.DATAPLANE_INFER):
        await faults.inject(fault_sites.DATAPLANE_INFER, key=model)
    # Literals are allowed when they ARE manifest sites.
    faults.inject_sync("storage.download", key=uri)
    # Not an inject call at all.
    faults.configure({})
