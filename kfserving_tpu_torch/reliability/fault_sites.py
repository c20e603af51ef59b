"""Fault-injection site names of the port.

Port of ``kfserving_tpu/reliability/fault_sites.py``: the same names, so
one ``KFS_FAULTS`` configuration reads alike in both packages.  Only the
sites the port calls are here; the others come with the modules that
call them.
"""

# DataPlane.infer, keyed by model name: an injected failure lands inside
# the request's measured path, as a model-side failure would.
DATAPLANE_INFER = "dataplane.infer"

# ResidencyManager fault-in, keyed by "<model> source:cold|warm": an
# injected failure fails that model's fault-in alone while the resident
# set keeps serving.
ENGINE_RESIDENCY_SWAP = "engine.residency_swap"
