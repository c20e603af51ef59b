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

# GenerationEngine draft-proposal seam of a speculative decode wave, keyed
# by engine name: an injected error degrades that wave to plain decode
# with the same tokens (specdec_fallbacks_total{site="draft"}).
ENGINE_SPEC_DRAFT = "engine.spec_draft"

# GenerationEngine K+1-position verify seam of a speculative decode wave,
# keyed by engine name: as above, counted under site="verify".
ENGINE_SPEC_VERIFY = "engine.spec_verify"
