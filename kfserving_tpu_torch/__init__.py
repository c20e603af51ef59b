"""kfserving_tpu_torch: the PyTorch/CUDA port of kfserving_tpu.

The package mirrors ``kfserving_tpu``'s layout, one module per counterpart,
and runs on an NVIDIA Hopper card: every kernel the JAX package wrote in
Pallas for the TPU has a hand-written CUDA kernel here (``csrc/``), beside
a plain PyTorch version of the same function that CPU tensors use.

It imports torch, numpy and the standard library only — never jax, flax,
aiohttp or anything of ``kfserving_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from kfserving_tpu_torch.model.model import Model  # noqa: E402
from kfserving_tpu_torch.model.repository import ModelRepository  # noqa: E402
from kfserving_tpu_torch.server.app import ModelServer  # noqa: E402

__all__ = ["Model", "ModelRepository", "ModelServer", "__version__"]
