"""Shared helpers of the port's parity tests (not a test module).

``randomized(variables, seed)`` replaces every leaf of a Flax variable
tree with seeded numpy values.  The JAX package's own init hides faults:
the last BatchNorm scale of every bottleneck block is 0 (so each residual
branch is exactly 0) and ViT's CLS token is 0, so a parity test on
``init_params`` weights would pass with a wrong padding or a lost token.
"""

import numpy as np


def _leaf(name: str, shape, rng) -> np.ndarray:
    if name == "var":                          # BatchNorm running variance
        return rng.uniform(0.5, 1.5, shape)
    if name == "scale":                        # norm scales, never 0
        return rng.uniform(0.5, 1.5, shape)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
    if name in ("cls_token", "pos_embed"):
        return rng.normal(0.0, 1.0, shape)
    return rng.normal(0.0, 0.1, shape)         # biases, running means


def randomized(variables, seed: int = 0):
    """A copy of ``variables`` (nested dicts) with every leaf drawn from
    numpy's generator under ``seed``, float32, in sorted key order."""
    rng = np.random.default_rng(seed)

    def walk(tree, name):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return _leaf(name, np.shape(tree), rng).astype(np.float32)

    return walk(variables, "")
