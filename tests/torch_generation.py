"""Helpers of the port's generation tests (not a test module): one tiny
decoder on shared weights in both packages, and the JAX package's token
rules run teacher-forced on its full forward.

The reference is the JAX decoder's ``apply`` (jitted once at a fixed
padded length; causal attention makes the padding inert).  Greedy picks
its argmax; a seeded request draws ``argmax(logits / T + gumbel)`` under
the JAX generator's key ``fold_in(fold_in(PRNGKey(rng_seed), seed),
position)``, the position being the length of the prefix the token
extends.  The JAX GenerationEngine itself is never driven (it takes tens
of seconds a test on the CPU).
"""

import asyncio
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kfserving_tpu.models.decoder import DecoderLM, decoder_tiny
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights

MAX_SEQ = 128
ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
            intermediate_size=128, max_seq=MAX_SEQ, vocab_size=96)
RNG_SEED = 7
# Engine logits/logprobs vs the JAX forward (fp32; the cached paths and
# the full forward sum in another order), as tests/test_torch_generator.py
# bounds them.
LOGPROB_ATOL = 1e-4
# Sampled scores closer than this to their runner-up are near-ties, where
# the two packages' Gumbel logarithms (a few ulps apart) may pick
# different tokens; the tests' seeds are chosen to have none.
NEAR_TIE = 1e-4


class TinyDecoder:
    """The JAX decoder, its variables, and the port's module on the same
    weights (fp32, CPU)."""

    def __init__(self, arch: Dict = ARCH):
        self.arch = dict(arch)
        self.jax_module = DecoderLM(decoder_tiny(**self.arch))
        self.variables = jax.tree_util.tree_map(
            np.asarray, jax.jit(self.jax_module.init)(
                jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
        self.apply = jax.jit(self.jax_module.apply)
        self._cache: Dict[tuple, np.ndarray] = {}

    def port(self) -> torch.nn.Module:
        spec = create_model("decoder_tiny", **self.arch)
        return weights.materialize(
            spec.module, torch.device("cpu"),
            state_dict=weights.decoder_params_from_flax(self.variables))

    def logits(self, seq) -> np.ndarray:
        """JAX full-forward logits [len(seq), V] of one sequence."""
        key = tuple(int(t) for t in seq)
        if key not in self._cache:
            buf = np.zeros((1, self.arch["max_seq"]), np.int32)
            buf[0, :len(key)] = key
            self._cache[key] = np.asarray(
                self.apply(self.variables, jnp.asarray(buf)))[0, :len(key)]
        return self._cache[key]

    def greedy(self, prompt, steps: int) -> List[int]:
        ids = [int(t) for t in prompt]
        for _ in range(steps):
            ids.append(int(np.argmax(self.logits(ids)[-1])))
        return ids[len(prompt):]

    def sampled(self, prompt, steps: int, temperature: float,
                seed: int) -> List[int]:
        """The JAX sampling rule (no top-k / top-p), teacher-forced;
        asserts no near-tie decided a token."""
        base = jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), seed)
        ids = [int(t) for t in prompt]
        for _ in range(steps):
            pos = len(ids)
            noise = np.asarray(jax.random.gumbel(
                jax.random.fold_in(base, pos), (self.arch["vocab_size"],)))
            scores = self.logits(ids)[-1] / max(temperature, 1e-6) + noise
            top2 = np.sort(scores)[-2:]
            assert top2[1] - top2[0] >= NEAR_TIE, (pos, top2)
            ids.append(int(np.argmax(scores)))
        return ids[len(prompt):]


def prompt(seed: int, n: int, vocab: int = ARCH["vocab_size"]) -> List[int]:
    """A seeded prompt of n ids in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, vocab, size=n)]


async def complete_all(engine, requests, timeout: float = 120.0):
    """Run (prompt, max_new_tokens, sampling kwargs) requests at once;
    returns [(tokens, finish_reason)] and closes the engine."""
    try:
        return await asyncio.wait_for(asyncio.gather(*[
            engine.complete(p, max_new_tokens=n, **kw)
            for p, n, kw in requests]), timeout=timeout)
    finally:
        await engine.close()
