"""Gradient-saliency explainer, and the black-box noise explainer.

Port of ``kfserving_tpu/explainers/saliency.py``.  ``explain()`` returns,
per instance, the input gradient of the winning logit:
d sum_i max(logits_i) / d x on the fp32 input, computed on the card
next to the served model (the reference explainer pods instead POST
thousands of perturbed samples to the predictor over HTTP).

Deployment shapes:
- ``SaliencyExplainer``: a ``TorchModel`` over the same artifact as the
  predictor (it serves predict too) that differentiates through the
  model locally (white box).
- ``BlackBoxExplainer``: owns no artifact; perturbs inputs and scores
  them against ``predictor_host`` over HTTP.

The gradient is taken outside ``torch.inference_mode`` (the engine's
forwards run inside it, and a tensor made there cannot be saved for
backward), with the parameters not requiring grad, so autograd records
only the path from the input.  Forward and backward run in an executor
thread, on the engine's predict stream under its replay lock: they never
interleave with a CUDA graph replay of the same model.  On the card
ViT's attention launches the flash kernel in the forward through
``ops.attention.FlashAttentionGrad``.
"""

import asyncio
import contextlib
import contextvars
import logging
from typing import Any, Dict

import numpy as np
import torch

from kfserving_tpu_torch.explainers.proxy import PredictorProxyModel
from kfserving_tpu_torch.models import apply_fn_for
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InferenceError

logger = logging.getLogger("kfserving_tpu_torch.explainers")


def _takes_token_ids(example: Any) -> bool:
    """Whether the model's input is integer token ids (BERT's)."""
    first = next(iter(example.values())) if isinstance(example, dict) \
        else example
    return np.asarray(first).dtype.kind in "iu"


class SaliencyExplainer(TorchModel):
    """TorchModel whose explain() returns input-gradient saliency maps.

    Differentiates through the raw logits, not the serving output mode:
    argmax- and topk-configured models explain identically."""

    def load(self) -> bool:
        ok = super().load()
        if ok:
            # Only the input's gradient is taken: autograd records no
            # path through the weights (and saves nothing for them).
            for p in self.module.parameters():
                p.requires_grad_(False)
        return ok

    def input_gradient(self, batch: np.ndarray) -> np.ndarray:
        """d sum(max(logits, -1)) / d batch for one fp32 batch (blocking:
        executor threads)."""
        if _takes_token_ids(self._spec.example):
            # The JAX package casts the batch to fp32 as here, and its
            # embedding lookup refuses it with this error.
            raise ValueError(
                "Input type must be an integer or unsigned integer.")
        engine, module = self.engine, self.module
        if engine is None or module is None:
            raise InferenceError(f"explainer {self.name} not loaded")
        apply = apply_fn_for(self._spec)
        # The JAX explainer multiplies the fp32 batch by the config's
        # scale in fp32 (the serving path rounds the scale to bf16 with
        # its bf16 input; here nothing is bf16 yet).
        scale = self.config.scale
        stream = (torch.cuda.stream(engine._stream)
                  if engine._stream is not None
                  else contextlib.nullcontext())
        with engine._replay_lock, stream, torch.enable_grad():
            x = torch.tensor(batch, device=engine.device,
                             requires_grad=True)
            scaled = x * scale if scale is not None else x
            logits = apply(module, scaled)
            # amax splits a tied maximum's gradient evenly, as jnp.max's
            # does.
            winners = logits.float().amax(dim=-1).sum()
            (grad,) = torch.autograd.grad(winners, x)
            return grad.cpu().numpy()

    async def explain(self, request: Any) -> Any:
        if self.residency is None and self.engine is None:
            raise InferenceError(f"explainer {self.name} not loaded")
        instances = v1.get_instances(request)
        batch = np.asarray(instances, dtype=np.float32)
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()

        async def run():
            return await loop.run_in_executor(
                None, ctx.run, self.input_gradient, batch)

        if self.residency is not None:
            # A demand-paged explainer faults in as a predict would.
            async with self.residency.serving(self.name):
                grads = await run()
        else:
            if self.hbm is not None:
                self.hbm.touch(self.name)
            grads = await run()
        return {
            "explanations": [
                {"saliency": g.tolist(),
                 "method": "gradient_saliency"} for g in grads
            ]
        }

    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        meta["explainer"] = "gradient_saliency"
        return meta


class BlackBoxExplainer(PredictorProxyModel):
    """The reference explainer pods' shape: explain() perturbs inputs
    locally and scores them against predictor_host over HTTP.  Feature
    importance = prediction flip rate under Gaussian feature jitter
    (noise-based, so single-instance requests perturb too)."""

    def __init__(self, name: str, num_samples: int = 32,
                 noise_scale: float = 1.0, seed: int = 0,
                 predict_fn=None):
        super().__init__(name, predict_fn=predict_fn)
        self.num_samples = num_samples
        self.noise_scale = noise_scale
        self.seed = seed

    def load(self) -> bool:
        self.ready = True
        return True

    async def explain(self, request: Any) -> Any:
        if not self.predictor_host and self._predict_fn is None:
            raise InferenceError(
                "BlackBoxExplainer requires predictor_host")
        instances = v1.get_instances(request)
        batch = np.asarray(instances, dtype=np.float32)
        base = await self._remote_predict(batch)
        rng = np.random.default_rng(self.seed)
        n_features = batch.shape[1]
        # Perturbation scale per feature: column std across the batch when
        # informative, else noise_scale (handles batch == 1).
        stds = batch.std(axis=0)
        stds = np.where(stds > 0, stds, self.noise_scale)
        importance = np.zeros((batch.shape[0], n_features))
        for f in range(n_features):
            flips = np.zeros(batch.shape[0])
            for _ in range(self.num_samples):
                perturbed = batch.copy()
                perturbed[:, f] += rng.normal(
                    0.0, stds[f], size=batch.shape[0])
                pred = await self._remote_predict(perturbed)
                flips += (np.asarray(pred) != np.asarray(base)).reshape(
                    batch.shape[0], -1).any(axis=1)
            importance[:, f] = flips / self.num_samples
        return {"explanations": [
            {"feature_importance": imp.tolist(),
             "method": "noise_flip_rate"} for imp in importance]}

    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        meta["explainer"] = "noise_flip_rate"
        return meta

    async def _remote_predict(self, batch: np.ndarray):
        # The shared proxy hop (an ndarray payload takes the V2 binary
        # wire when the predictor speaks it); a named method so tests
        # can replace it.
        return await self._proxied_predict(batch)
