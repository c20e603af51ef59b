"""The port's compiled-program accounting against the JAX package's, on the
CPU: ``kfserving_tpu_compile_cache_total{outcome}`` counted per dispatch
by ``TorchEngine`` as ``JaxEngine`` counts it, the ``KFS_MINIMAL_WARMUP``
grid of the predictors, and the compile-cache funnel's warmup
declaration, which reaches the sanitizer (``KFS_SANITIZE=1``).  (On the
card a miss is a CUDA graph capture; chip_smoke.py holds the graphs
there.)
"""

import numpy as np
import pytest
from torch_serving import BERT_CONFIG, MLP_CONFIG, write_artifact

from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch.engine import compile_cache
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.reliability import sanitizer

FAMILY = "kfserving_tpu_compile_cache_total"


def _counts(registry) -> dict:
    family = registry.counter(FAMILY)
    return {labels["outcome"]: child.value
            for labels, child in family.samples()}


def _requests(arch: str):
    """One request sequence: first sightings and repeats of buckets."""
    rng = np.random.default_rng(4)
    if arch == "mlp":
        rows = [rng.normal(size=(n, 64)).tolist() for n in (1, 3, 1, 4, 2)]
        return [{"instances": r} for r in rows]
    return [{"instances": [rng.integers(1, 90, size=n).tolist()]}
            for n in (5, 20, 7, 30, 12)]


def _model(kind: str, model_dir: str):
    return (JaxModel("m", model_dir) if kind == "jax"
            else TorchModel("m", model_dir, device="cpu"))


@pytest.mark.parametrize("arch,config,warmup", [
    ("mlp", MLP_CONFIG, False), ("mlp", MLP_CONFIG, True),
    ("bert", BERT_CONFIG, True)])
async def test_hits_and_misses_match_the_jax_engine(tmp_path, arch, config,
                                                    warmup):
    """The same load (with or without warmup) and requests move the
    family's hit and miss counts, and the compile count, equally in both
    engines."""
    model_dir = write_artifact(str(tmp_path), arch,
                               dict(config, warmup=warmup))
    moved = {}
    for kind, registry in (("jax", JAX_REGISTRY), ("torch", REGISTRY)):
        before = _counts(registry)
        model = _model(kind, model_dir)
        model.load()
        try:
            for body in _requests(arch):
                await model.predict(body)
            compiled = model.engine.compile_count
        finally:
            model.unload()
        after = _counts(registry)
        moved[kind] = {k: after.get(k, 0) - before.get(k, 0)
                       for k in ("hit", "miss")}
        moved[kind]["compile_count"] = compiled
    assert moved["torch"] == moved["jax"]
    assert moved["torch"]["miss"] > 0 and moved["torch"]["hit"] > 0


def test_minimal_warmup_trims_the_grid_as_jax(tmp_path, monkeypatch):
    """KFS_MINIMAL_WARMUP=1: only the largest batch bucket per seq
    bucket; the compile count and the warmed shapes equal the JAX
    predictor's, and neither declares its warmup complete."""
    monkeypatch.setenv("KFS_MINIMAL_WARMUP", "1")
    monkeypatch.setenv("KFS_SANITIZE", "1")
    sanitizer.reset()
    model_dir = write_artifact(str(tmp_path), "bert",
                               dict(BERT_CONFIG, warmup=True))
    jax_model, port = JaxModel("m", model_dir), \
        TorchModel("m", model_dir, device="cpu")
    jax_model.load()
    port.load()
    try:
        jax_grid = sorted(jax_model.engine._compiled_shapes)
        assert sorted(port.engine._dispatched) == jax_grid
        assert port.engine.compile_count == \
            jax_model.engine.compile_count == len(jax_grid)
        assert jax_grid == [(4, 16), (4, 32)]
        assert port.engine.compile_source not in \
            sanitizer.status()["warmed_sources"]
    finally:
        jax_model.unload()
        port.unload()
        sanitizer.reset()


def test_warmup_declaration_counts_later_notes(tmp_path, monkeypatch):
    """A note before the source's declared warmup is expected; one after
    it is a sanitizer ``recompile`` violation.  A full warmup declares, a
    minimal one does not."""
    monkeypatch.setenv("KFS_SANITIZE", "1")
    sanitizer.reset()
    source = "test-source"
    try:
        compile_cache.note_compilation(source, ("b", 1))
        assert sanitizer.violations() == {}
        compile_cache.declare_warmup_complete(source)
        compile_cache.note_compilation(source, ("b", 2))
        compile_cache.note_compilation(source, ("b", 4))
        assert sanitizer.violations() == {"recompile": 2}

        model_dir = write_artifact(str(tmp_path), "mlp",
                                   dict(MLP_CONFIG, warmup=True))
        port = TorchModel("m", model_dir, device="cpu")
        port.load()
        try:
            engine = port.engine
            assert engine.compile_source in \
                sanitizer.status()["warmed_sources"]
            # Every bucket was warmed: serving compiles nothing new.
            port.engine.predict_sync(np.zeros((3, 64), np.float32))
            assert sanitizer.violations() == {"recompile": 2}
        finally:
            port.unload()
    finally:
        sanitizer.reset()
