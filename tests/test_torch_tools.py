"""The port's tools against the JAX package's, on the CPU:
``tools/torch2openapi.py`` (a meta-device shape probe) against
``tools/jax2openapi.py`` (``jax.eval_shape``), and
``tools/check_metrics.py``'s lint rules and smoke run against the JAX
linter's."""

import asyncio
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.models import registry as jax_registry
from kfserving_tpu.models.resnet import ResNet as JaxResNet
from kfserving_tpu.tools import check_metrics as jax_lint
from kfserving_tpu.tools import jax2openapi
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models.resnet import ResNet
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.tools import check_metrics, torch2openapi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=7)


def _jax_resnet(image_size=32, dtype="bfloat16"):
    return (JaxResNet(**REDUCED, dtype=getattr(jnp, dtype)),
            jnp.zeros((1, image_size, image_size, 3), jnp.float32))


def _port_resnet(image_size=32, dtype="bfloat16"):
    with torch.device("meta"):
        module = ResNet(**REDUCED, dtype=dtype, image_size=image_size)
    return module, np.zeros((1, image_size, image_size, 3), np.float32)


@pytest.fixture
def resnet_reduced(monkeypatch):
    monkeypatch.setitem(jax_registry._REGISTRY, "resnet_reduced",
                        _jax_resnet)
    monkeypatch.setitem(port_registry._REGISTRY, "resnet_reduced",
                        _port_resnet)
    return "resnet_reduced"


@pytest.mark.parametrize("arch,kwargs", [
    ("mlp", {}),
    ("mlp", {"input_dim": 4, "features": [8], "num_classes": 2}),
    ("bert_tiny", {}),
    ("bert_tiny", {"seq_len": 32, "dtype": "float32"}),
    ("vit_tiny", {}),
    ("resnet_reduced", {}),
    ("resnet_reduced", {"image_size": 35, "dtype": "float32"}),
])
def test_openapi_document_equals_jax2openapi(resnet_reduced, arch, kwargs):
    got = torch2openapi.generate("svc", arch, kwargs)
    assert got == jax2openapi.generate("svc", arch, kwargs)
    assert "/v1/models/svc:predict" in got["paths"]
    assert got["x-model-signature"]["outputs"]


def test_probe_allocates_no_parameter(monkeypatch):
    """The probe runs the module on meta tensors: no parameter or
    activation gets storage (a materialized module would call
    ``to_empty``; every tensor it sees is on the meta device)."""
    seen = []
    real = torch.nn.Module.__call__

    def spy(module, *args, **kwargs):
        out = real(module, *args, **kwargs)
        for t in list(args) + list(kwargs.values()) + [out]:
            if isinstance(t, torch.Tensor):
                seen.append(t.device.type)
        return out

    monkeypatch.setattr(torch.nn.Module, "__call__", spy)
    monkeypatch.setattr(torch.nn.Module, "to_empty", None)
    sig = torch2openapi.model_signature("bert_tiny")
    assert seen and set(seen) == {"meta"}
    assert [e["name"] for e in sig["inputs"]] == \
        ["input_ids", "attention_mask"]


def test_cli_from_model_dir(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        {"architecture": "mlp",
         "arch_kwargs": {"input_dim": 4, "features": [8],
                         "num_classes": 2}}))
    out = subprocess.run(
        [sys.executable, "-m", "kfserving_tpu_torch.tools.torch2openapi",
         "--model_dir", str(d), "--name", "svc"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == jax2openapi.generate(
        "svc", "mlp", {"input_dim": 4, "features": [8], "num_classes": 2})


FAMILIES = {
    "unprefixed_total": "counter",
    "kfserving_tpu_requests": "counter",          # counter sans _total
    "kfserving_tpu_bad_total": "gauge",           # reserved suffix
    "kfserving_tpu_slow_milliseconds": "histogram",
    "kfserving_tpu_wait": "histogram",            # no unit suffix
    "kfserving_tpu_depth_tokens": "histogram",
    "kfserving_tpu_ok_total": "counter",
    "kfserving_tpu_ok_ms": "histogram",
}
EXPOSITIONS = [
    # tests/test_monitoring.py's duplicate declaration
    "# TYPE kfserving_tpu_x_total counter\n"
    "kfserving_tpu_x_total 1\n"
    "# TYPE kfserving_tpu_x_total counter\n"
    "kfserving_tpu_x_total 2\n",
    # an unprefixed sample, a bare one, a malformed TYPE line
    "# TYPE other_total counter\nother_total 3\nbare_sample 1\n"
    "# TYPE kfserving_tpu_half\n",
    # _ratio gauges: in range, above 1, NaN, unparseable
    "# TYPE kfserving_tpu_fill_ratio gauge\n"
    'kfserving_tpu_fill_ratio{model="a"} 0.5\n'
    'kfserving_tpu_fill_ratio{model="b"} 1.5\n'
    'kfserving_tpu_fill_ratio{model="c"} NaN\n'
    'kfserving_tpu_fill_ratio{model="d"} x\n',
    # a clean one
    "# HELP kfserving_tpu_ok_total ok\n# TYPE kfserving_tpu_ok_total "
    'counter\nkfserving_tpu_ok_total{verb="infer"} 4\n',
]


def test_lint_families_equals_jax():
    got = check_metrics.lint_families(FAMILIES)
    assert got == jax_lint.lint_families(FAMILIES)
    assert len(got) >= 5
    assert not any("kfserving_tpu_ok" in p or "depth_tokens" in p
                   for p in got)


@pytest.mark.parametrize("index", range(len(EXPOSITIONS)))
def test_lint_exposition_equals_jax(index):
    text = EXPOSITIONS[index]
    got = check_metrics.lint_exposition(text)
    assert got == jax_lint.lint_exposition(text)
    assert bool(got) == (index != len(EXPOSITIONS) - 1)


def test_smoke_lints_clean():
    REGISTRY.reset()
    try:
        assert asyncio.run(check_metrics.smoke()) == []
    finally:
        REGISTRY.reset()
