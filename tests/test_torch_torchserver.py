"""The port's torchserver (``kfserving_tpu_torch.predictors.torchserver``)
against the JAX package's, on the CPU.

The same class file and ``model.pt`` load through the port's
``PyTorchModel(device="cpu")`` and the JAX package's (which runs torch
on the host): a linear model of ``tests/test_predictors.py`` and the
CIFAR-10 Net that the chip run serves (``chip_smoke.CIFAR10_NET``).
Predictions must be equal, model-level and over HTTP.  The load contract
(one ``.py`` file, a strict state dict, one module per class file) holds
as in the JAX package.  The port serves on ``cuda`` by default, refuses
``cuda`` without a card, and registers no module under
``kfserving_tpu.``.
"""

import asyncio
import json
import sys

import numpy as np
import pytest
import torch
from torch_serving import arequest, serve

import chip_smoke
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.predictors.torchserver import PyTorchModel as JaxPyTorch
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.predictors.torchserver import PyTorchModel
from kfserving_tpu_torch.predictors.torchserver import __main__ as entry

LINEAR = ("import torch\n"
          "class PyTorchModel(torch.nn.Module):\n"
          "    def __init__(self):\n"
          "        super().__init__()\n"
          "        self.fc = torch.nn.Linear(4, 3)\n"
          "    def forward(self, x):\n"
          "        return self.fc(x)\n")


def _model_dir(root, name, source, class_name, seed):
    """A model directory: the class file and a seeded state dict."""
    import importlib.util

    d = root / name
    d.mkdir()
    (d / "net.py").write_text(source)
    spec = importlib.util.spec_from_file_location(f"_test_{name}",
                                                  d / "net.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.manual_seed(seed)
    net = getattr(module, class_name)()
    torch.save(net.state_dict(), d / "model.pt")
    return d, net


def _both(d, class_name):
    jax_model = JaxPyTorch("m", f"file://{d}", class_name)
    port_model = PyTorchModel("m", f"file://{d}", class_name,
                              device="cpu")
    assert jax_model.load() and port_model.load()
    return jax_model, port_model


@pytest.mark.parametrize("case", ["linear", "cifar10"])
async def test_predictions_equal_jax(tmp_path, case):
    source, class_name, shape = {
        "linear": (LINEAR, "PyTorchModel", (5, 4)),
        "cifar10": (chip_smoke.CIFAR10_NET, "Net", (4, 3, 32, 32)),
    }[case]
    d, net = _model_dir(tmp_path, case, source, class_name, seed=3)
    jax_model, port_model = _both(d, class_name)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    request = {"instances": x.tolist()}
    got = await port_model.predict(request)
    want = await jax_model.predict(request)
    assert got == want
    with torch.no_grad():
        direct = net(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.asarray(got["predictions"], np.float32),
                          direct)
    assert port_model.device == "cpu"
    assert {p.device.type for p in port_model._model.parameters()} == \
        {"cpu"}
    assert not port_model._model.training


def test_served_answers_equal_the_jax_servers(tmp_path):
    d, _ = _model_dir(tmp_path, "cifar", chip_smoke.CIFAR10_NET, "Net", 5)
    x = np.random.default_rng(1).normal(size=(2, 3, 32, 32))
    bodies = [{"instances": x.astype(np.float32).tolist()},
              {"instances": "nope"}, {"instances": [[1.0, 2.0]]}]
    out = {}
    for pkg, cls, kwargs in (("jax", JaxPyTorch, {}),
                             ("torch", PyTorchModel, {"device": "cpu"})):
        model = cls("cifar", str(d), "Net", **kwargs)
        model.load()

        async def drive(server):
            return [await arequest(server.http_port, "POST",
                                   "/v1/models/cifar:predict", body)
                    for body in bodies]

        out[pkg] = [(status, json.loads(data)) for status, _, data in
                    asyncio.run(serve(pkg, [model], drive))]
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    assert out["torch"] == out["jax"]
    assert [status for status, _ in out["torch"]] == [200, 400, 500]


def _load_outcome(model):
    try:
        return model.load()
    except Exception as e:  # compared across the packages
        return (type(e).__name__, str(e))


def test_load_errors_match_jax(tmp_path):
    """Ambiguous class files, a missing class file or model.pt, and a
    state dict that does not fit (strict load)."""
    cases = {}
    ambiguous = tmp_path / "ambiguous"
    ambiguous.mkdir()
    (ambiguous / "a.py").write_text("x = 1\n")
    (ambiguous / "b.py").write_text("x = 2\n")
    (ambiguous / "model.pt").write_bytes(b"")
    cases["ambiguous"] = ambiguous
    no_class = tmp_path / "no_class"
    no_class.mkdir()
    torch.save({}, no_class / "model.pt")
    cases["no_class"] = no_class
    no_weights = tmp_path / "no_weights"
    no_weights.mkdir()
    (no_weights / "net.py").write_text(LINEAR)
    cases["no_weights"] = no_weights
    strict = tmp_path / "strict"
    strict.mkdir()
    (strict / "net.py").write_text(LINEAR)
    torch.save({"fc.weight": torch.zeros(3, 4)}, strict / "model.pt")
    cases["strict"] = strict
    for name, d in cases.items():
        got = _load_outcome(PyTorchModel("m", f"file://{d}", device="cpu"))
        want = _load_outcome(JaxPyTorch("m", f"file://{d}"))
        assert got == want, name
        assert isinstance(got, tuple), name
    assert "More than one Python file" in _load_outcome(PyTorchModel(
        "m", f"file://{ambiguous}", device="cpu"))[1]


async def test_two_models_with_the_same_class_filename(tmp_path):
    """Two model directories both using net.py do not share a cached
    module, in the port as in the JAX package."""
    def make(name, scale):
        d = tmp_path / name
        d.mkdir()
        (d / "net.py").write_text(
            "import torch\n"
            "class PyTorchModel(torch.nn.Module):\n"
            "    def forward(self, x):\n"
            f"        return x * {scale}\n")
        torch.save({}, d / "model.pt")
        return d

    dirs = [make("ma", 2), make("mb", 10)]
    out = {}
    for pkg, cls, kwargs in (("jax", JaxPyTorch, {}),
                             ("torch", PyTorchModel, {"device": "cpu"})):
        models = [cls(d.name, f"file://{d}", **kwargs) for d in dirs]
        for m in models:
            m.load()
        out[pkg] = [await m.predict({"instances": [[1.0]]})
                    for m in models]
    assert out["torch"] == out["jax"] == [{"predictions": [[2.0]]},
                                          {"predictions": [[10.0]]}]


def test_user_modules_live_under_the_ports_namespace(tmp_path):
    d, _ = _model_dir(tmp_path, "ns", LINEAR, "PyTorchModel", seed=0)
    before = set(sys.modules)
    PyTorchModel("m", str(d), device="cpu").load()
    added = set(sys.modules) - before
    assert added and all(name.startswith(
        "kfserving_tpu_torch._torch_user_") for name in added)
    assert not any(name.startswith("kfserving_tpu.") for name in added)


def test_cuda_is_the_default_and_never_falls_back(tmp_path):
    """The port serves on the card unless asked for the CPU; asked for
    cuda on a machine without one, load raises before anything runs."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    d, _ = _model_dir(tmp_path, "gpu", LINEAR, "PyTorchModel", seed=0)
    model = PyTorchModel("m", str(d))
    assert model.device == "cuda"
    before = set(sys.modules)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        model.load()
    assert not model.ready and model._model is None
    assert set(sys.modules) == before       # no user code was run
    args, rest = entry.parser.parse_known_args(
        ["--model_dir", str(d), "--http_port", "0"])
    assert args.device == "cuda" and rest == []
    args, _ = entry.parser.parse_known_args(
        ["--model_dir", str(d), "--device", "cpu",
         "--model_class_name", "Net"])
    assert (args.device, args.model_class_name) == ("cpu", "Net")
