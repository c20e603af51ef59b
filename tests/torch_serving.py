"""Helpers of the port's serving tests: model artifacts, and one client
routine driven against a JAX package ModelServer and the port's on the
same requests."""

import asyncio
import http.client
import json
import os
from typing import Any, Dict, Optional, Tuple

from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu.server.app import ModelServer as JaxModelServer
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.server.app import ModelServer

MLP_CONFIG = {"architecture": "mlp", "batch_buckets": [1, 4],
              "max_batch_size": 4, "max_latency_ms": 2, "warmup": False}
BERT_CONFIG = {"architecture": "bert_tiny",
               "arch_kwargs": {"dtype": "float32"},
               "seq_buckets": [16, 32], "batch_buckets": [1, 4],
               "max_batch_size": 4, "max_latency_ms": 2, "warmup": False,
               "output": "topk", "topk": 3}


def write_artifact(root: str, name: str, config: Dict[str, Any]) -> str:
    model_dir = os.path.join(root, name)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    return model_dir


def request(port: int, method: str, path: str, body: Any = None,
            headers: Optional[Dict[str, str]] = None
            ) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP request: (status, lower-cased headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = (body if body is None or isinstance(body, bytes)
                   else json.dumps(body).encode())
        conn.request(method, path, body=payload, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                data)
    finally:
        conn.close()


async def arequest(port: int, method: str, path: str, body: Any = None,
                   headers: Optional[Dict[str, str]] = None):
    return await asyncio.to_thread(request, port, method, path, body,
                                   headers)


def load_models(kind: str, artifacts: Dict[str, str]):
    """Load every artifact {name: dir} as a JaxModel ("jax") or a CPU
    TorchModel ("torch")."""
    models = []
    for name, model_dir in artifacts.items():
        model = (JaxModel(name, model_dir) if kind == "jax"
                 else TorchModel(name, model_dir, device="cpu"))
        model.load()
        models.append(model)
    return models


async def serve(kind: str, models, drive, **server_kwargs):
    """Serve `models` on a fresh JAX ("jax") or port ("torch") server and
    return ``await drive(server)``."""
    cls = JaxModelServer if kind == "jax" else ModelServer
    server = cls(http_port=0, **server_kwargs)
    await server.start_async(models, host="127.0.0.1")
    try:
        return await drive(server)
    finally:
        await server.stop_async()
        for model in models:
            model.unload()
