"""Architecture registry: name -> (module, example_input) factories.

Port of ``kfserving_tpu/models/registry.py``.  The ``architecture`` string
of a model's config.json names a factory that yields an ``nn.Module`` on
the meta device and a single-instance example input (numpy, batch dim 1).
``models/weights.py`` materializes the module on its serving device.
The names and kwargs are the JAX package's; a ``dtype`` kwarg may be a
torch dtype or its name ("bfloat16", "float32"), so config.json can carry
it.  User models plug in with ``register_model``.
"""

from typing import Any, Callable, Dict, NamedTuple, Tuple

_REGISTRY: Dict[str, Callable[..., Tuple[Any, Any]]] = {}

# Built-ins resolve lazily (module_path, factory_name).
_LAZY_BUILTINS: Dict[str, Tuple[str, str]] = {
    "resnet50": ("kfserving_tpu_torch.models.resnet", "create_resnet50"),
    "bert": ("kfserving_tpu_torch.models.bert", "_create_bert_base"),
    "bert_tiny": ("kfserving_tpu_torch.models.bert", "_create_bert_tiny"),
    "vit_b16": ("kfserving_tpu_torch.models.vit", "_create_vit_b16"),
    "vit_tiny": ("kfserving_tpu_torch.models.vit", "_create_vit_tiny"),
    "mlp": ("kfserving_tpu_torch.models.mlp", "create_mlp"),
    "decoder": ("kfserving_tpu_torch.models.decoder",
                "_create_decoder_small"),
    "decoder_tiny": ("kfserving_tpu_torch.models.decoder",
                     "_create_decoder_tiny"),
}


class ModelSpec(NamedTuple):
    module: Any                # torch.nn.Module (meta device until loaded)
    example: Any               # single-instance example input (batch dim 1)


def register_model(name: str, factory: Callable[..., Tuple[Any, Any]]):
    _REGISTRY[name] = factory


def list_models():
    return sorted(set(_REGISTRY) | set(_LAZY_BUILTINS))


def _resolve(name: str) -> Callable[..., Tuple[Any, Any]]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _LAZY_BUILTINS:
        import importlib

        module_path, attr = _LAZY_BUILTINS[name]
        factory = getattr(importlib.import_module(module_path), attr)
        _REGISTRY[name] = factory
        return factory
    raise KeyError(
        f"unknown architecture {name!r}; known: {list_models()}")


def create_model(name: str, **kwargs) -> ModelSpec:
    module, example = _resolve(name)(**kwargs)
    return ModelSpec(module, example)


def apply_fn_for(spec: ModelSpec) -> Callable:
    """A (module, batch) -> output function in the engine's calling
    convention: dict batches are splatted as kwargs, tensors passed
    positionally (a bare token batch binds to the first input)."""

    def apply(module, batch):
        if isinstance(batch, dict):
            return module(**batch)
        return module(batch)
    return apply
