from kfserving_tpu_torch.models.registry import (
    ModelSpec,
    apply_fn_for,
    create_model,
    list_models,
    register_model,
)

__all__ = ["ModelSpec", "apply_fn_for", "create_model", "list_models",
           "register_model"]
