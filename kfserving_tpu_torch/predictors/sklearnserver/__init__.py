from kfserving_tpu_torch.predictors.sklearnserver.model import (  # noqa: F401
    SKLearnModel,
    SKLearnModelRepository,
)
