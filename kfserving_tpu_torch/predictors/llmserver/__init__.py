"""The port's generative server: ``python -m kfserving_tpu_torch.predictors.llmserver``."""
