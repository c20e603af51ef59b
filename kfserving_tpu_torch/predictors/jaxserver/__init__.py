"""The jaxserver artifact format served by the PyTorch port
(``python -m kfserving_tpu_torch.predictors.jaxserver``)."""
