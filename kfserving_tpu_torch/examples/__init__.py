"""Examples that run on the port:
``python -m kfserving_tpu_torch.examples.<name>``."""
