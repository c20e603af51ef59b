"""Command-line tools of the PyTorch port: checkpoint conversion
(``convert``), the OpenAPI shape probe (``torch2openapi``) and the
metrics-exposition linter (``check_metrics``)."""
