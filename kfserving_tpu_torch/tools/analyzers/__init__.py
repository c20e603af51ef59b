"""The metric-family naming rules (``naming``), shared by the port's
metrics linter (``tools/check_metrics.py``)."""
