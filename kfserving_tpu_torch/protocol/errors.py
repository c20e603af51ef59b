"""Serving error taxonomy mapped to HTTP status codes.

Mirrors the status codes raised by the reference data plane
(reference python/kfserving/kfserving/handlers/http.py and kfserver.py):
400 for malformed input, 404 for unknown model, 503 for not-ready,
500 for inference failure.
"""

from http import HTTPStatus


class ServingError(Exception):
    """Base class; carries an HTTP status code and a reason string."""

    status_code: int = HTTPStatus.INTERNAL_SERVER_ERROR

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class InvalidInput(ServingError):
    """Malformed request payload (reference handlers/http.py:43-51)."""

    status_code = HTTPStatus.BAD_REQUEST


class ModelNotFound(ServingError):
    """Unknown model name (reference kfserver.py:125-129)."""

    status_code = HTTPStatus.NOT_FOUND

    def __init__(self, name: str):
        super().__init__(f"Model with name {name} does not exist.")
        self.name = name


class ModelNotReady(ServingError):
    """Model exists but is not loaded/ready (reference kfserver.py:131-135)."""

    status_code = HTTPStatus.SERVICE_UNAVAILABLE

    def __init__(self, name: str, detail: str = ""):
        reason = f"Model with name {name} is not ready."
        if detail:
            reason = f"{reason} {detail}"
        super().__init__(reason)
        self.name = name


class InferenceError(ServingError):
    """Model execution failed."""

    status_code = HTTPStatus.INTERNAL_SERVER_ERROR
