"""Control-plane HTTP API: the K8s-apiserver surface of the framework.

The reference's clients (kubectl, the Python SDK) talk CRD objects to the
API server; the controller watches them (reference
api/kf_serving_client.py:89-380 drives CustomObjectsApi CRUD).  Here the
same CRUD surface is a small REST API directly over the in-process
Controller — apply is synchronous reconcile, so a successful response
already carries the resulting status.

Routes:

    GET    /healthz
    GET    /v1/inferenceservices
    POST   /v1/inferenceservices                      create-or-replace
    GET    /v1/inferenceservices/{ns}/{name}          {"spec","status"}
    PATCH  /v1/inferenceservices/{ns}/{name}          JSON merge-patch
    DELETE /v1/inferenceservices/{ns}/{name}
    GET    /v1/trainedmodels
    POST   /v1/trainedmodels
    GET    /v1/trainedmodels/{ns}/{name}
    DELETE /v1/trainedmodels/{ns}/{name}
    GET    /v1/secrets                                metadata only, no data
    POST   /v1/secrets                                create (+optional attach)
    DELETE /v1/secrets/{name}
    GET    /v1/serviceaccounts
    POST   /v1/serviceaccounts/{name}/secrets         attach existing secret

The secrets surface is the server side of the SDK's credential
registration (reference python/kfserving/kfserving/api/creds_utils.py:
create_secret + set_service_account against the K8s API); secret data is
write-only — list/read endpoints never return it.

Port of ``kfserving_tpu/control/api.py`` on the port's ``server/http.py``:
the same routes, statuses and error messages.
"""

import asyncio
import json
import logging
from dataclasses import asdict
from typing import Any, Dict, Optional

from kfserving_tpu_torch.control.controller import Controller
from kfserving_tpu_torch.control.spec import InferenceService, TrainedModel
from kfserving_tpu_torch.control.validation import ValidationError
from kfserving_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
)

logger = logging.getLogger("kfserving_tpu_torch.control.api")


def _json(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data).encode(), status=status)


def _err(message: str, status: int) -> Response:
    return _json({"error": message}, status=status)


def merge_patch(base: Dict[str, Any], patch: Dict[str, Any]
                ) -> Dict[str, Any]:
    """RFC 7386 JSON merge-patch (null deletes a key)."""
    out = dict(base)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        elif isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge_patch(out[key], value)
        else:
            out[key] = value
    return out


class ControlAPI:
    def __init__(self, controller: Controller, http_port: int = 0,
                 credentials=None, credentials_path: Optional[str] = None):
        self.controller = controller
        self.http_port = http_port
        # CredentialStore shared with the orchestrators; mutations via the
        # secrets routes take effect on the next replica build and persist
        # to credentials_path when configured.
        self.credentials = credentials
        self.credentials_path = credentials_path
        self._persist_lock = asyncio.Lock()
        self.router = Router()
        self._register_routes()
        self.http_server = HTTPServer(self.router)

    def _register_routes(self):
        r = self.router
        r.add("GET", "/healthz", self._healthz)
        r.add("GET", "/v1/inferenceservices", self._list_isvc)
        r.add("POST", "/v1/inferenceservices", self._apply_isvc)
        r.add("GET", "/v1/inferenceservices/{ns}/{name}", self._get_isvc)
        r.add("PATCH", "/v1/inferenceservices/{ns}/{name}",
              self._patch_isvc)
        r.add("DELETE", "/v1/inferenceservices/{ns}/{name}",
              self._delete_isvc)
        r.add("GET", "/v1/trainedmodels", self._list_tm)
        r.add("POST", "/v1/trainedmodels", self._apply_tm)
        r.add("GET", "/v1/trainedmodels/{ns}/{name}", self._get_tm)
        r.add("DELETE", "/v1/trainedmodels/{ns}/{name}", self._delete_tm)
        r.add("GET", "/v1/secrets", self._list_secrets)
        r.add("POST", "/v1/secrets", self._create_secret)
        r.add("DELETE", "/v1/secrets/{name}", self._delete_secret)
        r.add("GET", "/v1/serviceaccounts", self._list_service_accounts)
        r.add("POST", "/v1/serviceaccounts/{name}/secrets",
              self._attach_secret)

    async def start_async(self, host: str = "127.0.0.1"):
        await self.http_server.start(host, self.http_port)
        self.http_port = self.http_server.port

    async def stop_async(self):
        await self.http_server.stop()

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _decode(req: Request) -> Dict[str, Any]:
        try:
            data = json.loads(req.body or b"{}")
        except ValueError as e:
            raise ValidationError(f"invalid JSON body: {e}")
        if not isinstance(data, dict):
            raise ValidationError("body must be a JSON object")
        return data

    def _status_dict(self, name: str, ns: str) -> Optional[dict]:
        status = self.controller.status_of(name, ns)
        if status is None:
            return None
        out = asdict(status)
        out["ready"] = status.ready
        return out

    # -- handlers: InferenceService -----------------------------------------
    async def _healthz(self, req: Request) -> Response:
        return _json({"status": "ok",
                      "inferenceservices": len(self.controller.specs)})

    async def _list_isvc(self, req: Request) -> Response:
        items = []
        for key, isvc in self.controller.specs.items():
            status = self._status_dict(isvc.name, isvc.namespace)
            items.append({
                "name": isvc.name,
                "namespace": isvc.namespace,
                "ready": bool(status and status["ready"]),
            })
        return _json({"items": items})

    async def _apply_isvc(self, req: Request) -> Response:
        try:
            data = self._decode(req)
            isvc = InferenceService.from_dict(data)
            existing = self.controller.get(isvc.name, isvc.namespace)
            await self.controller.apply(isvc)
        except (ValidationError, TypeError, KeyError, ValueError) as e:
            return _err(str(e), 422)
        return _json(
            {"name": isvc.name, "namespace": isvc.namespace,
             "status": self._status_dict(isvc.name, isvc.namespace)},
            status=200 if existing is not None else 201)

    async def _get_isvc(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        isvc = self.controller.get(name, ns)
        if isvc is None:
            return _err(f"inference service {ns}/{name} not found", 404)
        return _json({"spec": isvc.to_dict(),
                      "status": self._status_dict(name, ns)})

    async def _patch_isvc(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        isvc = self.controller.get(name, ns)
        if isvc is None:
            return _err(f"inference service {ns}/{name} not found", 404)
        try:
            patch = self._decode(req)
            merged = merge_patch(isvc.to_dict(), patch)
            merged["name"], merged["namespace"] = name, ns
            updated = InferenceService.from_dict(merged)
            await self.controller.apply(updated)
        except (ValidationError, TypeError, KeyError, ValueError) as e:
            return _err(str(e), 422)
        return _json({"name": name, "namespace": ns,
                      "status": self._status_dict(name, ns)})

    async def _delete_isvc(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        if self.controller.get(name, ns) is None:
            return _err(f"inference service {ns}/{name} not found", 404)
        await self.controller.remove(name, ns)
        return _json({"deleted": f"{ns}/{name}"})

    # -- handlers: TrainedModel ---------------------------------------------
    async def _list_tm(self, req: Request) -> Response:
        items = [{"name": tm.name, "namespace": tm.namespace,
                  "inferenceService": tm.inference_service}
                 for tm in self.controller.trained_models.values()]
        return _json({"items": items})

    async def _apply_tm(self, req: Request) -> Response:
        try:
            data = self._decode(req)
            tm = TrainedModel(**data)
            result = await self.controller.apply_trained_model(tm)
        except (ValidationError, TypeError) as e:
            return _err(str(e), 422)
        return _json({"name": tm.name, "namespace": tm.namespace,
                      **result}, status=201)

    async def _get_tm(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        tm = self.controller.trained_models.get(f"{ns}/{name}")
        if tm is None:
            return _err(f"trained model {ns}/{name} not found", 404)
        return _json({"spec": asdict(tm)})

    async def _delete_tm(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        if f"{ns}/{name}" not in self.controller.trained_models:
            return _err(f"trained model {ns}/{name} not found", 404)
        await self.controller.remove_trained_model(name, ns)
        return _json({"deleted": f"{ns}/{name}"})

    # -- handlers: credentials ----------------------------------------------
    async def _persist_credentials(self) -> None:
        """Persist the store without stalling the loop (kfslint
        async-blocking: this API shares the manager's event loop with
        the router — a slow credentials-volume fsync here would stall
        live inference routing).  Snapshot on the loop (consistent,
        cheap), write in an executor, serialized so an older snapshot
        can never land after a newer one."""
        if not self.credentials_path:
            return
        async with self._persist_lock:
            snapshot = self.credentials.to_dict()
            await asyncio.get_running_loop().run_in_executor(
                None, self.credentials.write_snapshot,
                self.credentials_path, snapshot)

    async def _list_secrets(self, req: Request) -> Response:
        if self.credentials is None:
            return _err("credential store not configured", 404)
        items = [{"name": s.name, "type": s.type,
                  "annotations": s.annotations}
                 for s in self.credentials.secrets.values()]
        return _json({"items": items})

    async def _create_secret(self, req: Request) -> Response:
        if self.credentials is None:
            return _err("credential store not configured", 404)
        try:
            data = self._decode(req)
            secret_type = data["type"]
            if secret_type not in ("s3", "gcs", "azure", "https"):
                raise ValidationError(
                    f"unknown secret type {secret_type!r} "
                    f"(s3 | gcs | azure | https)")
            payload = data.get("data")
            if not isinstance(payload, dict) or not payload:
                raise ValidationError("secret 'data' must be a non-empty "
                                      "JSON object")
            name = self.credentials.add_secret(
                secret_type, payload,
                annotations=data.get("annotations"),
                name=data.get("name"))
            account = data.get("serviceAccount")
            if account:
                self.credentials.attach(account, name)
            await self._persist_credentials()
        except (ValidationError, KeyError, TypeError) as e:
            return _err(str(e), 422)
        return _json({"name": name,
                      "serviceAccount": account or None}, status=201)

    async def _delete_secret(self, req: Request) -> Response:
        if self.credentials is None:
            return _err("credential store not configured", 404)
        name = req.path_params["name"]
        try:
            self.credentials.remove_secret(name)
        except KeyError:
            return _err(f"secret {name} not found", 404)
        await self._persist_credentials()
        return _json({"deleted": name})

    async def _list_service_accounts(self, req: Request) -> Response:
        if self.credentials is None:
            return _err("credential store not configured", 404)
        return _json({"serviceAccounts": {
            k: list(v)
            for k, v in self.credentials.service_accounts.items()}})

    async def _attach_secret(self, req: Request) -> Response:
        if self.credentials is None:
            return _err("credential store not configured", 404)
        account = req.path_params["name"]
        try:
            data = self._decode(req)
            secret = data.get("secret")
            if not isinstance(secret, str) or not secret:
                raise ValidationError("body must carry a 'secret' name")
            self.credentials.attach(account, secret)
        except ValidationError as e:
            return _err(str(e), 422)
        except KeyError as e:
            return _err(str(e), 404)
        await self._persist_credentials()
        return _json({"serviceAccount": account,
                      "secrets": list(
                          self.credentials.service_accounts[account])})
