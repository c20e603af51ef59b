"""KFServingClient: the programmatic SDK for the serving fabric.

Mirrors the reference Python SDK's surface (reference
python/kfserving/kfserving/api/kf_serving_client.py:29-380 —
create/get/patch/delete/wait_isvc_ready plus TrainedModel ops, and
kf_serving_watch.py's watch loop) against the TPU control API and
ingress router instead of the K8s apiserver:

    client = KFServingClient("http://127.0.0.1:8081",
                             "http://127.0.0.1:8080")
    await client.create(isvc_dict)
    await client.wait_isvc_ready("sklearn-iris")
    result = await client.predict("sklearn-iris",
                                  {"instances": [[6.8, 2.8, 4.8, 1.4]]})

All methods are async (the whole stack is asyncio); use
``asyncio.run(...)`` from synchronous code or the CLI
(`python -m kfserving_tpu_torch.client`).

Port of ``kfserving_tpu/client/client.py``.  Requests go through the
port's ``server/client.py`` with a connection each: a request is sent
once, and only a failure to connect (nothing sent) is retried.
"""

import asyncio
import json
from dataclasses import asdict, is_dataclass
from urllib.parse import quote
from typing import Any, Dict, List, Optional

from kfserving_tpu_torch.reliability import (
    FaultInjected,
    RetryPolicy,
    fault_sites,
    faults,
)
from kfserving_tpu_torch.server.client import ConnectError, HTTPClient

DEFAULT_TIMEOUT_S = 60.0


class ClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class TimeoutError_(Exception):
    pass


def _to_dict(obj: Any) -> Dict[str, Any]:
    if is_dataclass(obj) and not isinstance(obj, type):
        return asdict(obj)
    if isinstance(obj, dict):
        return obj
    raise TypeError(f"expected spec dict or dataclass, got {type(obj)}")


class KFServingClient:
    """Async client for the control API (+ optional ingress data plane)."""

    def __init__(self, control_url: str,
                 ingress_url: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 retry: Optional[RetryPolicy] = None):
        self.control_url = control_url.rstrip("/")
        self.ingress_url = (ingress_url or "").rstrip("/") or None
        self.timeout_s = timeout_s
        self._session: Optional[HTTPClient] = None
        # Connection-level retry (KFS_CLIENT_RETRY_* knobs): a refused
        # or unroutable connect means the request never reached the
        # server, so replay is safe for every verb — including the
        # non-idempotent ones.  Errors AFTER dispatch (HTTP statuses,
        # mid-body resets, timeouts) are never retried here: a replayed
        # POST could double-create or double-infer.
        self.retry = retry or RetryPolicy.from_env(
            "KFS_CLIENT",
            retry_on=(ConnectError, ConnectionRefusedError, FaultInjected))

    async def _ensure_session(self) -> HTTPClient:
        if self._session is None:
            self._session = HTTPClient(timeout=self.timeout_s,
                                       keepalive=False)
        return self._session

    async def close(self):
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def __aenter__(self):
        await self._ensure_session()
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def _request(self, method: str, url: str,
                       body: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        session = await self._ensure_session()
        data = json.dumps(body).encode() if body is not None else None

        async def attempt():
            await faults.inject(fault_sites.CLIENT_REQUEST, key=url)
            status, _, payload = await session.request(
                method, url, body=data or b"")
            try:
                decoded = json.loads(payload) if payload else {}
            except ValueError:
                decoded = {"raw": payload.decode("utf-8", "replace")}
            if status >= 400:
                raise ClientError(
                    status, decoded.get("error", decoded.get("raw", "")))
            return decoded

        # Only pre-dispatch connection errors are classified retryable
        # (see __init__); ClientError carries the server's verdict and
        # is final.
        return await self.retry.acall(attempt)

    # -- InferenceService CRUD (reference kf_serving_client.py:89-231) ------
    async def create(self, isvc: Any) -> Dict[str, Any]:
        return await self._request(
            "POST", f"{self.control_url}/v1/inferenceservices",
            _to_dict(isvc))

    async def get(self, name: Optional[str] = None,
                  namespace: str = "default") -> Dict[str, Any]:
        if name is None:
            return await self._request(
                "GET", f"{self.control_url}/v1/inferenceservices")
        return await self._request(
            "GET",
            f"{self.control_url}/v1/inferenceservices/{namespace}/{name}")

    async def patch(self, name: str, patch: Dict[str, Any],
                    namespace: str = "default") -> Dict[str, Any]:
        return await self._request(
            "PATCH",
            f"{self.control_url}/v1/inferenceservices/{namespace}/{name}",
            patch)

    async def delete(self, name: str, namespace: str = "default"
                     ) -> Dict[str, Any]:
        return await self._request(
            "DELETE",
            f"{self.control_url}/v1/inferenceservices/{namespace}/{name}")

    # -- rollout helpers (reference canary docs flow) -----------------------
    async def rollout_canary(self, name: str, percent: int,
                             namespace: str = "default",
                             **spec_changes) -> Dict[str, Any]:
        """Set canary traffic percent (optionally with spec changes that
        mint the new revision)."""
        patch: Dict[str, Any] = {"predictor": {
            "canary_traffic_percent": percent, **spec_changes}}
        return await self.patch(name, patch, namespace)

    async def promote(self, name: str, namespace: str = "default"
                      ) -> Dict[str, Any]:
        """Promote the canary to 100% (clears the split; the losing
        revision is garbage-collected)."""
        return await self.patch(
            name, {"predictor": {"canary_traffic_percent": None}},
            namespace)

    async def rollouts(self) -> Dict[str, Any]:
        """Progressive-delivery status from the ingress router:
        active rollouts, recent promotions/rollbacks (with pinned
        evidence), and the quarantine ledger."""
        return await self._request("GET",
                                   f"{self._ingress()}/v2/rollouts")

    async def profile(self, window_s: Optional[float] = None,
                      replica: Optional[str] = None,
                      fmt: str = "trace_json") -> Dict[str, Any]:
        """Fetch the fleet's device-time profile from the ingress
        router: the engine event timeline (decode waves, prefill
        chunks, preemptions, HOLD windows) as Chrome-trace JSON ready
        for Perfetto (fmt="events" returns raw per-replica event
        lists instead)."""
        params = [f"format={fmt}"]
        if window_s is not None:
            params.append(f"window_s={float(window_s)}")
        if replica:
            params.append(f"replica={replica}")
        qs = "&".join(params)
        return await self._request(
            "GET", f"{self._ingress()}/debug/profile?{qs}")

    async def cache(self, replica: Optional[str] = None,
                    top_k: Optional[int] = None,
                    top_cost: Optional[int] = None) -> Dict[str, Any]:
        """Fetch the fleet's federated cache snapshot from the ingress
        router: per-replica prefix-index census (entry count,
        reuse-depth distribution, top-K hot chains), block-pool
        occupancy, and HBM residency — the observability feed
        prefix-affinity routing consumes.  `replica` narrows to one
        host; `top_k` bounds the hot-chain list; `top_cost` adds the
        top-N cost-attribution records ranked by attributed device-ms
        and by KV blocks held."""
        params = []
        if replica:
            params.append(f"replica={replica}")
        if top_k is not None:
            params.append(f"top_k={int(top_k)}")
        if top_cost is not None:
            params.append(f"top_cost={int(top_cost)}")
        qs = ("?" + "&".join(params)) if params else ""
        return await self._request(
            "GET", f"{self._ingress()}/debug/cache{qs}")

    async def incidents(self, incident_id: Optional[str] = None,
                        state: Optional[str] = None,
                        limit: Optional[int] = None,
                        replica: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Fetch diagnosed incidents from the ingress router: each
        replica's incident summaries under its host key plus the
        fleet rollup deduplicated by (root cause, model) and the
        router's own admission/brownout state.  `incident_id` pulls
        one full evidence-bearing record from whichever replica owns
        it; `state` filters (\"open\"/\"closed\"); `replica` narrows
        to one host."""
        params = []
        if incident_id:
            params.append(f"id={quote(incident_id)}")
        if state:
            params.append(f"state={quote(state)}")
        if limit is not None:
            params.append(f"limit={int(limit)}")
        if replica:
            params.append(f"replica={replica}")
        qs = ("?" + "&".join(params)) if params else ""
        return await self._request(
            "GET", f"{self._ingress()}/debug/incidents{qs}")

    async def history(self, series: Optional[str] = None,
                      labels: Optional[Dict[str, str]] = None,
                      window_s: Optional[float] = None,
                      step_s: Optional[float] = None,
                      replica: Optional[str] = None) -> Dict[str, Any]:
        """Fetch federated telemetry history from the ingress router:
        each replica's ring-TSDB frames for `series` (a family name;
        None = every live series) under its `replica` key, plus the
        fleet rollup merged by grid timestamp (rates sum, gauges/
        quantiles/ratios mean).  `labels` filters by label subset,
        `window_s` bounds the lookback, `step_s` overrides the 1 s
        alignment grid, `replica` narrows to one host."""
        params = []
        if series:
            params.append(f"series={quote(series)}")
        if labels:
            pairs = ",".join(f"{k}={v}" for k, v in
                             sorted(labels.items()))
            params.append(f"labels={quote(pairs)}")
        if window_s is not None:
            params.append(f"window_s={float(window_s)}")
        if step_s is not None:
            params.append(f"step_s={float(step_s)}")
        if replica:
            params.append(f"replica={replica}")
        qs = ("?" + "&".join(params)) if params else ""
        return await self._request(
            "GET", f"{self._ingress()}/debug/history{qs}")

    # -- readiness (reference wait_isvc_ready, kf_serving_client.py:232+) ---
    async def wait_isvc_ready(self, name: str, namespace: str = "default",
                              timeout_seconds: float = 120.0,
                              polling_interval: float = 0.2) -> None:
        deadline = asyncio.get_event_loop().time() + timeout_seconds
        last: Dict[str, Any] = {}
        while asyncio.get_event_loop().time() < deadline:
            try:
                last = await self.get(name, namespace)
            except ClientError as e:
                if e.status != 404:
                    raise
                last = {}
            status = (last or {}).get("status") or {}
            if status.get("ready"):
                return
            await asyncio.sleep(polling_interval)
        raise TimeoutError_(
            f"timeout waiting for {namespace}/{name} ready; "
            f"last status: {json.dumps((last or {}).get('status'))}")

    # -- TrainedModel ops (reference client TrainedModel section) -----------
    async def create_trained_model(self, tm: Any) -> Dict[str, Any]:
        return await self._request(
            "POST", f"{self.control_url}/v1/trainedmodels", _to_dict(tm))

    async def get_trained_model(self, name: Optional[str] = None,
                                namespace: str = "default"
                                ) -> Dict[str, Any]:
        if name is None:
            return await self._request(
                "GET", f"{self.control_url}/v1/trainedmodels")
        return await self._request(
            "GET", f"{self.control_url}/v1/trainedmodels/{namespace}/{name}")

    async def delete_trained_model(self, name: str,
                                   namespace: str = "default"
                                   ) -> Dict[str, Any]:
        return await self._request(
            "DELETE",
            f"{self.control_url}/v1/trainedmodels/{namespace}/{name}")

    # -- data plane ---------------------------------------------------------
    def _ingress(self) -> str:
        if self.ingress_url is None:
            raise ValueError(
                "no ingress_url configured; pass it to KFServingClient "
                "to use predict/explain")
        return self.ingress_url

    async def predict(self, name: str, payload: Dict[str, Any],
                      protocol: str = "v1",
                      model_name: Optional[str] = None) -> Dict[str, Any]:
        """POST a predict request through the ingress router.

        model_name: path model (defaults to the isvc name; differs for
        TrainedModels served under a parent isvc)."""
        model = model_name or name
        if protocol == "v2":
            url = f"{self._ingress()}/v2/models/{model}/infer"
        else:
            url = f"{self._ingress()}/v1/models/{model}:predict"
        return await self._request("POST", url, payload)

    async def predict_binary(self, name: str, tensors: Dict[str, Any],
                             model_name: Optional[str] = None,
                             binary_output: bool = False
                             ) -> Dict[str, Any]:
        """V2 binary-wire predict: tensors {name: ndarray} ship as raw
        bytes (Inference-Header-Content-Length extension) — the fast
        wire for dense inputs (images, token ids).  binary_output=True
        returns outputs as raw bytes too; their "data" decode to numpy
        arrays client-side."""
        import numpy as np

        from kfserving_tpu_torch.protocol import v2 as v2proto

        model = model_name or name
        body, hlen = v2proto.make_binary_request(
            {k: np.asarray(v) for k, v in tensors.items()},
            binary_output=binary_output)
        url = f"{self._ingress()}/v2/models/{model}/infer"
        session = await self._ensure_session()
        headers = {"Inference-Header-Content-Length": str(hlen),
                   "Content-Type": "application/octet-stream"}
        status, resp_headers, payload = await session.request(
            "POST", url, body=body, headers=headers)
        resp_hlen = resp_headers.get("inference-header-content-length")
        if status < 400 and resp_hlen:
            return v2proto.decode_binary_response(payload, int(resp_hlen))
        try:
            decoded = json.loads(payload) if payload else {}
        except ValueError:
            decoded = {"raw": payload.decode("utf-8", "replace")}
        if status >= 400:
            raise ClientError(
                status, decoded.get("error", decoded.get("raw", "")))
        return decoded

    async def explain(self, name: str, payload: Dict[str, Any],
                      model_name: Optional[str] = None) -> Dict[str, Any]:
        model = model_name or name
        url = f"{self._ingress()}/v1/models/{model}:explain"
        return await self._request("POST", url, payload)

    # -- credential registration (reference api/creds_utils.py:26-142) ------
    async def create_secret(self, payload: Dict[str, Any],
                            service_account: Optional[str] = None,
                            name: Optional[str] = None) -> str:
        """Register a secret; returns the (possibly generated) name."""
        body = dict(payload)
        if name:
            body["name"] = name
        if service_account:
            body["serviceAccount"] = service_account
        result = await self._request(
            "POST", f"{self.control_url}/v1/secrets", body)
        return result["name"]

    async def attach_secret(self, service_account: str,
                            secret_name: str) -> Dict[str, Any]:
        return await self._request(
            "POST",
            f"{self.control_url}/v1/serviceaccounts/{service_account}"
            f"/secrets",
            {"secret": secret_name})

    async def list_secrets(self) -> Dict[str, Any]:
        return await self._request(
            "GET", f"{self.control_url}/v1/secrets")

    async def delete_secret(self, name: str) -> Dict[str, Any]:
        return await self._request(
            "DELETE", f"{self.control_url}/v1/secrets/{name}")

    async def set_gcs_credentials(self, credentials_file: str,
                                  service_account: str = "default") -> str:
        """Register a GCS key file (reference set_gcs_credentials)."""
        from kfserving_tpu_torch.client.creds import gcs_secret_payload

        # Executor read (kfslint async-blocking): the SDK runs inside
        # callers' live event loops, and a key file can sit on a slow
        # mount.
        payload = await asyncio.get_running_loop().run_in_executor(
            None, gcs_secret_payload, credentials_file)
        return await self.create_secret(
            payload, service_account=service_account)

    async def set_s3_credentials(self, credentials_file: str,
                                 service_account: str = "default",
                                 s3_profile: str = "default",
                                 s3_endpoint: Optional[str] = None,
                                 s3_region: Optional[str] = None,
                                 s3_use_https: Optional[str] = None,
                                 s3_verify_ssl: Optional[str] = None
                                 ) -> str:
        """Register AWS-CLI-format credentials (reference
        set_s3_credentials; endpoint/region/SSL knobs become the same
        secret annotations the builder consumes)."""
        from functools import partial

        from kfserving_tpu_torch.client.creds import s3_secret_payload

        payload = await asyncio.get_running_loop().run_in_executor(
            None, partial(s3_secret_payload, credentials_file,
                          s3_profile=s3_profile,
                          s3_endpoint=s3_endpoint,
                          s3_region=s3_region,
                          s3_use_https=s3_use_https,
                          s3_verify_ssl=s3_verify_ssl))
        return await self.create_secret(
            payload, service_account=service_account)

    async def set_azure_credentials(self, credentials_file: str,
                                    service_account: str = "default"
                                    ) -> str:
        """Register an Azure service-principal JSON (reference
        set_azure_credentials)."""
        from kfserving_tpu_torch.client.creds import azure_secret_payload

        payload = await asyncio.get_running_loop().run_in_executor(
            None, azure_secret_payload, credentials_file)
        return await self.create_secret(
            payload, service_account=service_account)


def isvc_spec(name: str, framework: str, storage_uri: str,
              namespace: str = "default", **predictor_kwargs
              ) -> Dict[str, Any]:
    """Convenience builder for a minimal InferenceService spec dict
    (the SDK-side constructors the reference generates from swagger)."""
    return {
        "name": name,
        "namespace": namespace,
        "predictor": {
            "framework": framework,
            "storage_uri": storage_uri,
            **predictor_kwargs,
        },
    }
