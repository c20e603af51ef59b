"""Credential injection for model-artifact storage.

Port of ``kfserving_tpu/storage/credentials.py``, which re-expresses the
reference credentials builder (reference
pkg/credentials/service_account_credentials.go:64+ and the
{s3,gcs,azure,https}/*_secret.go sub-packages): secrets attached to a
service account become environment variables / credential files on the
serving replica, so `Storage.download` finds them the same way the
reference's storage-initializer container does.

Without Kubernetes the secret store is a JSON file (the cluster
operator's analogue of Secret objects):

    {
      "serviceAccounts": {"default": ["my-s3", "my-gcs"]},
      "secrets": {
        "my-s3": {
          "type": "s3",
          "data": {"accessKeyId": "...", "secretAccessKey": "..."},
          "annotations": {
            "serving.kfserving.io/s3-endpoint": "minio:9000",
            "serving.kfserving.io/s3-usehttps": "0",
            "serving.kfserving.io/s3-region": "us-east-1"
          }
        },
        "my-gcs":   {"type": "gcs", "data": {"gcloud": {...sa json...}}},
        "my-azure": {"type": "azure", "data": {"subscriptionId": "...",
                     "tenantId": "...", "clientId": "...",
                     "clientSecret": "..."}},
        "my-https": {"type": "https", "data": {"host": "models.example",
                     "headers": {"Authorization": "Bearer ..."}}}
      }
    }

`build_env(service_account)` returns the env mapping (writing the GCS
JSON to disk); orchestrators inject it into replica processes
(subprocess env / in-process os.environ), mirroring the reference's
env+volume injection into containers.
"""

import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("kfserving_tpu_torch.credentials")

# Annotation keys (reference pkg/credentials/s3/s3_secret.go constants).
S3_ENDPOINT_ANNOTATION = "serving.kfserving.io/s3-endpoint"
S3_USEHTTPS_ANNOTATION = "serving.kfserving.io/s3-usehttps"
S3_REGION_ANNOTATION = "serving.kfserving.io/s3-region"
S3_VERIFYSSL_ANNOTATION = "serving.kfserving.io/s3-verifyssl"

# File name matches the reference configmap default
# (gcsCredentialFileName, service_account_credentials.go:39-62).
DEFAULT_GCS_FILE_NAME = "gcloud-application-credentials.json"


@dataclass
class Secret:
    name: str
    type: str  # s3 | gcs | azure | https
    data: Dict = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


class CredentialStore:
    """Service-account -> secrets registry (the Secret-object store)."""

    def __init__(self, service_accounts: Optional[Dict[str, List[str]]]
                 = None,
                 secrets: Optional[Dict[str, Secret]] = None,
                 gcs_file_name: str = DEFAULT_GCS_FILE_NAME,
                 creds_dir: Optional[str] = None):
        self.service_accounts = service_accounts or {}
        self.secrets = secrets or {}
        self.gcs_file_name = gcs_file_name
        self._creds_dir = creds_dir

    @classmethod
    def load(cls, path: Optional[str],
             gcs_file_name: str = DEFAULT_GCS_FILE_NAME
             ) -> "CredentialStore":
        if not path:
            return cls(gcs_file_name=gcs_file_name)
        if not os.path.exists(path):
            # A configured-but-absent store starts empty; the first
            # client-side registration creates it (control/api.py).
            return cls(gcs_file_name=gcs_file_name)
        with open(path) as f:
            data = json.load(f)
        return cls.from_dict(data, gcs_file_name=gcs_file_name)

    @classmethod
    def from_dict(cls, data: Dict,
                  gcs_file_name: str = DEFAULT_GCS_FILE_NAME
                  ) -> "CredentialStore":
        secrets = {}
        for name, entry in (data.get("secrets") or {}).items():
            secrets[name] = Secret(
                name=name,
                type=entry.get("type", ""),
                data=entry.get("data") or {},
                annotations=entry.get("annotations") or {})
        return cls(service_accounts=dict(
                       data.get("serviceAccounts") or {}),
                   secrets=secrets, gcs_file_name=gcs_file_name)

    # -- registration (SDK creds_utils server side) -------------------------
    def add_secret(self, type: str, data: Dict,
                   annotations: Optional[Dict[str, str]] = None,
                   name: Optional[str] = None) -> str:
        """Create-or-replace a secret; generates a name when none given
        (reference creds_utils.create_secret uses generateName
        'kfserving-secret-', api/creds_utils.py:144-167)."""
        if not name:
            n = len(self.secrets)
            while f"kfserving-secret-{n}" in self.secrets:
                n += 1
            name = f"kfserving-secret-{n}"
        self.secrets[name] = Secret(name=name, type=type, data=dict(data),
                                    annotations=dict(annotations or {}))
        return name

    def attach(self, service_account: str, secret_name: str) -> None:
        """Attach a secret to a service account, creating the account if
        absent (reference set_service_account create-or-patch,
        api/creds_utils.py:170-180)."""
        if secret_name not in self.secrets:
            raise KeyError(f"secret {secret_name!r} not found")
        attached = self.service_accounts.setdefault(service_account, [])
        if secret_name not in attached:
            attached.append(secret_name)

    def remove_secret(self, name: str) -> None:
        if name not in self.secrets:
            raise KeyError(f"secret {name!r} not found")
        del self.secrets[name]
        for attached in self.service_accounts.values():
            if name in attached:
                attached.remove(name)

    def to_dict(self) -> Dict:
        return {
            "serviceAccounts": {k: list(v)
                                for k, v in self.service_accounts.items()},
            "secrets": {
                name: {"type": s.type, "data": s.data,
                       "annotations": s.annotations}
                for name, s in self.secrets.items()
            },
        }

    def save(self, path: str) -> None:
        """Persist the store (atomic replace; the file holds live
        credentials, so 0600 like the GCS key file)."""
        self.write_snapshot(path, self.to_dict())

    @staticmethod
    def write_snapshot(path: str, data: Dict) -> None:
        """Write an already-taken `to_dict()` snapshot.  Split from
        `save` so async callers can snapshot on the event loop (cheap,
        consistent) and ship only the disk write to an executor —
        handing the live store to a writer thread would race its dict
        iteration against loop-side mutations."""
        tmp = f"{path}.tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, path)

    # -- builder (CreateSecretVolumeAndEnv equivalent) ----------------------
    def build_env(self, service_account: str = "default"
                  ) -> Dict[str, str]:
        """Env mapping for a replica running under `service_account`.

        GCS service-account JSON is written to a credentials dir and
        referenced by GOOGLE_APPLICATION_CREDENTIALS (the reference
        mounts the secret as a volume at the same file name).
        """
        env: Dict[str, str] = {}
        for secret_name in self.service_accounts.get(service_account, []):
            secret = self.secrets.get(secret_name)
            if secret is None:
                logger.warning("secret %s attached to %s not found",
                               secret_name, service_account)
                continue
            builder = getattr(self, f"_build_{secret.type}", None)
            if builder is None:
                logger.warning("unknown secret type %r on %s",
                               secret.type, secret_name)
                continue
            builder(secret, env, service_account)
        return env

    def _build_s3(self, secret: Secret, env: Dict[str, str],
                  account: str = "default") -> None:
        """Reference s3_secret.go: key id/secret from data, endpoint/
        region/SSL knobs from annotations."""
        if "accessKeyId" in secret.data:
            env["AWS_ACCESS_KEY_ID"] = str(secret.data["accessKeyId"])
        if "secretAccessKey" in secret.data:
            env["AWS_SECRET_ACCESS_KEY"] = str(
                secret.data["secretAccessKey"])
        ann = secret.annotations
        if S3_ENDPOINT_ANNOTATION in ann:
            endpoint = ann[S3_ENDPOINT_ANNOTATION]
            env["S3_ENDPOINT"] = endpoint
            use_https = ann.get(S3_USEHTTPS_ANNOTATION, "1")
            env["S3_USE_HTTPS"] = use_https
            scheme = "https" if use_https not in ("0", "false") else "http"
            env["AWS_ENDPOINT_URL"] = f"{scheme}://{endpoint}"
        if S3_REGION_ANNOTATION in ann:
            env["AWS_REGION"] = ann[S3_REGION_ANNOTATION]
        if S3_VERIFYSSL_ANNOTATION in ann:
            env["S3_VERIFY_SSL"] = ann[S3_VERIFYSSL_ANNOTATION]

    def _build_gcs(self, secret: Secret, env: Dict[str, str],
                   account: str = "default") -> None:
        payload = secret.data.get("gcloud")
        if payload is None:
            logger.warning("gcs secret %s has no 'gcloud' key",
                           secret.name)
            return
        if self._creds_dir is None:
            self._creds_dir = tempfile.mkdtemp(prefix="kfs-creds-")
        # Per-account subdirectory: two service accounts must never
        # share (and overwrite) one key file.
        account_dir = os.path.join(self._creds_dir, account)
        os.makedirs(account_dir, exist_ok=True)
        path = os.path.join(account_dir, self.gcs_file_name)
        with open(path, "w") as f:
            if isinstance(payload, str):
                f.write(payload)
            else:
                json.dump(payload, f)
        os.chmod(path, 0o600)
        env["GOOGLE_APPLICATION_CREDENTIALS"] = path

    def _build_azure(self, secret: Secret, env: Dict[str, str],
                     account: str = "default") -> None:
        """Reference azure_secret.go: service-principal env quartet."""
        mapping = {"subscriptionId": "AZ_SUBSCRIPTION_ID",
                   "tenantId": "AZ_TENANT_ID",
                   "clientId": "AZ_CLIENT_ID",
                   "clientSecret": "AZ_CLIENT_SECRET"}
        for key, var in mapping.items():
            if key in secret.data:
                env[var] = str(secret.data[key])

    def _build_https(self, secret: Secret, env: Dict[str, str],
                     account: str = "default") -> None:
        """Per-host request headers for http(s) artifact pulls (reference
        https_secret.go builds header env from the secret).

        All hosts ride ONE env var holding a host->headers JSON map:
        mangling hosts into env-var names is not injective
        ('models-example.com' vs 'models.example.com' would collide and
        leak one host's Authorization header to the other).
        """
        host = secret.data.get("host")
        headers = secret.data.get("headers") or {}
        if not host:
            logger.warning("https secret %s has no 'host'", secret.name)
            return
        try:
            current = json.loads(env.get(HTTPS_HEADERS_ENV, "{}"))
        except ValueError:
            current = {}
        current[host] = headers
        env[HTTPS_HEADERS_ENV] = json.dumps(current)


HTTPS_HEADERS_ENV = "KFS_HTTPS_HEADERS"


def https_headers_for(uri: str,
                      env: Optional[Dict[str, str]] = None
                      ) -> Dict[str, str]:
    """Headers a https secret configured for this URI's host (consumed
    by Storage._download_from_uri).  Matches the exact netloc first,
    then the bare hostname (secrets usually omit the port)."""
    from urllib.parse import urlparse

    env = env if env is not None else os.environ
    raw = env.get(HTTPS_HEADERS_ENV)
    if not raw:
        return {}
    try:
        table = json.loads(raw)
    except ValueError:
        logger.warning("invalid headers JSON in %s", HTTPS_HEADERS_ENV)
        return {}
    parsed = urlparse(uri)
    for candidate in (parsed.netloc, parsed.hostname):
        entry = table.get(candidate)
        if isinstance(entry, dict):
            return {str(k): str(v) for k, v in entry.items()}
    return {}
