"""Model artifact storage: `Storage.download(uri, out_dir)` dispatch matrix.

Port of ``kfserving_tpu/storage/storage.py``, which re-implements the
reference storage layer (reference python/kfserving/
kfserving/storage.py:42-283) with the same URI scheme dispatch:

- `gs://`      Google Cloud Storage (anonymous fallback, storage.py:104-134)
- `s3://`      S3-compatible (env-configured endpoint, storage.py:82-101)
- `azure://`   (https://<account>.blob.core.windows.net/..., storage.py:137-204)
- `file://`    local symlink (storage.py:206-225)
- `http(s)://` download, unpacking zip/tar/tgz (storage.py:227-271)
- `pvc://`     mounted volume path
- local path   passthrough
- `mms://`     multi-model passthrough marker (storage.py:69-72)

Cloud SDKs are optional: providers raise a clear error when the client
library is absent (this environment is hermetic).  Downloads are idempotent
via `SUCCESS.<sha256(uri)>` marker files, the same scheme the reference Go
agent uses to skip completed pulls across restarts
(reference pkg/agent/downloader.go:42-75).

Remote downloads retry with exponential backoff (`KFS_STORAGE_RETRY_*`
env knobs; markers make replays idempotent — the TensorFlow-Serving
retried-model-load discipline), and the `storage.download` fault site
lets chaos tests inject failures exactly where a flaky object store
would produce them.

Content integrity: when the pulled artifact ships digests — per-file
`<name>.sha256` siblings or a `SHA256SUMS`/`checksums.sha256`
manifest — every covered file's sha256 is verified after the pull.
A mismatch deletes the corrupt file and raises a connection-class
error, so the retry policy re-pulls instead of the marker trusting a
corrupt payload forever (the marker keys only on the URI and is
written strictly after verification).
"""

import glob
import gzip
import hashlib
import json
import logging
import os
import re
import shutil
import tarfile
import tempfile
import zipfile
from typing import Optional
from urllib.parse import urlparse
from urllib.request import Request as UrlRequest
from urllib.request import urlopen

logger = logging.getLogger("kfserving_tpu_torch.storage")

_GCS_PREFIX = "gs://"
_S3_PREFIX = "s3://"
_AZURE_BLOB_RE = r"https://(.+?)\.blob\.core\.windows\.net/(.+)"
_LOCAL_PREFIX = "file://"
_PVC_PREFIX = "pvc://"
_MMS_PREFIX = "mms://"
_HTTP_PREFIX = ("http://", "https://")

_ARCHIVE_SUFFIXES = (".tar", ".tgz", ".tar.gz", ".zip", ".gz")


_MANIFEST_NAMES = ("SHA256SUMS", "checksums.sha256")


def _success_marker(uri: str, out_dir: str) -> str:
    digest = hashlib.sha256(uri.encode("utf-8")).hexdigest()
    return os.path.join(out_dir, f"SUCCESS.{digest}")


class StorageIntegrityError(ConnectionError):
    """Artifact content failed its shipped digest.  Subclasses
    ConnectionError on purpose: the retry policy classifies it
    transient, so a corrupted transfer re-pulls with backoff (the
    corrupt file is already deleted) instead of failing the replica
    terminally on one flipped bit."""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _digest_expectations(out_dir: str):
    """(file path, expected hex digest) pairs declared by the artifact:
    per-file `<name>.sha256` siblings (first hex token of the file —
    both bare-digest and coreutils `digest  name` layouts parse), and
    manifest files with `digest  relative/path` lines."""
    expectations = []
    # Coreutils manifest line: digest, separator, name (binary-mode
    # names lead with '*'; names may contain spaces).
    manifest_line = re.compile(r"^([0-9a-fA-F]{64})[ \t]+\*?(.+)$")
    # followlinks=False: a symlinked artifact dir (local passthrough)
    # is never verified here, and a payload shipping a self-referential
    # link must not walk the verifier into a cycle.
    for root, _, files in os.walk(out_dir):
        for fname in files:
            path = os.path.join(root, fname)
            if fname in _MANIFEST_NAMES:
                try:
                    with open(path) as f:
                        for line in f:
                            m = manifest_line.match(line.rstrip("\n"))
                            if m is None:
                                continue
                            target = os.path.normpath(
                                os.path.join(root, m.group(2)))
                            # Containment: a hostile manifest naming
                            # '../../etc/x' or an absolute path must
                            # not make the verifier hash — or on
                            # mismatch DELETE — anything outside the
                            # artifact dir.
                            if os.path.isabs(m.group(2)) or \
                                    os.path.commonpath(
                                        [os.path.abspath(target),
                                         os.path.abspath(out_dir)]) != \
                                    os.path.abspath(out_dir):
                                logger.warning(
                                    "ignoring digest for %r: escapes "
                                    "the artifact dir", m.group(2))
                                continue
                            expectations.append((target,
                                                 m.group(1).lower()))
                except OSError:
                    continue
            elif fname.endswith(".sha256"):
                try:
                    with open(path) as f:
                        head = f.read(1024).split()
                except OSError:
                    continue
                if head and re.fullmatch(r"[0-9a-fA-F]{64}", head[0]):
                    expectations.append((path[:-len(".sha256")],
                                         head[0].lower()))
    return expectations


def verify_integrity(out_dir: str) -> int:
    """Verify every digest the artifact ships; returns how many files
    were checked.  On mismatch the corrupt file is DELETED (so the
    retried pull rewrites it from the source instead of the bad bytes
    surviving a partial re-pull) and StorageIntegrityError raises.  A
    declared-but-missing file is the same condition: the payload is
    incomplete."""
    checked = 0
    for path, expected in _digest_expectations(out_dir):
        if not os.path.exists(path):
            raise StorageIntegrityError(
                f"artifact file {path} is declared in a digest "
                f"manifest but missing from the payload")
        actual = _file_sha256(path)
        if actual != expected:
            try:
                os.remove(path)
            except OSError:
                logger.exception("could not delete corrupt %s", path)
            raise StorageIntegrityError(
                f"sha256 mismatch for {path}: expected {expected}, "
                f"got {actual}; corrupt file deleted for re-pull")
        checked += 1
    return checked


class Storage:
    """Static download dispatcher, reference storage.py:42 equivalent."""

    @staticmethod
    def download(uri: str, out_dir: Optional[str] = None) -> str:
        logger.info("Copying contents of %s to local", uri)
        if uri.startswith(_MMS_PREFIX):
            # Multi-model passthrough: artifacts are pulled per-TrainedModel
            # by the agent (reference storage.py:69-72).
            return uri
        is_local = uri.startswith(_LOCAL_PREFIX) or os.path.exists(uri)
        if out_dir is None:
            if is_local:
                return Storage._download_local(uri, None)
            out_dir = tempfile.mkdtemp()
        os.makedirs(out_dir, exist_ok=True)

        marker = _success_marker(uri, out_dir)
        if os.path.exists(marker) and not is_local:
            logger.info("Found %s, skipping download of %s", marker, uri)
            return out_dir

        if uri.startswith(_PVC_PREFIX):
            return Storage._download_local(
                "file:///" + uri[len(_PVC_PREFIX):], out_dir)
        if is_local:
            return Storage._download_local(uri, out_dir)

        # Remote pulls go through the retry policy: transient transport
        # errors (and the `storage.download` fault site) replay with
        # backoff — safe because the marker is only written after a
        # full success, so a half-pulled attempt just re-pulls.
        # Terminal errors (unknown scheme, missing SDK, HTTP 4xx) are
        # not connection-level and fail fast.
        from kfserving_tpu_torch.reliability import fault_sites
        from kfserving_tpu_torch.reliability.faults import faults
        from kfserving_tpu_torch.reliability.retry import RetryPolicy

        def pull():
            faults.inject_sync(fault_sites.STORAGE_DOWNLOAD, key=uri)
            if uri.startswith(_GCS_PREFIX):
                Storage._download_gcs(uri, out_dir)
            elif uri.startswith(_S3_PREFIX):
                Storage._download_s3(uri, out_dir)
            elif re.search(_AZURE_BLOB_RE, uri):
                Storage._download_azure(uri, out_dir)
            elif uri.startswith(_HTTP_PREFIX):
                Storage._download_from_uri(uri, out_dir)
            else:
                raise Exception(
                    "Cannot recognize storage type for " + uri +
                    "\n'%s', '%s', '%s', and '%s' are the current "
                    "available storage type." % (
                        _GCS_PREFIX, _S3_PREFIX, _LOCAL_PREFIX,
                        "https://"))
            # Inside the retried pull, BEFORE the marker: a payload
            # failing its shipped digests deletes the corrupt file and
            # replays the download — never trusted forever by a
            # URI-keyed marker.
            verify_integrity(out_dir)

        RetryPolicy.from_env("KFS_STORAGE").call(pull)
        with open(marker, "w") as f:
            f.write(uri)
        logger.info("Successfully copied %s to %s", uri, out_dir)
        return out_dir

    # -- local -------------------------------------------------------------
    @staticmethod
    def _download_local(uri: str, out_dir: Optional[str]) -> str:
        """Symlink local artifacts into out_dir (reference storage.py:206-225)."""
        local_path = uri[len(_LOCAL_PREFIX):] if uri.startswith(_LOCAL_PREFIX) else uri
        if not os.path.exists(local_path):
            raise RuntimeError("Local path %s does not exist." % uri)
        if out_dir is None:
            return local_path
        if os.path.isdir(local_path):
            local_path = os.path.join(local_path, "*")
        matched = glob.glob(local_path)
        if not matched:
            raise RuntimeError("Local path %s does not exist." % uri)
        for src in matched:
            _, tail = os.path.split(src)
            dest_path = os.path.join(out_dir, tail)
            if src != dest_path and not os.path.exists(dest_path):
                os.symlink(src, dest_path)
        return out_dir

    # -- http --------------------------------------------------------------
    @staticmethod
    def _download_from_uri(uri: str, out_dir: str) -> str:
        """HTTP(S) download with archive extraction (reference storage.py:227-271)."""
        parsed = urlparse(uri)
        filename = os.path.basename(parsed.path)
        if not filename:
            raise ValueError("No filename contained in URI: %s" % uri)
        mimetype, encoding = _guess_type(filename)
        local_path = os.path.join(out_dir, filename)
        # Per-host credential headers (https secrets; reference
        # pkg/credentials/https/https_secret.go).
        from kfserving_tpu_torch.storage.credentials import https_headers_for

        cred_headers = https_headers_for(uri)
        headers = {"User-Agent": "kfserving-tpu-torch/0.1"}
        headers.update(cred_headers)
        req = UrlRequest(uri, headers=headers)
        if cred_headers:
            # Guarded opener: strips the injected auth on cross-host
            # redirects.  Without credentials, urlopen's default
            # redirect handling is fine (nothing to leak).
            opener = _build_opener_with_safe_redirects(set(cred_headers))
            response_cm = opener.open(req)
        else:
            response_cm = urlopen(req)
        with response_cm as response:
            if response.status != 200:
                raise RuntimeError(
                    "URI: %s returned a %s response code." % (uri, response.status))
            if encoding == "gzip" and mimetype != "application/x-tar":
                # plain .gz file: decompress to the stem name
                stem = filename[:-3]
                with open(os.path.join(out_dir, stem), "wb") as out:
                    shutil.copyfileobj(gzip.GzipFile(fileobj=response), out)
                return out_dir
            with open(local_path, "wb") as out:
                shutil.copyfileobj(response, out)
        if mimetype == "application/zip":
            with zipfile.ZipFile(local_path, "r") as zf:
                zf.extractall(out_dir)
            os.remove(local_path)
        elif mimetype == "application/x-tar":
            with tarfile.open(local_path, "r") as tf:
                # "data" filter: refuse absolute paths / traversal /
                # device nodes in model archives.
                tf.extractall(out_dir, filter="data")
            os.remove(local_path)
        return out_dir

    # -- cloud providers (optional SDKs) ------------------------------------
    @staticmethod
    def _download_gcs(uri: str, out_dir: str) -> None:
        try:
            from google.auth import exceptions
            from google.cloud import storage as gcs
        except ImportError:
            raise RuntimeError(
                "google-cloud-storage is not installed; cannot download %s" % uri)
        try:
            client = gcs.Client()
        except exceptions.DefaultCredentialsError:
            client = gcs.Client.create_anonymous_client()
        bucket_name, _, prefix = uri[len(_GCS_PREFIX):].partition("/")
        bucket = client.bucket(bucket_name, user_project=None)
        for blob in bucket.list_blobs(prefix=prefix):
            name = blob.name.replace(prefix, "", 1).lstrip("/")
            if not name:
                name = os.path.basename(prefix)
            dest = os.path.join(out_dir, name)
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            if not blob.name.endswith("/"):
                blob.download_to_filename(dest)

    @staticmethod
    def _download_s3(uri: str, out_dir: str) -> None:
        """S3 via Minio client configured from env, reference storage.py:82-101,
        273-282 (S3_ENDPOINT/AWS_* variables)."""
        try:
            from minio import Minio
        except ImportError:
            raise RuntimeError("minio is not installed; cannot download %s" % uri)
        endpoint = os.getenv("AWS_ENDPOINT_URL",
                             os.getenv("S3_ENDPOINT", "s3.amazonaws.com"))
        # Accept 1/0/true/false in any case (reference storage.py compares
        # against "0"; k8s users commonly set "False").
        use_ssl = os.getenv("S3_USE_HTTPS", "true").strip().lower() not in (
            "0", "false", "no")
        verify_ssl = os.getenv("S3_VERIFY_SSL", "1").strip().lower() not \
            in ("0", "false", "no")
        http_client = None
        if use_ssl and not verify_ssl:
            # Honor the s3-verifyssl annotation (self-signed endpoints).
            import urllib3

            http_client = urllib3.PoolManager(cert_reqs="CERT_NONE")
        endpoint = re.sub(r"^https?://", "", endpoint)
        client = Minio(endpoint,
                       access_key=os.getenv("AWS_ACCESS_KEY_ID", ""),
                       secret_key=os.getenv("AWS_SECRET_ACCESS_KEY", ""),
                       region=os.getenv("AWS_REGION", ""),
                       secure=use_ssl,
                       http_client=http_client)
        bucket_name, _, prefix = uri[len(_S3_PREFIX):].partition("/")
        for obj in client.list_objects(bucket_name, prefix=prefix,
                                       recursive=True):
            name = obj.object_name.replace(prefix, "", 1).lstrip("/")
            dest = os.path.join(out_dir, name or os.path.basename(prefix))
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            client.fget_object(bucket_name, obj.object_name, dest)

    @staticmethod
    def _download_azure(uri: str, out_dir: str) -> None:
        try:
            from azure.storage.blob import BlobServiceClient
        except ImportError:
            raise RuntimeError(
                "azure-storage-blob is not installed; cannot download %s" % uri)
        match = re.search(_AZURE_BLOB_RE, uri)
        account_url = f"https://{match.group(1)}.blob.core.windows.net"
        container, _, prefix = match.group(2).partition("/")
        client = BlobServiceClient(account_url)
        container_client = client.get_container_client(container)
        for blob in container_client.list_blobs(name_starts_with=prefix):
            name = blob.name.replace(prefix, "", 1).lstrip("/")
            dest = os.path.join(out_dir, name or os.path.basename(prefix))
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            with open(dest, "wb") as f:
                f.write(container_client.download_blob(blob.name).readall())


def _build_opener_with_safe_redirects(credential_keys):
    """urlopen forwards request headers across redirects, which would
    leak a host's Authorization header to whatever host a 302 points at
    (pre-signed CDN URLs are common for artifacts).  This opener strips
    the injected credential headers on cross-host hops and re-evaluates
    the https secrets for the new host."""
    from urllib.request import HTTPRedirectHandler, build_opener

    from kfserving_tpu_torch.storage.credentials import https_headers_for

    class SafeRedirectHandler(HTTPRedirectHandler):
        def redirect_request(self, req, fp, code, msg, headers, newurl):
            new = super().redirect_request(
                req, fp, code, msg, headers, newurl)
            if new is None:
                return None
            old_host = urlparse(req.full_url).hostname
            new_host = urlparse(newurl).hostname
            if old_host != new_host:
                for key in credential_keys:
                    new.remove_header(key.capitalize())
                    new.remove_header(key)
                for key, value in https_headers_for(newurl).items():
                    new.add_header(key, value)
            return new

    return build_opener(SafeRedirectHandler())


def _guess_type(filename: str):
    if filename.endswith(".tar.gz") or filename.endswith(".tgz"):
        return "application/x-tar", "gzip"
    if filename.endswith(".tar"):
        return "application/x-tar", None
    if filename.endswith(".zip"):
        return "application/zip", None
    if filename.endswith(".gz"):
        return None, "gzip"
    return None, None
