"""The port's storage layer (``Storage.download``, integrity checks, the
credential builder) and ``RetryPolicy`` against the JAX package's on the
same inputs, on the CPU.

Every case runs against both ``Storage`` classes: local paths, file://,
http(s) through a monkeypatched ``urlopen`` (zip, tar, gz, the success
marker, shipped digests and the re-pull on a mismatch), the cloud
branches through fake SDK modules installed in ``sys.modules`` (no
client ever reaches a network), and a cross-host redirect between two
local HTTP servers.  Both must leave the same files, markers and digests
and raise the same errors.
"""

import gzip
import hashlib
import http.server
import io
import json
import os
import sys
import tarfile
import threading
import types
import urllib.error
import zipfile

import pytest

from kfserving_tpu.reliability.retry import RetryPolicy as JaxRetryPolicy
from kfserving_tpu.storage import storage as jax_storage
from kfserving_tpu.storage.credentials import (
    CredentialStore as JaxCredentialStore,
)
from kfserving_tpu.storage.credentials import (
    https_headers_for as jax_https_headers_for,
)
from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.reliability.deadline import Deadline, deadline_scope
from kfserving_tpu_torch.reliability.faults import faults
from kfserving_tpu_torch.reliability.retry import RetryPolicy
from kfserving_tpu_torch.storage import storage as port_storage
from kfserving_tpu_torch.storage.credentials import (
    CredentialStore,
    https_headers_for,
)

PACKAGES = {"jax": jax_storage, "torch": port_storage}
STORE = {
    "serviceAccounts": {
        "default": ["my-s3", "my-gcs"],
        "team-b": ["my-azure", "my-https"],
    },
    "secrets": {
        "my-s3": {
            "type": "s3",
            "data": {"accessKeyId": "AKID123",
                     "secretAccessKey": "SK456"},
            "annotations": {
                "serving.kfserving.io/s3-endpoint": "minio.local:9000",
                "serving.kfserving.io/s3-usehttps": "0",
                "serving.kfserving.io/s3-region": "us-east-1",
            },
        },
        "my-gcs": {"type": "gcs",
                   "data": {"gcloud": {"type": "service_account",
                                       "project_id": "p1"}}},
        "my-azure": {"type": "azure",
                     "data": {"subscriptionId": "sub1", "tenantId": "t1",
                              "clientId": "c1", "clientSecret": "s1"}},
        "my-https": {"type": "https",
                     "data": {"host": "models.example.com",
                              "headers": {"Authorization": "Bearer tok"}}},
    },
}


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("KFS_STORAGE_RETRY_BASE_MS", "1")
    faults.reset()
    yield
    faults.reset()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root (markers by
    prefix, so both packages' markers compare by name)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(tmp_path, run):
    """run(module, out_dir) for both packages; returns {pkg: (tree or
    None, (error type, message) or None)}."""
    results = {}
    for pkg, mod in PACKAGES.items():
        out_dir = tmp_path / pkg
        try:
            run(mod, str(out_dir))
            error = None
        except Exception as e:
            error = (type(e).__name__, str(e).replace(str(tmp_path), ""))
        tree = _tree(out_dir) if out_dir.exists() else None
        results[pkg] = (tree, error)
    return results


class _Response:
    """A stand-in for urlopen's response over in-memory bytes."""

    status = 200

    def __init__(self, payload: bytes):
        self._buf = io.BytesIO(payload)

    def read(self, *a):
        return self._buf.read(*a)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


def _zip(files) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return buf.getvalue()


def _tar(files, mode="w") -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode=mode) as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _serve_urlopen(monkeypatch, payloads):
    """Both packages' urlopen answer from ``payloads`` (one per call, the
    last repeated); returns the list of requested URLs."""
    calls = []

    def urlopen(req):
        calls.append(req.full_url)
        return _Response(payloads[min(len(calls), len(payloads)) - 1])

    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "urlopen", urlopen)
    return calls


# -- local paths -------------------------------------------------------------
def test_local_passthrough_symlink_and_file_uri(tmp_path):
    src = tmp_path / "model"
    src.mkdir()
    (src / "weights.bin").write_bytes(b"abc")
    for mod in PACKAGES.values():
        assert mod.Storage.download(str(src)) == str(src)
        assert mod.Storage.download(f"file://{src}") == str(src)
    res = _both(tmp_path, lambda mod, out: mod.Storage.download(
        str(src), out))
    assert res["jax"] == res["torch"] == ({"weights.bin": b"abc"}, None)
    res = _both(tmp_path / "f", lambda mod, out: mod.Storage.download(
        f"file://{src}", out))
    assert res["jax"] == res["torch"]
    assert res["torch"][0] == {"weights.bin": b"abc"}
    assert os.path.islink(tmp_path / "f" / "torch" / "weights.bin")
    for mod in PACKAGES.values():
        assert mod.Storage.download("mms://whatever") == "mms://whatever"


@pytest.mark.parametrize("uri,error", [
    ("{tmp}/nope/missing", "Cannot recognize storage type"),
    ("file://{tmp}/nope/missing", "does not exist"),
    ("weird://bucket/path", "Cannot recognize storage type"),
])
def test_unrecognized_and_missing_raise_alike(tmp_path, uri, error):
    uri = uri.format(tmp=tmp_path)
    errors = []
    for mod in PACKAGES.values():
        with pytest.raises(Exception, match=error) as e:
            mod.Storage.download(uri, str(tmp_path / "out"))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# -- http(s) -----------------------------------------------------------------
ARCHIVES = {
    "model.zip": _zip({"model.joblib": b"MODELBYTES",
                       "sub/extra.txt": b"EXTRA"}),
    "model.tar": _tar({"model.txt": b"T"}),
    "model.tar.gz": _tar({"a/b.bin": b"B" * 100}, mode="w:gz"),
    "weights.bin.gz": gzip.compress(b"GZ" * 50),
    "weights.bin": b"RAW",
}


@pytest.mark.parametrize("filename", sorted(ARCHIVES))
def test_http_download_unpacks_alike(tmp_path, monkeypatch, filename):
    calls = _serve_urlopen(monkeypatch, [ARCHIVES[filename]])
    uri = f"http://example.com/{filename}"
    res = _both(tmp_path, lambda mod, out: mod.Storage.download(uri, out))
    assert res["jax"] == res["torch"]
    tree, error = res["torch"]
    assert error is None and len(calls) == 2
    marker = f"SUCCESS.{_sha256(uri.encode())}"
    assert tree[marker] == uri.encode()
    assert filename not in tree or filename == "weights.bin"


def test_success_marker_skips_the_second_pull(tmp_path, monkeypatch):
    calls = _serve_urlopen(monkeypatch, [b""])
    for mod in PACKAGES.values():
        out = str(tmp_path / mod.__name__)
        mod.Storage.download("http://example.com/weights.bin", out)
        mod.Storage.download("http://example.com/weights.bin", out)
        assert [f for f in os.listdir(out) if f.startswith("SUCCESS.")]
    assert len(calls) == 2      # one pull per package


def test_https_credential_headers_reach_the_request(tmp_path, monkeypatch):
    monkeypatch.setenv("KFS_HTTPS_HEADERS", json.dumps(
        {"example.com": {"Authorization": "Bearer tok"}}))
    seen = []

    class Opener:
        def open(self, req):
            seen.append(dict(req.header_items()))
            return _Response(b"W")

    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_build_opener_with_safe_redirects",
                            lambda keys: Opener())
        mod.Storage.download("https://example.com/w.bin",
                             str(tmp_path / mod.__name__))
    assert len(seen) == 2
    assert all(h["Authorization"] == "Bearer tok" for h in seen)


# -- integrity ---------------------------------------------------------------
@pytest.mark.parametrize("payloads,attempts,error", [
    # shipped digest holds: one pull, verified
    ([{"weights.bin": b"GOOD", "weights.bin.sha256": _sha256(b"GOOD")}],
     "1", None),
    # corrupt every time: deleted, retried, no marker
    ([{"weights.bin": b"CORRUPTED", "weights.bin.sha256": _sha256(b"GOOD")}],
     "2", "sha256 mismatch"),
    # corrupt once, then clean: the retry converges
    ([{"weights.bin": b"FLIPPED", "weights.bin.sha256": _sha256(b"GOOD")},
      {"weights.bin": b"GOOD", "weights.bin.sha256": _sha256(b"GOOD")}],
     "3", None),
])
def test_digest_mismatch_repulls_alike(tmp_path, monkeypatch, payloads,
                                       attempts, error):
    monkeypatch.setenv("KFS_STORAGE_RETRY_MAX_ATTEMPTS", attempts)
    trees, errors, pulls = [], [], []
    for mod in PACKAGES.values():
        calls = _serve_urlopen(monkeypatch, [_zip(p) for p in payloads])
        out = tmp_path / mod.__name__
        try:
            mod.Storage.download("http://example.com/model.zip", str(out))
            errors.append(None)
        except Exception as e:
            errors.append((type(e).__name__,
                           str(e).replace(str(out), "")))
        trees.append(_tree(out))
        pulls.append(len(calls))
    assert trees[0] == trees[1] and errors[0] == errors[1]
    assert pulls[0] == pulls[1]
    if error is None:
        assert errors[0] is None and trees[1]["weights.bin"] == b"GOOD"
        assert any(f.startswith("SUCCESS.") for f in trees[1])
    else:
        assert error in errors[1][1]
        assert errors[1][0] == "StorageIntegrityError"
        assert "weights.bin" not in trees[1] and pulls[1] == 2
        assert not any(f.startswith("SUCCESS.") for f in trees[1])


@pytest.mark.parametrize("manifest,files,checked,error", [
    ("{a}  a.bin\n{b}  b.bin\n", {"a.bin": b"AAA", "b.bin": b"BBB"},
     2, None),
    ("{a}  a.bin\n{b}  b.bin\n", {"a.bin": b"AAA", "b.bin": b"EVIL"},
     None, "sha256 mismatch"),
    ("{a}  a.bin\n{x}  gone.bin\n", {"a.bin": b"AAA"}, None, "missing"),
    ("{d}  my model.bin\n", {"my model.bin": b"DATA"}, 1, None),
    ("{a}  a.bin\n{x}  ../outside.bin\n{x}  /etc/hostname\n",
     {"a.bin": b"AAA"}, 1, None),
])
def test_verify_integrity_alike(tmp_path, manifest, files, checked, error):
    digests = {"a": _sha256(b"AAA"), "b": _sha256(b"BBB"),
               "x": _sha256(b"X"), "d": _sha256(b"DATA")}
    outside = tmp_path / "outside.bin"
    outside.write_bytes(b"PRECIOUS")
    results = []
    for pkg, mod in PACKAGES.items():
        art = tmp_path / pkg
        art.mkdir()
        for name, data in files.items():
            (art / name).write_bytes(data)
        (art / "SHA256SUMS").write_text(manifest.format(**digests))
        try:
            results.append((mod.verify_integrity(str(art)), None))
        except Exception as e:
            results.append((type(e).__name__,
                            str(e).replace(str(art), "")))
        results.append(_tree(art))
    assert results[0] == results[2] and results[1] == results[3]
    if error is None:
        assert results[2] == (checked, None)
    else:
        assert error in results[2][1]
    assert outside.read_bytes() == b"PRECIOUS"


def test_fault_site_is_retried(tmp_path, monkeypatch):
    """An injected storage.download fault is a flaky store: retried, and
    the pull succeeds on the next attempt."""
    calls = _serve_urlopen(monkeypatch, [b"W"])
    faults.configure({fault_sites.STORAGE_DOWNLOAD: {"fail_first": 1}})
    port_storage.Storage.download("http://example.com/w.bin",
                                  str(tmp_path / "out"))
    assert len(calls) == 1
    assert (tmp_path / "out" / "w.bin").read_bytes() == b"W"


def test_redirect_strips_auth_cross_host(tmp_path, monkeypatch):
    """A 302 from the credentialed host to another host does not carry
    the Authorization header along, in either package."""
    received = {}

    class Target(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            received.setdefault(self.server.server_port, []).append(
                dict(self.headers))
            if self.server.server_port == ports["origin"]:
                self.send_response(302)
                self.send_header(
                    "Location",
                    f"http://127.0.0.2:{ports['cdn']}{self.path}")
                self.end_headers()
            else:
                payload = b"WEIGHTS"
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        def log_message(self, *a):
            pass

    origin = http.server.HTTPServer(("127.0.0.1", 0), Target)
    cdn = http.server.HTTPServer(("127.0.0.2", 0), Target)
    ports = {"origin": origin.server_port, "cdn": cdn.server_port}
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (origin, cdn)]
    for t in threads:
        t.start()
    try:
        monkeypatch.setenv(
            "KFS_HTTPS_HEADERS",
            json.dumps({"127.0.0.1": {"Authorization": "Bearer tok"}}))
        res = _both(tmp_path, lambda mod, out: mod.Storage.download(
            f"http://127.0.0.1:{ports['origin']}/model.bin", out))
        assert res["jax"] == res["torch"]
        assert res["torch"][0]["model.bin"] == b"WEIGHTS"
        assert [h.get("Authorization") for h in
                received[ports["origin"]]] == ["Bearer tok"] * 2
        assert not any("Authorization" in h for h in received[ports["cdn"]])
    finally:
        origin.shutdown()
        cdn.shutdown()


# -- cloud SDK branches (fake modules) ---------------------------------------
def _fake_gcs(monkeypatch):
    created = {}

    class Blob:
        def __init__(self, name, payload):
            self.name, self._payload = name, payload

        def download_to_filename(self, dest):
            with open(dest, "wb") as f:
                f.write(self._payload)

    class Bucket:
        def list_blobs(self, prefix=""):
            return [b for b in (Blob("models/iris/model.joblib", b"W"),
                                Blob("models/iris/sub/extra.txt", b"E"),
                                Blob("models/other/x.bin", b"N"))
                    if b.name.startswith(prefix)]

    class Client:
        def __init__(self):
            created["mode"] = "default"

        def bucket(self, name, user_project=None):
            created["bucket"] = name
            return Bucket()

    gcs = types.ModuleType("google.cloud.storage")
    gcs.Client = Client
    cloud = types.ModuleType("google.cloud")
    cloud.storage = gcs
    exc = types.ModuleType("google.auth.exceptions")
    exc.DefaultCredentialsError = type("CredErr", (Exception,), {})
    auth = types.ModuleType("google.auth")
    auth.exceptions = exc
    google = types.ModuleType("google")
    google.cloud, google.auth = cloud, auth
    for name, mod in [("google", google), ("google.cloud", cloud),
                      ("google.cloud.storage", gcs), ("google.auth", auth),
                      ("google.auth.exceptions", exc)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return "gs://my-bucket/models/iris", created


def _fake_s3(monkeypatch):
    created = {}

    class Obj:
        def __init__(self, object_name):
            self.object_name = object_name

    class Minio:
        def __init__(self, endpoint, access_key=None, secret_key=None,
                     region=None, secure=True, http_client=None):
            created.update(endpoint=endpoint, access_key=access_key,
                           secret_key=secret_key, region=region,
                           secure=secure)

        def list_objects(self, bucket, prefix="", recursive=True):
            created["bucket"] = bucket
            return [Obj(f"{prefix}/model.joblib"),
                    Obj(f"{prefix}/config.json")]

        def fget_object(self, bucket, object_name, dest):
            with open(dest, "wb") as f:
                f.write(b"S3:" + object_name.encode())

    minio = types.ModuleType("minio")
    minio.Minio = Minio
    monkeypatch.setitem(sys.modules, "minio", minio)
    for key, value in CredentialStore.from_dict(STORE).build_env(
            "default").items():
        if not key.startswith("GOOGLE"):
            monkeypatch.setenv(key, value)
    return "s3://bkt/models/iris", created


def _fake_azure(monkeypatch):
    created = {}

    class Download:
        def __init__(self, payload):
            self._payload = payload

        def readall(self):
            return self._payload

    class Container:
        def list_blobs(self, name_starts_with=""):
            created["prefix"] = name_starts_with
            return [types.SimpleNamespace(
                name=f"{name_starts_with}/model.bin")]

        def download_blob(self, name):
            return Download(b"AZ:" + name.encode())

    class Service:
        def __init__(self, account_url):
            created["account_url"] = account_url

        def get_container_client(self, container):
            created["container"] = container
            return Container()

    azure, storage, blob = (types.ModuleType(n) for n in (
        "azure", "azure.storage", "azure.storage.blob"))
    blob.BlobServiceClient = Service
    storage.blob, azure.storage = blob, storage
    for name, mod in [("azure", azure), ("azure.storage", storage),
                      ("azure.storage.blob", blob)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return "https://acct.blob.core.windows.net/models/iris", created


@pytest.mark.parametrize("fake", [_fake_gcs, _fake_s3, _fake_azure])
def test_cloud_branches_alike(tmp_path, monkeypatch, fake):
    uri, created = fake(monkeypatch)
    seen = []

    def run(mod, out):
        created.clear()
        mod.Storage.download(uri, out)
        seen.append(dict(created))

    res = _both(tmp_path, run)
    assert res["jax"] == res["torch"] and res["torch"][1] is None
    assert seen[0] == seen[1] and seen[1]
    assert any(f.startswith("SUCCESS.") for f in res["torch"][0])


@pytest.mark.parametrize("uri,sdks", [
    ("gs://bucket/m", ("google.auth", "google.cloud.storage")),
    ("s3://bucket/m", ("minio",)),
    ("https://acct.blob.core.windows.net/c/m", ("azure.storage.blob",)),
])
def test_missing_sdk_fails_with_the_same_message(tmp_path, monkeypatch,
                                                 uri, sdks):
    """No SDK, no client: the reference's RuntimeError, not retried.
    The modules are made unimportable, so no client is ever built."""
    for sdk in sdks:
        monkeypatch.setitem(sys.modules, sdk, None)
    res = _both(tmp_path, lambda mod, out: mod.Storage.download(uri, out))
    assert res["jax"][1] == res["torch"][1]
    assert res["torch"][1][0] == "RuntimeError"
    assert "is not installed" in res["torch"][1][1]


# -- credentials -------------------------------------------------------------
@pytest.mark.parametrize("account", ["default", "team-b", "nope"])
def test_build_env_alike(tmp_path, account):
    envs = []
    for cls in (JaxCredentialStore, CredentialStore):
        store = cls.from_dict(STORE)
        store._creds_dir = str(tmp_path / cls.__module__)
        env = store.build_env(account)
        gcs = env.pop("GOOGLE_APPLICATION_CREDENTIALS", None)
        if gcs is not None:
            assert oct(os.stat(gcs).st_mode & 0o777) == "0o600"
            env["gcs_key"] = json.load(open(gcs))
            env["gcs_file"] = os.path.relpath(gcs, store._creds_dir)
        envs.append(env)
    assert envs[0] == envs[1]
    if account == "default":
        assert envs[1]["AWS_ENDPOINT_URL"] == "http://minio.local:9000"
        assert envs[1]["gcs_key"]["project_id"] == "p1"


def test_store_round_trip_and_registration_alike(tmp_path):
    dicts = []
    for cls in (JaxCredentialStore, CredentialStore):
        path = tmp_path / f"{cls.__module__}.json"
        path.write_text(json.dumps(STORE))
        store = cls.load(str(path))
        name = store.add_secret("https", {"host": "h", "headers": {}})
        store.attach("fresh", name)
        store.remove_secret("my-gcs")
        with pytest.raises(KeyError):
            store.attach("fresh", "ghost")
        store.save(str(path))
        assert oct(os.stat(path).st_mode & 0o777) == "0o600"
        dicts.append(cls.load(str(path)).to_dict())
        assert cls.load(None).build_env("default") == {}
        assert cls.load(str(tmp_path / "absent.json")).to_dict() == \
            {"serviceAccounts": {}, "secrets": {}}
    assert dicts[0] == dicts[1]


@pytest.mark.parametrize("uri", [
    "https://models.example.com/w", "https://models-example.com/w",
    "https://models.example.com:8443/w", "https://other.host/x"])
def test_https_headers_for_alike(uri):
    store = {"serviceAccounts": {"sa": ["h1", "h2"]},
             "secrets": {
                 "h1": {"type": "https",
                        "data": {"host": "models.example.com",
                                 "headers": {"Authorization": "dot"}}},
                 "h2": {"type": "https",
                        "data": {"host": "models-example.com",
                                 "headers": {"Authorization": "dash"}}}}}
    env = CredentialStore.from_dict(store).build_env("sa")
    assert env == JaxCredentialStore.from_dict(store).build_env("sa")
    assert https_headers_for(uri, env=env) == \
        jax_https_headers_for(uri, env=env)


# -- RetryPolicy -------------------------------------------------------------
def _run_policy(cls, fn, **kw):
    calls = []

    def wrapped():
        calls.append(1)
        return fn(len(calls))

    try:
        result = ("ok", cls(**kw).call(wrapped))
    except Exception as e:
        result = ("raised", type(e).__name__)
    return result, len(calls)


def _flaky(n):
    if n < 3:
        raise ConnectionError("flake")
    return n


def _always(n):
    raise ConnectionError("down")


def _bad_config(n):
    raise ValueError("not transient")


def _missing(n):
    raise FileNotFoundError("gone")


def _http_404(n):
    raise urllib.error.HTTPError("http://x", 404, "nf", {}, None)


def _http_503(n):
    if n < 2:
        raise urllib.error.HTTPError("http://x", 503, "bad", {}, None)
    return n


@pytest.mark.parametrize("fn,expect", [
    (_flaky, (("ok", 3), 3)),
    (_always, (("raised", "ConnectionError"), 3)),
    (_bad_config, (("raised", "ValueError"), 1)),
    (_missing, (("raised", "FileNotFoundError"), 1)),
    (_http_404, (("raised", "HTTPError"), 1)),
    (_http_503, (("ok", 2), 2)),
])
def test_retry_call_alike(fn, expect):
    kw = dict(max_attempts=3, base_delay_s=0.001)
    assert _run_policy(RetryPolicy, fn, **kw) == \
        _run_policy(JaxRetryPolicy, fn, **kw) == expect


@pytest.mark.parametrize("budget_s,attempts", [(-1.0, 1), (0.03, 1)])
def test_retry_respects_the_deadline(budget_s, attempts):
    """A spent budget, or a backoff longer than what is left, stops the
    retries (the port's Deadline, as the JAX policy reads its own)."""
    calls = []

    def flaky():
        calls.append(1)
        raise ConnectionError("flake")

    with deadline_scope(Deadline(budget_s)):
        with pytest.raises(ConnectionError):
            RetryPolicy(max_attempts=5, base_delay_s=0.05,
                        jitter=0.0).call(flaky)
    assert len(calls) == attempts


def test_retry_delays_and_env_knobs_alike(monkeypatch):
    for cls in (RetryPolicy, JaxRetryPolicy):
        assert list(cls(max_attempts=4, base_delay_s=0.1, max_delay_s=0.3,
                        jitter=0.0).delays_s()) == [0.1, 0.2, 0.3]
    monkeypatch.setenv("KFS_STORAGE_RETRY_MAX_ATTEMPTS", "7")
    monkeypatch.setenv("KFS_RETRY_BASE_MS", "10")
    monkeypatch.setenv("KFS_RETRY_JITTER", "oops")
    for prefix in ("KFS_STORAGE", "KFS_AGENT"):
        port, ref = RetryPolicy.from_env(prefix), JaxRetryPolicy.from_env(
            prefix)
        assert (port.max_attempts, port.base_delay_s, port.max_delay_s,
                port.jitter, port.name) == \
            (ref.max_attempts, ref.base_delay_s, ref.max_delay_s,
             ref.jitter, ref.name)
    assert RetryPolicy.from_env("KFS_STORAGE").max_attempts == 7


def test_retry_counter():
    """Each retry counts kfserving_tpu_retry_total{edge, reason}."""
    from kfserving_tpu_torch.observability.registry import REGISTRY

    REGISTRY.reset()
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.001, name="edge")
    assert _run_policy(lambda **kw: policy, _flaky) == (("ok", 3), 3)
    assert policy.retries == 2
    text = "\n".join(REGISTRY.render_lines(exemplars=False))
    assert 'kfserving_tpu_retry_total{edge="edge",reason=' \
        '"ConnectionError"} 2' in text
