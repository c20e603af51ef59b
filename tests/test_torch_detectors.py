"""The port's payload detectors (``kfserving_tpu_torch.detectors``)
against the JAX package's (``kfserving_tpu.detectors``), on the CPU.

Seeded reference samples and traffic go through both packages: the
Mahalanobis scores and fitted thresholds, the KS statistics and
p-values, the drift test and the served detectors' response sequences
must agree within 1e-12 (booleans and counts exactly).  Also
``build_detector``'s dispatch and the rejections, the streaming
monitors built from a served detector (now that the port's monitors
call the detectors' math), the alert CloudEvent, and the port's
RequestLogger feeding a detector server end to end.
"""

import asyncio
import json

import numpy as np
import pytest
from torch_serving import arequest

from kfserving_tpu import detectors as jax_detectors
from kfserving_tpu.observability.monitoring import monitors as jax_monitors
from kfserving_tpu.protocol.errors import InvalidInput as JaxInvalidInput
from kfserving_tpu_torch import detectors
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability.monitoring import monitors
from kfserving_tpu_torch.protocol.errors import InvalidInput
from kfserving_tpu_torch.server.app import ModelServer

PACKAGES = {"jax": jax_detectors, "torch": detectors}
TOL = 1e-12


def _close(got, want):
    """Equal structure; floats within TOL, everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple, np.ndarray)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)
    else:
        assert got == want and type(got) is type(want), (got, want)


@pytest.mark.parametrize("seed,dim", [(0, 1), (1, 4), (2, 28)])
def test_mahalanobis_scores_and_thresholds(seed, dim):
    rng = np.random.default_rng(seed)
    train = rng.normal(size=(500, dim)) @ rng.normal(size=(dim, dim))
    batch = rng.normal(size=(64, dim)) * 3
    out = {}
    for pkg, module in PACKAGES.items():
        scorer = module.MahalanobisScorer(train, regularization=1e-5)
        out[pkg] = (scorer.score(batch), scorer.mean, scorer.precision,
                    [module.outlier.fit_threshold(scorer, train, p)
                     for p in (50.0, 99.5)])
    _close(out["torch"], out["jax"])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_ks_statistics_and_p_values(seed):
    rng = np.random.default_rng(seed)
    pairs = [(rng.normal(size=n), rng.normal(loc=shift, size=m))
             for n, m, shift in ((500, 500, 0.0), (2000, 128, 0.3),
                                 (64, 37, 2.0), (10, 10, 0.0))]
    out = {}
    for pkg, module in PACKAGES.items():
        stats = [module.ks_statistic(a, b) for a, b in pairs]
        presorted = [module.ks_statistic(np.sort(a), b, a_sorted=True)
                     for a, b in pairs]
        p = [module.ks_p_value(d, len(a), len(b))
             for d, (a, b) in zip(stats, pairs)]
        out[pkg] = (stats, presorted, p, module.ks_p_value(0.0, 5, 5))
    _close(out["torch"], out["jax"])


def test_drift_test_core():
    rng = np.random.default_rng(6)
    ref = np.sort(rng.normal(size=(400, 6)), axis=0)
    windows = [rng.normal(size=(64, 6)),
               rng.normal(size=(64, 6)) + [3, 0, 0, 0, 0, 0]]
    out = {pkg: [module.drift.ks_drift_test(ref, w, 400, 0.05)
                 for w in windows]
           for pkg, module in PACKAGES.items()}
    _close(out["torch"], out["jax"])
    assert [r["drift"] for r in out["torch"]] == [False, True]


def _artifact(tmp_path, seed=7, shape=(1000, 4), **configs):
    d = tmp_path / f"det{seed}"
    d.mkdir(exist_ok=True)
    np.save(str(d / "train.npy"),
            np.random.default_rng(seed).normal(size=shape))
    for name, cfg in configs.items():
        (d / f"{name}.json").write_text(json.dumps(cfg))
    return str(d)


async def _responses(det, requests):
    out = []
    for request in requests:
        try:
            out.append(await det.predict(request))
        except Exception as e:  # compared across the packages
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("config", [{}, {"threshold": 0.0},
                                    {"threshold_percentile": 90.0,
                                     "regularization": 1e-3}])
async def test_outlier_detector_sequences(tmp_path, config):
    path = _artifact(tmp_path, outlier=config)
    rng = np.random.default_rng(8)
    requests = [{"instances": rng.normal(size=(4, 4)).tolist()},
                {"instances": [[10.0, 10.0, 10.0, 10.0]]},
                {"instances": [1.0, 2.0, 3.0, 4.0]},
                {"predictions": [1, 2]},
                {"instances": [["hello", "world"]]},
                {"instances": [[1.0, 2.0]]},
                {"instances": (rng.normal(size=(16, 4)) * 4).tolist()}]
    out = {}
    for pkg, module in PACKAGES.items():
        det = module.OutlierDetector("od", path)
        det.load()
        out[pkg] = (await _responses(det, requests), det.seen,
                    det.flagged, det.threshold,
                    {k: v for k, v in det.metadata().items()
                     if k != "platform"})
    _close(out["torch"], out["jax"])


@pytest.mark.parametrize("window,p_value,stride", [(64, 0.05, None),
                                                   (32, 0.01, 1),
                                                   (128, 0.05, 8)])
async def test_drift_detector_verdict_sequences(tmp_path, window, p_value,
                                                stride):
    cfg = {"window": window, "p_value": p_value}
    if stride is not None:
        cfg["test_stride"] = stride
    path = _artifact(tmp_path, seed=9, shape=(400, 3), drift=cfg)
    rng = np.random.default_rng(10)
    requests = ([{"instances": rng.normal(size=(8, 3)).tolist()}
                 for _ in range(12)]
                + [{"instances": (rng.normal(size=(8, 3)) + 3.0).tolist()}
                   for _ in range(12)]
                + [{"predictions": [0]}, {"instances": [[1.0, 2.0]]},
                   {"instances": [["x", "y", "z"]]}])
    out = {}
    for pkg, module in PACKAGES.items():
        det = module.KSDriftDetector("dd", path)
        det.load()
        out[pkg] = (await _responses(det, requests), det.drift_events,
                    {k: v for k, v in det.metadata().items()
                     if k != "platform"})
    _close(out["torch"], out["jax"])
    verdicts = [r.get("drift") for r in out["torch"][0][:24]]
    assert True in verdicts and out["torch"][1] >= 1


def test_build_detector_and_rejections(tmp_path):
    path = _artifact(tmp_path, seed=11, shape=(100, 3))
    assert isinstance(detectors.build_detector("x", "outlier", path),
                      detectors.OutlierDetector)
    assert isinstance(detectors.build_detector("x", "drift", path),
                      detectors.KSDriftDetector)
    assert detectors.DETECTOR_TYPES == jax_detectors.DETECTOR_TYPES
    bad_train = tmp_path / "bad"
    bad_train.mkdir()
    np.save(str(bad_train / "train.npy"), np.zeros(5))
    cases = [lambda m: m.build_detector("x", "nope", path),
             lambda m: m.KSDriftDetector("d", path, window=0).load(),
             lambda m: m.KSDriftDetector("d", path, p_value=0.0).load(),
             lambda m: m.KSDriftDetector("d", path, p_value=1.0).load(),
             lambda m: m.KSDriftDetector("d", str(bad_train)).load(),
             lambda m: m.OutlierDetector("o", str(bad_train)).load(),
             lambda m: m.MahalanobisScorer(np.zeros((1, 3)))]
    for case in cases:
        raised = {}
        for pkg, module in PACKAGES.items():
            with pytest.raises(Exception) as err:
                case(module)
            raised[pkg] = (type(err.value).__name__, str(err.value))
        assert raised["torch"] == raised["jax"]
    with pytest.raises(InvalidInput):
        detectors.KSDriftDetector("d", path, window=0).load()
    with pytest.raises(JaxInvalidInput):
        jax_detectors.KSDriftDetector("d", path, window=0).load()


def test_monitors_call_the_detectors_math(tmp_path):
    """The port's streaming monitors hold no copy of the math: they
    call the detectors', and wrap a loaded detector as the JAX ones do."""
    assert monitors.ks_drift_test is detectors.ks_drift_test
    assert monitors.MahalanobisScorer is detectors.MahalanobisScorer
    assert monitors.fit_threshold is detectors.fit_threshold
    assert not hasattr(monitors, "ks_statistic")
    path = _artifact(tmp_path, seed=12, shape=(128, 2))
    out = {}
    for pkg, module, mon in (("jax", jax_detectors, jax_monitors),
                             ("torch", detectors, monitors)):
        drift = module.KSDriftDetector("d", path)
        drift.load()
        outlier = module.OutlierDetector("o", path)
        outlier.load()
        dm = mon.DriftMonitor.from_detector(drift)
        om = mon.OutlierMonitor.from_detector(outlier, window=16)
        out[pkg] = (dm.model, dm.dim, dm.window_size, dm.p_value,
                    dm.test_stride, om.model, om.threshold,
                    om.window_size)
    assert out["torch"] == out["jax"] == ("d", 2, 128, 0.05, 8, "o",
                                          out["jax"][6], 16)


class _Sink(Model):
    """Records what it is sent (CloudEvents unwrap in preprocess)."""

    def __init__(self, name):
        super().__init__(name)
        self.received = []
        self.ready = True

    async def predict(self, request):
        self.received.append(request)
        return {"predictions": [0] * len(request.get("instances", []))}


async def test_outlier_alert_cloudevent(tmp_path):
    """An outlier posts one alert CloudEvent through the port's HTTP
    client, fire and forget; a dead broker counts an error and fails
    nothing."""
    path = _artifact(tmp_path, seed=13)
    sink = _Sink("alerts")
    server = ModelServer(http_port=0)
    await server.start_async([sink], host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{server.http_port}/v1/models/alerts:predict"
        det = detectors.OutlierDetector("od", path, alert_url=url)
        det.load()
        out = await det.predict({"instances": [[9.0] * 4, [0.0] * 4]})
        assert out["outlier"] == [1, 0]
        for _ in range(100):
            if det.alerts_sent:
                break
            await asyncio.sleep(0.02)
        await det.close()
        assert (det.alerts_sent, det.alert_errors) == (1, 0)
        (alert,) = sink.received
        assert alert["count"] == 1 and alert["threshold"] == det.threshold
        assert alert["max_score"] == pytest.approx(out["score"][0],
                                                   abs=1e-6)
        dead = detectors.OutlierDetector(
            "od", path, alert_url="http://127.0.0.1:1/unreachable")
        dead.load()
        assert (await dead.predict({"instances": [[9.0] * 4]}))[
            "outlier"] == [1]
        for _ in range(100):
            if dead.alert_errors:
                break
            await asyncio.sleep(0.02)
        assert (dead.alerts_sent, dead.alert_errors) == (0, 1)
        await dead.close()
    finally:
        await server.stop_async()
        REGISTRY.reset()


async def test_request_logger_feeds_a_detector_end_to_end(tmp_path):
    """The deployment shape: a served model's logger.url points at a
    detector server; its request payloads are scored as they are served,
    and the counts equal the direct scorer's on the same rows."""
    from kfserving_tpu_torch.agent import RequestLogger

    path = _artifact(tmp_path, seed=14)
    det = detectors.OutlierDetector("od", path)
    det.load()
    model = _Sink("m")
    det_server = ModelServer(http_port=0)
    server = ModelServer(http_port=0)
    await det_server.start_async([det], host="127.0.0.1")
    await server.start_async([model], host="127.0.0.1")
    logger = RequestLogger(
        log_url=(f"http://127.0.0.1:{det_server.http_port}"
                 f"/v1/models/od:predict"),
        log_mode="request", inference_service="m")
    await logger.start()
    logger.attach(server)
    rows = [np.random.default_rng(15).normal(size=(2, 4)).tolist(),
            [[9.0, 9.0, 9.0, 9.0]]]
    try:
        for instances in rows:
            status, _, _ = await arequest(
                server.http_port, "POST", "/v1/models/m:predict",
                {"instances": instances})
            assert status == 200
        for _ in range(200):
            if logger.sent >= 2:
                break
            await asyncio.sleep(0.02)
        assert logger.stats() == {"sent": 2, "failed": 0, "dropped": 0,
                                  "queued": 0}
    finally:
        await logger.stop()
        await server.stop_async()
        await det_server.stop_async()
        REGISTRY.reset()
    flat = np.concatenate([np.asarray(r, np.float32) for r in rows])
    scores = det.scorer.score(flat)
    assert det.seen == 3
    assert det.flagged == int((scores > det.threshold).sum()) == 1
