"""The port's registry, ``/metrics``, tracing and ``/debug/traces`` against
the JAX package's, on the CPU: the same requests to a JAX ModelServer and
to the port's must publish the same metric families and the same span
chain, and the port's scrape must pass the JAX package's exposition
linter.
"""

import json

import numpy as np
import pytest
from torch_serving import (
    BERT_CONFIG,
    MLP_CONFIG,
    arequest,
    load_models,
    serve,
    write_artifact,
)

from kfserving_tpu import tracing as jax_tracing
from kfserving_tpu.tools.check_metrics import lint_exposition
from kfserving_tpu_torch import tracing
from kfserving_tpu_torch.observability import REGISTRY

# Families the JAX server publishes for these requests that the port does
# not yet, each with the ROADMAP item that ports it: none left.  The
# history sampler's families appear once its background tick has run,
# so both servers tick fast here (KFS_HISTORY_TICK_S in `scrapes`).
NOT_PORTED: dict = {}
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
# The request path's spans, from the server to the engine.
SPAN_CHAIN = ["server.decode", "server.infer", "dataplane.preprocess",
              "dataplane.predict", "batcher.queue", "engine.execute",
              "dataplane.postprocess", "server.encode"]


@pytest.fixture(autouse=True)
def _port_registry():
    # The port's process registry is its own (the JAX one is reset by
    # tests/conftest.py): every test here starts and ends empty.
    REGISTRY.reset()
    tracing.tracer.clear()
    yield
    REGISTRY.reset()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obs"))
    return {"mlp": write_artifact(root, "mlp", MLP_CONFIG),
            "bert": write_artifact(root, "bert", BERT_CONFIG)}


def _families(text: str):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


async def _drive(server):
    """The same requests on either server: V1 and V2 predicts to both
    models, one traced request, one whose budget is already spent, then
    a classic and an OpenMetrics scrape and the traced request's spans."""
    port = server.http_port
    rng = np.random.default_rng(0)
    statuses = []
    mlp_rows = rng.standard_normal((3, 64)).astype(np.float32)
    for body in ({"instances": mlp_rows.tolist()},
                 {"inputs": [{"name": "input_0", "datatype": "FP32",
                              "shape": [2, 64],
                              "data": mlp_rows[:2].ravel().tolist()}]}):
        path = ("/v1/models/mlp:predict" if "instances" in body
                else "/v2/models/mlp/infer")
        statuses.append((await arequest(port, "POST", path, body))[0])
    for n in (5, 20):
        statuses.append((await arequest(
            port, "POST", "/v1/models/bert:predict",
            {"instances": [rng.integers(1, 1000, n).tolist()]}))[0])
    status, headers, _ = await arequest(
        port, "POST", "/v1/models/bert:predict",
        {"instances": [[5, 6, 7]]}, headers={"traceparent": TRACEPARENT})
    statuses.append(status)
    echoed = headers.get("x-request-id")
    statuses.append((await arequest(
        port, "POST", "/v1/models/mlp:predict",
        {"instances": mlp_rows[:1].tolist()},
        headers={"x-request-timeout-ms": "0.001"}))[0])
    _, classic_headers, classic = await arequest(port, "GET", "/metrics")
    _, om_headers, om = await arequest(
        port, "GET", "/metrics",
        headers={"accept": "application/openmetrics-text"})
    _, _, traces = await arequest(port, "GET",
                                  f"/debug/traces?trace_id={TRACE_ID}")
    return {"statuses": statuses, "echoed": echoed,
            "classic": classic.decode(), "om": om.decode(),
            "classic_type": classic_headers["content-type"],
            "om_type": om_headers["content-type"],
            "spans": json.loads(traces)["spans"]}


@pytest.fixture(scope="module")
def scrapes(artifacts, tmp_path_factory):
    """One run of _drive on each server (module scope: both loads and the
    JAX compiles happen once).  A module fixture runs before the per-test
    private param cache of tests/conftest.py, so it sets its own."""
    import asyncio

    from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KFS_PARAM_CACHE", str(tmp_path_factory.mktemp("params")))
        mp.setenv("KFS_HISTORY_TICK_S", "0.02")
        for kind in ("jax", "torch"):
            JAX_REGISTRY.reset()
            REGISTRY.reset()
            jax_tracing.tracer.clear()
            tracing.tracer.clear()
            out[kind] = asyncio.run(serve(
                kind, load_models(kind, artifacts), _drive))
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    return out


def test_same_statuses(scrapes):
    assert scrapes["torch"]["statuses"] == scrapes["jax"]["statuses"] == \
        [200] * 5 + [504]
    assert scrapes["torch"]["echoed"] == scrapes["jax"]["echoed"] == \
        TRACE_ID


def test_route_tables_are_equal():
    """Every (method, path) the JAX server routes, the port routes, and
    no other."""
    from kfserving_tpu.server import http as jax_http
    from kfserving_tpu.server.app import ModelServer as JaxModelServer
    from kfserving_tpu_torch.server import http as port_http
    from kfserving_tpu_torch.server.app import ModelServer

    tables = {}
    for key, module, cls in (("jax", jax_http, JaxModelServer),
                             ("torch", port_http, ModelServer)):
        table = tables[key] = set()
        add = module.Router.add

        def recording(self, method, pattern, handler, _add=add,
                      _table=table):
            _table.add((method, pattern))
            return _add(self, method, pattern, handler)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module.Router, "add", recording)
            cls(http_port=0)
    assert tables["torch"] == tables["jax"]
    assert ("POST", "/debug/profile/capture") in tables["torch"]
    assert len(tables["torch"]) == 39


def test_port_scrape_passes_the_linter(scrapes):
    for key in ("classic", "om"):
        assert lint_exposition(scrapes["torch"][key]) == []


def test_same_families_as_the_jax_server(scrapes):
    jax_families = _families(scrapes["jax"]["classic"])
    port_families = _families(scrapes["torch"]["classic"])
    assert port_families == jax_families - set(NOT_PORTED)
    assert "kfserving_tpu_compile_cache_total" in jax_families
    for family in ("kfserving_tpu_request_total",
                   "kfserving_tpu_request_latency_ms",
                   "kfserving_tpu_batch_queue_wait_ms",
                   "kfserving_tpu_batch_fill_ratio",
                   "kfserving_tpu_engine_stage_ms",
                   "kfserving_tpu_deadline_exceeded_total",
                   "kfserving_tpu_param_cache_total"):
        assert family in port_families
    assert "kfserving_tpu_uptime_seconds " in scrapes["torch"]["classic"]


def _samples(text: str, prefix: str):
    return sorted(line.rsplit(" ", 1)[0] for line in text.splitlines()
                  if line.startswith(prefix))


def test_request_and_stage_series_match(scrapes):
    """The request counter by model/verb/status and the stage histogram's
    labels agree with the JAX server's."""
    for prefix in ("kfserving_tpu_request_total{",
                   "kfserving_tpu_deadline_exceeded_total{",
                   "kfserving_tpu_engine_stage_ms_count{"):
        assert _samples(scrapes["torch"]["classic"], prefix) == \
            _samples(scrapes["jax"]["classic"], prefix), prefix
    counts = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
              for line in scrapes["torch"]["classic"].splitlines()
              if line.startswith("kfserving_tpu_request_total{")}
    assert counts['kfserving_tpu_request_total{model="bert",status="200",'
                  'verb="predict"}'] == 3
    assert counts['kfserving_tpu_request_total{model="mlp",status="504",'
                  'verb="predict"}'] == 1


def test_exemplars_only_under_openmetrics(scrapes):
    port = scrapes["torch"]
    assert port["classic_type"].startswith("text/plain")
    assert port["om_type"].startswith("application/openmetrics-text")
    assert " # {trace_id=" not in port["classic"]
    assert f'# {{trace_id="{TRACE_ID}"}}' in port["om"]
    assert port["om"].endswith("# EOF\n")
    assert not port["classic"].rstrip().endswith("# EOF")


def test_span_chain_of_one_request(scrapes):
    """The traced request's spans, from server.decode through
    batcher.queue to engine.execute, as the JAX server records them."""
    for kind in ("jax", "torch"):
        spans = {s["name"]: s for s in scrapes[kind]["spans"]}
        assert set(SPAN_CHAIN) <= set(spans), (kind, sorted(spans))
        assert all(s["trace_id"] == TRACE_ID
                   for s in scrapes[kind]["spans"])
    port = {s["name"]: s for s in scrapes["torch"]["spans"]}
    jax = {s["name"]: s for s in scrapes["jax"]["spans"]}
    assert set(port) == set(jax)
    starts = [port[name]["start"] for name in
              ("server.decode", "batcher.queue", "engine.execute")]
    assert starts == sorted(starts)
    assert port["engine.execute"]["attrs"]["batch"] == 1
    assert set(port["engine.execute"]["attrs"]) == \
        set(jax["engine.execute"]["attrs"])
    assert set(port["batcher.queue"]["attrs"]) == \
        set(jax["batcher.queue"]["attrs"])


@pytest.mark.parametrize("value", [
    TRACEPARENT, TRACEPARENT.upper(), " " + TRACEPARENT + " ",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "00-xyz92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "", "garbage"])
def test_traceparent_parse_matches(value):
    assert tracing.parse_traceparent(value) == \
        jax_tracing.parse_traceparent(value)


def test_traceparent_format_and_request_ids():
    assert tracing.format_traceparent(TRACE_ID, "00f067aa0ba902b7") == \
        jax_tracing.format_traceparent(TRACE_ID, "00f067aa0ba902b7") == \
        TRACEPARENT
    for headers in ({"traceparent": TRACEPARENT, "x-request-id": "r1"},
                    {"traceparent": "bad", "x-request-id": "r1"},
                    {"x-request-id": "r2"}):
        assert tracing.ensure_request_id(headers) == \
            jax_tracing.ensure_request_id(headers)
        assert tracing.current_request_id.get() == \
            tracing.ensure_request_id(headers)
    minted = tracing.ensure_request_id({})
    assert len(minted) == len(jax_tracing.ensure_request_id({})) == 16


def _scrape_samples(text: str):
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines()
            if line and not line.startswith("#")}


def test_generator_families(tmp_path):
    """A decoder_tiny stream through the port's server publishes the
    generator's families under the JAX package's names."""
    from kfserving_tpu_torch.predictors.llm import GenerativeModel

    cfg = {"architecture": "decoder_tiny",
           "arch_kwargs": dict(num_layers=2, hidden_size=64, num_heads=2,
                               intermediate_size=128, max_seq=128),
           "max_slots": 2, "max_seq": 128, "prefill_buckets": [32, 128],
           "block_size": 16, "cache_blocks": 16, "steps_per_call": 2,
           "tokenizer": "byte"}
    model = GenerativeModel("gen", write_artifact(str(tmp_path), "gen", cfg),
                            device="cpu")
    model.load()

    async def drive(server):
        body = {"text_input": "x" * 40, "max_tokens": 6}
        for _ in range(2):       # the second prompt hits the first's blocks
            status, _, _ = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate_stream",
                body)
            assert status == 200
        return (await arequest(server.http_port, "GET", "/metrics"))[2]

    from kfserving_tpu_torch.server.app import ModelServer

    async def run():
        server = ModelServer(http_port=0)
        await server.start_async([model], host="127.0.0.1")
        try:
            return await drive(server)
        finally:
            await server.stop_async()
            await model.engine.close()

    import asyncio

    text = asyncio.run(run()).decode()
    assert lint_exposition(text) == []
    samples = _scrape_samples(text)
    assert samples["kfserving_tpu_llm_ttft_ms_count"] == 2
    assert samples['kfserving_tpu_llm_tokens_total{direction="in"}'] == \
        2 * len(model.tokenizer.encode("x" * 40))
    assert samples['kfserving_tpu_llm_tokens_total{direction="out"}'] == \
        samples["kfserving_tpu_llm_inter_token_ms_count"] + 2
    assert samples["kfserving_tpu_llm_tokens_per_second_count"] == 2
    assert samples['kfserving_tpu_generator_prefix_lookups_total{model="gen",'
                   'outcome="hit"}'] == 2
    assert samples['kfserving_tpu_generator_prefill_tokens_saved_total{'
                   'model="gen"}'] == 32
    for family in ("kfserving_tpu_generator_block_evictions_total",
                   "kfserving_tpu_generator_pool_occupancy_ratio",
                   "kfserving_tpu_generator_pool_fragmentation_ratio",
                   "kfserving_tpu_engine_goodput_ratio",
                   "kfserving_tpu_engine_achieved_tflops"):
        assert f"# TYPE {family} " in text, family


def test_multi_model_families(tmp_path):
    """Demand-paged MLPs under a budget of two: the ledger, residency and
    param-cache families, pruned when a model leaves."""
    import asyncio

    from kfserving_tpu_torch.engine.hbm import HBMManager
    from kfserving_tpu_torch.engine.torch_engine import module_bytes
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.predictors.jaxserver.repository import (
        TorchModelRepository,
    )
    from kfserving_tpu_torch.server.app import ModelServer

    for i in range(3):
        write_artifact(str(tmp_path), f"m{i}", MLP_CONFIG)
    nbytes = module_bytes(create_model("mlp").module)
    repo = TorchModelRepository(
        models_dir=str(tmp_path), device="cpu",
        hbm=HBMManager(budget_bytes=2 * nbytes + 100))
    repo.register_all()
    rows = {"instances": np.zeros((1, 64)).tolist()}

    async def run():
        server = ModelServer(http_port=0, registered_models=repo)
        await server.start_async([], host="127.0.0.1")
        try:
            for name in ("m0", "m1", "m2", "m0"):
                status, _, _ = await arequest(
                    server.http_port, "POST", f"/v1/models/{name}:predict",
                    rows)
                assert status == 200
            scraped = (await arequest(server.http_port, "GET",
                                      "/metrics"))[2].decode()
            await arequest(server.http_port, "POST",
                           "/v2/repository/models/m0/unload")
            after = (await arequest(server.http_port, "GET",
                                    "/metrics"))[2].decode()
            return scraped, after
        finally:
            await server.stop_async()

    text, after = asyncio.run(run())
    assert lint_exposition(text) == []
    samples = _scrape_samples(text)
    assert samples["kfserving_tpu_hbm_budget_bytes"] == 2 * nbytes + 100
    assert samples['kfserving_tpu_hbm_evictions_total{model="m0"}'] == 1
    assert samples['kfserving_tpu_hbm_evictions_total{model="m1"}'] == 1
    assert samples['kfserving_tpu_hbm_resident_bytes{model="m0"}'] == nbytes
    assert 'kfserving_tpu_hbm_resident_bytes{model="m1"}' not in samples
    assert samples['kfserving_tpu_residency_state{model="m0"}'] == 3
    assert samples['kfserving_tpu_residency_state{model="m1"}'] == 1
    assert samples['kfserving_tpu_residency_fault_ins_total{model="m0",'
                   'outcome="cold"}'] == 1
    assert samples['kfserving_tpu_residency_fault_ins_total{model="m0",'
                   'outcome="warm"}'] == 1
    assert samples['kfserving_tpu_residency_fault_in_ms_count{'
                   'source="warm"}'] == 1
    # One config, one init seed: one entry, missed and stored by the
    # first cold fault, then mapped by all three.
    assert [samples[f'kfserving_tpu_param_cache_total{{outcome="{k}"}}']
            for k in ("miss", "store", "hit")] == [1, 1, 3]
    after_samples = _scrape_samples(after)
    assert 'kfserving_tpu_residency_state{model="m0"}' not in after_samples
    assert 'kfserving_tpu_hbm_resident_bytes{model="m0"}' not in \
        after_samples
