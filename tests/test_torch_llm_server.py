"""The port's generative serving path (GenerativeModel, the generate
routes and token streaming over the stdlib HTTP server) on the CPU.

The served model is a reduced ``decoder_tiny`` whose weights come from
the JAX package's ``init_params`` through a Flax checkpoint; greedy
answers are held against the JAX decoder's greedy forward on the same
weights (``jax.jit(module.apply)`` at a fixed padded length).
"""

import asyncio
import http.client
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu_torch.predictors.llm import (
    EOS_ID,
    ByteTokenizer,
    GenerativeModel,
)
from kfserving_tpu_torch.protocol.errors import InvalidInput
from kfserving_tpu_torch.server.app import ModelServer

MAX_SEQ = 128
ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
            intermediate_size=128, max_seq=MAX_SEQ)
CONFIG = {"architecture": "decoder_tiny", "arch_kwargs": ARCH,
          "max_slots": 4, "max_seq": MAX_SEQ, "prefill_buckets": [32, 128],
          "block_size": 16, "cache_blocks": 32, "steps_per_call": 2,
          "max_new_tokens": 12, "tokenizer": "byte"}


def _write_dir(path, config, checkpoint=None):
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if checkpoint is not None:
        with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
            f.write(checkpoint)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    spec = jax_create_model("decoder_tiny", **ARCH)
    variables = init_params(spec, seed=2)
    model_dir = _write_dir(str(tmp_path_factory.mktemp("gen") / "gen"),
                           CONFIG, serialization.to_bytes(variables))
    # A module fixture is set up before the per-test private param cache
    # of tests/conftest.py: this load gets a private cache of its own.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KFS_PARAM_CACHE", str(tmp_path_factory.mktemp("params")))
        model = GenerativeModel("gen", model_dir, device="cpu")
        model.load()
    apply = jax.jit(spec.module.apply)

    def greedy_text(prompt, steps):
        ids = ByteTokenizer().encode(prompt)
        out = []
        for _ in range(steps):
            buf = np.zeros((1, MAX_SEQ), np.int32)
            buf[0, :len(ids)] = ids
            nxt = int(np.argmax(np.asarray(apply(
                variables, jnp.asarray(buf)))[0, len(ids) - 1]))
            if nxt == EOS_ID:
                break
            out.append(nxt)
            ids.append(nxt)
        return ByteTokenizer().decode(out), len(out)

    yield model, greedy_text
    model.unload()


def _post(port, path, body, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = raw if raw is not None else json.dumps(body).encode()
        conn.request("POST", path, body=data)
        resp = conn.getresponse()
        payload = resp.read()
        if resp.getheader("content-type", "").startswith(
                "text/event-stream"):
            events = [json.loads(line[len(b"data: "):])
                      for line in payload.split(b"\n\n")
                      if line.startswith(b"data: ")]
            return resp.status, events
        return resp.status, json.loads(payload) if payload else None
    finally:
        conn.close()


async def _serve(model):
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    return server


async def test_predict_and_generate_match_jax_greedy(served):
    model, greedy_text = served
    server = await _serve(model)
    port = server.http_port
    try:
        status, body = await asyncio.to_thread(
            _post, port, "/v1/models/gen:predict",
            {"instances": ["hello there",
                           {"prompt": "abc", "max_tokens": 5}]})
        assert status == 200
        (p1, p2) = body["predictions"]
        want1, n1 = greedy_text("hello there", 12)
        want2, n2 = greedy_text("abc", 5)
        assert (p1["text"], p1["token_count"]) == (want1, n1)
        assert (p2["text"], p2["token_count"]) == (want2, n2)
        status, body = await asyncio.to_thread(
            _post, port, "/v2/models/gen/generate",
            {"text_input": "abc", "parameters": {"max_tokens": 5}})
        assert status == 200
        assert body["model_name"] == "gen"
        assert body["text_output"] == want2
        assert body["details"]["finish_reason"] == p2["finish_reason"]
    finally:
        await server.stop_async()


@pytest.mark.parametrize("route", ["generate_stream", "generate"])
async def test_stream_events_and_terminal_text(served, route):
    model, greedy_text = served
    server = await _serve(model)
    try:
        status, events = await asyncio.to_thread(
            _post, server.http_port, f"/v2/models/gen/{route}",
            {"text_input": "stream me", "max_tokens": 9, "stream": True})
    finally:
        await server.stop_async()
    assert status == 200
    want, n = greedy_text("stream me", 9)
    final = events[-1]
    assert final["finish_reason"] in ("length", "eos")
    assert final["generated_text"] == want
    assert final["details"]["token_count"] == n
    assert all("finish_reason" not in e for e in events[:-1])
    assert "".join(e["token"]["text"] for e in events
                   if "token" in e) == want


async def test_stop_sequence_truncates(served):
    model, greedy_text = served
    full, _ = greedy_text("stop test", 12)
    stop = next(c for c in full[1:] if c != "�")
    expect = full[:full.find(stop)]
    server = await _serve(model)
    port = server.http_port
    try:
        status, body = await asyncio.to_thread(
            _post, port, "/v2/models/gen/generate",
            {"text_input": "stop test", "max_tokens": 12, "stop": stop})
        assert status == 200
        assert body["details"]["finish_reason"] == "stop"
        assert body["text_output"] == expect
        status, events = await asyncio.to_thread(
            _post, port, "/v2/models/gen/generate_stream",
            {"text_input": "stop test", "max_tokens": 12,
             "stop": [stop]})
        assert status == 200
        assert events[-1]["finish_reason"] == "stop"
        assert events[-1]["generated_text"] == expect
        streamed = "".join(e["token"]["text"] for e in events)
        assert streamed == expect and stop not in streamed
    finally:
        await server.stop_async()


@pytest.mark.parametrize("path,body,raw,status", [
    ("/v2/models/gen/generate", None, b"{not json", 400),
    ("/v2/models/gen/generate_stream", None, b"{not json", 400),
    ("/v2/models/gen/generate", {"parameters": {}}, None, 400),
    ("/v2/models/gen/generate_stream",
     {"text_input": "x", "max_tokens": 0}, None, 400),
    ("/v2/models/gen/generate_stream",
     {"text_input": "x" * 200}, None, 400),
    ("/v1/models/gen:predict", {"instances": [5]}, None, 400),
    ("/v2/models/gen/generate", {"text_input": "x", "top_p": 2}, None, 400),
    ("/v2/models/nope/generate_stream", {"text_input": "x"}, None, 404),
])
async def test_bad_requests_are_4xx(served, path, body, raw, status):
    model, _ = served
    server = await _serve(model)
    try:
        got, payload = await asyncio.to_thread(
            _post, server.http_port, path, body, raw)
    finally:
        await server.stop_async()
    assert got == status, payload
    assert "error" in payload


async def test_stream_slot_freed_on_client_disconnect(served):
    model, _ = served
    engine = model.engine
    server = await _serve(model)

    def read_one_event_and_hang_up(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v2/models/gen/generate_stream",
                     body=json.dumps({"text_input": "abandon",
                                      "max_tokens": 100}).encode())
        resp = conn.getresponse()
        first = resp.readline()
        conn.sock.close()
        conn.close()
        return first

    try:
        finished0 = engine.requests_finished
        tokens0 = engine.tokens_generated
        first = await asyncio.to_thread(read_one_event_and_hang_up,
                                        server.http_port)
        assert first.startswith(b"data: ")
        pool = engine.stats()["paged"]
        for _ in range(250):
            await asyncio.sleep(0.02)
            pool = engine.stats()["paged"]
            if (all(s is None for s in engine._slots)
                    and pool["free_blocks"] + pool["reclaimable_blocks"]
                    == pool["pool_blocks"]):
                break
        assert all(s is None for s in engine._slots)
        assert (pool["free_blocks"] + pool["reclaimable_blocks"]
                == pool["pool_blocks"])
        assert engine.requests_finished == finished0 + 1
        # Cancelled: the 100-token budget was never decoded.
        assert engine.tokens_generated - tokens0 < 100
    finally:
        await server.stop_async()


# An hf: tokenizer loads from a local directory only: a missing one
# fails the load (tests/test_torch_tokenizer.py serves one that exists).
# Every generator mode serves under a mesh
# (tests/test_torch_mesh_modes.py).
@pytest.mark.parametrize("extra,message", [
    ({"tokenizer": "hf:/nonexistent/kfs-tokenizer"},
     "is not a local directory"),
])
def test_unported_config_is_refused(tmp_path, extra, message):
    config = dict(CONFIG)
    config.update(extra)
    model = GenerativeModel("g", _write_dir(str(tmp_path / "g"), config),
                            device="cpu")
    with pytest.raises(InvalidInput, match=message):
        model.load()


def test_metadata_and_stats(served):
    model, _ = served
    meta = model.metadata()
    assert meta["architecture"] == "decoder_tiny"
    assert meta["max_seq"] == MAX_SEQ and meta["max_slots"] == 4
    stats = model.engine_stats()
    assert stats["param_source"] == "checkpoint"
    assert stats["paged"]["pool_blocks"] == 32


class _RewritingTokenizer(ByteTokenizer):
    """Decodes a lone 'a' as 'A': decoding is not append-stable, which
    drives the detokenizer's degraded (full re-decode) mode."""

    def decode(self, ids):
        text = super().decode(ids)
        return "A" if text == "a" else text


@pytest.mark.parametrize("text,stops,tokenizer", [
    ("héllo wörld, 你好!", [], ByteTokenizer),        # multi-byte splits
    ("abc STOP def", ["STOP"], ByteTokenizer),        # stop mid-text
    ("xx<e", ["<end>"], ByteTokenizer),               # held stop prefix
    ("abcdef", ["cd"], _RewritingTokenizer),          # degraded mode
])
def test_incremental_decoder_matches_jax(text, stops, tokenizer):
    from kfserving_tpu.predictors.llm import (
        IncrementalDecoder as JaxDecoder,
    )
    from kfserving_tpu_torch.predictors.llm import IncrementalDecoder

    ids = list(text.encode("utf-8"))
    port, ref = (cls(tokenizer(), stops)
                 for cls in (IncrementalDecoder, JaxDecoder))
    for t in ids:
        got, want = port.push(t), ref.push(t)
        assert got == want, (t, got, want)
        if want[1]:
            break
    else:
        assert port.finish() == ref.finish()
    assert port.text() == ref.text()
    assert port.degraded == ref.degraded


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


async def test_debug_cache_carries_the_generative_block(served):
    """GET /debug/cache: per generative model the engine's prefix census
    (reuse depth, hot chains by hits) and pool, under the JAX server's
    keys; ?top_k= bounds the hot chains, ?top_cost= adds the cost
    records; a bad query is a 400."""
    from kfserving_tpu_torch.observability import attribution

    attribution.clear()   # the ring is the process's
    model, _ = served
    server = await _serve(model)
    port = server.http_port
    shared = "a shared system prompt of two blocks or so. " * 2
    try:
        for tail in ("one", "two", "three"):
            status, _ = await asyncio.to_thread(
                _post, port, "/v2/models/gen/generate",
                {"text_input": shared + tail,
                 "parameters": {"max_tokens": 2}})
            assert status == 200
        status, body = await asyncio.to_thread(
            _get, port, "/debug/cache?top_k=1&top_cost=2")
        assert status == 200
        assert set(body) == {"models", "hbm", "residency", "host_tier",
                             "top_cost"}
        assert body["host_tier"] is None
        # ?top_cost=2: the attribution ring's two costliest records each
        # way, of the three requests above.
        top = body["top_cost"]
        assert set(top) == {"by_device_ms", "by_held_blocks"}
        assert [len(top[k]) for k in sorted(top)] == [2, 2]
        assert all(r["model"] == "gen" and r["decode_tokens"] == 2
                   for k in top for r in top[k])
        gen = body["models"]["gen"]
        assert set(gen) == {"paged", "index_entries", "reuse_depth",
                            "hot_chains", "pool"}
        assert gen["paged"] is True and gen["index_entries"] >= 5
        assert len(gen["hot_chains"]) == 1
        assert gen["hot_chains"][0]["hits"] == gen["reuse_depth"]["max"] >= 2
        assert gen["pool"] == model.engine.stats()["paged"]
        status, _ = await asyncio.to_thread(_get, port,
                                            "/debug/cache?top_k=x")
        assert status == 400
    finally:
        await server.stop_async()
