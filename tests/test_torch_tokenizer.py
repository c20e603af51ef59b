"""``hf:<dir>`` tokenizers in the port (``predictors/llm.py::build_tokenizer``)
against the JAX package's, on the CPU.

The tokenizer is a byte-level BPE trained here with ``tokenizers`` on a
few seeded multilingual lines and saved with
``PreTrainedTokenizerFast.save_pretrained``: its 320 ids fit decoder_tiny's
vocabulary, and its pieces split multi-byte UTF-8 characters, which the
streaming detokenizer must hold back.  Only a local directory is read; a
guard refuses any connection that is not to this machine.
"""

import asyncio
import json
import os
import socket

import pytest
from torch_serving import arequest

from kfserving_tpu.predictors.llm import IncrementalDecoder as JaxDecoder
from kfserving_tpu.predictors.llm import build_tokenizer as jax_build
from kfserving_tpu_torch.predictors.llm import (
    GenerativeModel,
    IncrementalDecoder,
    build_tokenizer,
)
from kfserving_tpu_torch.server.app import ModelServer

os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("HF_HUB_OFFLINE", "1")
VOCAB = 320
CORPUS = ["héllo wörld, 你好! the quick brown fox ☃ jumps " * 3,
          "naïve café déjà vu 日本語 über straße " * 3]
TEXTS = ["héllo ☃ 日本", "plain words", "", "naïve straße über 你好!",
         "unseen: ßλ€"]
LOCAL = ("127.0.0.1", "localhost", "::1")
GEN_CONFIG = {"architecture": "decoder_tiny",
              "arch_kwargs": dict(num_layers=2, hidden_size=64,
                                  num_heads=2, intermediate_size=128,
                                  max_seq=128, vocab_size=VOCAB),
              "max_slots": 2, "max_seq": 128, "prefill_buckets": [32, 128],
              "block_size": 16, "cache_blocks": 16, "steps_per_call": 2,
              "max_new_tokens": 16}


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Only this machine answers: a name lookup or connection elsewhere
    raises before it leaves the process."""
    real_lookup, real_connect = socket.getaddrinfo, socket.socket.connect

    def lookup(host, *args, **kwargs):
        if host not in LOCAL:
            raise OSError(f"test refuses a lookup of {host!r}")
        return real_lookup(host, *args, **kwargs)

    def connect(sock, address):
        if isinstance(address, tuple) and address[0] not in LOCAL:
            raise OSError(f"test refuses a connection to {address!r}")
        return real_connect(sock, address)

    monkeypatch.setattr(socket, "getaddrinfo", lookup)
    monkeypatch.setattr(socket.socket, "connect", connect)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        pre_tokenizers,
        trainers,
    )
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=VOCAB, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>")
    path = str(tmp_path_factory.mktemp("tok"))
    fast.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def tokenizers(hf_dir):
    return build_tokenizer(f"hf:{hf_dir}"), jax_build(f"hf:{hf_dir}")


def test_ids_and_vocabulary_equal_jax(tokenizers):
    port, ref = tokenizers
    assert (port.vocab_size, port.bos_id, port.eos_id) == \
        (ref.vocab_size, ref.bos_id, ref.eos_id) == (VOCAB, 0, 1)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("add_bos", [True, False])
def test_encode_and_decode_equal_jax(tokenizers, text, add_bos):
    port, ref = tokenizers
    ids = port.encode(text, add_bos=add_bos)
    assert ids == ref.encode(text, add_bos=add_bos)
    assert (ids[:1] == [port.bos_id]) is add_bos
    assert port.decode(ids) == ref.decode(ids) == text
    # Special tokens are skipped in decode, as the JAX package does.
    with_eos = ids + [port.eos_id]
    assert port.decode(with_eos) == ref.decode(with_eos) == text


def test_incremental_decoder_holds_back_partial_utf8_as_jax(tokenizers):
    port_tok, ref_tok = tokenizers
    text = "日本語 ☃ naïve 你好! ßλ€"
    ids = port_tok.encode(text, add_bos=False)
    # The vocabulary splits characters: some single ids decode to U+FFFD.
    assert any("�" in port_tok.decode([i]) for i in ids)
    port, ref = IncrementalDecoder(port_tok, []), JaxDecoder(ref_tok, [])
    deltas = []
    for t in ids:
        got, want = port.push(t), ref.push(t)
        assert got == want
        deltas.append(got[0])
    assert port.finish() == ref.finish()
    assert "�" not in "".join(deltas)
    assert port.text() == ref.text() == text
    assert not port.degraded


def test_missing_directory_fails_before_transformers(tmp_path):
    from kfserving_tpu_torch.protocol.errors import InvalidInput

    with pytest.raises(InvalidInput, match="not a local directory"):
        build_tokenizer(f"hf:{tmp_path / 'missing'}")


async def test_served_stream_is_the_decode_of_its_ids(hf_dir, tmp_path):
    """decoder_tiny (seeded init) with the hf: tokenizer: the SSE stream's
    text is ``tokenizer.decode`` of its greedy ids, the unary generate's
    the same."""
    model_dir = tmp_path / "gen"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(
        dict(GEN_CONFIG, tokenizer=f"hf:{hf_dir}")))
    model = GenerativeModel("gen", str(model_dir), device="cpu")
    model.load()
    tok = model.tokenizer
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    try:
        for prompt in ("日本語 ☃", "the quick brown"):
            status, _, body = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate_stream",
                {"text_input": prompt, "max_tokens": 16})
            assert status == 200
            events = [json.loads(line[len(b"data: "):])
                      for line in body.split(b"\n\n")
                      if line.startswith(b"data: ")]
            ids = [e["token"]["id"] for e in events
                   if e.get("token") and e["token"].get("id") is not None]
            text = "".join(e["token"]["text"] for e in events
                           if e.get("token"))
            assert ids and all(0 <= i < VOCAB for i in ids)
            assert text == tok.decode(ids) == events[-1]["generated_text"]
            status, _, body = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate",
                {"text_input": prompt, "parameters": {"max_tokens": 16}})
            assert status == 200
            assert json.loads(body)["text_output"] == text
    finally:
        await server.stop_async()
        await asyncio.to_thread(model.unload)
