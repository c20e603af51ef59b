"""GenerativeModel: the decoder-serving predictor.

Port of ``kfserving_tpu/predictors/llm.py``: load a decoder from the
registry plus its weights, run it in the ``GenerationEngine`` on the card
(paged or dense slots, chunked prefill, speculative decoding with the
n-gram head or a draft model), and serve V1 ``:predict``, ``:generate``
and ``generate_stream``.

Model directory layout (a local path or a ``file://`` URI):

    config.json          — required; see GenerativeConfig
    checkpoint.msgpack   — Flax ``to_bytes`` variables as the JAX package
                           writes them (optional: absent -> seeded random
                           init)

config.json keys are the JAX package's (unknown keys are ignored):
    {
      "architecture": "decoder" | "decoder_tiny" | <registered>,
      "arch_kwargs": {...},
      "max_slots": 8, "max_seq": 512,
      "prefill_buckets": [64, 128, 256, 512],
      "max_new_tokens": 64, "temperature": 0.0,
      "tokenizer": "byte",
      "steps_per_call": 1, "pipeline_depth": 2, "logprob_topk": 5,
      "block_size": 128,           # paged cache; absent: dense slots
      "cache_blocks": 48,
      "prefill_chunk_tokens": 256, # paged only: cold prompts in chunks
      "host_tier_blocks": 256,     # paged only: evicted prefix blocks
                                   #   spill to a host mmap tier of this
                                   #   many blocks and fault back on the
                                   #   next turn (KFS_KV_TIER_BLOCKS)
      "host_tier_dir": "/var/kv",  # a persistent tier a successor
                                   #   adopts (KFS_KV_TIER_DIR); absent:
                                   #   a private tempdir
      "adaptive_depth": true,
      "speculative": {"tokens": 4, # K proposals a wave (n-gram head)
                      "draft": {"architecture": "decoder",
                                "arch_kwargs": {...},
                                "model_dir": "...",  # default: this dir
                                "window": 128}}
    }
The draft materializes through the mmap param cache beside the target;
with no model_dir of its own it shares the target's directory (a
self-draft on the target's weights).  Every mode serves under a
``"mesh"`` of more than one rank too (``engine/generator.py``, meshes):
each rank holds its shard of the target, and rank 0 the draft.
``"tokenizer": "hf:<dir>"`` loads a tokenizer saved in a local
directory.

Request shapes (V1 predict and the generate routes):
    {"instances": ["a prompt", {"prompt": "...", "max_tokens": 32,
                                "temperature": 0.7, "top_k": 40,
                                "top_p": 0.95, "seed": 7,
                                "stop": ["\\n\\n"], "logprobs": 3}]}
    {"text_input": "...", "parameters": {...}}   # v2 generate extension
Stop sequences match host-side in text space; the streaming path holds
back any suffix that could begin a stop sequence.  The byte tokenizer
(ids = UTF-8 bytes, BOS = 256, EOS = 257) is lossless for any input.
"""

import asyncio
import json
import logging
import os
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from kfserving_tpu_torch import startup
from kfserving_tpu_torch.engine import compile_cache, param_cache
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.engine.speculative import (
    DEFAULT_DRAFT_WINDOW,
    DraftModel,
)
from kfserving_tpu_torch.engine.torch_engine import resolve_device
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.parallel.mesh import MeshConfig
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.storage import Storage
from kfserving_tpu_torch.streams import GuardedStream

logger = logging.getLogger("kfserving_tpu_torch.llm")

BOS_ID = 256
EOS_ID = 257


def _find_stop(text: str, stops: List[str]) -> int:
    """Earliest index of any stop sequence in `text`, or -1."""
    idx = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (idx < 0 or i < idx):
            idx = i
    return idx


def _holdback_len(text: str, stops: List[str]) -> int:
    """Length of the longest suffix of `text` that is a proper prefix of
    some stop sequence: the streaming path must not emit it yet."""
    hold = 0
    for s in stops:
        for length in range(min(len(s) - 1, len(text)), hold, -1):
            if text.endswith(s[:length]):
                hold = length
                break
    return hold


class IncrementalDecoder:
    """Streaming detokenizer with emission-stable deltas and O(window)
    work per token: it re-decodes only a window of not-yet-emitted
    tokens and releases text only when it can no longer change (a
    trailing U+FFFD may be a partial UTF-8 sequence; a suffix that could
    begin a stop sequence is held).  If decoding ever rewrites emitted
    text, deltas stop and stop matching falls back to decoding the full
    history."""

    # Tokens of context kept across window compaction, so piece-joining
    # tokenizers decode a boundary token the same way every time.
    _KEEP = 4

    def __init__(self, tokenizer, stops: List[str],
                 history: Optional[List[int]] = None):
        self.tok = tokenizer
        self.stops = stops
        self.max_stop = max((len(s) for s in stops), default=0)
        self._sent: List[str] = []
        self._pending: List[int] = []
        self._p_emitted = ""   # prefix of decode(_pending) already out
        self.degraded = False
        # Full token history, read only by the degraded path; a caller
        # that appends before each push may share its own list.
        self._all: List[int] = [] if history is None else history
        self._owns_history = history is None
        self._final: Optional[str] = None  # degraded-stop truncation

    def push(self, token: int):
        """Feed one token; returns (delta, stopped).  On a stop match the
        delta ends just before the match and the caller stops."""
        if self._owns_history:
            self._all.append(token)
        if self.degraded:
            return "", self._degraded_stop()
        self._pending.append(token)
        ptext = self.tok.decode(self._pending)
        if not ptext.startswith(self._p_emitted):
            self.degraded = True
            if self.stops:
                logger.warning(
                    "tokenizer decode rewrote emitted text; stop-"
                    "sequence matching degraded to full re-decode")
            return "", self._degraded_stop()
        rest = ptext[len(self._p_emitted):]
        if self.stops:
            idx = _find_stop(rest, self.stops)
            if idx >= 0:
                delta = rest[:idx]
                self._emit(delta, ptext)
                return delta, True
            hold = _holdback_len(rest, self.stops)
        else:
            hold = 0
        candidate = rest[:len(rest) - hold] if hold else rest
        while candidate.endswith("�"):
            candidate = candidate[:-1]
        self._emit(candidate, ptext)
        return candidate, False

    def _degraded_stop(self) -> bool:
        if not self.stops:
            return False
        window = self.max_stop * 4 + 16
        if _find_stop(self.tok.decode(self._all[-window:]), self.stops) < 0:
            return False
        full = self.tok.decode(self._all)
        idx = _find_stop(full, self.stops)
        if idx < 0:
            return False
        self._final = full[:idx]
        return True

    def finish(self) -> str:
        """Flush everything still held; returns the final delta."""
        if self.degraded:
            return ""
        ptext = self.tok.decode(self._pending)
        if not ptext.startswith(self._p_emitted):
            self.degraded = True
            return ""
        delta = ptext[len(self._p_emitted):]
        self._emit(delta, ptext)
        return delta

    def text(self) -> str:
        """Text emitted so far (the full output after finish(), the
        truncated output after a stop)."""
        if self._final is not None:
            return self._final
        return "".join(self._sent)

    def _emit(self, s: str, ptext: str):
        if s:
            self._sent.append(s)
            self._p_emitted += s
        if self._p_emitted == ptext and len(self._pending) > self._KEEP:
            self._pending = self._pending[-self._KEEP:]
            self._p_emitted = self.tok.decode(self._pending)


def _lp_payload(req, tokens: List[int]) -> List[Dict[str, Any]]:
    """Per-token logprob records (aligned with content tokens)."""
    return [
        {"id": int(t), "logprob": c,
         "top": [{"id": i, "logprob": p} for i, p in top]}
        for t, c, top in zip(tokens, req.lp_chosen, req.lp_top)
    ]


class ByteTokenizer:
    """Lossless byte-level tokenizer: ids 0-255 are UTF-8 bytes, 256 is
    BOS, 257 is EOS."""

    vocab_size = 258
    bos_id = BOS_ID
    eos_id = EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def build_tokenizer(spec: str):
    if spec == "byte":
        return ByteTokenizer()
    if spec.startswith("hf:"):
        return _hf_tokenizer(spec)
    raise InvalidInput(f"unknown tokenizer spec {spec!r}")


def _hf_tokenizer(spec: str):
    """``hf:<dir>``: a tokenizer saved with ``save_pretrained`` in a
    local directory, loaded by ``transformers.AutoTokenizer`` with the
    JAX package's encode and decode rules.  Only a local directory
    resolves: the hub is never asked (``local_files_only``)."""
    path = spec[3:]
    if not os.path.isdir(path):
        raise InvalidInput(
            f"tokenizer {spec!r}: {path!r} is not a local directory "
            "(hf: tokenizers load from a local directory only)")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    if tok.eos_token_id is None:
        logger.warning(
            "tokenizer %s has no eos_token_id: generation will only "
            "stop at the token budget or a stop sequence", spec)

    class _HF:
        vocab_size = tok.vocab_size
        bos_id = tok.bos_token_id
        eos_id = tok.eos_token_id

        def encode(self, text, add_bos=True):
            # add_special_tokens=False: some tokenizers append EOS (or
            # wrap with template tokens) in plain encode(), which would
            # poison the prompt; BOS is added explicitly and only when
            # the tokenizer has one.
            ids = tok.encode(text, add_special_tokens=False)
            if add_bos and tok.bos_token_id is not None:
                ids = [tok.bos_token_id] + ids
            return ids

        def decode(self, ids):
            return tok.decode(ids, skip_special_tokens=True)

    return _HF()


class GenerativeConfig:
    def __init__(self, architecture: str,
                 arch_kwargs: Optional[Dict] = None,
                 max_slots: int = 8, max_seq: int = 512,
                 prefill_buckets: Optional[List[int]] = None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 tokenizer: str = "byte",
                 steps_per_call: int = 1,
                 pipeline_depth: int = 2,
                 logprob_topk: int = 5,
                 block_size: Optional[int] = None,
                 cache_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 host_tier_blocks: Optional[int] = None,
                 host_tier_dir: Optional[str] = None,
                 adaptive_depth: bool = True,
                 speculative: Optional[Dict[str, Any]] = None,
                 mesh: Optional[Dict[str, int]] = None,
                 **_ignored):
        self.architecture = architecture
        self.arch_kwargs = arch_kwargs or {}
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.prefill_buckets = prefill_buckets
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.tokenizer = tokenizer
        self.steps_per_call = int(steps_per_call)
        self.pipeline_depth = int(pipeline_depth)
        self.logprob_topk = int(logprob_topk)
        self.block_size = int(block_size) if block_size else None
        self.cache_blocks = int(cache_blocks) if cache_blocks else None
        self.prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                     if prefill_chunk_tokens else None)
        self.host_tier_blocks = (int(host_tier_blocks)
                                 if host_tier_blocks else None)
        self.host_tier_dir = host_tier_dir
        self.adaptive_depth = bool(adaptive_depth)
        self.speculative = dict(speculative) if speculative else None
        self.mesh = mesh or {}

    @classmethod
    def from_file(cls, path: str,
                  overrides: Optional[Dict[str, Any]] = None):
        with open(path) as f:
            data = json.load(f)
        if overrides:
            data.update(overrides)
        if "architecture" not in data:
            raise InvalidInput(
                f"{path} missing required key 'architecture'")
        return cls(**data)


class GenerativeModel(Model):
    """A served decoder with continuous batching and token streaming.

    hbm: an optional ``HBMManager``; the load books the target's
        parameters, its KV cache and the draft's parameters under the
        model's name.
    residency: an optional ``ResidencyManager``; a configured draft
        registers there as ``"<name>:draft"``, resident and pinned while
        the target serves.
    """

    def __init__(self, name: str, model_dir: str,
                 config: Optional[GenerativeConfig] = None,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda", hbm=None, residency=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.config = config
        self.config_overrides = dict(config_overrides or {})
        self.device = resolve_device(device)
        self.hbm = hbm
        self.residency = residency
        self.engine: Optional[GenerationEngine] = None
        self.module: Optional[torch.nn.Module] = None
        self.tokenizer = None
        self._draft_handle: Optional[DraftModel] = None
        # "checkpoint" or "init" once loaded.
        self.param_source: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def load(self) -> bool:
        startup.mark("load_start")
        local = Storage.download(self.model_dir)
        startup.mark("download")
        cfg = self.config
        if cfg is None:
            cfg = GenerativeConfig.from_file(
                os.path.join(local, "config.json"),
                overrides=self.config_overrides)
            self.config = cfg
        self.tokenizer = build_tokenizer(cfg.tokenizer)
        mesh_cfg = MeshConfig.from_dict(cfg.mesh)
        if mesh_cfg.num_devices > 1 and self.engine is not None:
            # One process group a process: the serving generation's mesh
            # goes before the new one starts.
            self.unload()
        spec = create_model(cfg.architecture, **cfg.arch_kwargs)
        # mmap-first, as the draft model below and TorchModel: a standby
        # successor maps its predecessor's stored parameters instead of
        # re-initializing or re-converting them.
        leader = (self._start_mesh(mesh_cfg, local)
                  if mesh_cfg.num_devices > 1 else None)
        try:
            module, _, self.param_source = \
                param_cache.load_or_materialize(
                    cfg.architecture, cfg.arch_kwargs, spec, local,
                    self.device)
            # The draft (rank 0's alone under a mesh): a failed load
            # stops the followers too.
            speculative, draft = self._speculative(cfg, local)
        except BaseException:
            if leader is not None:
                leader.close()
            raise
        if leader is not None:
            engine = self._mesh_leader_engine(module, leader, speculative)
        else:
            engine = self._engine(module, speculative)
        # The engine compiled its greedy wave; a variant compiled later
        # is a note after warmup.
        compile_cache.declare_warmup_complete(engine.compile_source)
        if self.hbm is not None:
            # Generation residency: parameters + the KV cache, plus the
            # draft's parameters (the ledger books both models).
            try:
                self.hbm.admit(self.name,
                               engine.param_bytes() + engine.cache_bytes()
                               + engine.draft_param_bytes())
            except Exception:
                engine.shutdown_nowait()
                raise
        old = self.engine
        self.module, self.engine = module, engine
        if draft is not None:
            module_d, window = draft
            self._draft_handle = DraftModel(f"{self.name}:draft", module_d,
                                            engine, window=window)
            if self.residency is not None:
                # Registers as resident and pinned: the manager never
                # evicts the draft from under its serving target.
                self.residency.register(self._draft_handle.name,
                                        self._draft_handle)
        self.ready = True
        if old is not None:
            old.shutdown_nowait()
        return True

    def _engine(self, module, speculative=None, mesh=None
                ) -> GenerationEngine:
        cfg = self.config
        return GenerationEngine(
            module, max_slots=cfg.max_slots, max_seq=cfg.max_seq,
            prefill_buckets=cfg.prefill_buckets,
            eos_id=getattr(self.tokenizer, "eos_id", None),
            steps_per_call=cfg.steps_per_call,
            pipeline_depth=cfg.pipeline_depth,
            block_size=cfg.block_size, cache_blocks=cfg.cache_blocks,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens,
            host_tier_blocks=cfg.host_tier_blocks,
            host_tier_dir=cfg.host_tier_dir,
            adaptive_depth=cfg.adaptive_depth, speculative=speculative,
            logprob_topk=cfg.logprob_topk, name=self.name, mesh=mesh)

    def _start_mesh(self, mesh_cfg: MeshConfig, local: str):
        """Start the mesh's other ranks (rank 0 is this process); they
        load once this rank has joined."""
        from kfserving_tpu_torch.parallel.follower import (
            Leader,
            mesh_devices,
        )

        cfg = self.config
        config = dict(vars(cfg))
        env = os.environ.get("KFS_SPECDEC_TOKENS", "0")
        if not config["speculative"] and env.isdigit() and int(env) > 0:
            # The env twin as this rank's engine reads it: a follower's
            # environment is its forkserver's, which may predate it.
            config["speculative"] = {"tokens": int(env)}
        return Leader(
            mesh_cfg, mesh_devices(cfg.mesh, mesh_cfg.num_devices,
                                   self.device),
            cfg.mesh.get("backend"),
            {"kind": "generate", "name": self.name, "local_dir": local,
             "config": config, "seed": 0})

    def _mesh_leader_engine(self, module, leader, speculative=None
                            ) -> GenerationEngine:
        """Rank 0 of a mesh (the JAX package's mesh path,
        ``kfserving_tpu/predictors/llm.py``): keep this rank's shard,
        build the engine (every rank's engine runs its own greedy wave
        at construction) and hand it the followers."""
        from kfserving_tpu_torch.parallel.sharding import shard_module

        try:
            shard_module(module, leader.join().mesh)
            engine = self._engine(module, speculative, mesh=leader.mesh)
            leader.wait_ready()
        except BaseException:
            leader.close()
            raise
        engine.attach_leader(leader)
        return engine

    def mesh_engine(self, local: str, mesh) -> GenerationEngine:
        """A follower rank's load: this rank's shard and an engine over it
        that never schedules (``GenerationEngine.mirror``); no draft,
        whose proposals rank 0 broadcasts."""
        cfg = self.config
        self.tokenizer = build_tokenizer(cfg.tokenizer)
        spec = create_model(cfg.architecture, **cfg.arch_kwargs)
        module, _, self.param_source = param_cache.load_or_materialize(
            cfg.architecture, cfg.arch_kwargs, spec, local, self.device)
        from kfserving_tpu_torch.parallel.sharding import shard_module

        shard_module(module, mesh)
        speculative, _ = self._speculative(cfg, local, with_draft=False)
        return self._engine(module, speculative, mesh=mesh)

    def _speculative(self, cfg: GenerativeConfig, local: str,
                     with_draft: bool = True):
        """The engine's ``speculative`` argument and (draft module,
        window), or (None, None) when speculation is off.  The draft is
        a second model materialized through the mmap param cache; it
        shares the target's directory when it names none of its own
        (``with_draft`` False: none is loaded)."""
        spec_cfg = cfg.speculative or {}
        if int(spec_cfg.get("tokens", 0)) <= 0:
            return None, None
        speculative: Dict[str, Any] = {"tokens": int(spec_cfg["tokens"])}
        draft_cfg = spec_cfg.get("draft")
        if not draft_cfg or not with_draft:
            return speculative, None
        draft_kwargs = dict(draft_cfg.get("arch_kwargs") or {})
        draft_spec = create_model(draft_cfg["architecture"], **draft_kwargs)
        draft_dir = draft_cfg.get("model_dir")
        draft_local = Storage.download(draft_dir) if draft_dir else local
        module_d, _, _ = param_cache.load_or_materialize(
            draft_cfg["architecture"], draft_kwargs, draft_spec,
            draft_local, self.device)
        window = int(draft_cfg.get("window", 0) or 0) or DEFAULT_DRAFT_WINDOW
        speculative.update({"draft_module": module_d,
                            "draft_window": window})
        return speculative, (module_d, window)

    async def close(self) -> None:
        """Stop the engine, joining its threads (its host tier closes,
        a persistent one's lock released for a successor)."""
        if self.engine is not None:
            await self.engine.close()
            self.engine = None

    def unload(self) -> None:
        if self.engine is not None:
            self.engine.shutdown_nowait()
            self.engine = None
        if self._draft_handle is not None:
            if self.residency is not None:
                self.residency.deregister(self._draft_handle.name)
            # Unpin: a registration that outlives this unload must not
            # keep vetoing eviction.
            self._draft_handle.release()
            self._draft_handle = None
        if self.hbm is not None:
            self.hbm.release(self.name)
        self.module = None
        self.ready = False

    # -- request parsing ---------------------------------------------------
    def _parse_instance(self, inst: Any) -> Dict[str, Any]:
        cfg = self.config
        if isinstance(inst, str):
            inst = {"prompt": inst}
        if not isinstance(inst, dict):
            raise InvalidInput(
                f"generate instance must be a string or object, got "
                f"{type(inst).__name__}")
        if "prompt" not in inst and "text_input" not in inst:
            raise InvalidInput(
                "generate instance needs 'prompt' (or 'text_input')")
        stop = inst.get("stop", [])
        if isinstance(stop, str):
            stop = [stop]
        if not (isinstance(stop, list)
                and all(isinstance(s, str) and s for s in stop)):
            raise InvalidInput(
                "stop must be a non-empty string or a list of them")
        seed = inst.get("seed")
        logprobs = inst.get("logprobs", 0)
        if logprobs is True:
            logprobs = 1
        try:
            return {
                "prompt": str(inst.get("prompt", inst.get("text_input"))),
                "max_tokens": int(inst.get("max_tokens",
                                           inst.get("max_new_tokens",
                                                    cfg.max_new_tokens))),
                "temperature": float(inst.get("temperature",
                                              cfg.temperature)),
                "top_k": int(inst.get("top_k", 0)),
                "top_p": float(inst.get("top_p", 1.0)),
                "seed": None if seed is None else int(seed),
                "stop": stop,
                "logprobs": int(logprobs),
            }
        except (TypeError, ValueError) as e:
            raise InvalidInput(f"invalid generate parameter: {e}")

    def _submit(self, parsed: Dict[str, Any]):
        ids = self.tokenizer.encode(parsed["prompt"])
        # Prompt-side token accounting (the "out" side counts in the
        # engine's _emit).
        obs.llm_tokens_total().labels(direction="in").inc(len(ids))
        return self.engine.submit(
            ids, max_new_tokens=parsed["max_tokens"],
            temperature=parsed["temperature"],
            top_k=parsed["top_k"], top_p=parsed["top_p"],
            seed=parsed["seed"], logprobs=parsed["logprobs"])

    async def _run_one(self, parsed: Dict[str, Any]) -> Dict[str, Any]:
        req = self._submit(parsed)
        tokens: List[int] = []
        decoder = IncrementalDecoder(self.tokenizer, parsed["stop"],
                                     history=tokens)
        reason = "length"
        async for token, fin in self.engine.stream(req):
            if token is not None:
                tokens.append(token)
                _, stopped = decoder.push(token)
                if stopped:
                    # The match runs host-side on decoded text; the
                    # engine slot is cancelled the moment it lands.
                    self.engine.cancel(req)
                    return self._result(req, decoder.text(), tokens,
                                        "stop", parsed)
            if fin is not None:
                reason = fin
        decoder.finish()
        text = (self.tokenizer.decode(tokens) if decoder.degraded
                else decoder.text())
        return self._result(req, text, tokens, reason, parsed)

    def _result(self, req, text: str, tokens: List[int], reason: str,
                parsed: Dict[str, Any]) -> Dict[str, Any]:
        out = {"text": text, "token_count": len(tokens),
               "finish_reason": reason}
        if parsed["logprobs"] > 0:
            out["logprobs"] = _lp_payload(req, tokens)
        return out

    # -- serving entry points ----------------------------------------------
    def _require_engine(self) -> None:
        if self.engine is None:
            raise InferenceError(f"model {self.name} not loaded")

    async def predict(self, request: Any) -> Any:
        self._require_engine()
        instances = v1.get_instances(request)
        if not instances:
            raise InvalidInput("generate needs at least one instance")
        parsed = [self._parse_instance(i) for i in instances]
        # All instances submit at once and share decode waves; every
        # sibling settles before a failure surfaces.
        results = await asyncio.gather(*[self._run_one(p) for p in parsed],
                                       return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return v1.make_response(list(results))

    async def generate(self, request: Any) -> Any:
        """Non-streaming :generate — v2 generate-extension shape in,
        single result out."""
        self._require_engine()
        result = await self._run_one(self._parse_generate_body(request))
        details = {"token_count": result["token_count"],
                   "finish_reason": result["finish_reason"]}
        if "logprobs" in result:
            details["logprobs"] = result["logprobs"]
        return {"model_name": self.name, "text_output": result["text"],
                "details": details}

    def _parse_generate_body(self, request: Any) -> Dict[str, Any]:
        if isinstance(request, dict) and (
                "text_input" in request or "prompt" in request):
            merged = dict(request)
            params = request.get("parameters") or {}
            if not isinstance(params, dict):
                raise InvalidInput("parameters must be an object")
            merged.update(params)
            return self._parse_instance(merged)
        instances = v1.get_instances(request)
        if not instances:
            raise InvalidInput("generate needs a prompt")
        return self._parse_instance(instances[0])

    async def generate_stream(self, request: Any
                              ) -> AsyncIterator[Dict[str, Any]]:
        """Streaming :generate: an async iterator of per-token events
        {"token": {"id", "text"}} ending with an event that carries
        finish_reason and the whole text.  Validation and submission run
        HERE, before the caller commits response headers, so a bad
        request is a clean 4xx."""
        self._require_engine()
        parsed = self._parse_generate_body(request)
        req = self._submit(parsed)
        stops = parsed["stop"]
        want_lp = parsed["logprobs"] > 0
        finished = False

        async def events():
            nonlocal finished
            collected: List[int] = []
            decoder = IncrementalDecoder(self.tokenizer, stops,
                                         history=collected)

            def token_event(token, text_delta):
                event = {"token": {"id": int(token), "text": text_delta}}
                if want_lp and len(collected) <= len(req.lp_chosen):
                    i = len(collected) - 1
                    event["token"]["logprob"] = req.lp_chosen[i]
                    event["token"]["top_logprobs"] = [
                        {"id": t, "logprob": p} for t, p in req.lp_top[i]]
                return event

            async for token, reason in self.engine.stream(req):
                if token is not None:
                    collected.append(token)
                    delta, stopped = decoder.push(token)
                    if stopped:
                        self.engine.cancel(req)
                        finished = True
                        event = token_event(token, delta)
                        event["finish_reason"] = "stop"
                        event["generated_text"] = decoder.text()
                        event["details"] = {"token_count": len(collected)}
                        yield event
                        return
                    event = token_event(token, delta)
                else:
                    event = {}
                if reason is not None:
                    finished = True
                    tail = decoder.finish()
                    if tail:
                        tok = event.setdefault("token",
                                               {"id": None, "text": ""})
                        tok["text"] += tail
                    full = (self.tokenizer.decode(collected)
                            if decoder.degraded else decoder.text())
                    event["finish_reason"] = reason
                    event["generated_text"] = full
                    event["details"] = {"token_count": len(collected)}
                yield event

        def on_close():
            # The consumer abandoned the stream (client disconnect, even
            # before the first event): free the decode slot.
            if not finished:
                self.engine.cancel(req)

        return GuardedStream(events(), on_close)

    def engine_stats(self) -> Dict[str, Any]:
        stats = dict(self.engine.stats()) if self.engine else {}
        if self.param_source is not None:
            stats["param_source"] = self.param_source
        return stats

    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        if self.config is not None:
            meta["platform"] = "pytorch-generate"
            meta["architecture"] = self.config.architecture
            meta["max_slots"] = self.config.max_slots
            meta["max_seq"] = self.config.max_seq
        return meta
