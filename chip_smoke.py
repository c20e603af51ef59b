#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``kfserving_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, each fatal on
failure:

1. print the card's name and power limit; build every kernel under
   ``kfserving_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc per
   source, all started together); build the native V1 JSON codec
   (``csrc/tensorjson.c``, the host C compiler against this Python's
   headers: the run fails if it does not build), parse one seeded
   224 x 224 x 3 uint8 V1 body with it and with the pure-Python codec
   (equal arrays) and print host us per body of each;
2. hold each kernel (flash attention, paged decode attention) against its
   plain PyTorch version on the card at the serving paths' shapes and
   edge cases (K1 also at head dims 16 and 32; K2 also at one tp rank's
   heads, around the hopper path's tile and at one 4096-token row, each
   row naming the path that ran, checked against the profiled kernel
   names; both at head dims 80, 96, 192 and 256: the Gemma-2B-width
   prefill and decode, ViT-H/14's L = 257, Phi-2's and GPT-NeoX-20B's
   heads, a D192 case, tile edges and fp32, each row naming its path),
   and time kernel (device, events and host issue time),
   plain version and the library call that computes the same function (a
   yardstick only; SDPA's flash backend forced where there is no mask,
   else the backend it picks, named from its kernels).  Device time comes
   from torch.profiler; where a session records no device event three
   times over, from CUDA events behind a sleep kernel;
3. serve BERT-base fill-mask (full width, seeded random init, bf16) through
   the port's ModelServer, send V1 and V2 requests over HTTP, check the
   answers, check that every encoder layer of every executed batch
   launched the flash kernel exactly once, and hold the served model
   against the same weights run with the plain attention; scrape
   ``/metrics`` (requests by model, verb and status; one
   ``engine_stage_ms`` observation per stage and batch); one request with
   a 1 ms ``x-request-timeout-ms`` answers 504 and moves
   ``deadline_exceeded_total``, and one with a ``traceparent`` leaves the
   span chain from ``server.decode`` through ``batcher.queue`` to
   ``engine.execute`` in ``/debug/traces``; every batch of the run a
   compile-cache hit (the grid was captured at warmup); then each of the
   15 buckets' CUDA graph replayed against the eager forward on the same
   seeded padded batch, ``torch.equal``;
4. serve the generate_4k configuration (the decoder at GPT-2-small width,
   seeded random init, bf16, paged cache) over HTTP: 16 SSE streams at
   concurrency 8 behind a shared ~2980-token prompt, one V1 predict and
   one V2 generate; check every answer, that the paged kernel ran
   exactly once per layer per decode step and the flash kernel once per
   layer in every prefill, the prefix-cache hits and the idle pool, and hold one served
   stream against a teacher-forced forward with the plain attention;
   ``llm_ttft_ms`` counts one first token per stream; a stream with a
   400 ms budget ends with finish_reason "timeout" and frees its slot;
   replay the greedy and a seeded (temperature, top-k, top-p) decode
   wave's graph against the same wave run eagerly from the same state
   (tokens and written-back feed equal); time one decode wave eagerly
   and from its graph (between events and busy; no host sync on the
   graph's enqueue path) and one prefill on the card; then the same at
   Gemma-2B's widths (vocab 256000, hidden 2048, 18 layers, 8 heads of
   256, MLP 16384; line "gen_d256", phase "generate_d256": K1 18 times
   per prefill, K2 18 times per step);
   then line "observe": the same configuration with the observability
   layer on (KFS_SANITIZE=1, a 0.5 s history tick, one declared SLO
   objective, incidents spooled to a temporary directory): a 2 s
   ``POST /debug/profile/capture`` across 16 traced streams whose Chrome
   trace must name K1's kernel (K2's kernels or only graph launches are
   counted); ``GET /debug/profile``'s device ``decode.wave`` and
   ``prefill.bucket`` events equal the engine's waves and prefills, and
   every slot event carries a stream's trace id; ``/debug/cache?top_cost``
   holds one cost record per stream, whose prefill + decode device ms sum
   to the engine's device time within 1%, and
   ``kfserving_tpu_request_device_ms`` counts 16 per phase; the ready
   probe's sanitizer block shows the guard armed and no violation, then
   ``.item()`` on a CUDA tensor under ``loop_guard`` raises, counts one
   ``forbidden_transfer``, pins it and opens one incident, read back by
   id and spooled; ``/debug/history`` lists the request and generator
   families with at least two points of the request counter;
   ``/v2/health/slo`` reports the objective; then tokens/s with the
   layer on against off (history, incidents and the sanitizer off), two
   interleaved reps of each, printed beside the card;
   Before it, bert_tiny (head dim 32), vit_tiny (16) and decoder_tiny
   (32) load and serve on the card through K1, each against the plain
   attention.  After it, the generator's other modes at their published
   widths (GPT-2-small width, vocab 32000, bf16, seeded random init):
   ``generate`` on dense slots (24 SSE streams of 64 tokens at
   concurrency 8; K1 once per layer per prefill, K2 never; a stream
   against the plain teacher-forced forward; the dense wave's graphs
   against the eager wave; one cache), ``generate_cold4k`` (four live
   streams while five salted 3900-token prompts land, once chunked and
   once monolithic: decode gaps, chunk counts and the stall histogram;
   the greedy cold outputs equal across the arms; a chunk's graph
   against its eager run) and ``specdec`` (the arms off, ngram and a
   self-draft: six repetitive prompts' greedy ids identical across the
   arms, a seeded stream equal to its plain run, tokens/s, acceptance
   and accepted length; K1 = layers x (prefills + K x draft waves); the
   verify and draft graphs against their eager runs), ``kvtier`` (the
   host KV tier: tier, drop and keep arms on one server, 8 conversations
   of a 1920-token context through a 72-block pool, the return visits
   timed; the tier arm's ids equal the keep arm's, its faulted-back and
   spilled blocks equal the keep arm's bytes, tokens saved == (faulted +
   coalesced) x 128, no spill or fault-back failure; K2 = layers x steps
   x waves, K1 never (every prompt is chunked); the fault-back and spill
   of 12 blocks timed with their GB/s beside a 1920-token prefill
   forward) and ``kvhandoff`` (a recycle per arm: the incumbent serves 6
   conversations and, in the handoff arm, exports into a persistent tier;
   a successor on the same directory adopts it and serves the return
   visits with the unbroken session's ids; the adopted payloads equal
   the exported ones; export ms and outcomes, adopted blocks, return
   TTFT against the cold arm);
5. serve ResNet-50 (224 px, 1000 classes, bf16, seeded random init with
   BatchNorm statistics calibrated on a seeded batch) at the resnet bench
   configuration: 128 V1 and V2 uint8 image requests at concurrency 32,
   then the same 128 images as V2 binary UINT8 requests; every V1 body
   of the JSON arm must be parsed by the native codec; every served
   argmax must equal the direct forward's on the card, but for counted
   near-ties; one ``binary_data_output`` response must decode to its JSON
   counterpart; the request and stage series of the scrape; time a b128
   forward (CUDA events, MFU); each batch bucket's graph against the
   eager forward;
6. serve ViT-B/16 (224 px, L = 197) at the chain bench's predictor
   configuration; the flash kernel must launch exactly 12 times per
   executed batch, and the served model must agree with the same weights
   run with the plain attention (its logits, and its top-1 but for
   near-ties); each batch bucket's graph against the eager forward; then
   ViT-H/14 (patch 14, hidden 1280, 32 layers, 16 heads of 80, L = 257)
   the same way ("vit_h14", K1 32 times per batch);
   then the explain verb: ResNet-50 (the resnet bench configuration)
   and ViT-B/16 (L = 197) served as saliency explainers, one batch of 8
   images POSTed twice to each explain route with single-image predicts
   served beside them; every map has the input's shape, is finite and
   not all zeros, the served bf16 maps agree with the same gradient
   computed directly and with the same logit's gradient in fp32 from the
   same weights (relative L2 and cosine per image, SALIENCY_LIMITS), and
   ViT's K1 launches in the window equal 12 x (explains + predict
   batches), its gradient through the K1 Function against the one
   through the plain attention; forward and backward device ms.  Then
   ResNet-50 served as the predictor of anchor_images, lime_images (256
   samples, batch 64) and square_attack, each served on a server of its
   own and reaching it through predictor_host: every hop on the V2
   binary wire (the predictor counts only ``infer``), well-formed
   explanations, wall ms, hop requests, images and req/s.  Then a tar of
   an MLP artifact served over http:// by a stdlib server loads through
   Storage.download into the port's server and answers a predict; a
   second pull into one directory stops at the success marker;
7. serve the multi-model catalog (8 MLPs) through the eager repository
   routes under a device-memory budget of 4 models: LRU eviction in the
   index, evicted models freed, predictions held against direct forwards;
   the ledger equal to the resident models' parameters and graph pools
   (as the allocator reports them) plus the shared cuBLAS workspace;
8. serve four BERT-base fill-mask models demand-paged (registered, then
   faulted in by their requests) under a budget of two: three rounds of
   b1 requests round-robin; after every warm fault the top-5 equals round
   1's, once every parameter and buffer equals its mmap source bit for
   bit, the ledger stays within budget, ``memory_allocated`` is the same
   after each round, 8 concurrent requests coalesce onto one fault, a
   fault-in skips a model held in flight, and the flash kernel launched
   12 times per batch (cold-fault warmups included); after each round
   the ledger equals the resident models' parameters and graph pools
   plus the workspace (each warm fault's first request recaptures its
   bucket);
9. serve 20 catalog MLPs demand-paged under 40% of their bytes, four
   workers each taking 6 shuffled passes; every answer held against its
   model's direct forward;
   then the serving control plane: line ``chain`` (ViT-B/16 at the chain
   bench's configuration behind the port's image transformer, both
   in-process replicas of an InferenceService applied through the
   Controller and served through the IngressRouter, the transformer
   reaching the predictor through the router's /direct/predictor lane:
   128 requests of one seeded uint8 image at concurrency 16, then 20
   req/s for 5 s; every answer equals the argmax of the direct forward
   on the transformer's preprocessed image, but for a counted near-tie,
   and carries ``x-kfs-revision``; K1 = 12 x the predictor's batches),
   line ``activate`` (the predictor re-applied with min_replicas 0, the
   autoscaler scales it to zero and ``memory_allocated`` falls by at
   least its parameter bytes; one request activates it again with the
   same answer) and line ``recycle`` (the generate_4k decoder as an
   llmserver subprocess replica on the card with a standby pool of one,
   a persistent KV tier and a RecyclePolicy that recycles it after the
   first of two turns of 8 conversations over SSE; the successor adopts
   the drained incumbent's KV, a profiler capture on it names K1 and K2;
   then the successor is SIGKILLed during a stream, which ends with the
   router's retriable failover event, a request sent right after is
   retried by the router and the promoted standby answers, pulling from
   the x-kfs-kv-peer it is named; every stream's ids held against a
   teacher-forced plain forward in this process; swap and promotion ms,
   return-visit TTFT, device memory in use with one and two replica
   processes).  A replica that fails to come up is run once more in the
   foreground, its output printed;
10. the predictors that place no model of the zoo, after ``agent``:
   line ``tabular`` (the xgb, lgb and pmml servers on their native
   evaluators, over seeded artifacts at the frameworks' default sizes:
   100 trees of depth 6 and 100 trees of 31 leaves over HIGGS's 28
   features, a PMML TreeModel of depth 6; 64 requests of 1 and of 64
   rows at concurrency 8 on V1 JSON and V2 binary, every answer equal
   to the evaluator's direct predict; the sklearn server is tested on
   the CPU only), line ``torchserver`` (KFServing's CIFAR-10 sample Net,
   class file and seeded state dict, served with ``--device cuda``: 64
   requests each of 1 and 16 images at concurrency 8, every answer equal
   to the direct forward on the card and within a stated fp32 tolerance
   of its CPU copy; one b16 forward's ms) and line ``detectors`` (the
   RequestLogger tees the xgb server's 256 one-row requests, the last 64
   shifted by 3 sigma in 4 features, to an outlier and a KS drift
   detector: events sent and dropped, outlier rates, where the drift
   verdict flips; scores and verdicts against the detectors fed
   directly).  None of the three launches K1 or K2;
11. line ``mesh`` (``kfserving_tpu_torch/parallel/``): NCCL's answer to
   two ranks on one card, and a one-rank NCCL mesh's all-reduce and
   ring exchange inside a captured CUDA graph; then, the ranks sharing
   the card over gloo (eager: a gloo collective cannot sit in a graph),
   BERT-base (the ``bert`` phase's config) served over HTTP under
   {"tp": 2}, {"sp": 2} and {"dp": 2, "tp": 2}, every answer held
   against the unsharded model's under ``agreement``, and the
   generate_4k decoder under {"tp": 2} (16 streams of 48 tokens at
   concurrency 8), every token the unsharded model's greedy choice
   teacher-forced but for counted near-ties; K1 and K2 launches counted
   on every rank (the followers report theirs), each rank's parameter
   and KV-pool bytes beside the unsharded engine's, req/s, tokens/s and
   TTFT as information; no follower left after each unload;
12. line ``checkpoint`` (seeded HF-layout state dicts at BERT-base's and
   ResNet-50's published widths, ResNet's BatchNorm statistics
   calibrated in memory first, converted by ``python -m
   kfserving_tpu_torch.tools.convert`` and loaded from the written
   ``checkpoint.msgpack`` with no msgpack package: each loaded module bit
   for bit the same weights mapped in memory and its forward that
   module's; BERT over V2 JSON, K1 = 12 x batches, its top-k against the
   plain attention; ResNet over the V2 binary wire, its argmax the
   in-memory forward's but for counted near-ties; the checkpoint's
   bytes, the conversion's, decode's and load's times, GB/s), line
   ``openapi`` (``tools/torch2openapi`` for BERT-base, ResNet-50 and
   ViT-B/16 on meta tensors: ``memory_allocated`` unchanged), line
   ``grpc`` where ``grpc`` and ``google.protobuf`` import (BERT-base and
   generate_4k behind ``grpc_port``: 32 ``ModelInfer`` requests, raw and
   typed, at concurrency 8, then 8 ``GenerateStream`` streams of 48
   tokens whose ids equal the same prompts' SSE ids, or both hold as the
   greedy choice teacher-forced but for counted near-ties; K1 and K2
   counted as in the HTTP phases; elsewhere one line says it did not
   run) and line ``metrics_lint`` (``tools/check_metrics.lint_exposition``
   over the BERT, generate_4k and router scrapes, each linted as its
   phase ends: zero problems);
13. print a ``graphs`` line (per engine: the buckets held equal, capture
   ms, pool bytes; compile-cache hits and misses per phase; the decode
   wave's variants, graph and eager wave ms; the residency catalog's
   warm fault and first-request ms), the ResNet arms' req/s and each
   predict model's mean engine stage ms (prepare, transfer, compute,
   fetch) on a ``stages`` line, the seconds of every phase on a
   ``phase_seconds`` line, one ``{"kernels": [...]}`` line, the
   card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Every model loads through a private mmap param cache (``KFS_PARAM_CACHE``
points at a temporary directory for the run).

Exits non-zero, printing no result, without a CUDA device.  Imports
nothing of JAX.
"""

import asyncio
import dataclasses
import http.client
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its operand type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain version.  bf16 (both kernels): each side computes in
# fp32 from the same bf16 inputs and rounds the output to bf16 (K1 also
# rounds P to bf16 before P.V, one ulp is 2^-8 relative).  An output
# shrinks with the keys its query attends (about 0.03 at ~3000 keys), so
# the limit follows each output vector's own scale: |out - ref| <=
# BF16_RTOL * max|ref| over the vector's D elements (two bf16 ulps of its
# largest element) + BF16_ATOL.  fp32: an absolute limit per kernel.
BF16_RTOL, BF16_ATOL = 2 ** -6, 1e-5
# K1 fp32 splits operands into bf16 hi + lo halves (about 16 mantissa
# bits).
FLASH_FP32_TOLERANCE = 2e-4

SEQ_BUCKETS = [32, 64, 128, 256, 512]
BATCH_BUCKETS = [1, 4, 16]
REQUEST_LENGTHS = [24, 48, 100, 200, 450]
TOPK = 5
# Served model vs the same weights with plain attention (both bf16): the
# share of positions whose top-1 token agrees, and the largest logit gap.
MIN_TOP1_AGREEMENT = 0.9
MAX_LOGIT_DIFF = 0.5

PREFILL_CASE = "b8 L4096 bf16 causal kv_lengths"
VIT_CASE = "b16 L197 bf16 (ViT-B/16)"
# The head dims the kernels took in PR 19 (the rest of 16-256): each case
# of theirs goes in the kernels line with the path it ran.
NEW_HEAD_DIMS = (80, 96, 192, 256)
GEMMA_PREFILL_CASE = "gemma b8 L4096 bf16 H8 D256 causal kv_lengths"
VIT_H14_CASE = "vit_h14 b16 L257 bf16 H16 D80"
GEMMA_DECODE_CASE = "gemma b8 decode ~3045 bf16 H8 D256"
# K2 fp32 differs from its plain version by summation order only
# (partitions, fp32 exp).
PAGED_FP32_TOLERANCE = 2e-5
PAGED_MAIN_CASE = "b8 decode ~3045 bf16"
PAGED_LONG_ROW_CASE = "b1 4096 bf16"
# The device kernel each path of K2 launches first (its merge follows).
PAGED_KERNEL_NAMES = {"hopper": "paged_span_kernel",
                      "simple": "paged_partition_kernel"}
# One rank's heads (H = 6 of 12) under the mesh phase's {"tp": 2}.
MESH_BERT_CASE = "tp2 rank: b16 L512 bf16 H6 kv_lengths"
MESH_PREFILL_CASE = "tp2 rank: b8 L4096 bf16 H6 causal kv_lengths"
MESH_DECODE_CASE = "tp2 rank: b8 decode ~3045 bf16 H6"

# The generate_4k configuration (benchmarks/configs.py:1891-1949): the
# decoder at GPT-2-small width, paged 8 slots x 4096, 16 streams of 48
# tokens at concurrency 8 behind a ~2980-character shared system prompt.
GEN_CONFIG = {
    "architecture": "decoder",
    "arch_kwargs": {"vocab_size": 32000, "hidden_size": 768,
                    "num_layers": 12, "num_heads": 12,
                    "intermediate_size": 3072, "max_seq": 4096},
    "max_slots": 8, "max_seq": 4096, "prefill_buckets": [512, 4096],
    "block_size": 128, "cache_blocks": 112, "steps_per_call": 16,
    "tokenizer": "byte",
}
GEN_REQUESTS, GEN_CONCURRENCY, GEN_MAX_TOKENS = 16, 8, 48
# The decoder at Gemma-2B's widths (Gemma Team, 2024, Table 1: vocab
# 256000, hidden 2048, 18 layers, 8 heads of 256, MLP 16384, tied
# embeddings; the port's decoder is GPT-class, so only the widths carry
# over) under generate_4k's serving settings and traffic: head dim 256,
# K1's wgmma path at 64-key tiles and K2's hopper path at 4-token tiles.
GEMMA_CONFIG = dict(GEN_CONFIG, arch_kwargs={
    "vocab_size": 256000, "hidden_size": 2048, "num_layers": 18,
    "num_heads": 8, "intermediate_size": 16384, "max_seq": 4096})
GEMMA_WIDTHS = (18, 2048, 8, 4096)
GEN_SYSTEM_LEN, GEN_TAIL_LEN = 2980, 40

# GPT-2-small width with a 32000 vocabulary, as the three configurations
# below publish it.
GPT2_SMALL = {"vocab_size": 32000, "hidden_size": 768, "num_layers": 12,
              "num_heads": 12, "intermediate_size": 3072}
# The generate configuration (benchmarks/configs.py:1458-1466): dense
# slots, 8 x 512, buckets 64/512, 16 steps a wave at depth 2; 24 SSE
# streams of 64 tokens at concurrency 8.
DENSE_CONFIG = {
    "architecture": "decoder", "arch_kwargs": dict(GPT2_SMALL, max_seq=512),
    "max_slots": 8, "max_seq": 512, "prefill_buckets": [64, 512],
    "steps_per_call": 16, "pipeline_depth": 2, "tokenizer": "byte",
}
DENSE_REQUESTS, DENSE_CONCURRENCY, DENSE_MAX_TOKENS = 24, 8, 64
DENSE_PROMPT_LENS = (40, 120, 300, 420)
# The generate_cold4k configuration (benchmarks/configs.py:2058-2073):
# 4096-token slots, 176 blocks of 128, chunks of 512 in one arm and
# monolithic prefill in the other; four live streams (60-token prompts,
# 128 tokens) while five unique, salted 3900-token cold prompts land
# (24 tokens each).  The published smallest bucket, 64, is not a
# multiple of the block size, which both engines refuse (a paged insert
# writes whole blocks): 128 takes its place.
COLD_CONFIG = {
    "architecture": "decoder", "arch_kwargs": dict(GPT2_SMALL, max_seq=4096),
    "max_slots": 8, "max_seq": 4096, "prefill_buckets": [128, 512, 4096],
    "block_size": 128, "cache_blocks": 176, "steps_per_call": 16,
    "tokenizer": "byte",
}
COLD_CHUNK = 512
COLD_STREAMS, COLD_STREAM_LEN, COLD_STREAM_TOKENS = 4, 60, 128
COLD_PROMPTS, COLD_LEN, COLD_TOKENS = 5, 3900, 24
# The specdec configuration (benchmarks/configs.py:2990-3010): 4 slots x
# 2048, 96 blocks of 128, chunks of 256, 16 steps a wave; K = 4 proposals
# a spec wave, a 128-token draft window; 6 repetitive 640-character
# prompts, 64 greedy tokens each, in the arms off, ngram and draft (a
# self-draft on the target's weights).
SPEC_CONFIG = {
    "architecture": "decoder", "arch_kwargs": dict(GPT2_SMALL, max_seq=2048),
    "max_slots": 4, "max_seq": 2048, "prefill_buckets": [256, 1024, 2048],
    "block_size": 128, "cache_blocks": 96, "prefill_chunk_tokens": 256,
    "steps_per_call": 16, "tokenizer": "byte",
}
SPEC_K, SPEC_WINDOW = 4, 128
SPEC_PROMPTS, SPEC_CTX_LEN, SPEC_MAX_TOKENS = 6, 640, 64
SPEC_SEED = 7

# The kvtier configuration (benchmarks/configs.py:2569-2585): 4 slots x
# 4096, 72 blocks of 128, chunks of 512, 16 steps a wave; a host tier of
# 256 blocks in the "tier" arm, none in "drop", and in "keep" a pool of
# 256 blocks that never evicts (the reference for the tier arm's ids and
# block bytes).  8 conversations of a 1920-character salted context (+
# " turn NNN"), 16 tokens a turn, turns 0 and 1 to warm up, turn 2 the
# measured return visits at Poisson gaps of 50 ms mean.
KVTIER_SETUP = {
    "config": {
        "architecture": "decoder",
        "arch_kwargs": dict(GPT2_SMALL, max_seq=4096),
        "max_slots": 4, "max_seq": 4096, "prefill_buckets": [512, 2048, 4096],
        "block_size": 128, "cache_blocks": 72, "prefill_chunk_tokens": 512,
        "steps_per_call": 16, "tokenizer": "byte"},
    "tier_blocks": 256, "keep_blocks": 256, "convs": 8, "ctx_len": 1920,
    "tokens": 16, "gap_mean_s": 0.05, "timed_blocks": 12,
}
# The kvhandoff configuration (benchmarks/configs.py:2778-2800): as kvtier
# with 120 blocks, so the pool holds every conversation; 6 conversations;
# both arms carry a 256-block tier, the "handoff" arm's persistent (the
# incumbent exports into it within 10 s and the successor adopts it), the
# "cold" arm's ephemeral.
KVHANDOFF_SETUP = dict(KVTIER_SETUP, convs=6, export_budget_s=10.0,
                       config=dict(KVTIER_SETUP["config"], cache_blocks=120))

# The resnet bench configuration (benchmarks/configs.py:207-219).
RESNET_CONFIG = {
    "architecture": "resnet50", "arch_kwargs": {"image_size": 224},
    "max_batch_size": 128, "batch_buckets": [4, 8, 16, 32, 64, 128],
    "pipeline_depth": 3, "max_latency_ms": 15.0, "warmup": True,
    "input_dtype": "uint8", "scale": 1.0 / 255.0, "output": "argmax",
}
RESNET_REQUESTS, RESNET_CONCURRENCY = 128, 32
V2_EVERY = 4          # every fourth image request is V2, the rest V1
# A served argmax may differ from the direct forward's only where that
# forward's top two logits lie within this share of its largest |logit|:
# the served batches run at other batch sizes (other cuDNN algorithms),
# and bf16 activations (8 mantissa bits) are rounded at other places
# through 53 layers.
RESNET_TIE_RTOL = 2 ** -5
# The chain bench's ViT predictor (benchmarks/configs.py:1389-1393).
VIT_CONFIG = {
    "architecture": "vit_b16", "arch_kwargs": {"image_size": 224},
    "max_batch_size": 16, "max_latency_ms": 5.0, "warmup": True,
    "output": "argmax",
}
VIT_REQUESTS, VIT_CONCURRENCY = 48, 16
# ViT-H/14 at 224 px (Dosovitskiy et al., 2021, Table 1: patch 14, hidden
# 1280, 32 layers, 16 heads, MLP 5120): L = 257, head dim 80, the mma.sync
# path of K1.  The chain bench's ViT serving settings and traffic.
VIT_H14_CONFIG = dict(VIT_CONFIG, arch_kwargs={
    "image_size": 224, "patch_size": 14, "hidden_size": 1280,
    "num_layers": 32, "num_heads": 16, "intermediate_size": 5120,
    "num_classes": 1000})
VIT_H14_WIDTHS = (32, 1280, 16, 257)
# ViT served through K1 vs the same weights with the plain attention
# (both bf16): the logits of one batch differ by at most this share of
# the batch's largest |logit|.  K1 and the plain version differ by bf16
# rounding of P and of the output (2^-6 of each output vector); the
# residual stream carries that through 12 blocks.  On the CPU two
# roundings of the attention moved ViT-B/16's logits by ~1% of their
# largest.
VIT_LOGIT_RTOL = 2 ** -4
# The explain phase: one batch of EXPLAIN_IMAGES images POSTed
# EXPLAIN_ROUNDS times to each explain route of a saliency explainer
# (ResNet-50 at the resnet bench configuration, ViT-B/16 at the chain
# bench's), with EXPLAIN_IMAGES / 2 single-image predicts served beside.
EXPLAIN_IMAGES, EXPLAIN_ROUNDS = 8, 2
# Limits of the per-image gradient gaps: relative L2 ||g - ref|| / ||ref||
# at most the first, cosine at least the second, for the served bf16 map
# against the same logit's gradient in fp32 from the same weights, and
# against the same bf16 gradient computed directly.  A bf16 forward rounds
# every activation to 8 significand bits (2^-9 relative), and a rounding
# that flips a max-pool or ReLU gate re-routes the gradient, so the fp32
# gradient itself moves under one such rounding of its input.  The run
# measures that spread (a seeded 2^-9 jitter of the input) and the limit
# is twice it, or these where they are looser: ResNet-50's 53 gated
# convolutions against ViT-B/16's 12 smooth blocks (GELU and softmax).
SALIENCY_LIMITS = {"resnet": (0.5, 0.9), "vit": (0.1, 0.99)}
# ViT's gradient through the K1 Function against the same gradient through
# the plain attention forward, both bf16: the forwards differ by the bf16
# rounding of P and of the output (see VIT_LOGIT_RTOL), and the backward
# is the same VJP.
K1_GRAD_REL_L2, K1_GRAD_COSINE = 0.1, 0.99
# The black-box explainers' artifact configurations, pointed at ResNet-50
# (calibrated BatchNorm, so its answers depend on the image) through
# predictor_host.  Anchors over a 4 x 4 grid of superpixels, anchors of at
# most two; LIME with 256 samples in batches of 64; the square attack
# within 16 of 255 per pixel.
ANCHOR_IMAGES_CONFIG = {"n_segments": 16, "batch_size": 24, "beam_size": 2,
                        "max_anchor_size": 2, "seed": 0}
LIME_CONFIG = {"num_samples": 256, "batch_size": 64, "top_labels": 2,
               "seed": 0}
ART_CONFIG = {"eps": 16.0, "max_iter": 20, "candidates_per_iter": 8,
              "clip_min": 0.0, "clip_max": 255.0, "seed": 0}
# The multi-model catalog (benchmarks/configs.py:896-907).
MMS_MODELS, MMS_RESIDENT = 8, 4
MMS_CONFIG = {
    "architecture": "mlp",
    "arch_kwargs": {"input_dim": 32, "features": [64], "num_classes": 8},
    "max_latency_ms": 2.0, "warmup": True,
}
# The demand-paged BERT-base catalog: four fill-mask models of
# serve_bert's configuration (each its own init seed, so each serves its
# own weights) under a budget of two models' device bytes; ten rounds of
# b1 requests round-robin (round 1 cold-faults every model, each later
# request warm-faults one: 36 warm faults), then 8 concurrent requests to
# one offloaded model.
RES_MODELS, RES_RESIDENT, RES_ROUNDS, RES_COALESCE = 4, 2, 10, 8
RES_CONFIG = {
    "architecture": "bert", "seq_buckets": SEQ_BUCKETS,
    "batch_buckets": BATCH_BUCKETS, "max_batch_size": 16,
    "output": "topk", "topk": TOPK,
}
# MLP density, the full size of benchmarks/configs.py:1027-1120: 24
# catalog MLPs demand-paged under 40% of the catalog's bytes, four workers
# each taking 24 shuffled passes over it (2304 requests).
DENSITY_MODELS, DENSITY_FRAC, DENSITY_WORKERS, DENSITY_PASSES = \
    24, 0.4, 4, 24


# The request path's stage series, and one traced request's span chain.
STAGES = ("prepare", "transfer", "compute", "fetch")
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"
SPAN_CHAIN = ("server.decode", "server.infer", "dataplane.preprocess",
              "dataplane.predict", "batcher.queue", "engine.execute",
              "dataplane.postprocess", "server.encode")
# A generate stream whose budget runs out: max_tokens far past what the
# budget lets it generate.
GEN_TIMEOUT_MS, GEN_TIMEOUT_TOKENS = 400, 2000
# The codec phase: host time of the C and the pure-Python parse of one
# 224 x 224 x 3 uint8 V1 body.
CODEC_ITERS = {"native": 20, "python": 3}


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def agreement(out: torch.Tensor, ref: torch.Tensor, fp32_tol: float,
              where: str) -> tuple:
    """Fails unless ``out`` agrees with ``ref`` (the limits above).
    Returns (max abs error, the limit as printed, the largest error as a
    share of its limit)."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.bfloat16:
        scale = ref.float().abs().amax(dim=-1, keepdim=True)
        limit = BF16_RTOL * scale + BF16_ATOL
        tolerance = f"{BF16_RTOL} * max|ref| per vector + {BF16_ATOL}"
    else:
        limit = torch.full_like(err, fp32_tol)
        tolerance = fp32_tol
    worst = float((err / limit).max())
    check(worst <= 1.0, f"{where}: error {worst} times the limit "
          f"({tolerance}); max abs error {float(err.max())}")
    return float(err.max()), tolerance, worst


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_events_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn`` from CUDA events, with host gaps
    kept out: a sleep kernel holds the stream while the host queues the
    calls, so the card runs them back to back between the two events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # At most ~2e9 cycles a second: the sleep outlasts twice the host's
    # time to queue the calls.
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int = 20, attempts: int = 3) -> tuple:
    """Device time per call of ``fn``: the summed durations of the kernels
    and copies it ran (torch.profiler), each device event counted once and
    idle gaps excluded, so host overhead between launches does not count.
    The profiler now and then records no device event at all; after
    ``attempts`` such sessions the time comes from ``queued_events_ms``.
    Returns (ms per call, the device events' key_averages or [] when the
    profiler saw none, "profiler" | "events")."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            return total_us / 1e3 / iters, events, "profiler"
    print(f"torch.profiler recorded no device time in {attempts} sessions; "
          "timing with CUDA events behind a sleep kernel", file=sys.stderr,
          flush=True)
    return queued_events_ms(fn, iters), [], "events"


SDPA_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}


def sdpa_backend(events, library) -> str:
    """Which of scaled_dot_product_attention's backends ran: from the
    names of the device kernels it launched or, where the profiler saw
    none, from the choice SDPA makes for the same call (``library`` run
    with ``torch._fused_sdp_choice`` in place of the SDPA function)."""
    names = " ".join(e.key.lower() for e in events)
    if "cudnn" in names:
        return "cudnn"
    if "flash" in names:
        return "flash"
    if "fmha" in names or "efficient" in names:
        return "efficient"
    if names:
        return "math"
    choice = library(torch._fused_sdp_choice)
    return SDPA_BACKENDS.get(int(choice), f"backend {int(choice)}")


def host_us_per_call(fn, iters: int = 20) -> float:
    """Host time to issue one call, with the card left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host_us


def time_kernel_case(kernel, plain, library, plain_iters: int) -> dict:
    """Kernel, plain version and library call at one shape: profiled
    device time per call ("ms", "plain_ms", "library_ms", each with how
    it was timed), the kernel's time between CUDA events over
    back-to-back calls ("events_ms", which a slow host inflates for a
    short kernel) and behind a sleep kernel ("queued_ms", the profiler's
    stand-in), the host's time to issue one kernel call ("host_us"),
    the library call's backend, the kernel-to-library ratio and the
    names of the device kernels of the kernel's call ("device_kernels",
    empty where the profiler saw none).  ``library(sdpa)`` makes the library call through the function
    ``sdpa`` (scaled_dot_product_attention by default)."""
    ms, events, timing = profiled_device_ms(kernel)
    library_ms, library_events, library_timing = profiled_device_ms(library)
    plain_ms, _, plain_timing = profiled_device_ms(plain, plain_iters)
    return {"ms": ms, "timing": timing,
            "device_kernels": sorted(e.key for e in events),
            "events_ms": cuda_time_ms(kernel),
            "queued_ms": queued_events_ms(kernel),
            "host_us": host_us_per_call(kernel),
            "plain_ms": plain_ms, "plain_timing": plain_timing,
            "library_ms": library_ms, "library_timing": library_timing,
            "library_backend": sdpa_backend(library_events, library),
            "kernel_to_library": ms / library_ms}


# -- phase 2: kernels against their plain versions ---------------------------
def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    """Least time for a call's work, the larger of its bytes over the
    memory rate and its operations over the peak rate for its type:
    (ms, "bytes" | "operations")."""
    op_s = ops / PEAK_OPS_PER_S[str(dtype).split(".")[-1]]
    byte_s = nbytes / PEAK_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations"
    return byte_s * 1e3, "bytes"


def attention_bound_ms(B, H, Lq, Lk, D, dtype, causal, lengths) -> tuple:
    """Least time for this flash call's work (causal needs Lq == Lk)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if lengths is not None:
        keys = [min(max(int(n), 0), Lk) for n in lengths.tolist()]
        if causal:
            # Query i attends min(i + 1, n) keys.
            pairs = sum(n * (n + 1) // 2 + (Lq - n) * n for n in keys)
        else:
            pairs = sum(Lq * n for n in keys)
        kv_rows = sum(keys)
    elif causal:
        pairs = B * Lq * (Lq + 1) // 2
        kv_rows = B * Lk
    else:
        pairs = B * Lq * Lk
        kv_rows = B * Lk
    ops = 4 * H * D * pairs
    nbytes = (2 * B * Lq + 2 * kv_rows) * H * D * itemsize
    if lengths is not None:
        nbytes += 4 * B
    return bound_ms(nbytes, ops, dtype)


def check_flash_attention() -> dict:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from kfserving_tpu_torch.csrc import build
    from kfserving_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        kernel_path,
    )

    bf16, fp32 = torch.bfloat16, torch.float32
    # The decoder's bucketed prefill at the generate_4k shape: 8 rows of
    # ~3020 prompt tokens in the 4096 bucket, a dummy row of length 1 (the
    # engine pads prefill batches with such rows).  Its row goes in the
    # kernels line: the largest call on the serving paths.
    prefill_lengths = [3021, 1, 4096, 3021, 2000, 3021, 17, 3021]
    # Rows at the kernel's 128-key tile edges, and an empty row.
    edges = [0, 1, 127, 128, 129, 200]
    cases = [
        # name, B, H, Lq, Lk, D, dtype, causal, lengths ("ragged": random
        # with a full row, a zero row and a half row).  BERT serves
        # L32-512 with lengths, the decoder prefills L512 and L4096
        # causal with lengths.
        ("L32 bf16 kv_lengths", 16, 12, 32, 32, 64, bf16, False, "ragged"),
        ("L64 bf16 kv_lengths", 16, 12, 64, 64, 64, bf16, False, "ragged"),
        ("L128 bf16 kv_lengths", 16, 12, 128, 128, 64, bf16, False,
         "ragged"),
        ("L128 bf16 causal", 16, 12, 128, 128, 64, bf16, True, None),
        ("L200 bf16 kv_lengths edges", 6, 12, 200, 200, 64, bf16, False,
         edges),
        ("L200 bf16 causal kv_lengths edges", 6, 12, 200, 200, 64, bf16,
         True, edges),
        ("L256 bf16 kv_lengths", 16, 12, 256, 256, 64, bf16, False,
         "ragged"),
        ("Lq136 Lk520 bf16 kv_lengths", 4, 12, 136, 520, 64, bf16, False,
         "ragged"),
        ("L512 bf16 causal", 16, 12, 512, 512, 64, bf16, True, None),
        ("L512 bf16 full", 16, 12, 512, 512, 64, bf16, False, None),
        ("L512 fp32 D128 kv_lengths", 16, 12, 512, 512, 128, fp32, False,
         "ragged"),
        ("L512 bf16 D128 causal kv_lengths", 16, 12, 512, 512, 128, bf16,
         True, "ragged"),
        # BERT-base serving's largest shape.
        ("L512 bf16 kv_lengths", 16, 12, 512, 512, 64, bf16, False,
         "ragged"),
        ("L512 bf16 causal kv_lengths", 16, 12, 512, 512, 64, bf16, True,
         "ragged"),
        (PREFILL_CASE, 8, 12, 4096, 4096, 64, bf16, True, prefill_lengths),
        # ViT-B/16 at 224 px: L = 197 with no mask, its largest bucket
        # and one image; the fp32 path's partial tiles at 197; a short
        # ragged length.
        (VIT_CASE, 16, 12, 197, 197, 64, bf16, False, None),
        ("b1 L197 bf16", 1, 12, 197, 197, 64, bf16, False, None),
        ("b2 L197 fp32", 2, 12, 197, 197, 64, fp32, False, None),
        ("b2 L13 bf16", 2, 12, 13, 13, 64, bf16, False, None),
        # The head dims of the tiny models (the mma.sync path): bert_tiny's
        # buckets (D32, lengths), decoder_tiny's causal + lengths prefill
        # (D32), vit_tiny's L = 17 (D16); bf16 and fp32 each.
        ("bert_tiny b16 L32 bf16 D32 kv_lengths", 16, 4, 32, 32, 32, bf16,
         False, "ragged"),
        ("bert_tiny b16 L128 bf16 D32 kv_lengths", 16, 4, 128, 128, 32,
         bf16, False, "ragged"),
        ("bert_tiny b16 L128 fp32 D32 kv_lengths", 16, 4, 128, 128, 32,
         fp32, False, "ragged"),
        ("decoder_tiny b8 L256 fp32 D32 causal kv_lengths", 8, 4, 256, 256,
         32, fp32, True, "ragged"),
        ("decoder_tiny b8 L256 bf16 D32 causal kv_lengths", 8, 4, 256, 256,
         32, bf16, True, "ragged"),
        ("vit_tiny b16 L17 bf16 D16", 16, 4, 17, 17, 16, bf16, False, None),
        ("vit_tiny b16 L17 fp32 D16", 16, 4, 17, 17, 16, fp32, False, None),
        # One rank's heads under {"tp": 2} (the mesh phase): BERT-base's
        # largest bucket and the generate_4k prefill at H = 6.
        (MESH_BERT_CASE, 16, 6, 512, 512, 64, bf16, False, "ragged"),
        (MESH_PREFILL_CASE, 8, 6, 4096, 4096, 64, bf16, True,
         prefill_lengths),
        # The head dims past 128 and the two public ones below it that are
        # not multiples of 64: the Gemma-2B-width prefill (generate_d256's
        # bucket), ViT-H/14 at 224 px (L = 257, vit_h14's largest batch),
        # GPT-NeoX-20B's heads, a D192 prefill, the wgmma path's 64-key
        # tile edges at D256 and D192, and fp32 at D80 and D256.
        (GEMMA_PREFILL_CASE, 8, 8, 4096, 4096, 256, bf16, True,
         prefill_lengths),
        (VIT_H14_CASE, 16, 16, 257, 257, 80, bf16, False, None),
        ("vit_h14 b16 L257 bf16 D80 kv_lengths", 16, 16, 257, 257, 80,
         bf16, False, "ragged"),
        ("neox b4 L2048 bf16 H64 D96 causal kv_lengths", 4, 64, 2048, 2048,
         96, bf16, True, "ragged"),
        ("b4 L2048 bf16 H16 D192 causal kv_lengths", 4, 16, 2048, 2048, 192,
         bf16, True, "ragged"),
        ("L200 bf16 D256 causal kv_lengths edges", 6, 8, 200, 200, 256,
         bf16, True, [0, 1, 63, 64, 65, 200]),
        ("L200 bf16 D192 kv_lengths edges", 6, 8, 200, 200, 192, bf16,
         False, [0, 1, 63, 64, 65, 200]),
        ("b2 L128 fp32 D80 kv_lengths", 2, 4, 128, 128, 80, fp32, False,
         [128, 37]),
        ("b2 L128 fp32 D256 causal kv_lengths", 2, 4, 128, 128, 256, fp32,
         True, [128, 37]),
    ]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []
    for name, B, H, Lq, Lk, D, dtype, causal, spec in cases:
        q = torch.randn((B, Lq, H, D), generator=gen, device="cuda",
                        dtype=dtype)
        k, v = (torch.randn((B, Lk, H, D), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        lengths = None
        if spec == "ragged":
            lengths = torch.randint(1, Lk + 1, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            lengths[0], lengths[1], lengths[2] = Lk, 0, Lk // 2 + 3
        elif spec is not None:
            lengths = torch.tensor(spec, dtype=torch.int32, device="cuda")
        out = flash_attention(q, k, v, causal=causal, kv_lengths=lengths)
        ref = flash_attention_plain(q, k, v, causal=causal,
                                    kv_lengths=lengths)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err, tol, share = agreement(out, ref, FLASH_FP32_TOLERANCE, name)
        if lengths is not None:
            for r in (lengths == 0).nonzero().flatten().tolist():
                check(bool((out[r] == 0).all()),
                      f"{name}: the zero-length row {r} is not 0")
        del ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if lengths is not None:
            keys = torch.arange(Lk, device="cuda")
            mask = (keys[None, :] < lengths[:, None])[:, None, None, :]
            if causal:   # SDPA takes a mask or is_causal, not both
                mask = mask & torch.ones((Lq, Lk), dtype=torch.bool,
                                         device="cuda").tril()

        def library(sdpa=F.scaled_dot_product_attention):
            # No mask, bf16: SDPA's flash backend, forced.  Otherwise
            # (a mask, or fp32, which the flash backend does not take):
            # the backend SDPA picks (recorded from its kernels' names).
            if mask is None and dtype == bf16:
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return sdpa(qt, kt, vt, is_causal=causal)
            return sdpa(qt, kt, vt, attn_mask=mask)

        times = time_kernel_case(
            lambda: flash_attention(q, k, v, causal=causal,
                                    kv_lengths=lengths),
            lambda: flash_attention_plain(q, k, v, causal=causal,
                                          kv_lengths=lengths),
            library, plain_iters=2 if Lk > 512 else 5)
        bound, bound_by = attention_bound_ms(B, H, Lq, Lk, D, dtype, causal,
                                             lengths)
        row = {"case": name, "head_dim": D,
               "dtype": str(dtype).split(".")[-1],
               "path": kernel_path(dtype, D), "max_abs_err": err,
               "tolerance": tol, "share_of_limit": share, **times,
               "bound_ms": bound, "bound_by": bound_by,
               "share_of_bound": bound / times["ms"]}
        print("flash_attention " + json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, qt, kt, vt, out, mask
    main_row = next(r for r in results if r["case"] == PREFILL_CASE)
    keys = ("case", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err")
    small = [{k: r[k] for k in keys}
             for r in results if " D32" in r["case"] or " D16" in r["case"]]
    mesh = [{k: r[k] for k in keys} for r in results
            if r["case"] in (MESH_BERT_CASE, MESH_PREFILL_CASE)]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "kfserving_tpu_torch/csrc/flash_attention.cu",
        "replaces": "kfserving_tpu/ops/pallas_attention.py:129",
        "launches": None,  # filled from the serving run
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # The head dims 16 and 32 (the tiny models' shapes).
        "small_head_dim_cases": small,
        # One tp rank's heads (the mesh phase's shapes).
        "mesh_cases": mesh,
        # Head dims 80, 96, 192 and 256: each case with its path.
        "head_dim_cases": head_dim_cases(results),
        # Registers, spills and static shared memory of every instance.
        "ptxas": ptxas_report(build.build_logs.get("flash_attention", ""),
                              "flash_fwd"),
    }


def head_dim_cases(results, dims=NEW_HEAD_DIMS) -> list:
    """The kernels line's summary of the cases at head dims ``dims``."""
    keys = ("case", "head_dim", "dtype", "path", "ms", "bound_ms",
            "bound_by", "plain_ms", "library_ms", "library_backend",
            "max_abs_err")
    return [{k: r[k] for k in keys} for r in results
            if r["head_dim"] in dims]


def paged_bound_ms(B, H, D, BS, MB, dtype, lengths) -> tuple:
    """Least time for one paged decode call: every valid key and value
    read once (rows clamp to the table), q read and out written once;
    4 * H * D operations per valid (row, token)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tokens = sum(min(max(int(n), 0), MB * BS) for n in lengths.tolist())
    nbytes = (tokens * H * D * 2 + 2 * B * H * D) * itemsize
    nbytes += 4 * (B * MB + B)                   # table and lengths
    return bound_ms(nbytes, 4 * H * D * tokens, dtype)


def paged_case(gen, name, B, H, D, BS, MB, dtype, lengths, edit=None):
    """Pools with a sink block, a table of distinct random blocks."""
    nb = B * MB + 8
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda", dtype=dtype)
    pool_k, pool_v = (torch.randn((nb + 1, BS, H, D), generator=gen,
                                  device="cuda", dtype=dtype)
                      for _ in range(2))
    table = torch.randperm(nb, generator=gen, device="cuda")[:B * MB]
    table = table.reshape(B, MB).to(torch.int32)
    if edit is not None:
        edit(table)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return name, (q, pool_k, pool_v, table.contiguous(), lengths)


def ptxas_report(log: str, kernel: str) -> list:
    """Registers, spills and static shared memory of each instance of
    ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    out, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = None
            if kernel in entry.group(1):
                current = {"function": entry.group(1)}
                out.append(current)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def check_paged_attention() -> dict:
    import torch.nn.functional as F

    from kfserving_tpu_torch.csrc import build
    from kfserving_tpu_torch.ops.paged_attention import (
        _sm_count,
        kernel_path,
        paged_attention_kernel,
        paged_attention_plain,
        split_plan,
    )

    bf16, fp32 = torch.bfloat16, torch.float32
    B, H, D, BS, MB = 8, 12, 64, 128, 32
    # Row 7 has length 0; row 6 is parked past the table (4097); row 0
    # has a -1 tail; rows 2 and 4 share their first block.
    edge = [1, 127, 128, 129, 3021, 4096, 4097, 0]

    def edit(table):
        table[0, 1:] = -1
        table[2, 0] = table[4, 0]

    # The hopper path's tile: one below, at and one above it, around a
    # block, and multiples of the block size.
    tile = split_plan(B, H, D, BS, MB, _sm_count(torch.device("cuda")))
    tt = tile.tile_tokens
    boundary = [tt - 1, tt, tt + 1, BS - 1, BS, BS + 1, 4 * BS, 24 * BS]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    decode = [3021 + 4 * i for i in range(B)]     # the served rows
    cases = [
        paged_case(gen, "edge rows bf16", B, H, D, BS, MB, bf16, edge, edit),
        paged_case(gen, "edge rows fp32", B, H, D, BS, MB, fp32, edge, edit),
        paged_case(gen, "edge rows bf16 D128", B, H, 128, BS, MB, bf16,
                   edge, edit),
        paged_case(gen, PAGED_MAIN_CASE, B, H, D, BS, MB, bf16, decode),
        # One rank's heads of the decode wave under {"tp": 2}.
        paged_case(gen, MESH_DECODE_CASE, B, H // 2, D, BS, MB, bf16,
                   decode),
        paged_case(gen, "edge rows bf16 H6", B, H // 2, D, BS, MB, bf16,
                   edge, edit),
        paged_case(gen, f"tile boundaries bf16 (tile {tt})", B, H, D, BS,
                   MB, bf16, boundary),
        # One row holds all the work: the split must spread it.
        paged_case(gen, PAGED_LONG_ROW_CASE, 1, H, D, BS, MB, bf16, [4096]),
        # The head dims of PR 19: generate_d256's decode (Gemma-2B widths),
        # Phi-2's and GPT-NeoX-20B's heads, a D192 decode, the edge rows
        # at D256 (the other rows bit-equal, as for every case here), and
        # the simple path at D16 and in fp32 at D80, D192 and D256 (three
        # and two 16-byte vectors a lane at the last two).
        paged_case(gen, GEMMA_DECODE_CASE, B, 8, 256, BS, MB, bf16, decode),
        paged_case(gen, "phi2 b8 decode ~3045 bf16 H32 D80", B, 32, 80, BS,
                   MB, bf16, decode),
        paged_case(gen, "neox b8 decode ~3045 bf16 H64 D96", B, 64, 96, BS,
                   MB, bf16, decode),
        paged_case(gen, "b8 decode ~3045 bf16 H12 D192", B, H, 192, BS, MB,
                   bf16, decode),
        paged_case(gen, "edge rows bf16 H8 D256", B, 8, 256, BS, MB, bf16,
                   edge, edit),
        paged_case(gen, "edge rows bf16 H4 D16", B, 4, 16, BS, MB, bf16,
                   edge, edit),
        paged_case(gen, "edge rows fp32 H32 D80", B, 32, 80, BS, MB, fp32,
                   edge, edit),
        paged_case(gen, "edge rows fp32 H12 D192", B, H, 192, BS, MB, fp32,
                   edge, edit),
        paged_case(gen, "edge rows fp32 H8 D256", B, 8, 256, BS, MB, fp32,
                   edge, edit),
    ]
    results = []
    for name, args in cases:
        q, pool_k, pool_v, table, lengths = args
        rows, _, H, d = q.shape
        path = kernel_path(q.dtype, d)
        out = paged_attention_kernel(*args)
        ref = paged_attention_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err, tol, share = agreement(out, ref, PAGED_FP32_TOLERANCE, name)
        zero_rows = (lengths == 0).nonzero().flatten().tolist()
        for r in zero_rows:
            check(bool((out[r] == 0).all()),
                  f"{name}: the zero-length row is not exactly 0")
        if rows > 1:
            # A row's output must not depend on the other rows' lengths
            # (a speculative verify and plain decode give the same tokens
            # only so): row 0's length changes, the rest are bit-equal.
            changed = lengths.clone()
            changed[0] = (int(lengths[0]) + 37) % (MB * BS)
            again = paged_attention_kernel(q, pool_k, pool_v, table,
                                           changed)
            check(torch.equal(again[1:], out[1:]), f"{name}: rows 1-"
                  f"{rows - 1} changed with row 0's length")
        # Yardstick: SDPA over K/V gathered beforehand (the gather is not
        # timed), with a length mask.
        idx = table.long().clamp_min(0)
        k_all = pool_k[idx].reshape(rows, MB * BS, H, d).transpose(1, 2)
        v_all = pool_v[idx].reshape(rows, MB * BS, H, d).transpose(1, 2)
        keys = torch.arange(MB * BS, device="cuda")
        mask = (keys[None, :] < lengths[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        times = time_kernel_case(
            lambda: paged_attention_kernel(*args),
            lambda: paged_attention_plain(*args),
            lambda sdpa=F.scaled_dot_product_attention: sdpa(
                qt, k_all, v_all, attn_mask=mask),
            plain_iters=5)
        # The path that ran, from the profiled device kernels' names.
        if times["device_kernels"]:
            check(any(PAGED_KERNEL_NAMES[path] in k
                      for k in times["device_kernels"]),
                  f"{name}: the {path} path's kernel is not among "
                  f"{times['device_kernels']}")
        bound, bound_by = paged_bound_ms(rows, H, d, BS, MB, q.dtype,
                                         lengths)
        row = {"case": name, "head_dim": d,
               "dtype": str(q.dtype).split(".")[-1], "path": path,
               "max_abs_err": err,
               "tolerance": tol, "share_of_limit": share, **times,
               "bound_ms": bound, "bound_by": bound_by,
               "share_of_bound": bound / times["ms"],
               "library": "scaled_dot_product_attention over K/V "
                          "gathered beforehand (gather not timed)"}
        print("paged_attention " + json.dumps(row), flush=True)
        results.append(row)
        del out, ref, k_all, v_all
    main_row = next(r for r in results if r["case"] == PAGED_MAIN_CASE)
    summary = ("case", "path", "ms", "bound_ms", "bound_by", "plain_ms",
               "library_ms", "max_abs_err")
    mesh = [{k: r[k] for k in summary}
            for r in results if r["case"] == MESH_DECODE_CASE]
    long_row = [{k: r[k] for k in summary}
                for r in results if r["case"] == PAGED_LONG_ROW_CASE]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "kfserving_tpu_torch/csrc/paged_attention.cu",
        "replaces": "kfserving_tpu/ops/paged_attention.py:107",
        "launches": None,  # filled from the generative serving run
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # One tp rank's heads (the mesh phase's shape), and one long row.
        "mesh_cases": mesh,
        "long_row_cases": long_row,
        # The hopper path at the main case: its plan and ptxas's report.
        "hopper_plan": dataclasses.asdict(tile),
        "hopper_ptxas": ptxas_report(
            build.build_logs.get("paged_attention", ""),
            PAGED_KERNEL_NAMES["hopper"]),
        # Head dims 80, 96, 192 and 256 (and the simple path's D16 and
        # fp32 instances): each case with its path, the hopper plan at
        # generate_d256's decode, and the simple path's ptxas report.
        "head_dim_cases": head_dim_cases(results, NEW_HEAD_DIMS + (16,)),
        "gemma_plan": dataclasses.asdict(split_plan(
            B, 8, 256, BS, MB, _sm_count(torch.device("cuda")))),
        "simple_ptxas": ptxas_report(
            build.build_logs.get("paged_attention", ""),
            PAGED_KERNEL_NAMES["simple"]),
    }


# -- phase 3: BERT-base through the port's server ----------------------------
def http_json(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        payload = (body if body is None or isinstance(body, bytes)
                   else json.dumps(body).encode())
        t0 = time.perf_counter()
        conn.request(method, path, body=payload,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        latency_ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    return resp.status, (json.loads(data) if data else None), latency_ms


def http_raw(port: int, method: str, path: str, body=None, headers=None):
    """One request: (status, lower-cased headers, raw body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        payload = (body if body is None or isinstance(body, bytes)
                   else json.dumps(body).encode())
        conn.request(method, path, body=payload, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                data)
    finally:
        conn.close()


def scrape(port: int) -> dict:
    """GET /metrics: {sample name with its labels: value}."""
    status, _, data = http_raw(port, "GET", "/metrics")
    check(status == 200, f"/metrics: HTTP {status}")
    out = {}
    for line in data.decode().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def family_total(samples: dict, family: str) -> float:
    """The sum of a counter's samples over all label sets."""
    return sum(v for k, v in samples.items()
               if k == family or k.startswith(family + "{"))


def stage_window(before: dict, after: dict, batches: int,
                 where: str) -> dict:
    """``kfserving_tpu_engine_stage_ms`` between two scrapes: one
    observation per stage for each engine batch, and each stage's mean
    ms."""
    out = {}
    for stage in STAGES:
        label = f'{{stage="{stage}"}}'
        count, total = (
            after.get(f"kfserving_tpu_engine_stage_ms_{part}{label}", 0)
            - before.get(f"kfserving_tpu_engine_stage_ms_{part}{label}", 0)
            for part in ("count", "sum"))
        check(count == batches, f"{where}: engine_stage_ms has {count} "
              f"{stage} observations for {batches} engine batches")
        out[f"{stage}_ms"] = total / count if count else None
    return out


def request_counts(samples: dict, model: str) -> dict:
    """``kfserving_tpu_request_total`` of one model: {"verb status": n}."""
    out = {}
    for key, value in samples.items():
        if key.startswith("kfserving_tpu_request_total{"):
            labels = dict(re.findall(r'(\w+)="([^"]*)"', key))
            if labels["model"] == model:
                out[f"{labels['verb']} {labels['status']}"] = int(value)
    return out


def check_deadline_and_trace(port: int, path: str, body) -> dict:
    """A request with a 1 ms budget answers 504 and moves
    deadline_exceeded_total; a request with a traceparent leaves, under
    its trace id in /debug/traces, the spans from server.decode through
    batcher.queue to engine.execute."""
    before = family_total(scrape(port),
                          "kfserving_tpu_deadline_exceeded_total")
    status, _, data = http_raw(port, "POST", path, body,
                               {"x-request-timeout-ms": "1"})
    check(status == 504, f"1 ms budget: HTTP {status} {data[:200]!r}")
    after = family_total(scrape(port),
                         "kfserving_tpu_deadline_exceeded_total")
    check(after == before + 1, f"deadline_exceeded_total {before} -> "
          f"{after} for one 504")
    status, headers, data = http_raw(port, "POST", path, body,
                                     {"traceparent": TRACEPARENT})
    check(status == 200 and headers.get("x-request-id") == TRACE_ID,
          f"traced request: HTTP {status} {headers}")
    status, _, data = http_raw(port, "GET",
                               f"/debug/traces?trace_id={TRACE_ID}")
    spans = {sp["name"]: sp for sp in json.loads(data)["spans"]}
    missing = [name for name in SPAN_CHAIN if name not in spans]
    check(status == 200 and not missing,
          f"/debug/traces: spans {missing} missing of {sorted(spans)}")
    starts = [spans[name]["start"] for name in
              ("server.decode", "batcher.queue", "engine.execute")]
    check(starts == sorted(starts), f"span starts out of order {starts}")
    return {"deadline_504": True, "deadline_exceeded_total": after,
            "spans": {name: round(spans[name]["duration_ms"], 3)
                      for name in SPAN_CHAIN},
            "engine_execute": spans["engine.execute"]["attrs"]}


def check_topk(values, indices, length: int, vocab: int, where: str):
    values, indices = np.asarray(values), np.asarray(indices)
    check(values.shape == (length, TOPK) and indices.shape == values.shape,
          f"{where}: top-k shape {values.shape}/{indices.shape}, "
          f"want ({length}, {TOPK})")
    check(bool(np.isfinite(values).all()), f"{where}: non-finite scores")
    check(bool((np.diff(values, axis=-1) <= 0).all()),
          f"{where}: top-k scores not in descending order")
    check(bool(((indices >= 0) & (indices < vocab)).all()),
          f"{where}: token index out of range")


async def drive_server(model, vocab: int, rng) -> dict:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    try:
        status, live, _ = await asyncio.to_thread(
            http_json, port, "GET", "/v2/health/ready")
        check(status == 200 and live == {"ready": True},
              f"server not ready: {status} {live}")
        bodies = {n: rng.integers(1, vocab, size=n).tolist()
                  for n in REQUEST_LENGTHS}

        async def predict(n: int):
            status, resp, latency = await asyncio.to_thread(
                http_json, port, "POST", "/v1/models/bert:predict",
                {"instances": [bodies[n]]})
            check(status == 200, f"V1 len {n}: HTTP {status} {resp}")
            preds = resp["predictions"]
            check(len(preds) == 1, f"V1 len {n}: {len(preds)} predictions")
            # Rows come back padded to the sequence bucket, as from the
            # JAX package's server.
            check_topk(preds[0]["values"], preds[0]["indices"],
                       model.engine.seq_buckets.fit(n), vocab, f"V1 len {n}")
            return latency, preds[0]

        before = await asyncio.to_thread(scrape, port)
        # The main path's run: every count starts at 0 here.
        flash_attention.launches = 0
        executed0 = model.engine.execute_count
        served = {}
        for n in REQUEST_LENGTHS:                 # one at a time
            _, served[n] = await predict(n)
        burst = [n for n in REQUEST_LENGTHS for _ in range(8)]
        sem = asyncio.Semaphore(16)

        async def limited(n):
            async with sem:
                return await predict(n)

        t0 = time.perf_counter()
        done = await asyncio.gather(*(limited(n) for n in burst))
        wall_s = time.perf_counter() - t0
        ids = rng.integers(1, vocab, size=100).tolist()
        status, resp, _ = await asyncio.to_thread(
            http_json, port, "POST", "/v2/models/bert/infer",
            {"inputs": [{"name": "input_ids", "shape": [1, 100],
                         "datatype": "INT32", "data": ids}]})
        check(status == 200, f"V2 infer: HTTP {status} {resp}")
        outputs = {o["name"]: o for o in resp["outputs"]}
        check(set(outputs) == {"values", "indices"},
              f"V2 outputs {sorted(outputs)}")
        bucket = model.engine.seq_buckets.fit(100)
        check(outputs["values"]["shape"] == [1, bucket, TOPK],
              f"V2 shape {outputs['values']['shape']}")
        check_topk(np.reshape(outputs["values"]["data"], (bucket, TOPK)),
                   np.reshape(outputs["indices"]["data"], (bucket, TOPK)),
                   bucket, vocab, "V2")
        launches = flash_attention.launches
        batches = model.engine.execute_count - executed0
        after = await asyncio.to_thread(scrape, port)
        stages = stage_window(before, after, batches, "bert")
        compiles = compile_cache_window(before, after)
        check(compiles == {"hit": batches, "miss": 0},
              f"bert: compile cache {compiles} for {batches} batches of "
              "warmed buckets")
        counts = request_counts(after, "bert")
        want = {"predict 200": len(REQUEST_LENGTHS) + len(burst),
                "infer 200": 1}
        check(counts == want, f"bert: request_total {counts} != {want}")
        request_path = await asyncio.to_thread(
            check_deadline_and_trace, port, "/v1/models/bert:predict",
            {"instances": [bodies[REQUEST_LENGTHS[0]]]})
        await asyncio.to_thread(lint_metrics, port, "bert")
    finally:
        await server.stop_async()
    latencies = sorted(lat for lat, _ in done)
    return {"launches": launches, "batches": batches, "stages": stages,
            "compile_cache": compiles,
            "request_total": counts, "request_path": request_path,
            "requests": len(REQUEST_LENGTHS) + len(burst) + 1,
            "burst_requests": len(burst), "burst_wall_s": wall_s,
            "burst_req_per_s": len(burst) / wall_s,
            "burst_p50_ms": latencies[len(latencies) // 2],
            "served": served, "bodies": bodies}


def check_against_plain(model, ids, served) -> dict:
    """The served top-k for one request against the same weights run
    directly, with the kernel and with the plain attention."""
    from kfserving_tpu_torch.ops.flash_attention import flash_attention_plain

    module, device = model.module, model.device
    n = len(ids)
    bucket = model.engine.seq_buckets.fit(n)
    x = torch.zeros((1, bucket), dtype=torch.int64, device=device)
    x[0, :n] = torch.tensor(ids, device=device)
    mask = torch.zeros((1, bucket), dtype=torch.int32, device=device)
    mask[0, :n] = 1

    def plain(q, k, v, attn_mask):
        lengths = attn_mask.reshape(attn_mask.shape[0], -1,
                                    attn_mask.shape[-1])[:, 0].sum(-1)
        return flash_attention_plain(q, k, v, kv_lengths=lengths)

    with torch.inference_mode():
        kernel_logits = module(x, mask)[0, :n]
        module.config.attn_fn = plain
        try:
            plain_logits = module(x, mask)[0, :n]
        finally:
            module.config.attn_fn = None
    diff = float((kernel_logits - plain_logits).abs().max())
    agree = float((kernel_logits.argmax(-1)
                   == plain_logits.argmax(-1)).float().mean())
    served_top = np.asarray(served["values"])[:n, 0]
    direct_top = kernel_logits.max(-1).values.cpu().numpy()
    served_diff = float(np.abs(served_top - direct_top).max())
    check(math.isfinite(diff) and diff <= MAX_LOGIT_DIFF,
          f"kernel vs plain logits differ by {diff} > {MAX_LOGIT_DIFF}")
    check(agree >= MIN_TOP1_AGREEMENT,
          f"kernel vs plain top-1 agreement {agree} < "
          f"{MIN_TOP1_AGREEMENT}")
    check(served_diff <= MAX_LOGIT_DIFF,
          f"served vs direct top-1 score differ by {served_diff}")
    return {"length": n, "logits_max_abs_diff": diff,
            "top1_agreement": agree,
            "served_vs_direct_top1_max_abs_diff": served_diff}


def time_largest_bucket(model) -> dict:
    """Device time of one forward at the largest bucket (CUDA events),
    and host time of one engine batch there (pad, forward, top-k,
    fetch), outside the server."""
    B, L = max(BATCH_BUCKETS), max(SEQ_BUCKETS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(1, model.module.config.vocab_size, (B, L),
                        generator=gen, device="cuda")
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        forward_ms = cuda_time_ms(lambda: model.module(ids, mask),
                                  iters=5, warmup=1)
    batch = {"input_ids": ids.cpu().numpy(),
             "attention_mask": mask.cpu().numpy()}
    model.engine.predict_sync(batch)
    t0 = time.perf_counter()
    for _ in range(5):
        model.engine.predict_sync(batch)
    engine_ms = (time.perf_counter() - t0) / 5 * 1e3
    flops = model.module.flops(B, L)
    return {"shape": [B, L], "forward_ms": forward_ms,
            "engine_batch_ms": engine_ms,
            "forward_tflops": flops / forward_ms / 1e9}


def compile_cache_window(before: dict, after: dict) -> dict:
    """``kfserving_tpu_compile_cache_total`` between two scrapes."""
    return {outcome: after.get(key, 0) - before.get(key, 0)
            for outcome in ("hit", "miss")
            for key in [f'kfserving_tpu_compile_cache_total'
                        f'{{outcome="{outcome}"}}']}


def _leaves(tree) -> list:
    """(name, tensor) pairs of a tensor or a dict of tensors."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    return [("", tree)]


def _bucket_input(name: str, static: torch.Tensor, gen, vocab: int):
    """A seeded batch shaped and typed as one static input of a graph:
    floats in [0, 1), uint8 pixels, suffix-padding masks, token ids."""
    if static.dtype.is_floating_point:
        return torch.rand(static.shape, generator=gen,
                          device="cuda").to(static.dtype)
    if name == "attention_mask":
        b, s = static.shape
        lengths = torch.randint(1, s + 1, (b, 1), generator=gen,
                                device="cuda")
        return (torch.arange(s, device="cuda")[None]
                < lengths).to(static.dtype)
    low, high = (0, 256) if static.dtype == torch.uint8 else (1, vocab)
    return torch.randint(low, high, static.shape, generator=gen,
                         device="cuda").to(static.dtype)


def check_graphs(model, buckets: int, vocab: int = 1000) -> dict:
    """Every bucket the served engine captured (``buckets`` of them): the
    graph's replay against the model's eager forward on the same seeded
    padded batch, both on the capture thread and the predict stream
    where the graph was captured, ``torch.equal`` per output.  Returns
    the engine's capture ms and pool bytes, and fails naming each bucket
    that differs with its max abs diff."""
    from kfserving_tpu_torch.engine import graphs

    engine = model.engine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def one(program):
        with torch.inference_mode(), torch.cuda.stream(engine._stream):
            batch = {name: _bucket_input(name, t, gen, vocab)
                     for name, t in _leaves(program.inputs)}
            eager = engine._apply(engine.params, batch.get("", batch))
            with engine._replay_lock:
                for name, t in _leaves(program.inputs):
                    t.copy_(batch[name])
                graphs.replay(program.graph, program.launches)
                pairs = list(zip((t for _, t in _leaves(eager)),
                                 (t for _, t in _leaves(program.outputs))))
                equal = all(torch.equal(a, b) for a, b in pairs)
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in pairs)
            torch.cuda.current_stream().synchronize()
        return equal, diff

    results = {}
    for key, program in sorted(engine._programs.items(),
                               key=lambda kv: (kv[0][0], kv[0][1] or 0)):
        equal, diff = graphs.on_capture_thread(one, program)
        name = f"b{key[0]}" + ("" if key[1] is None else f"s{key[1]}")
        results[name] = True if equal else diff
    failed = {k: v for k, v in results.items() if v is not True}
    check(not failed, f"{model.name}: graph replay differs from the eager "
          f"forward at {failed} (bucket: max abs diff)")
    check(len(results) == buckets, f"{model.name}: {len(results)} graphs "
          f"for {buckets} buckets")
    stats = engine.graph_stats()
    return {"buckets_equal": sorted(results), "captures": stats["captures"],
            "capture_ms_total": stats["capture_ms_total"],
            "pool_bytes": stats["pool_bytes"]}


def load_model(name: str, config: dict, device: str = "cuda"):
    from kfserving_tpu_torch.predictors.torch_model import TorchModel

    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(config, f)
        model = TorchModel(name, model_dir, device=device)
        t0 = time.perf_counter()
        model.load()
        return model, time.perf_counter() - t0


BERT_CONFIG = {"architecture": "bert", "seq_buckets": SEQ_BUCKETS,
               "batch_buckets": BATCH_BUCKETS, "max_batch_size": 16,
               "output": "topk", "topk": TOPK}


def serve_bert(card: str) -> dict:
    model, load_s = load_model("bert", BERT_CONFIG)
    cfg = model.module.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads)
          == (12, 768, 12), "not BERT-base")
    rng = np.random.default_rng(0)
    try:
        run = asyncio.run(drive_server(model, cfg.vocab_size, rng))
        check(run["batches"] > 0, "no batch executed")
        check(run["launches"] == cfg.num_layers * run["batches"],
              f"flash kernel launched {run['launches']} times for "
              f"{run['batches']} batches of {cfg.num_layers} layers")
        reference = check_against_plain(model, run["bodies"][100],
                                        run["served"][100])
        stats = model.engine_stats()
        largest = time_largest_bucket(model)
        graph_check = check_graphs(
            model, len(SEQ_BUCKETS) * len(BATCH_BUCKETS), cfg.vocab_size)
    finally:
        model.unload()
    summary = {
        "card": card, "load_and_warmup_s": load_s,
        "graphs": graph_check, "compile_cache": run["compile_cache"],
        "requests": run["requests"], "batches": run["batches"],
        "flash_launches": run["launches"],
        "burst_requests": run["burst_requests"],
        "burst_req_per_s": run["burst_req_per_s"],
        "burst_p50_ms": run["burst_p50_ms"],
        "engine": {k: stats[k] for k in (
            "avg_prepare_ms", "avg_device_ms", "avg_fetch_ms",
            "achieved_tflops", "mfu", "bucket_hits") if k in stats},
        "reference": reference,
        "largest_bucket": largest,
        "engine_stage_means": run["stages"],
        "request_total": run["request_total"],
        "request_path": run["request_path"],
    }
    print("serving " + json.dumps(summary), flush=True)
    return summary


# -- phase 4: generative serving at the generate_4k shape --------------------
def gen_prompt(i: int) -> str:
    """The shared system prompt plus a distinct tail, as
    benchmarks/configs.py builds the generate_4k traffic."""
    system = ("the quick brown fox jumps over the lazy dog. " * 80)
    return (system[:GEN_SYSTEM_LEN] + f" request {i:04d} "
            + "x" * (GEN_TAIL_LEN - 14))


def sse_stream(port: int, path: str, body: dict, headers=None,
               times=None):
    """POST a streaming generate and read its SSE events: (status,
    events, seconds to the first event, seconds to the end).  ``times``,
    when given, collects each event's arrival (perf_counter)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, resp.read(), None, None
        events, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                now = time.perf_counter()
                if first is None:
                    first = now - t0
                if times is not None:
                    times.append(now)
                events.append(json.loads(line[len(b"data: "):]))
        return resp.status, events, first, time.perf_counter() - t0
    finally:
        conn.close()


def stream_tokens(events, where: str, max_tokens: int = GEN_MAX_TOKENS):
    check(bool(events) and events[-1].get("finish_reason") is not None,
          f"{where}: stream ended without a finish_reason")
    count = events[-1]["details"]["token_count"]
    check(count <= max_tokens, f"{where}: {count} tokens > {max_tokens}")
    ids = [e["token"]["id"] for e in events
           if e.get("token") and e["token"]["id"] is not None]
    check(len(ids) == count, f"{where}: {len(ids)} token events for "
          f"token_count {count}")
    return ids


async def drive_generate(model, name: str = "gen4k") -> dict:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
    )
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    path = f"/v2/models/{name}/generate_stream"
    engine = model.engine
    try:
        status, events, _, _ = await asyncio.to_thread(
            sse_stream, port, path,
            {"text_input": gen_prompt(9999), "max_tokens": GEN_MAX_TOKENS})
        check(status == 200, f"warm-up stream: HTTP {status} {events}")
        stream_tokens(events, "warm-up stream")

        scraped = {"before": await asyncio.to_thread(scrape, port)}
        # The main path's run: every count starts at 0 here.
        flash_attention.launches = 0
        paged_attention_kernel.launches = 0
        before = engine.stats()
        sem = asyncio.Semaphore(GEN_CONCURRENCY)

        async def one(i):
            async with sem:
                return await asyncio.to_thread(
                    sse_stream, port, path,
                    {"text_input": gen_prompt(i),
                     "max_tokens": GEN_MAX_TOKENS})

        t0 = time.perf_counter()
        streams = await asyncio.gather(*(one(i)
                                         for i in range(GEN_REQUESTS)))
        wall_s = time.perf_counter() - t0
        scraped["streams"] = await asyncio.to_thread(scrape, port)
        status, v1, _ = await asyncio.to_thread(
            http_json, port, "POST", f"/v1/models/{name}:predict",
            {"instances": [{"prompt": gen_prompt(100), "max_tokens": 8}]})
        check(status == 200, f"V1 predict: HTTP {status} {v1}")
        pred = v1["predictions"][0]
        check(pred["finish_reason"] in ("length", "eos")
              and pred["token_count"] <= 8, f"V1 predict: {pred}")
        status, v2, _ = await asyncio.to_thread(
            http_json, port, "POST", f"/v2/models/{name}/generate",
            {"text_input": gen_prompt(101), "parameters": {"max_tokens": 8}})
        check(status == 200, f"V2 generate: HTTP {status} {v2}")
        check(v2["details"]["token_count"] <= 8
              and v2["model_name"] == name, f"V2 generate: {v2}")
        after = engine.stats()
        launches = {"flash_attention": flash_attention.launches,
                    "paged_attention": paged_attention_kernel.launches}
        # A stream whose budget runs out ends "timeout" and frees its
        # slot (the idle check below finds its blocks released too).
        status, events, _, timeout_s = await asyncio.to_thread(
            sse_stream, port, path,
            {"text_input": "hello", "max_tokens": GEN_TIMEOUT_TOKENS},
            {"x-request-timeout-ms": str(GEN_TIMEOUT_MS)})
        check(status == 200 and events
              and events[-1].get("finish_reason") == "timeout"
              and events[-1]["details"]["token_count"]
              < GEN_TIMEOUT_TOKENS,
              f"budgeted stream: HTTP {status} ended "
              f"{events[-1] if events else events}")
        timed_out = {"budget_ms": GEN_TIMEOUT_MS, "stream_s": timeout_s,
                     "tokens": events[-1]["details"]["token_count"]}
        idle = None
        for _ in range(200):
            paged = engine.stats()["paged"]
            if (paged["free_blocks"] + paged["reclaimable_blocks"]
                    == paged["pool_blocks"]
                    and all(slot is None for slot in engine._slots)):
                idle = paged
                break
            await asyncio.sleep(0.05)
        check(idle is not None, f"slots or blocks not all free when idle: "
              f"{engine.stats()['paged']}")
        scraped["end"] = await asyncio.to_thread(scrape, port)
        await asyncio.to_thread(lint_metrics, port, name)
    finally:
        await server.stop_async()
    tokens = []
    for i, (status, events, _, _) in enumerate(streams):
        check(status == 200, f"stream {i}: HTTP {status} {events}")
        tokens.append(stream_tokens(events, f"stream {i}"))
    ttfts = sorted(first for _, _, first, _ in streams)
    generated = sum(len(t) for t in tokens)
    ttft = "kfserving_tpu_llm_ttft_ms_count"
    ttfts_counted = (scraped["streams"].get(ttft, 0)
                     - scraped["before"].get(ttft, 0))
    check(ttfts_counted == GEN_REQUESTS, f"llm_ttft_ms counted "
          f"{ttfts_counted} first tokens for {GEN_REQUESTS} streams")
    counts = request_counts(scraped["end"], name)
    want = {"generate_stream 200": GEN_REQUESTS + 2, "predict 200": 1,
            "generate 200": 1}
    check(counts == want, f"{name}: request_total {counts} != {want}")
    return {"launches": launches, "before": before, "after": after,
            "ttft_count": ttfts_counted, "request_total": counts,
            "timed_out_stream": timed_out,
            "tokens": tokens, "generated": generated, "wall_s": wall_s,
            "tokens_per_s": generated / wall_s,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
            "ttft_max_ms": ttfts[-1] * 1e3, "idle_paged": idle}


def check_generation_against_plain(model, prompt: str, served) -> dict:
    """One served stream against a teacher-forced full forward of the
    same weights with the plain attention: the top-1 at each generated
    position, and the served token's logit against the maximum."""
    from kfserving_tpu_torch.ops.attention import _torch_attention

    module = model.module
    prompt_ids = model.tokenizer.encode(prompt)
    ids = torch.tensor([prompt_ids + served[:-1]], device=model.device)
    with torch.inference_mode():
        module.config.attn_fn = _torch_attention
        try:
            logits = module(ids)[0, len(prompt_ids) - 1:]
        finally:
            module.config.attn_fn = None
    served_t = torch.tensor(served, device=model.device)
    top = logits.max(dim=-1).values
    gap = top - logits.gather(-1, served_t[:, None])[:, 0]
    agree = float((logits.argmax(dim=-1) == served_t).float().mean())
    max_gap = float(gap.max())
    check(agree >= MIN_TOP1_AGREEMENT,
          f"served vs plain top-1 agreement {agree} < {MIN_TOP1_AGREEMENT}")
    check(math.isfinite(max_gap) and max_gap <= MAX_LOGIT_DIFF,
          f"served token's logit {max_gap} under the plain maximum")
    return {"positions": len(served), "top1_agreement": agree,
            "max_served_logit_gap": max_gap}


def host_syncs(fn) -> list:
    """The host<->card synchronisations ``fn`` makes, as reported by
    torch.cuda.set_sync_debug_mode("warn")."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # The debug mode's own notice also says "synchronizing"; a sync
    # reads "called a synchronizing CUDA operation".
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def wave_state(engine):
    """The served streams' decode state, outside the server: 8 rows of
    ~3045 tokens sharing a 23-block prefix (a seeded block table, feed
    tokens and positions)."""
    S, BS, MB = engine.max_slots, engine.block_size, engine.blocks_per_slot
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    lengths = [3021 + 4 * i for i in range(S)]
    blocks = torch.randperm(engine.num_blocks, generator=gen,
                            device="cuda").to(torch.int32)
    shared = (GEN_SYSTEM_LEN + 1) // BS
    table = torch.full((S, MB), -1, dtype=torch.int32, device="cuda")
    table[:, :shared] = blocks[:shared]
    table[:, shared:shared + 2] = blocks[shared:shared + 2 * S].reshape(S, 2)
    tokens = torch.randint(0, 258, (S,), generator=gen, device="cuda",
                           dtype=torch.int32)
    positions = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return table, tokens, positions


def check_wave_graphs(model, state=None) -> dict:
    """One greedy and one seeded decode wave (temperature 0.8, top-k 40,
    top-p 0.9): each variant's graph replayed against the same wave run
    eagerly from the same state (``state(engine)``, by default
    ``wave_state``), on the engine's enqueue thread and stream; the
    tokens and the feed written back must be equal (a wave's cache
    writes are the same both times).  A variant not captured by the
    serving run is captured here (its first wave runs eagerly before the
    capture, as in serving)."""
    from kfserving_tpu_torch.engine import graphs
    from kfserving_tpu_torch.engine.generator import _Request

    engine = model.engine
    S = engine.max_slots
    table, tokens, positions = (state or wave_state)(engine)
    table_h = table.cpu().numpy()
    rows = {"greedy": [None] * S,
            "seeded": [_Request(np.zeros(1, np.int32), 1, 0.8, top_k=40,
                                top_p=0.9, seed=100 + i)
                       for i in range(S)]}

    def run(kind):
        arrays, flags = engine._sampling_arrays(rows[kind], S)
        key = engine._wave_key(flags)
        feed = (engine._feed_tokens[:S], engine._feed_positions[:S])
        with torch.inference_mode(), engine._device_scope():
            def reset():
                feed[0].copy_(tokens)
                feed[1].copy_(positions)

            p = engine._stage_wave(table_h, arrays, flags)
            if key not in engine._programs:
                reset()
                engine._compile_program(key, lambda: engine._wave(p))
            reset()
            eager = [t.clone() for t in engine._wave(p)]
            fed = [t.clone() for t in feed]
            reset()
            graph, outputs, tally = engine._programs[key]
            graphs.replay(graph, tally)
            equal = (all(torch.equal(a, b) for a, b in zip(eager, outputs))
                     and all(torch.equal(a, b) for a, b in zip(fed, feed)))
            torch.cuda.current_stream().synchronize()
        return key, equal, eager[0].cpu().tolist()

    out = {}
    for kind in rows:
        key, equal, wave_tokens = engine._enqueue_executor.submit(
            run, kind).result()
        check(equal, f"{kind} decode wave {key}: graph replay differs from "
              f"the eager wave")
        out[kind] = {"variant": list(key), "equal": equal,
                     "row0_tokens": wave_tokens[0]}
    check(out["greedy"]["row0_tokens"] != out["seeded"]["row0_tokens"],
          "the seeded wave drew the greedy tokens")
    out["graph_stats"] = engine.graph_stats()
    return out


def time_generate_device(model) -> dict:
    """CUDA-event times, outside the server, at the served shapes: one
    16-step decode wave (the engine's own device program; 8 rows of
    ~3045 tokens sharing a 23-block prefix, as the served streams do),
    K2 at that wave's shape, and one b8x4096 prefill (forward + pool
    insert).  Also the wave's summed kernel time and its kernel launches
    from torch.profiler, and a check that the wave never synchronises
    the host with the card (torch.cuda.set_sync_debug_mode)."""
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
        paged_insert,
    )

    from kfserving_tpu_torch.engine import graphs

    engine, module = model.engine, model.module
    cfg = module.config
    S, BS = engine.max_slots, engine.block_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    table, tokens, positions = wave_state(engine)
    greedy = engine._sampling([None] * S, S)

    def wave():
        with torch.inference_mode():
            engine._decode_steps(table, tokens, positions, greedy)

    wave_ms = cuda_time_ms(wave, iters=5, warmup=2)
    check(bool(host_syncs(lambda: torch.ones(1, device="cuda").sum().item())),
          "sync debug mode did not report the .item() of its control")
    syncs = host_syncs(wave)
    check(not syncs, f"the decode wave synchronised: {syncs[:1]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave()
    torch.cuda.synchronize()
    wave_host_ms = (time.perf_counter() - t0) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wave()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launch_events = [e for e in events
                     if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx")]
    launches = sum(e.count for e in launch_events)
    launch_cpu_us = sum(e.self_cpu_time_total for e in launch_events)
    busy_ms, device_events, busy_timing = profiled_device_ms(wave, iters=1)
    # Where the profiler saw no device event, K2's share of the wave is
    # not measured.
    k2_ms_profiled = (sum(e.self_device_time_total for e in device_events
                          if "paged_" in e.key) / 1e3
                      if device_events else None)
    q = torch.randn((S, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda", dtype=cfg.dtype)
    pool_k, pool_v = engine._caches[0]
    k2_ms = profiled_device_ms(lambda: paged_attention_kernel(
        q, pool_k, pool_v, table, positions + 1))[0]
    steps = engine.steps_per_call
    prefill_lengths = torch.tensor([3021] * S, dtype=torch.int32,
                                   device="cuda")
    ids = torch.randint(0, 258, (S, 4096), generator=gen, device="cuda")
    dest = torch.full((S, 4096 // BS), -1, dtype=torch.int64, device="cuda")

    def prefill():
        with torch.inference_mode():
            _, caches = module(ids, kv_lengths=prefill_lengths,
                               return_cache=True,
                               logit_positions=prefill_lengths - 1)
            for (pk, pv), (k, v) in zip(engine._caches, caches):
                paged_insert(pk, pv, k, v, dest)

    prefill_ms = cuda_time_ms(prefill, iters=3, warmup=1)

    # The served wave: the greedy variant's graph, replayed on the
    # engine's stream from the same state (its feed written back each
    # time, so each replay starts where the last ended).
    arrays, flags = engine._sampling_arrays([None] * S, S)
    graph, outputs, tally = engine._programs[engine._wave_key(flags)]

    def graph_wave():
        graphs.replay(graph, tally)

    table_h = table.cpu().numpy()
    with torch.inference_mode(), engine._device_scope():
        engine._stage_wave(table_h, arrays, flags)
        engine._feed_tokens[:S].copy_(tokens)
        engine._feed_positions[:S].copy_(positions)
        graph_wave_ms = cuda_time_ms(graph_wave, iters=3, warmup=1)
        graph_busy_ms, _, graph_busy_timing = profiled_device_ms(
            graph_wave, iters=1)
        graph_host_us = host_us_per_call(graph_wave, iters=3)

        def enqueue():
            engine._start_fetch(engine._run_wave(table_h, arrays, flags))

        replay_syncs = host_syncs(enqueue)
        torch.cuda.synchronize()
    check(not replay_syncs, f"the graph wave's enqueue synchronised: "
          f"{replay_syncs[:1]}")
    return {
        "graph_wave_ms": graph_wave_ms, "graph_wave_busy_ms": graph_busy_ms,
        "graph_wave_busy_timing": graph_busy_timing,
        "graph_wave_idle_share": max(0.0, 1 - graph_busy_ms / graph_wave_ms),
        "graph_wave_host_issue_us": graph_host_us,
        "graph_wave_host_syncs": len(replay_syncs),
        "wave_steps": steps, "wave_ms": wave_ms,
        "wave_host_ms": wave_host_ms,
        "wave_kernel_busy_ms": busy_ms, "wave_busy_timing": busy_timing,
        "wave_k2_ms": k2_ms_profiled,
        "wave_kernel_launches": launches,
        "launch_cpu_us_mean": launch_cpu_us / launches if launches else None,
        "wave_host_syncs": len(syncs),
        "k2_ms_at_wave_shape": k2_ms,
        "k2_share_of_wave_busy": (k2_ms_profiled / busy_ms
                                  if device_events else None),
        "k2_share_of_wave": (k2_ms_profiled / wave_ms
                             if device_events else None),
        "prefill_b8x4096_ms": prefill_ms,
    }


def serve_generate(card: str, name: str = "gen4k",
                   config: dict = GEN_CONFIG,
                   widths: tuple = (12, 768, 12, 4096)) -> dict:
    """A decoder at ``config`` served over HTTP with generate_4k's serving
    settings and traffic; ``widths`` is (layers, hidden, heads, max_seq)."""
    model, load_s = load_generative(name, config)
    cfg = model.module.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.max_seq)
          == widths, f"{name}: not the decoder of {widths}")
    try:
        run = asyncio.run(drive_generate(model, name))
        before, after = run["before"], run["after"]
        waves = after["decode_steps"] - before["decode_steps"]
        prefills = after["prefills"] - before["prefills"]
        want_k2 = cfg.num_layers * waves * after["steps_per_call"]
        got = run["launches"]
        check(waves > 0 and got["paged_attention"] == want_k2,
              f"paged kernel launched {got['paged_attention']} times for "
              f"{waves} waves x {after['steps_per_call']} steps x "
              f"{cfg.num_layers} layers")
        check(prefills > 0
              and got["flash_attention"] == cfg.num_layers * prefills,
              f"flash kernel launched {got['flash_attention']} times for "
              f"{prefills} prefills")
        hits = (after["paged"]["prefix_hits"]
                - before["paged"]["prefix_hits"])
        check(hits > 0, "no prefix-cache hit over the shared prompt")
        reference = check_generation_against_plain(
            model, gen_prompt(0), run["tokens"][0])
        wave_graphs = check_wave_graphs(model)
        device = time_generate_device(model)
    finally:
        model.unload()
    summary = {
        "card": card, "load_s": load_s, "requests": GEN_REQUESTS,
        "widths": {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                   "heads": cfg.num_heads, "head_dim": cfg.head_dim,
                   "vocab": cfg.vocab_size,
                   "intermediate": cfg.intermediate_size},
        "concurrency": GEN_CONCURRENCY,
        "generated_tokens": run["generated"], "wall_s": run["wall_s"],
        "tokens_per_s": run["tokens_per_s"],
        "ttft_p50_ms": run["ttft_p50_ms"], "ttft_max_ms": run["ttft_max_ms"],
        "decode_waves": waves, "prefills": prefills, "prefix_hits": hits,
        "launches": run["launches"],
        "engine": {k: after[k] for k in (
            "decode_device_s", "decode_wait_s", "prefill_device_s",
            "slot_occupancy", "goodput_ratio", "depth_effective",
            "suppressed_waves") if k in after},
        "idle_pool": run["idle_paged"],
        "ttft_count": run["ttft_count"],
        "request_total": run["request_total"],
        "timed_out_stream": run["timed_out_stream"],
        "reference": reference, "device": device, "graphs": wave_graphs,
    }
    print(("generate " if name == "gen4k" else f"{name} ")
          + json.dumps(summary), flush=True)
    return summary


# -- phase 4a: the observability layer over generate_4k ----------------------
# The on arm's settings: the sanitizer armed (its stall threshold above
# the profiler capture's stop, which parses the window's CUDA events on
# the loop's thread), a 0.5 s history tick, one declared objective far
# above a stream's latency (no breach: the only incident is the probe's),
# incidents spooled to a temporary directory.  The off arm turns history,
# incidents and the sanitizer off.
OBSERVE_ON = {"KFS_SANITIZE": "1", "KFS_SANITIZE_STALL_MS": "2000",
              "KFS_HISTORY": "1", "KFS_HISTORY_TICK_S": "0.5",
              "KFS_INCIDENTS": "1", "KFS_INCIDENT_TICK_S": "0.2",
              "KFS_SLO_OBJECTIVES": json.dumps(
                  {"gen4k": {"latency_ms": 60000, "target": 0.99}})}
OBSERVE_OFF = {"KFS_HISTORY": "0", "KFS_INCIDENTS": "0"}
OBSERVE_CAPTURE_S = 2.0
# The capture starts this long before the streams, so their prefills
# (K1, eager) land inside its window.
OBSERVE_LEAD_S = 0.5
# Attributed device ms summed over the requests against the engine's
# prefill + decode device seconds over the same window.
ATTRIBUTION_RTOL = 0.01


def set_env(values: dict, unset=()) -> None:
    for key in unset:
        os.environ.pop(key, None)
    os.environ.update(values)


async def observe_streams(port: int, prefix: str) -> dict:
    """16 SSE streams at concurrency 8, request i traced as
    ``<prefix>-i``: (tokens per stream, wall seconds)."""
    path = "/v2/models/gen4k/generate_stream"
    sem = asyncio.Semaphore(GEN_CONCURRENCY)

    async def one(i):
        async with sem:
            return await asyncio.to_thread(
                sse_stream, port, path,
                {"text_input": gen_prompt(i), "max_tokens": GEN_MAX_TOKENS},
                {"x-request-id": f"{prefix}-{i}"})

    t0 = time.perf_counter()
    streams = await asyncio.gather(*(one(i) for i in range(GEN_REQUESTS)))
    wall_s = time.perf_counter() - t0
    tokens = []
    for i, (status, events, _, _) in enumerate(streams):
        check(status == 200, f"observe {prefix}-{i}: HTTP {status} {events}")
        tokens.append(stream_tokens(events, f"observe {prefix}-{i}"))
    return {"tokens": tokens, "wall_s": wall_s,
            "tokens_per_s": sum(len(t) for t in tokens) / wall_s}


async def wait_idle(engine) -> None:
    """Until no slot is live and the scheduler loop has returned (it
    returns 1 s after its last work): a wave still in flight is fetched
    and counted, and the next submit starts a fresh loop, which reads the
    sanitizer setting anew."""
    for _ in range(200):
        task = engine._loop_task
        if all(s is None for s in engine._slots) and (
                task is None or task.done()):
            return
        await asyncio.sleep(0.05)
    check(False, "the generator did not go idle")


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def module_logits(module, x: np.ndarray) -> np.ndarray:
    """The harness's reference for a served answer: ``module`` called
    directly on the card, its fp32 logits on the host."""
    with torch.inference_mode():
        return module(torch.from_numpy(x).to("cuda")).float().cpu().numpy()


def kernel_events(trace_path: str) -> dict:
    """The capture's Chrome trace: device kernel events of K1, of K2 and
    of any kernel, and the host's graph launches."""
    with open(trace_path) as f:
        trace = json.load(f)
    out = {"flash_attention": 0, "paged_attention": 0, "kernels": 0,
           "graph_launches": 0}
    for event in trace.get("traceEvents", []):
        name, cat = str(event.get("name", "")), event.get("cat")
        if cat == "kernel":
            out["kernels"] += 1
            if "flash_fwd" in name:
                out["flash_attention"] += 1
            elif "paged_" in name:
                out["paged_attention"] += 1
        elif "cudaGraphLaunch" in name:
            out["graph_launches"] += 1
    return out


async def observe_window(model, trace_dir: str) -> dict:
    """The on arm: a profiler capture across 16 traced streams, then the
    timeline, attribution, sanitizer, history, SLO and flight-recorder
    checks on the same server."""
    from kfserving_tpu_torch.observability.profiling import TIMELINE
    from kfserving_tpu_torch.reliability import sanitizer
    from kfserving_tpu_torch.server.app import ModelServer

    engine, cfg = model.engine, model.module.config
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    try:
        warm = await asyncio.to_thread(
            sse_stream, port, "/v2/models/gen4k/generate_stream",
            {"text_input": gen_prompt(9999), "max_tokens": GEN_MAX_TOKENS},
            {"x-request-id": "observe-warm"})
        check(warm[0] == 200, f"observe warm-up: HTTP {warm[0]}")
        await wait_idle(engine)
        TIMELINE.clear()
        reset_launches()
        window_t0 = time.time()
        before = engine.stats()
        scraped = {"before": await asyncio.to_thread(scrape, port)}
        capture = asyncio.ensure_future(asyncio.to_thread(
            http_json, port, "POST", "/debug/profile/capture",
            {"duration_s": OBSERVE_CAPTURE_S, "log_dir": trace_dir}))
        await asyncio.sleep(OBSERVE_LEAD_S)
        run = await observe_streams(port, "observe")
        status, captured, capture_ms = await capture
        check(status == 200 and captured["captured"],
              f"profile capture: HTTP {status} {captured}")
        await wait_idle(engine)
        after = engine.stats()
        launches = read_launches()
        scraped["after"] = await asyncio.to_thread(scrape, port)
        status, trace, _ = await asyncio.to_thread(
            http_json, port, "GET", "/debug/profile")
        check(status == 200 and "traceEvents" in trace,
              f"/debug/profile: HTTP {status}")
        # The attribution ring is the process's: earlier phases' records
        # are older than the window.
        status, cache, _ = await asyncio.to_thread(
            http_json, port, "GET",
            f"/debug/cache?top_cost={2 * GEN_REQUESTS}&cost_window_s="
            f"{time.time() - window_t0 + 1.0:.3f}")
        check(status == 200, f"/debug/cache?top_cost: HTTP {status}")
        status, ready, _ = await asyncio.to_thread(
            http_json, port, "GET", "/v2/health/ready")
        check(status == 200 and "sanitizer" in ready,
              f"ready probe: HTTP {status} {ready}")
        # The probe: an implicit device-to-host read under the guard, on
        # the server's loop thread.
        probe = torch.ones(4, device="cuda")
        raised = False
        try:
            with sanitizer.loop_guard("chip_smoke", "cuda"):
                # kfslint: disable=host-sync the deliberate violation the
                # sanitizer's probe must catch
                probe.sum().item()
        except sanitizer.ForbiddenTransfer:
            raised = True
        check(raised, ".item() on a CUDA tensor under loop_guard did not "
              "raise")
        incidents = None
        for _ in range(100):
            status, incidents, _ = await asyncio.to_thread(
                http_json, port, "GET", "/debug/incidents")
            if any(i["trigger_counts"].get("sanitizer")
                   for i in incidents["incidents"]):
                break
            await asyncio.sleep(0.1)
        opened = [i for i in incidents["incidents"]
                  if i["trigger_counts"].get("sanitizer")]
        check(len(opened) == 1, f"the sanitizer pin opened "
              f"{len(opened)} incidents: {incidents}")
        status, record, _ = await asyncio.to_thread(
            http_json, port, "GET", f"/debug/incidents?id={opened[0]['id']}")
        check(status == 200 and record["trigger_counts"] == {"sanitizer": 1}
              and record["root_cause"] == "recompile_host_sync",
              f"incident record: HTTP {status} {record}")
        after_probe = sanitizer.status()
        status, index, _ = await asyncio.to_thread(
            http_json, port, "GET", "/debug/history?index=1")
        status2, series, _ = await asyncio.to_thread(
            http_json, port, "GET",
            "/debug/history?series=kfserving_tpu_request_total&window_s=120")
        status3, slo, _ = await asyncio.to_thread(
            http_json, port, "GET", "/v2/health/slo?refresh=1")
        status4, pinned, _ = await asyncio.to_thread(
            http_json, port, "GET", "/debug/flightrecorder?pinned=1")
        check((status, status2, status3, status4) == (200,) * 4,
              f"history/slo/flightrecorder: {status} {status2} {status3} "
              f"{status4}")
        scraped["end"] = await asyncio.to_thread(scrape, port)
    finally:
        await server.stop_async()
    waves = after["decode_steps"] - before["decode_steps"]
    prefills = after["prefills"] - before["prefills"]
    check(launches["paged_attention"]
          == cfg.num_layers * waves * after["steps_per_call"]
          and launches["flash_attention"] == cfg.num_layers * prefills,
          f"observe launches {launches} for {waves} waves and {prefills} "
          "prefills")

    # 1. The capture names K1 (the eager prefill); K2 runs in graphs.
    kernels = await asyncio.to_thread(kernel_events, captured["trace"])
    check(kernels["flash_attention"] > 0, f"the profiler capture names no "
          f"flash attention kernel: {kernels}")
    # 2. The timeline over the window.
    ids = {f"observe-{i}" for i in range(GEN_REQUESTS)}
    device = [e for e in trace["traceEvents"]
              if e.get("cat") == "device"]
    decode_events = sum(1 for e in device if e["name"] == "decode.wave")
    prefill_events = sum(1 for e in device if e["name"] == "prefill.bucket")
    check(decode_events == waves and prefill_events == prefills,
          f"timeline: {decode_events} decode.wave and {prefill_events} "
          f"prefill.bucket events for {waves} waves and {prefills} "
          "prefills")
    slot_ids = {e["args"].get("trace_id") for e in trace["traceEvents"]
                if e.get("cat") == "slot"}
    check(slot_ids and slot_ids <= ids, f"slot events of other requests: "
          f"{sorted(str(i) for i in slot_ids - ids)}")
    # 3. Attribution: one record per request, summing to device time.
    records = {r["trace_id"]: r for r in cache["top_cost"]["by_device_ms"]
               if r["trace_id"] in ids}
    check(len(records) == GEN_REQUESTS, f"{len(records)} cost records for "
          f"{GEN_REQUESTS} requests")
    attributed_ms = sum(r["device_ms"]["prefill"] + r["device_ms"]["decode"]
                        for r in records.values())
    engine_ms = 1e3 * sum(after[k] - before[k] for k in (
        "prefill_device_s", "decode_device_s"))
    check(abs(attributed_ms - engine_ms) <= ATTRIBUTION_RTOL * engine_ms,
          f"attributed {attributed_ms:.3f} ms against the engine's "
          f"{engine_ms:.3f} ms")
    for phase in ("prefill", "decode"):
        key = f'kfserving_tpu_request_device_ms_count{{model="gen4k",' \
              f'phase="{phase}"}}'
        moved = scraped["after"].get(key, 0) - scraped["before"].get(key, 0)
        check(moved == GEN_REQUESTS, f"request_device_ms {phase}: {moved} "
              f"observations for {GEN_REQUESTS} requests")
    # 4. The sanitizer: clean run, then the probe's one violation.
    block = ready["sanitizer"]
    check(block["enabled"] and block["watchdog"]
          and block["guard"]["arms"] >= 1 and block["violations"] == {},
          f"sanitizer after the clean run: {block}")
    check(after_probe["violations"] == {"forbidden_transfer": 1},
          f"sanitizer after the probe: {after_probe}")
    reasons = [e["pinned"] for e in pinned["pinned"]]
    check("sanitizer_forbidden_transfer" in reasons,
          f"pinned entries {reasons}")
    # 5. History and the SLO report.
    names = {s["name"] for s in index["series"]}
    for family in ("kfserving_tpu_request_total",
                   "kfserving_tpu_request_latency_ms_p99",
                   "kfserving_tpu_llm_ttft_ms_p99",
                   "kfserving_tpu_generator_prefix_lookups_total"):
        check(family in names, f"/debug/history index lacks {family}")
    points = max((len(s["frames"]) for s in series["series"]), default=0)
    check(points >= 2, f"request_total history: {points} points")
    check("gen4k" in slo["models"] and slo["models"]["gen4k"]["objective"][
        "latency_ms"] == 60000, f"SLO report: {slo}")
    return {"tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
            "tokens": run["tokens"], "waves": waves, "prefills": prefills,
            "launches": launches, "capture": kernels,
            "capture_request_ms": capture_ms,
            "capture_bytes": os.path.getsize(captured["trace"]),
            "timeline_events": len(trace["traceEvents"]),
            "timeline_events_per_s": len(trace["traceEvents"])
            / (run["wall_s"] + OBSERVE_LEAD_S),
            "attributed_ms": attributed_ms, "engine_device_ms": engine_ms,
            "sanitizer": after_probe, "incident": opened[0]["id"],
            "history_series": len(index["series"]),
            "request_total_points": points,
            "recorded_pins": reasons}


async def observe_rep(model, arm: str) -> dict:
    """One timed rep on a fresh server under ``arm``'s settings."""
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    try:
        await wait_idle(model.engine)
        reset_launches()
        run = await observe_streams(server.http_port, f"{arm}-rep")
        await wait_idle(model.engine)
        return {"tokens_per_s": run["tokens_per_s"],
                "launches": read_launches(),
                "history": server.history is not None,
                "incidents": server.incidents is not None}
    finally:
        await server.stop_async()


def serve_observe(card: str) -> dict:
    """The generate_4k configuration with the observability layer on:
    the capture, timeline, attribution, sanitizer, history, SLO and
    flight-recorder checks, then the layer's cost as tokens/s on against
    off, two interleaved reps of each."""
    from kfserving_tpu_torch.reliability import sanitizer

    keys = set(OBSERVE_ON) | set(OBSERVE_OFF) | {"KFS_INCIDENT_SPOOL_DIR"}
    saved = {k: os.environ.get(k) for k in keys}
    trace_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-profile-")
    spool = tempfile.mkdtemp(prefix="kfs-chip-smoke-incidents-")
    try:
        set_env(dict(OBSERVE_ON, KFS_INCIDENT_SPOOL_DIR=spool))
        sanitizer.reset()
        model, load_s = load_generative("gen4k", GEN_CONFIG)
        try:
            window = asyncio.run(observe_window(model, trace_dir))
            spooled = sorted(os.listdir(spool))
            check(f"{window['incident']}.json" in spooled,
                  f"incident spool holds {spooled}")
            reps = []
            for arm in ("off", "on", "on", "off"):
                if arm == "on":
                    set_env(dict(OBSERVE_ON, KFS_INCIDENT_SPOOL_DIR=spool))
                else:
                    set_env(OBSERVE_OFF, unset=("KFS_SANITIZE",))
                rep = asyncio.run(observe_rep(model, arm))
                check(rep["history"] == rep["incidents"] == (arm == "on"),
                      f"observe {arm} rep: {rep}")
                reps.append((arm, rep))
        finally:
            model.unload()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        sanitizer.reset()
        shutil.rmtree(trace_dir, ignore_errors=True)
        shutil.rmtree(spool, ignore_errors=True)
    launches = dict(window["launches"])
    for _arm, rep in reps:
        for k, v in rep["launches"].items():
            launches[k] += v
    summary = {
        "card": card, "load_s": load_s,
        "tokens_per_s": {arm: [r["tokens_per_s"] for a, r in reps
                               if a == arm] for arm in ("on", "off")},
        "window": {k: v for k, v in window.items() if k != "tokens"},
        "launches": launches,
    }
    print("observe " + json.dumps(summary), flush=True)
    return summary


# -- phase 4b-4e: the generator's other modes and the tiny models -------------
def load_generative(name: str, config: dict, device: str = "cuda",
                    **extra):
    """A GenerativeModel of ``config`` (plus ``extra`` keys) on the card,
    loaded from a temporary directory: (model, load seconds)."""
    from kfserving_tpu_torch.predictors.llm import GenerativeModel

    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(dict(config, **extra), f)
        model = GenerativeModel(name, model_dir, device=device)
        t0 = time.perf_counter()
        model.load()
        return model, time.perf_counter() - t0


def reset_launches() -> None:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
    )

    flash_attention.launches = 0
    paged_attention_kernel.launches = 0


def read_launches() -> dict:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
    )

    return {"flash_attention": flash_attention.launches,
            "paged_attention": paged_attention_kernel.launches}


def gaps_ms(times) -> list:
    return [(b - a) * 1e3 for a, b in zip(times, times[1:])]


def gap_summary(gaps) -> dict:
    if not gaps:
        return {"n": 0}
    return {"n": len(gaps), "p50_ms": percentile(gaps, 0.5),
            "p99_ms": percentile(gaps, 0.99), "max_ms": max(gaps)}


def on_enqueue_thread(engine, fn):
    """Run ``fn()`` on the engine's enqueue thread, in inference mode on
    the engine's stream, and synchronise that stream."""
    def run():
        with torch.inference_mode(), engine._device_scope():
            out = fn()
            torch.cuda.current_stream().synchronize()
            return out

    return engine._enqueue_executor.submit(run).result()


def graph_equal(engine, key, eager_fn) -> bool:
    """Program ``key``'s graph against the same program run eagerly over
    the same static inputs (staged by the caller): outputs equal."""
    from kfserving_tpu_torch.engine import graphs

    eager = [t.clone() for t in eager_fn()]
    graph, outputs, tally = engine._programs[key]
    graphs.replay(graph, tally)
    return all(torch.equal(a, b) for a, b in zip(eager, outputs))


def dense_prompt(i: int) -> str:
    text = ("the quick brown fox jumps over the lazy dog. " * 12)
    return (f"request {i:04d} " + text)[:DENSE_PROMPT_LENS[i % 4]]


def dense_wave_state(engine):
    """8 dense rows at positions 300-328, random feed tokens; no table."""
    S = engine.max_slots
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, 258, (S,), generator=gen, device="cuda",
                           dtype=torch.int32)
    positions = torch.tensor([300 + 4 * i for i in range(S)],
                             dtype=torch.int32, device="cuda")
    table = torch.zeros((S, 0), dtype=torch.int32, device="cuda")
    return table, tokens, positions


async def drive_dense(model) -> dict:
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    path = "/v2/models/generate/generate_stream"
    engine = model.engine
    try:
        for i in (9998, 9999):   # one prompt in each bucket
            status, events, _, _ = await asyncio.to_thread(
                sse_stream, port, path, {"text_input": dense_prompt(i),
                                         "max_tokens": 8})
            check(status == 200, f"dense warm-up: HTTP {status} {events}")
        before = engine.stats()
        sem = asyncio.Semaphore(DENSE_CONCURRENCY)

        async def one(i):
            async with sem:
                return await asyncio.to_thread(
                    sse_stream, port, path,
                    {"text_input": dense_prompt(i),
                     "max_tokens": DENSE_MAX_TOKENS})

        # The main path's run: every count starts at 0 here.
        reset_launches()
        t0 = time.perf_counter()
        streams = await asyncio.gather(*(one(i)
                                         for i in range(DENSE_REQUESTS)))
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        after = engine.stats()
    finally:
        await server.stop_async()
    tokens = []
    for i, (status, events, _, _) in enumerate(streams):
        check(status == 200, f"dense stream {i}: HTTP {status} {events}")
        tokens.append(stream_tokens(events, f"dense stream {i}",
                                    DENSE_MAX_TOKENS))
    ttfts = sorted(first for _, _, first, _ in streams)
    generated = sum(len(t) for t in tokens)
    return {"launches": launches, "before": before, "after": after,
            "tokens": tokens, "generated": generated, "wall_s": wall_s,
            "tokens_per_s": generated / wall_s,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3}


def serve_generate_dense(card: str) -> dict:
    """The generate configuration on dense slots: K1 once per layer per
    prefill, K2 never; a served stream against the plain teacher-forced
    forward; the dense wave's greedy and seeded graphs against the eager
    wave; one cache (cache_bytes) and its device bytes."""
    model, load_s = load_generative("generate", DENSE_CONFIG)
    engine, cfg = model.engine, model.module.config
    check(engine.block_size is None and (cfg.num_layers, cfg.hidden_size,
                                         cfg.max_seq) == tuple(
        DENSE_CONFIG["arch_kwargs"][k] for k in ("num_layers", "hidden_size",
                                                 "max_seq")),
          "not the dense generate decoder")
    try:
        run = asyncio.run(drive_dense(model))
        before, after = run["before"], run["after"]
        prefills = after["prefills"] - before["prefills"]
        waves = after["decode_steps"] - before["decode_steps"]
        got = run["launches"]
        check(prefills > 0
              and got["flash_attention"] == cfg.num_layers * prefills,
              f"dense: flash kernel launched {got['flash_attention']} times "
              f"for {prefills} prefills")
        check(got["paged_attention"] == 0,
              f"dense: paged kernel launched {got['paged_attention']} times")
        reference = check_generation_against_plain(
            model, dense_prompt(0), run["tokens"][0])
        wave_graphs = check_wave_graphs(model, dense_wave_state)
        S, H, D = engine.max_slots, cfg.num_heads, cfg.head_dim
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        want_bytes = (2 * cfg.num_layers * S * engine.max_seq * H * D
                      * itemsize)
        check(engine.cache_bytes() == want_bytes,
              f"dense cache_bytes {engine.cache_bytes()} != {want_bytes}")
        cache_device_bytes = sum(k.numel() * k.element_size()
                                 + v.numel() * v.element_size()
                                 for k, v in engine._caches)
    finally:
        model.unload()
    summary = {
        "card": card, "load_s": load_s, "requests": DENSE_REQUESTS,
        "concurrency": DENSE_CONCURRENCY,
        "generated_tokens": run["generated"], "wall_s": run["wall_s"],
        "tokens_per_s": run["tokens_per_s"],
        "ttft_p50_ms": run["ttft_p50_ms"], "prefills": prefills,
        "decode_waves": waves, "launches": got,
        "cache_bytes": engine.cache_bytes(),
        "cache_device_bytes": cache_device_bytes,
        "engine": {k: after[k] for k in (
            "decode_device_s", "prefill_device_s", "slot_occupancy",
            "goodput_ratio", "depth_effective") if k in after},
        "reference": reference,
        "graphs": {k: wave_graphs[k] for k in ("greedy", "seeded")},
        "graph_stats": wave_graphs["graph_stats"],
    }
    print("generate_dense " + json.dumps(summary), flush=True)
    return summary


def cold_prompt(i: int) -> str:
    """Unique from its first block on: the salt leads."""
    return f"cold{i:06d} " + "y" * (COLD_LEN - 11)


def live_prompt(i: int) -> str:
    return f"s{i:04d} " + "x" * (COLD_STREAM_LEN - 6)


async def drive_cold(port: int, name: str) -> dict:
    """Four live streams; once each has its first token, the five cold
    prompts land at once.  Returns the live streams' decode gaps, the
    cold streams' ids and TTFTs, and the /metrics scrape after."""
    path = f"/v2/models/{name}/generate_stream"
    live_times = [[] for _ in range(COLD_STREAMS)]
    lives = [asyncio.create_task(asyncio.to_thread(
        sse_stream, port, path,
        {"text_input": live_prompt(i), "max_tokens": COLD_STREAM_TOKENS},
        None, live_times[i])) for i in range(COLD_STREAMS)]
    for _ in range(600):
        if all(live_times):
            break
        await asyncio.sleep(0.01)
    check(all(live_times), f"{name}: a live stream never started")
    t_cold = time.perf_counter()
    colds = await asyncio.gather(*(asyncio.to_thread(
        sse_stream, port, path,
        {"text_input": cold_prompt(i), "max_tokens": COLD_TOKENS})
        for i in range(COLD_PROMPTS)))
    lives = await asyncio.gather(*lives)
    for i, (status, events, _, _) in enumerate(lives + colds):
        check(status == 200, f"{name} stream {i}: HTTP {status} {events}")
    cold_ids = [stream_tokens(events, f"{name} cold {i}", COLD_TOKENS)
                for i, (_, events, _, _) in enumerate(colds)]
    # Decode gaps of the live streams while the cold prompts landed.
    gaps = []
    for times in live_times:
        gaps += gaps_ms([t for t in times if t >= t_cold])
    return {"gaps": gaps, "cold_ids": cold_ids,
            "cold_ttft_ms": sorted(first * 1e3 for _, _, first, _ in colds),
            "scrape": await asyncio.to_thread(scrape, port)}


def check_chunk_graph(engine) -> dict:
    """A middle chunk of a 3900-token prompt (index 2: table blocks 0-11
    of the row) from its graph against the same chunk run eagerly over
    the same static input: the sampled token and the chunk's written
    blocks in every layer equal."""
    from kfserving_tpu_torch.engine.generator import _Sampling

    C, MB, BS = (engine.prefill_chunk_tokens, engine.blocks_per_slot,
                 engine.block_size)
    idx = 2
    nb = (idx + 1) * C // BS
    key = ("chunk", nb, False, False, False)
    check(key in engine._programs, f"chunk program {key} not captured")
    rng = np.random.default_rng(6)
    host = np.zeros(2 * C + MB + 8, np.int32)
    host[:C] = rng.integers(0, 258, size=C)
    host[C:2 * C] = idx * C + np.arange(C)
    host[2 * C:2 * C + MB] = np.arange(MB)
    tail = 2 * C + MB
    host[tail:tail + 4] = (C - 1, 0, engine.max_slots, COLD_LEN)
    host[tail + 4:] = engine._sampling_bits(
        engine._sampling_arrays([None], 1)[0])
    written = slice(idx * C // BS, nb)

    def run():
        engine._stage(engine._chunk_in, host)
        p = _Sampling(*engine._sampling_views(engine._chunk_in[tail + 4:],
                                              1), False, False, False)
        eager = [t.clone() for t in engine._chunk_program(nb, p)]
        blocks = [pk[written].clone() for pk, _ in engine._caches]
        from kfserving_tpu_torch.engine import graphs

        graph, outputs, tally = engine._programs[key]
        graphs.replay(graph, tally)
        return (all(torch.equal(a, b) for a, b in zip(eager, outputs))
                and all(torch.equal(b, pk[written])
                        for b, (pk, _) in zip(blocks, engine._caches)))

    equal = on_enqueue_thread(engine, run)
    check(equal, f"chunk graph {key} differs from the eager chunk")
    return {"key": list(key), "equal": equal}


def serve_cold4k(card: str) -> dict:
    """generate_cold4k: the chunked and the monolithic arm on one server,
    one after the other.  Live decode gaps p50/p99 while the cold prompts
    land, chunk counts and the stall histogram per arm, the greedy cold
    outputs equal across the arms, the chunk graph against its eager
    run, and the K1/K2 launches of the run."""
    from kfserving_tpu_torch.server.app import ModelServer

    chunked, load_c = load_generative("cold-chunked", COLD_CONFIG,
                                      prefill_chunk_tokens=COLD_CHUNK)
    mono, load_m = load_generative("cold-monolithic", COLD_CONFIG)
    arms = {}
    try:
        async def drive():
            server = ModelServer(http_port=0)
            await server.start_async([chunked, mono], host="127.0.0.1")
            port = server.http_port
            try:
                # Warm each arm's programs (the chunk graphs, the bucket
                # prefill, the waves) on a cold prompt outside the run.
                for name in ("cold-chunked", "cold-monolithic"):
                    status, events, _, _ = await asyncio.to_thread(
                        sse_stream, port,
                        f"/v2/models/{name}/generate_stream",
                        {"text_input": cold_prompt(999), "max_tokens": 4})
                    check(status == 200, f"{name} warm-up: {status}")
                out = {}
                for name, model in (("cold-chunked", chunked),
                                    ("cold-monolithic", mono)):
                    before = model.engine.stats()
                    scraped = await asyncio.to_thread(scrape, port)
                    reset_launches()
                    t0 = time.perf_counter()
                    run = await drive_cold(port, name)
                    run["scrape_before"] = scraped
                    run["wall_s"] = time.perf_counter() - t0
                    run["launches"] = read_launches()
                    run["before"], run["after"] = before, model.engine.stats()
                    out[name] = run
                return out
            finally:
                await server.stop_async()

        runs = asyncio.run(drive())
        chunk_graph = check_chunk_graph(chunked.engine)
    finally:
        chunked.unload()
        mono.unload()
    layers = COLD_CONFIG["arch_kwargs"]["num_layers"]
    steps = COLD_CONFIG["steps_per_call"]
    for name, run in runs.items():
        before, after = run["before"], run["after"]
        waves = after["decode_steps"] - before["decode_steps"]
        prefills = after["prefills"] - before["prefills"]
        got = run["launches"]
        check(got["flash_attention"] == layers * prefills,
              f"{name}: flash kernel launched {got['flash_attention']} "
              f"times for {prefills} prefills")
        check(waves > 0 and got["paged_attention"] == layers * steps * waves,
              f"{name}: paged kernel launched {got['paged_attention']} "
              f"times for {waves} waves")
        # The two chunk families carry no model label: this arm's share
        # is the difference of the scrapes around its run.
        delta = {k: v - run["scrape_before"].get(k, 0.0)
                 for k, v in run["scrape"].items()}
        stall = {k.split("_ms_")[-1]: v for k, v in delta.items()
                 if k.startswith("kfserving_tpu_generator_prefill_chunk_"
                                 "stall_ms_")}
        chunks = {k: v for k, v in delta.items()
                  if k.startswith("kfserving_tpu_generator_prefill_chunks_"
                                  "total")}
        arms[name] = {
            "decode_gap": gap_summary(run["gaps"]),
            "cold_ttft_p50_ms": percentile(run["cold_ttft_ms"], 0.5),
            "wall_s": run["wall_s"], "decode_waves": waves,
            "prefills": prefills, "launches": got,
            "chunked_prefill": after.get("chunked_prefill"),
            "prefill_chunks_total": chunks, "chunk_stall_ms": stall,
        }
    c, m = runs["cold-chunked"], runs["cold-monolithic"]
    check(c["cold_ids"] == m["cold_ids"],
          "greedy cold outputs differ between the chunked and the "
          "monolithic arm")
    cp = arms["cold-chunked"]["chunked_prefill"]
    want_chunks = COLD_PROMPTS * -(-(COLD_LEN + 1) // COLD_CHUNK)
    check(cp["admissions"] - c["before"]["chunked_prefill"]["admissions"]
          == COLD_PROMPTS
          and cp["chunks_dispatched"]
          - c["before"]["chunked_prefill"]["chunks_dispatched"]
          == want_chunks,
          f"chunked arm: {cp}, want {want_chunks} chunks")
    check(arms["cold-monolithic"]["chunked_prefill"] is None,
          "the monolithic arm chunked")
    summary = {"card": card, "load_s": [load_c, load_m], "arms": arms,
               "cold_outputs_equal": True, "chunk_graph": chunk_graph}
    print("generate_cold4k " + json.dumps(summary), flush=True)
    return summary


def spec_prompt(i: int) -> str:
    """Repetitive prompts, each led by its own salt (benchmarks/
    configs.py's specdec traffic)."""
    head = f"request {i:04d} "
    return (head + "alpha beta gamma delta epsilon " * 40)[:SPEC_CTX_LEN]


def check_spec_graphs(engine) -> dict:
    """The verify (and the draft) program's graph against the same
    program run eagerly over the same static inputs: four rows at
    positions ~700 over fresh table rows, random last tokens and
    proposals (the draft arm: random windows, whose proposals the verify
    then reads)."""
    from kfserving_tpu_torch.engine.generator import _Sampling

    S, K, MB = engine.max_slots, engine.spec_tokens, engine.blocks_per_slot
    rng = np.random.default_rng(7)
    last = rng.integers(0, 258, size=S).astype(np.int32)
    draft = rng.integers(0, 258, size=(S, K)).astype(np.int32)
    qpos = (700 + 3 * np.arange(S, dtype=np.int32))[:, None] + np.arange(
        K + 1, dtype=np.int32)
    table = (np.arange(S * MB) % engine.num_blocks).astype(
        np.int32).reshape(S, MB)
    arrays, flags = engine._sampling_arrays([None] * S, S)
    host = np.concatenate([last, draft.ravel(), qpos.ravel(),
                           table.ravel(), engine._sampling_bits(arrays)])
    verify_key = ("spec_verify", S, K + 1) + flags
    draft_key = ("spec_draft", S, engine._draft_window)
    out = {}

    def run():
        engine._stage(engine._spec_in, host)
        if engine._draft_module is not None:
            check(draft_key in engine._programs,
                  f"draft program {draft_key} not captured")
            engine._stage(engine._draft_in, rng.integers(
                0, 258, size=S * engine._draft_window).astype(np.int32))
            out["draft"] = graph_equal(engine, draft_key,
                                       engine._draft_program)
        check(verify_key in engine._programs,
              f"verify program {verify_key} not captured")
        p = _Sampling(*engine._spec_views()[4], *flags)
        out["verify"] = graph_equal(engine, verify_key,
                                    lambda: engine._verify_program(p))

    on_enqueue_thread(engine, run)
    check(all(out.values()), f"spec graphs differ from eager runs: {out}")
    return out


def serve_specdec(card: str) -> dict:
    """specdec: the arms off, ngram and draft on one server.  The six
    greedy streams' ids identical across the arms, one seeded stream of
    each speculative arm equal to the off arm's, tokens/s, acceptance and
    accepted length per arm, K1 launches = 12 x (prefills + K x draft
    waves) and K2 launches = 12 x (16 x plain waves + (K + 1) x spec
    waves), and the verify and draft graphs against their eager runs."""
    from kfserving_tpu_torch.server.app import ModelServer

    arms = {"off": {},
            "ngram": {"speculative": {"tokens": SPEC_K}},
            "draft": {"speculative": {"tokens": SPEC_K, "draft": {
                "architecture": SPEC_CONFIG["architecture"],
                "arch_kwargs": SPEC_CONFIG["arch_kwargs"],
                "window": SPEC_WINDOW}}}}
    models = {}
    for arm, extra in arms.items():
        models[arm], _ = load_generative(f"specdec_{arm}", SPEC_CONFIG,
                                         **extra)
    out = {}
    try:
        async def drive():
            server = ModelServer(http_port=0)
            await server.start_async(list(models.values()), host="127.0.0.1")
            port = server.http_port
            try:
                runs = {}
                for arm, model in models.items():
                    path = f"/v2/models/specdec_{arm}/generate_stream"
                    status, events, _, _ = await asyncio.to_thread(
                        sse_stream, port, path,
                        {"text_input": "warm " + spec_prompt(99),
                         "max_tokens": 8})
                    check(status == 200, f"{arm} warm-up: HTTP {status}")
                    before = model.engine.stats()
                    reset_launches()
                    t0 = time.perf_counter()
                    streams = await asyncio.gather(*(asyncio.to_thread(
                        sse_stream, port, path,
                        {"text_input": spec_prompt(i),
                         "max_tokens": SPEC_MAX_TOKENS})
                        for i in range(SPEC_PROMPTS)))
                    wall_s = time.perf_counter() - t0
                    launches = read_launches()
                    after = model.engine.stats()
                    seeded = await asyncio.to_thread(
                        sse_stream, port, path,
                        {"text_input": spec_prompt(50),
                         "max_tokens": SPEC_MAX_TOKENS,
                         "temperature": 0.8, "seed": SPEC_SEED})
                    runs[arm] = {"streams": streams, "wall_s": wall_s,
                                 "launches": launches, "before": before,
                                 "after": after, "seeded": seeded}
                return runs
            finally:
                await server.stop_async()

        runs = asyncio.run(drive())
        graphs_equal = {arm: check_spec_graphs(models[arm].engine)
                        for arm in ("ngram", "draft")}
    finally:
        for model in models.values():
            model.unload()
    ids = {}
    for arm, run in runs.items():
        toks = []
        for i, (status, events, _, _) in enumerate(run["streams"]):
            check(status == 200, f"{arm} stream {i}: HTTP {status}")
            toks.append(stream_tokens(events, f"{arm} stream {i}",
                                      SPEC_MAX_TOKENS))
        status, events, _, _ = run["seeded"]
        check(status == 200, f"{arm} seeded stream: HTTP {status}")
        ids[arm] = (toks, stream_tokens(events, f"{arm} seeded",
                                        SPEC_MAX_TOKENS))
        before, after = run["before"], run["after"]
        prefills = after["prefills"] - before["prefills"]
        waves = after["decode_steps"] - before["decode_steps"]
        spec = after.get("speculative") or {}
        spec_waves = spec.get("waves", 0) - (
            (before.get("speculative") or {}).get("waves", 0))
        draft_waves = spec_waves if arm == "draft" else 0
        got = run["launches"]
        layers = SPEC_CONFIG["arch_kwargs"]["num_layers"]
        want_k1 = layers * (prefills + SPEC_K * draft_waves)
        # Plain waves: K2 once per layer per step; a verify runs its
        # K + 1 positions at the decode step's shapes, K2 included.
        want_k2 = layers * (SPEC_CONFIG["steps_per_call"]
                            * (waves - spec_waves)
                            + (SPEC_K + 1) * spec_waves)
        check(got["flash_attention"] == want_k1,
              f"{arm}: flash kernel launched {got['flash_attention']} times, "
              f"want {layers} x ({prefills} prefills + {SPEC_K} x "
              f"{draft_waves} draft waves)")
        check(got["paged_attention"] == want_k2,
              f"{arm}: paged kernel launched {got['paged_attention']} "
              f"times for {waves - spec_waves} plain and {spec_waves} "
              f"spec waves")
        if arm != "off":
            check(spec_waves > 0, f"{arm}: no speculative wave ran")
        generated = sum(len(t) for t in toks)
        out[arm] = {"tokens_per_s": generated / run["wall_s"],
                    "generated": generated, "wall_s": run["wall_s"],
                    "waves": waves, "spec_waves": spec_waves,
                    "prefills": prefills, "launches": got,
                    "acceptance_rate": spec.get("acceptance_rate"),
                    "accepted_length_p50": spec.get("accepted_length_p50"),
                    "accepted_length_p99": spec.get("accepted_length_p99"),
                    "draft_device_s": spec.get("draft_device_s"),
                    "verify_device_s": spec.get("verify_device_s"),
                    "fallbacks": spec.get("fallbacks")}
    for arm in ("ngram", "draft"):
        check(ids[arm][0] == ids["off"][0],
              f"{arm}: streamed ids differ from the off arm's")
        check(ids[arm][1] == ids["off"][1],
              f"{arm}: the seeded stream differs from its plain run")
    summary = {"card": card, "arms": out, "ids_identical": True,
               "seeded_identical": True, "graphs": graphs_equal}
    print("specdec " + json.dumps(summary), flush=True)
    return summary


def kv_prompt(conv: int, turn: int, ctx_len: int) -> str:
    """benchmarks/configs.py's conversation turn: the salt leads, so each
    conversation owns its chains from the first block on."""
    head = f"conversation {conv:04d} "
    return (head + "history " * 400)[:ctx_len] + f" turn {turn:03d}"


async def drive_kv_turns(port: int, name: str, setup: dict, turn: int,
                         convs, rng=None) -> tuple:
    """One turn of each conversation in order over SSE (after a Poisson
    gap when ``rng`` is given): ({conv: ids}, [TTFT ms])."""
    ids, ttfts = {}, []
    for conv in convs:
        if rng is not None:
            await asyncio.sleep(float(rng.exponential(setup["gap_mean_s"])))
        status, events, first, _ = await asyncio.to_thread(
            sse_stream, port, f"/v2/models/{name}/generate_stream",
            {"text_input": kv_prompt(conv, turn, setup["ctx_len"]),
             "max_tokens": setup["tokens"]})
        check(status == 200, f"{name} conversation {conv} turn {turn}: "
              f"HTTP {status} {events}")
        ids[conv] = stream_tokens(events, f"{name} conversation {conv}",
                                  setup["tokens"])
        ttfts.append(first * 1e3)
    return ids, ttfts


def ttft_summary(ttfts) -> dict:
    return {"n": len(ttfts), "p50_ms": percentile(ttfts, 0.5),
            "p99_ms": percentile(ttfts, 0.99)}


def context_chains(model, setup: dict, conv: int) -> list:
    """Chain digests of a conversation's full context blocks, as the
    engine's plan computes them."""
    import hashlib

    bs = setup["config"]["block_size"]
    ids = np.asarray(model.tokenizer.encode(
        kv_prompt(conv, 0, setup["ctx_len"])), np.int32)
    full = (setup["ctx_len"] + 1) // bs   # + BOS; the turn varies after
    chains, chain = [], b""
    for c in range(full):
        chain = hashlib.blake2b(chain + ids[c * bs:(c + 1) * bs].tobytes(),
                                digest_size=16).digest()
        chains.append(chain)
    return chains


def block_bytes(engine, blk: int) -> torch.Tensor:
    """A pool block's payload bytes in the tier's layout [layers, (k, v),
    BS, H, D], as uint8 on the host."""
    return torch.stack([torch.stack((pk[blk], pv[blk]))
                        for pk, pv in engine._caches]).view(
                            torch.uint8).cpu()


def check_tier_blocks(tier_model, keep_model, setup: dict) -> dict:
    """Every context block the tier arm holds, on the card (faulted back
    or recomputed) or in the host tier, byte-equal to the same chain's
    block in the keep arm, whose pool never evicted it (the same chunk
    programs over the same tokens wrote both).  The blocks a device-
    resident conversation's return visit faulted back are the first
    ``chunk // block`` x (chunks - 1) of its context."""
    tier_eng, keep_eng = tier_model.engine, keep_model.engine
    cfg = setup["config"]
    faulted_span = (cfg["prefill_chunk_tokens"] // cfg["block_size"]) * (
        -(-(setup["ctx_len"] + 10) // cfg["prefill_chunk_tokens"]) - 1)

    def keep_bytes(chains):
        return [block_bytes(keep_eng, keep_eng._prefix_index[c])
                for c in chains]

    out = {"device_equal": 0, "faulted_back_equal": 0, "tier_equal": 0}
    for conv in range(setup["convs"]):
        chains = context_chains(tier_model, setup, conv)
        check(all(c in keep_eng._prefix_index for c in chains),
              f"keep arm lost conversation {conv}'s blocks")
        want = on_enqueue_thread(keep_eng, lambda: keep_bytes(chains))
        dev = {i: tier_eng._prefix_index.get(c)
               for i, c in enumerate(chains)}
        got = on_enqueue_thread(tier_eng, lambda: {
            i: block_bytes(tier_eng, b) for i, b in dev.items()
            if b is not None})
        for i, b in got.items():
            check(torch.equal(b, want[i]), f"conversation {conv} block {i}: "
                  f"the tier arm's device bytes differ from the keep arm's")
            out["device_equal"] += 1
            if all(j in got for j in range(faulted_span)) \
                    and i < faulted_span:
                out["faulted_back_equal"] += 1
        for i, c in enumerate(chains):
            if tier_eng.kv_tier.contains(c):
                payload = torch.frombuffer(
                    bytearray(tier_eng.kv_tier.read(c)), dtype=torch.uint8)
                check(torch.equal(payload, want[i].reshape(-1)),
                      f"conversation {conv} block {i}: the tier's payload "
                      f"differs from the keep arm's block")
                out["tier_equal"] += 1
    check(out["faulted_back_equal"] > 0 and out["tier_equal"] > 0,
          f"no faulted-back or tier block was compared: {out}")
    return out


def time_tier_paths(engine, setup: dict, reps: int = 3) -> dict:
    """On the engine's enqueue thread, outside the counted run: the
    fault-back of ``timed_blocks`` tier blocks (mmap read into pinned
    memory, host-to-device copy, paged_insert into the sink block,
    synchronised), the spill of as many resident blocks (gather, copy to
    pinned memory, mmap write into a scratch tier), and a 1920-token
    re-prefill forward (the bucketed prefill's K1 path, CUDA events).
    Medians of ``reps``; GB/s over the payload bytes."""
    from kfserving_tpu_torch.engine.kv_tier import HostKVTier
    from kfserving_tpu_torch.ops.paged_attention import paged_insert

    n = setup["timed_blocks"]
    tier = engine.kv_tier
    chains = [bytes.fromhex(c) for c in tier.chains()[-n:]]
    resident = list(engine._prefix_index.values())[:n]
    check(len(chains) == n and len(resident) == n,
          f"time_tier_paths: {len(chains)} tier and {len(resident)} "
          f"resident blocks, want {n}")
    nbytes = n * tier.block_bytes
    # A fresh chain every rep: a duplicate put copies nothing.
    scratch = HostKVTier(block_bytes=tier.block_bytes,
                         capacity_blocks=n * reps, model="chip-smoke-scratch")

    def faultback():
        t0 = time.perf_counter()
        buf = torch.empty((n,) + engine._payload_shape,
                          dtype=engine._cache_dtype, pin_memory=True)
        rows = buf.view(torch.uint8).numpy().reshape(n, -1)
        for row, c in zip(rows, chains):
            tier.read_into(c, row)
        t1 = time.perf_counter()
        dev = buf.to(engine.device, non_blocking=True)
        dest = torch.full((n, 1), -1, dtype=torch.int64,
                          device=engine.device)
        for li, (pk, pv) in enumerate(engine._caches):
            paged_insert(pk, pv, dev[:, li, 0], dev[:, li, 1], dest)
        torch.cuda.current_stream().synchronize()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    def spill(rep):
        t0 = time.perf_counter()
        rows = engine._payload_rows(engine._gather_blocks(resident))
        t1 = time.perf_counter()
        for i, row in enumerate(rows):
            check(scratch.put(bytes([rep, i]) * 8, row),
                  "scratch spill failed")
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    try:
        fb = [on_enqueue_thread(engine, faultback) for _ in range(reps)]
        sp = [on_enqueue_thread(engine, lambda r=r: spill(r))
              for r in range(reps)]
        check(scratch.debug()["spills"] == n * reps,
              f"scratch tier: {scratch.debug()}")
    finally:
        scratch.close()
    fb_ms = float(np.median([t for t, _ in fb]))
    sp_ms = float(np.median([t for t, _ in sp]))
    L = setup["ctx_len"]
    ids = torch.randint(0, 258, (1, 2048), device=engine.device,
                        generator=torch.Generator(engine.device).manual_seed(5))
    lengths = torch.tensor([L], dtype=torch.int32, device=engine.device)

    def prefill():
        with torch.inference_mode():
            engine.module(ids, kv_lengths=lengths, return_cache=True,
                          logit_positions=lengths - 1)

    return {"blocks": n, "bytes": nbytes,
            "faultback_ms": fb_ms,
            "faultback_read_ms": float(np.median([r for _, r in fb])),
            "faultback_gb_s": nbytes / fb_ms / 1e6,
            "spill_ms": sp_ms,
            "spill_gather_copy_ms": float(np.median([g for _, g in sp])),
            "spill_gb_s": nbytes / sp_ms / 1e6,
            "reprefill_tokens": L,
            "reprefill_device_ms": cuda_time_ms(prefill, iters=5)}


def serve_kvtier(card: str, setup: dict = KVTIER_SETUP) -> dict:
    """kvtier: the tier, drop and keep arms on one server.  Turns 0 and 1
    of every conversation warm each arm up (the tier arm's pool churns
    already); then each arm's return visits (turn 2) at Poisson gaps, the
    K1/K2 counts read from 0 around them.  Holds: the tier arm's ids equal
    the keep arm's bit for bit, its device and tier blocks equal the keep
    arm's bytes, tokens saved == (faulted + coalesced) x block size, no
    spill or fault-back failed.  Then the fault-back, spill and
    re-prefill timings."""
    from kfserving_tpu_torch.server.app import ModelServer

    cfg = setup["config"]
    arms = {"tier": {"host_tier_blocks": setup["tier_blocks"]},
            "drop": {}, "keep": {"cache_blocks": setup["keep_blocks"]}}
    models, loads = {}, {}
    for arm, extra in arms.items():
        models[arm], loads[arm] = load_generative(f"kvtier_{arm}", cfg,
                                                  **extra)
    convs = range(setup["convs"])
    try:
        async def drive():
            server = ModelServer(http_port=0)
            await server.start_async(list(models.values()), host="127.0.0.1")
            port = server.http_port
            try:
                for arm in arms:
                    for turn in (0, 1):
                        await drive_kv_turns(port, f"kvtier_{arm}", setup,
                                             turn, convs)
                before = {a: m.engine.stats() for a, m in models.items()}
                rng = np.random.default_rng(1234)
                reset_launches()
                runs = {}
                for arm in arms:
                    runs[arm] = await drive_kv_turns(
                        port, f"kvtier_{arm}", setup, 2, convs, rng)
                launches = read_launches()
                after = {a: m.engine.stats() for a, m in models.items()}
                return runs, launches, before, after
            finally:
                await server.stop_async()

        runs, launches, before, after = asyncio.run(drive())
        blocks = check_tier_blocks(models["tier"], models["keep"], setup)
        timing = time_tier_paths(models["tier"].engine, setup)
    finally:
        for model in models.values():
            model.unload()
    layers = cfg["arch_kwargs"]["num_layers"]
    waves = sum(after[a]["decode_steps"] - before[a]["decode_steps"]
                for a in arms)
    check(waves > 0 and launches["paged_attention"]
          == layers * cfg["steps_per_call"] * waves,
          f"kvtier: paged kernel launched {launches['paged_attention']} "
          f"times for {waves} waves")
    check(launches["flash_attention"] == layers * sum(
        after[a]["prefills"] - before[a]["prefills"] for a in arms),
        f"kvtier: flash kernel launched {launches['flash_attention']} times")
    check(runs["tier"][0] == runs["keep"][0],
          "kvtier: the tier arm's return-visit ids differ from the keep "
          "arm's")
    ht = after["tier"]["host_tier"]
    bs = cfg["block_size"]
    saved = after["tier"]["paged"]["host_tier_tokens_saved"]
    check(saved == (ht["faulted_blocks"] + ht["coalesced_blocks"]) * bs,
          f"kvtier: tokens saved {saved} != (faulted + coalesced) x {bs}")
    check(ht["spill_failures"] == 0 and ht["fault_failures"] == 0,
          f"kvtier: spill or fault-back failures: {ht}")
    d_faulted = ht["faulted_blocks"] - before["tier"]["host_tier"][
        "faulted_blocks"]
    check(d_faulted > 0, "kvtier: the return visits faulted nothing back")
    check(after["keep"]["paged"]["evictions"]["capacity_dropped"] == 0,
          "kvtier: the keep arm evicted")
    summary = {
        "card": card, "load_s": loads,
        "return_ttft": {a: ttft_summary(runs[a][1]) for a in arms},
        "ids_tier_equal_keep": True,
        "ids_drop_equal_keep": runs["drop"][0] == runs["keep"][0],
        "spills": ht["spills"],
        "spills_run": ht["spills"] - before["tier"]["host_tier"]["spills"],
        "faulted_blocks": ht["faulted_blocks"],
        "faulted_blocks_run": d_faulted,
        "coalesced_blocks": ht["coalesced_blocks"],
        "tokens_saved": saved, "tokens_saved_consistent": True,
        "faultback_batch_ms_p50": ht["faultback_ms"]["p50"],
        "faultback_batch_ms_p99": ht["faultback_ms"]["p99"],
        "evictions": {a: after[a]["paged"]["evictions"] for a in arms},
        "block_bytes": ht["block_bytes"], "blocks_equal": blocks,
        "timing": timing, "launches": launches, "decode_waves": waves,
    }
    print("kvtier " + json.dumps(summary), flush=True)
    return summary


def serve_kvhandoff(card: str, setup: dict = KVHANDOFF_SETUP) -> dict:
    """kvhandoff: a simulated recycle per arm, in one process.  The
    incumbent serves turn 0 of every conversation; in the "cold" arm it
    then serves turn 1 too (the unbroken session's ids), in the "handoff"
    arm it exports into the persistent tier; it closes, and a successor
    on the same directory (handoff: adopting the generation) serves turn
    1.  Holds: the handoff successor's ids equal the unbroken session's,
    its adopted payloads equal the exported ones (digests), and nothing
    was dropped or failed.  The K1/K2 counts are read from 0 around both
    arms (4 engine starts, each compiling its greedy wave eagerly)."""
    from kfserving_tpu_torch.engine.kv_tier import payload_digest
    from kfserving_tpu_torch.server.app import ModelServer

    cfg = setup["config"]
    convs = range(setup["convs"])
    kv_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-kv-")
    waves = [0]

    async def incarnation(extra, work):
        model, load_s = await asyncio.to_thread(
            load_generative, "kvhandoff", cfg, **extra)
        server = ModelServer(http_port=0)
        await server.start_async([model], host="127.0.0.1")
        try:
            out = await work(model, server.http_port)
            out["load_s"] = load_s
            waves[0] += model.engine.stats()["decode_steps"]
            return out
        finally:
            await server.stop_async()
            await model.close()
            model.unload()

    async def drive():
        loop = asyncio.get_running_loop()
        recs = {}
        for arm in ("cold", "handoff"):
            extra = {"host_tier_blocks": setup["tier_blocks"]}
            if arm == "handoff":
                extra["host_tier_dir"] = kv_dir

            async def incumbent(model, port, arm=arm):
                rec = {}
                await drive_kv_turns(port, "kvhandoff", setup, 0, convs)
                if arm == "cold":
                    rec["ids"], rec["ttft"] = await drive_kv_turns(
                        port, "kvhandoff", setup, 1, convs)
                    return rec
                t0 = time.perf_counter()
                rec["export"] = await loop.run_in_executor(
                    None, model.engine.export_kv, setup["export_budget_s"])
                rec["export_ms"] = (time.perf_counter() - t0) * 1e3
                tier = model.engine.kv_tier
                rec["block_bytes"] = tier.block_bytes
                rec["digests"] = {c: payload_digest(tier.read(bytes.fromhex(c)))
                                  for c in tier.chains()}
                return rec

            async def successor(model, port):
                tier = model.engine.kv_tier
                rec = {"handoff": dict(tier.handoff),
                       "digests": {c: payload_digest(tier.read(
                           bytes.fromhex(c))) for c in tier.chains()}}
                rec["ids"], rec["ttft"] = await drive_kv_turns(
                    port, "kvhandoff", setup, 1, convs)
                st = model.engine.stats()
                rec["faulted_blocks"] = st["host_tier"]["faulted_blocks"]
                rec["tokens_saved"] = st["paged"]["host_tier_tokens_saved"]
                return rec

            recs[arm] = (await incarnation(extra, incumbent),
                         await incarnation(extra, successor))
        return recs

    try:
        reset_launches()
        recs = asyncio.run(drive())
        launches = read_launches()
    finally:
        shutil.rmtree(kv_dir, ignore_errors=True)
    (unbroken, cold), (incumbent, handoff) = recs["cold"], recs["handoff"]
    layers = cfg["arch_kwargs"]["num_layers"]
    check(launches["paged_attention"]
          == layers * cfg["steps_per_call"] * (waves[0] + 4),
          f"kvhandoff: paged kernel launched {launches['paged_attention']} "
          f"times for {waves[0]} waves and 4 warm waves")
    check(launches["flash_attention"] == 0,
          f"kvhandoff: flash kernel launched {launches['flash_attention']} "
          f"times; every prompt is chunked")
    exp = incumbent["export"]
    check(exp["exported"] > 0 and exp["dropped"] == 0 and exp["failed"] == 0,
          f"kvhandoff: export {exp}")
    adopted = handoff["handoff"]
    check(adopted["adopted"] == exp["exported"] and all(
        adopted[k] == 0 for k in ("corrupt", "truncated", "torn",
                                  "version_skew", "dropped_capacity",
                                  "failed")),
          f"kvhandoff: adoption {adopted} after exporting {exp}")
    check(handoff["digests"] == incumbent["digests"],
          "kvhandoff: the adopted payloads differ from the exported ones")
    check(handoff["ids"] == unbroken["ids"],
          "kvhandoff: the successor's ids differ from the unbroken "
          "session's")
    check(handoff["faulted_blocks"] > 0 and cold["faulted_blocks"] == 0,
          f"kvhandoff: faulted {handoff['faulted_blocks']} (handoff), "
          f"{cold['faulted_blocks']} (cold)")
    summary = {
        "card": card, "export": exp, "export_ms": incumbent["export_ms"],
        "export_gb_s": (exp["exported"] * incumbent["block_bytes"]
                        / incumbent["export_ms"] / 1e6),
        "adopted_blocks": adopted["adopted"], "adoption": adopted,
        "return_ttft": {"handoff": ttft_summary(handoff["ttft"]),
                        "cold": ttft_summary(cold["ttft"]),
                        "unbroken": ttft_summary(unbroken["ttft"])},
        "faulted_blocks": handoff["faulted_blocks"],
        "tokens_saved": handoff["tokens_saved"],
        "ids_handoff_equal_unbroken": True,
        "ids_cold_equal_unbroken": cold["ids"] == unbroken["ids"],
        "load_s": [unbroken["load_s"], cold["load_s"],
                   incumbent["load_s"], handoff["load_s"]],
        "launches": launches, "decode_waves": waves[0],
    }
    print("kvhandoff " + json.dumps(summary), flush=True)
    return summary


def load_tiny_models(card: str) -> dict:
    """bert_tiny (D32), vit_tiny (D16) and decoder_tiny (D32) load and
    serve on the card through K1: each model's warmup or prefill
    launched the kernel, its forward agrees with the plain attention,
    and decoder_tiny's greedy tokens with the teacher-forced plain
    forward."""
    from kfserving_tpu_torch.ops.attention import _torch_attention
    from kfserving_tpu_torch.ops.flash_attention import flash_attention

    out = {}
    for name, config in (
            ("bert_tiny", {"architecture": "bert_tiny",
                           "seq_buckets": [32, 128], "batch_buckets": [1, 4],
                           "max_batch_size": 4, "warmup": True,
                           "output": "topk", "topk": 5}),
            ("vit_tiny", {"architecture": "vit_tiny",
                          "batch_buckets": [1, 4], "max_batch_size": 4,
                          "warmup": True, "output": "argmax"})):
        flash_attention.launches = 0
        model, load_s = load_model(name, config)
        try:
            launches = flash_attention.launches
            cfg = model.module.config
            check(launches > 0, f"{name}: warmup launched no flash kernel")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(8)
            with torch.inference_mode():
                if name == "bert_tiny":
                    x = torch.randint(0, cfg.vocab_size, (4, 128),
                                      generator=gen, device="cuda")
                    mask = torch.ones((4, 128), dtype=torch.int32,
                                      device="cuda")
                    mask[1, 70:] = 0
                    inputs = (x, mask)
                else:
                    inputs = (torch.rand((4, cfg.image_size,
                                          cfg.image_size, 3),
                                         generator=gen, device="cuda"),)
                kernel = model.module(*inputs).float()
                cfg.attn_fn = lambda q, k, v, m: _torch_attention(q, k, v, m)
                try:
                    plain = model.module(*inputs).float()
                finally:
                    cfg.attn_fn = None
            diff = float((kernel - plain).abs().max())
            scale = float(plain.abs().max())
            check(math.isfinite(diff) and diff <= VIT_LOGIT_RTOL * scale,
                  f"{name}: kernel vs plain differ by {diff} (max |plain| "
                  f"{scale})")
            out[name] = {"head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
                         "load_s": load_s, "warmup_flash_launches": launches,
                         "max_abs_diff": diff, "max_abs": scale}
        finally:
            model.unload()
    tiny, load_s = load_generative("decoder_tiny", {
        "architecture": "decoder_tiny", "max_slots": 2, "max_seq": 256,
        "prefill_buckets": [64, 256], "block_size": 32,
        "steps_per_call": 4, "tokenizer": "byte"})
    try:
        flash_attention.launches = 0

        async def run():
            try:
                return await tiny.engine.complete(
                    tiny.tokenizer.encode(dense_prompt(1)),
                    max_new_tokens=16)
            finally:
                await tiny.engine.close()

        tokens, _ = asyncio.run(run())
        check(flash_attention.launches
              == tiny.module.config.num_layers * tiny.engine.prefills,
              "decoder_tiny: flash launches != layers x prefills")
        reference = check_generation_against_plain(tiny, dense_prompt(1),
                                                   tokens)
        out["decoder_tiny"] = {"head_dim": tiny.module.config.head_dim,
                               "load_s": load_s, "reference": reference}
    finally:
        tiny.unload()
    print("tiny_models " + json.dumps({"card": card, **out}), flush=True)
    return out


# -- phase 5: ResNet-50 through the port's server -----------------------------
def bench_images(rng, n: int, size: int) -> np.ndarray:
    """Seeded uint8 NHWC images that differ in more than noise: a colour
    of their own, a gradient and pixel noise each (iid noise alone gives
    every image the same pooled features)."""
    base = rng.uniform(0, 255, (n, 1, 1, 3))
    ramp = np.linspace(-60, 60, size)[None, :, None, None]
    grad = rng.uniform(-1, 1, (n, 1, 1, 3)) * ramp
    noise = rng.normal(0, 20, (n, size, size, 3))
    return np.clip(base + grad + noise, 0, 255).astype(np.uint8)


def calibrate_batch_norm(module, images: torch.Tensor) -> None:
    """Sets every BatchNorm's running mean and variance to the statistics
    of its input over ``images``, in one forward, layer by layer.  With
    its seeded statistics the random network's answer hardly depends on
    the image, so a misrouted answer would not show; calibrated, it
    does."""
    from kfserving_tpu_torch.models.resnet import BatchNorm

    def take_stats(bn, args):
        x = args[0].float()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in module.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.inference_mode():
            module(images)
    finally:
        for hook in hooks:
            hook.remove()


def forward_breakdown(fn, top: int = 8) -> dict:
    """One forward's device time (profiler, idle gaps excluded) beside its
    time between CUDA events (which a slow host stretches), the kernels
    that take most of it, and K1's share."""
    events_ms = cuda_time_ms(fn, iters=5, warmup=1)
    busy_ms, events, timing = profiled_device_ms(fn, iters=3)
    by_name = sorted(((e.self_device_time_total / 3e3, e.count // 3, e.key)
                      for e in events), reverse=True)
    flash_ms = sum(ms for ms, _, key in by_name if "flash_fwd" in key)
    return {"events_ms": events_ms, "device_busy_ms": busy_ms,
            "busy_timing": timing,
            "device_idle_share": max(0.0, 1 - busy_ms / events_ms),
            "flash_ms": flash_ms if events else None,
            "top_kernels": [{"ms": ms, "calls": n, "kernel": key[:90]}
                            for ms, n, key in by_name[:top]]}


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


async def drive_requests(port: int, requests, concurrency: int):
    """POST (path, body, headers) requests at a fixed concurrency, each
    on its own connection in a thread; returns ([(status, raw body)] in
    request order, client latencies in ms, wall s)."""
    sem = asyncio.Semaphore(concurrency)

    def timed(path, body, headers):
        t0 = time.perf_counter()
        status, _, data = http_raw(port, "POST", path, body, headers)
        return status, data, (time.perf_counter() - t0) * 1e3

    async def one(request):
        async with sem:
            return await asyncio.to_thread(timed, *request)

    t0 = time.perf_counter()
    results = await asyncio.gather(*(one(r) for r in requests))
    wall_s = time.perf_counter() - t0
    return ([(s, d) for s, d, _ in results], [lat for _, _, lat in results],
            wall_s)


async def drive_images(port: int, name: str, bodies, concurrency: int):
    """POST pre-encoded bodies (V1 or V2) at a fixed concurrency; returns
    (the answers in request order, client latencies in ms, wall seconds)."""
    headers = {"content-type": "application/json"}
    results, latencies, wall_s = await drive_requests(
        port, [(path, body, headers) for path, body in bodies], concurrency)
    answers = []
    for i, (status, data) in enumerate(results):
        check(status == 200, f"{name} request {i}: HTTP {status} "
              f"{data[:200]!r}")
        resp = json.loads(data)
        if "predictions" in resp:                          # V1
            answers.append(int(resp["predictions"][0]))
        else:                                              # V2
            out = resp["outputs"][0]
            check(out["shape"] == [1], f"{name} V2 shape {out['shape']}")
            answers.append(int(out["data"][0]))
    return answers, latencies, wall_s


def image_bodies(name: str, images: np.ndarray):
    """One request per image: V1 JSON, and V2 JSON for every
    ``V2_EVERY``-th image."""
    datatype = {np.uint8: "UINT8", np.float32: "FP32"}[images.dtype.type]
    bodies = []
    for i, img in enumerate(images):
        if i % V2_EVERY == V2_EVERY - 1:
            body = {"inputs": [{"name": "images", "datatype": datatype,
                                "shape": [1] + list(img.shape),
                                "data": img.ravel().tolist()}]}
            path = f"/v2/models/{name}/infer"
        else:
            body = {"instances": [img.tolist()]}
            path = f"/v1/models/{name}:predict"
        bodies.append((path, json.dumps(body).encode()))
    return bodies


def http_binary(port: int, path: str, body: bytes, header_length: int,
                headers=None):
    """POST a V2 binary-extension body; returns (status, lower-cased
    response headers, raw response bytes, latency ms)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body, headers={
            "content-type": "application/octet-stream",
            "inference-header-content-length": str(header_length),
            **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        latency_ms = (time.perf_counter() - t0) * 1e3
        out_headers = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    return resp.status, out_headers, data, latency_ms


async def drive_binary_images(port: int, name: str, images: np.ndarray,
                              concurrency: int):
    """One V2 binary UINT8 request per image at a fixed concurrency;
    returns (the answers in request order, latencies in ms, wall s)."""
    from kfserving_tpu_torch.protocol.v2 import make_binary_request

    path = f"/v2/models/{name}/infer"
    requests = []
    for img in images:
        body, hlen = make_binary_request({"images": img[None]})
        requests.append((path, body, {
            "content-type": "application/octet-stream",
            "inference-header-content-length": str(hlen)}))
    results, latencies, wall_s = await drive_requests(port, requests,
                                                      concurrency)
    answers = []
    for i, (status, data) in enumerate(results):
        check(status == 200, f"{name} binary request {i}: HTTP {status} "
              f"{data[:200]!r}")
        out = json.loads(data)["outputs"][0]
        check(out["shape"] == [1], f"{name} binary shape {out['shape']}")
        answers.append(int(out["data"][0]))
    return answers, latencies, wall_s


def check_binary_output(port: int, name: str, image: np.ndarray) -> dict:
    """One image as V2 JSON and as V2 binary asking for
    binary_data_output: the binary response decodes to the JSON one."""
    from kfserving_tpu_torch.protocol.v2 import (
        INFERENCE_HEADER_CONTENT_LENGTH,
        decode_binary_response,
        make_binary_request,
    )

    status, expect, _ = http_json(port, "POST", f"/v2/models/{name}/infer", {
        "inputs": [{"name": "images", "datatype": "UINT8",
                    "shape": [1] + list(image.shape),
                    "data": image.ravel().tolist()}]})
    check(status == 200, f"{name} V2 JSON: HTTP {status} {expect}")
    body, hlen = make_binary_request({"images": image[None]},
                                     binary_output=True)
    status, headers, data, _ = http_binary(port, f"/v2/models/{name}/infer",
                                           body, hlen)
    check(status == 200, f"{name} binary output: HTTP {status}")
    check(headers.get("content-type") == "application/octet-stream",
          f"{name} binary output content-type {headers}")
    resp = decode_binary_response(
        data, int(headers[INFERENCE_HEADER_CONTENT_LENGTH]))
    got, want = resp["outputs"][0], expect["outputs"][0]
    check(got["datatype"] == want["datatype"]
          and list(got["data"].shape) == want["shape"]
          and got["data"].ravel().tolist() == want["data"],
          f"{name}: binary output {got} != JSON output {want}")
    return {"datatype": got["datatype"], "shape": want["shape"],
            "answer": want["data"], "response_bytes": len(data)}


def bucket_hits_between(before: dict, after: dict) -> dict:
    """Batches formed per bucket between two ``engine_stats()``."""
    before, after = before or {}, after or {}
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


async def serve_over_http(model, drive):
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    try:
        return await drive(server.http_port)
    finally:
        await server.stop_async()


def serve_resnet(card: str) -> dict:
    from kfserving_tpu_torch.protocol import native

    model, load_s = load_model("resnet", RESNET_CONFIG)
    module = model.module
    check(len(module.blocks) == 16 and module.head.out_features == 1000
          and module.num_filters == 64, "not ResNet-50")
    rng = np.random.default_rng(5)
    scale = float(torch.tensor(RESNET_CONFIG["scale"], dtype=torch.bfloat16))

    def forward_input(images: np.ndarray) -> torch.Tensor:
        # What the served path computes from the uint8 wire.
        return torch.from_numpy(images).to("cuda").float() * scale

    try:
        size = module.image_size
        calibrate_batch_norm(module, forward_input(bench_images(rng, 64,
                                                                size)))
        # The statistics were written on this thread's stream; the
        # engine's graphs read them on the predict stream.
        torch.cuda.synchronize()
        images = bench_images(rng, RESNET_REQUESTS, size)
        bodies = image_bodies("resnet", images)

        async def drive(port):
            # The JSON arm, then the same images over the binary wire.
            arms = {}
            first = await asyncio.to_thread(scrape, port)
            executed = model.engine.execute_count
            for arm in ("json", "binary"):
                executed0 = model.engine.execute_count
                hits0 = model.engine_stats().get("bucket_hits")
                if arm == "json":
                    parsed0 = native.parse_counts["native"]
                    run = await drive_images(port, "resnet", bodies,
                                             RESNET_CONCURRENCY)
                    arms["native_parses"] = (native.parse_counts["native"]
                                             - parsed0)
                else:
                    run = await drive_binary_images(port, "resnet", images,
                                                    RESNET_CONCURRENCY)
                arms[arm] = (*run, model.engine.execute_count - executed0,
                             bucket_hits_between(
                                 hits0,
                                 model.engine_stats().get("bucket_hits")))
            arms["binary_output"] = await asyncio.to_thread(
                check_binary_output, port, "resnet", images[0])
            last = await asyncio.to_thread(scrape, port)
            arms["stages"] = stage_window(
                first, last, model.engine.execute_count - executed,
                "resnet")
            arms["compile_cache"] = compile_cache_window(first, last)
            arms["request_total"] = request_counts(last, "resnet")
            return arms

        arms = asyncio.run(serve_over_http(model, drive))
        v1_bodies = sum(1 for path, _ in bodies if ":predict" in path)
        check(arms["native_parses"] == v1_bodies,
              f"resnet: the native codec parsed {arms['native_parses']} "
              f"of the JSON arm's {v1_bodies} V1 bodies")
        want = {"predict 200": v1_bodies,
                "infer 200": len(bodies) - v1_bodies + len(images) + 2}
        check(arms["request_total"] == want,
              f"resnet: request_total {arms['request_total']} != {want}")
        answers, latencies, wall_s, batches, json_hits = arms["json"]
        bin_answers, bin_latencies, bin_wall_s, bin_batches, bin_hits = \
            arms["binary"]
        stats = model.engine_stats()
        with torch.inference_mode():
            logits = module(forward_input(images)).float()
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        limit = (RESNET_TIE_RTOL * logits.abs().amax(dim=-1)).cpu().numpy()
        direct = logits.argmax(dim=-1).cpu().numpy()
        mismatched, bin_mismatched = ([i for i in range(len(served))
                                       if served[i] != int(direct[i])]
                                      for served in (answers, bin_answers))
        for arm, wrong in (("json", mismatched), ("binary", bin_mismatched)):
            far = [i for i in wrong if gap[i] > limit[i]]
            check(not far, f"resnet {arm}: served argmax differs from the "
                  f"direct forward's at images {far[:5]} (top-2 gaps "
                  f"{[float(gap[i]) for i in far[:5]]})")
        check(arms["binary_output"]["answer"] == [int(direct[0])]
              or gap[0] <= limit[0], "resnet: binary_data_output answer "
              f"{arms['binary_output']} vs direct {int(direct[0])}")
        check(bool(torch.isfinite(logits).all()), "resnet: non-finite logits")
        big = torch.from_numpy(images[:128]).to("cuda")
        with torch.inference_mode():
            b128 = forward_breakdown(lambda: module(big.float() * scale))
        b128_ms = b128["events_ms"]
        flops = module.flops(128)
        graph_check = check_graphs(model,
                                   len(RESNET_CONFIG["batch_buckets"]))
    finally:
        model.unload()
    check(arms["compile_cache"]["miss"] == 0,
          f"resnet: compile cache {arms['compile_cache']} after warmup")
    summary = {
        "card": card, "load_and_warmup_s": load_s,
        "graphs": graph_check, "compile_cache": arms["compile_cache"],
        "requests": len(answers), "v2_requests": len(answers) // V2_EVERY,
        "concurrency": RESNET_CONCURRENCY, "wall_s": wall_s,
        "req_per_s": len(answers) / wall_s,
        "p50_ms": percentile(latencies, 0.5),
        "p99_ms": percentile(latencies, 0.99),
        "batches": batches, "bucket_hits": json_hits,
        "native_parses": arms["native_parses"],
        "engine_stage_means": arms["stages"],
        "request_total": arms["request_total"],
        "binary": {
            "requests": len(bin_answers), "wall_s": bin_wall_s,
            "req_per_s": len(bin_answers) / bin_wall_s,
            "p50_ms": percentile(bin_latencies, 0.5),
            "p99_ms": percentile(bin_latencies, 0.99),
            "batches": bin_batches, "bucket_hits": bin_hits,
            "argmax_mismatches_near_tie": len(bin_mismatched),
            "binary_output": arms["binary_output"]},
        "engine": {k: stats[k] for k in (
            "avg_prepare_ms", "avg_device_ms", "avg_fetch_ms",
            "achieved_tflops", "mfu", "slot_pad_waste") if k in stats},
        "distinct_direct_classes": len(set(direct.tolist())),
        "argmax_mismatches_near_tie": len(mismatched),
        "tie_rtol": RESNET_TIE_RTOL,
        "b128_forward": b128,
        "b128_gflop": flops / 1e9,
        "b128_events_tflops": flops / b128_ms / 1e9,
        "b128_events_mfu": flops / b128_ms / 1e-3
        / PEAK_OPS_PER_S["bfloat16"],
    }
    print("resnet " + json.dumps(summary), flush=True)
    return summary


# -- phase 6: ViT-B/16 through the port's server -----------------------------
def serve_vit(card: str, name: str = "vit", config: dict = VIT_CONFIG,
              widths: tuple = (12, 768, 12, 197)) -> dict:
    """A ViT at ``config`` served over HTTP (48 images at concurrency 16,
    V1 with every fourth V2); ``widths`` is (layers, hidden, heads, L)."""
    from kfserving_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    model, load_s = load_model(name, config)
    module = model.module
    cfg = module.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.seq_len)
          == widths, f"{name}: not the ViT of {widths}")
    rng = np.random.default_rng(6)
    try:
        images = bench_images(rng, VIT_REQUESTS, cfg.image_size)
        images = images.astype(np.float32) / 255.0
        images = np.round(images, 3)         # shorter JSON, same function
        bodies = image_bodies(name, images)

        async def drive(port):
            first = await asyncio.to_thread(scrape, port)
            # The main path's run: the count starts at 0 here.
            flash_attention.launches = 0
            executed0 = model.engine.execute_count
            answers, latencies, wall_s = await drive_images(
                port, name, bodies, VIT_CONCURRENCY)
            launches = flash_attention.launches
            batches = model.engine.execute_count - executed0
            last = await asyncio.to_thread(scrape, port)
            stages = stage_window(first, last, batches, name)
            compiles = compile_cache_window(first, last)
            return (answers, latencies, wall_s, launches, batches, stages,
                    compiles)

        (answers, latencies, wall_s, launches, batches, stages,
         compiles) = asyncio.run(serve_over_http(model, drive))
        check(compiles == {"hit": batches, "miss": 0},
              f"{name}: compile cache {compiles} for {batches} batches")
        check(batches > 0 and launches == cfg.num_layers * batches,
              f"{name}: flash kernel launched {launches} times for "
              f"{batches} batches of {cfg.num_layers} layers")
        batch = torch.from_numpy(images[:config["max_batch_size"]]
                                 ).to("cuda")
        with torch.inference_mode():
            served_logits = module(batch).float()
            cfg.attn_fn = lambda q, k, v, mask: flash_attention_plain(q, k, v)
            try:
                plain_logits = module(batch).float()
            finally:
                cfg.attn_fn = None
        diff = float((served_logits - plain_logits).abs().max())
        limit = VIT_LOGIT_RTOL * float(plain_logits.abs().max())
        check(math.isfinite(diff) and diff <= limit,
              f"{name}: kernel vs plain logits differ by {diff} > {limit}")
        served = answers[:len(batch)]
        # The tie rule: a served argmax may differ from the direct forward's
        # (through K1) or the plain attention's only where that forward's
        # top two logits lie within the limit.
        top1 = {}
        for ref_name, logits in (("direct", served_logits),
                                 ("plain", plain_logits)):
            ref = logits.argmax(dim=-1).cpu().tolist()
            top2 = logits.topk(2, dim=-1).values
            near_tie = (top2[:, 0] - top2[:, 1]).cpu().tolist()
            far = [i for i, (a, b) in enumerate(zip(served, ref))
                   if a != b and near_tie[i] > limit]
            check(not far, f"{name}: served argmax differs from the "
                  f"{ref_name} forward's at images {far}")
            top1[ref_name] = (sum(a == b for a, b in zip(served, ref))
                              / len(ref))
        sixteen = torch.from_numpy(images[:16]).to("cuda")
        with torch.inference_mode():
            b16 = forward_breakdown(lambda: module(sixteen))
        stats = model.engine_stats()
        graph_check = check_graphs(
            model, len(model.engine.batch_buckets.buckets))
    finally:
        model.unload()
    summary = {
        "card": card, "load_and_warmup_s": load_s,
        "widths": dict(zip(("layers", "hidden", "heads", "seq_len"), widths),
                       head_dim=cfg.head_dim),
        "graphs": graph_check, "compile_cache": compiles,
        "requests": len(answers), "concurrency": VIT_CONCURRENCY,
        "wall_s": wall_s, "req_per_s": len(answers) / wall_s,
        "p50_ms": percentile(latencies, 0.5),
        "p99_ms": percentile(latencies, 0.99),
        "batches": batches, "flash_launches": launches,
        "bucket_hits": stats.get("bucket_hits"),
        "engine": {k: stats[k] for k in (
            "avg_prepare_ms", "avg_device_ms", "avg_fetch_ms",
            "achieved_tflops", "mfu") if k in stats},
        "engine_stage_means": stages,
        "logits_max_abs_diff_vs_plain": diff, "logit_limit": limit,
        "top1_agreement": top1,
        "b16_forward": b16,
        "b16_busy_tflops": module.flops(16) / b16["device_busy_ms"] / 1e9,
    }
    print(f"{name} " + json.dumps(summary), flush=True)
    return summary


# -- phase 7: the multi-model catalog through the repository routes ----------
def allocated_bytes() -> int:
    from kfserving_tpu_torch.engine.hbm import device_hbm_in_use

    torch.cuda.synchronize()
    return device_hbm_in_use()


def requested_bytes() -> int:
    """The bytes live tensors asked the caching allocator for.
    ``memory_allocated`` counts whole blocks instead: a large block is
    not split when less than 1 MiB would remain, so it also moves with
    the allocator's free-block history."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def ledger_bytes(hbm, name: str) -> int:
    """The bytes the ledger booked for one resident model."""
    return next(r["bytes"] for r in hbm.debug()["resident"]
                if r["model"] == name)


def shared_bytes(hbm) -> int:
    """The bytes the ledger books for every model at once (the capture
    thread's cuBLAS workspace)."""
    return sum(hbm.debug().get("shared", {}).values())


def pool_requested(pool) -> int:
    """The bytes live tensors asked for inside one graph pool."""
    if pool is None:
        return 0
    return sum(seg["requested_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def check_ledger(repo, hbm, base_requested: int, where: str) -> dict:
    """The ledger against the allocator: its total equals, for every
    resident model, its parameter bytes plus its graph pool, the pool
    counted as the allocator's segments report it now or, where larger,
    as the reserve its warmed grid took (a restored engine recaptures its
    buckets as they are hit); plus the shared cuBLAS workspaces.  And
    every live byte the phase added (``requested_bytes``) is booked."""
    from kfserving_tpu_torch.engine import graphs

    held = shared_bytes(hbm)
    pools = {}
    for name in hbm.resident_models():
        engine = repo.get_model(name).engine
        live = (graphs.pool_bytes(engine._pool, engine.device)
                if engine._pool is not None else 0)
        pools[name] = {"live": live, "reserve": engine.pool_reserve,
                       "requested": pool_requested(engine._pool)}
        held += (engine.host_param_bytes() or engine.param_bytes()) + max(
            live, engine.pool_reserve)
    added = requested_bytes() - base_requested
    check(hbm.used_bytes == held, f"{where}: ledger {hbm.used_bytes} != "
          f"params + graph pools + workspaces on the card {held}")
    check(added <= hbm.used_bytes, f"{where}: {added} live bytes added, "
          f"{hbm.used_bytes} booked")
    return {"ledger": hbm.used_bytes, "pools": pools,
            "requested_added": added}


async def drive_repository(root: str) -> dict:
    import gc
    import weakref

    from kfserving_tpu_torch.engine.hbm import HBMManager
    from kfserving_tpu_torch.predictors.jaxserver.repository import (
        TorchModelRepository,
    )
    from kfserving_tpu_torch.server.app import ModelServer

    hbm = HBMManager(budget_bytes=2 ** 40)
    # The eager mode (demand paging is the default and has phases 8-9).
    repo = TorchModelRepository(models_dir=root, hbm=hbm, residency=False,
                                device="cuda")
    server = ModelServer(http_port=0, registered_models=repo)
    await server.start_async([], host="127.0.0.1")
    port = server.http_port

    async def call(method, path, body=None):
        status, resp, ms = await asyncio.to_thread(http_json, port, method,
                                                   path, body)
        check(status == 200, f"{method} {path}: HTTP {status} {resp}")
        return resp, ms

    async def index():
        resp, _ = await call("GET", "/v2/repository/index")
        return {m["name"]: m["state"] for m in resp}

    try:
        base_requested = requested_bytes()
        load_ms, allocated, freed = {}, {"before_loads": allocated_bytes()}, []
        for i in range(MMS_MODELS):
            name = f"m{i}"
            if i >= MMS_RESIDENT:      # this load evicts m{i - 4}
                victim = repo.get_model(f"m{i - MMS_RESIDENT}")
                freed.append(weakref.ref(victim.module))
            _, load_ms[name] = await call(
                "POST", f"/v2/repository/models/{name}/load")
            if i == 0:
                # The budget: four models' device bytes (parameters and
                # graph pool, as the ledger booked m0) and the shared
                # cuBLAS workspace.
                per_model = ledger_bytes(hbm, "m0")
                hbm.budget_bytes = (MMS_RESIDENT * per_model
                                    + shared_bytes(hbm))
            if i == MMS_RESIDENT - 1:
                allocated["before_evictions"] = allocated_bytes()
        allocated["after_evictions"] = allocated_bytes()
        ledger = {"after_loads": check_ledger(repo, hbm, base_requested,
                                              "multi-model loads")}
        gc.collect()
        check(all(ref() is None for ref in freed),
              "an evicted model's parameters are still referenced")
        states = await index()
        want = {f"m{i}": ("UNAVAILABLE" if i < MMS_RESIDENT else "READY")
                for i in range(MMS_MODELS)}
        check(states == want, f"repository index {states}, want {want}")
        check(hbm.resident_models() == [f"m{i}" for i in
                                        range(MMS_RESIDENT, MMS_MODELS)],
              f"ledger {hbm.resident_models()}")
        rng = np.random.default_rng(7)
        first_predict_ms = {}
        for i in range(MMS_RESIDENT, MMS_MODELS):
            name = f"m{i}"
            x = rng.normal(size=(3, 32)).astype(np.float32)
            resp, first_predict_ms[name] = await call(
                "POST", f"/v1/models/{name}:predict",
                {"instances": x.tolist()})
            direct = await asyncio.to_thread(
                module_logits, repo.get_model(name).module, x)
            served = np.asarray(resp["predictions"], np.float32)
            limit = BF16_RTOL * np.abs(direct).max(axis=-1, keepdims=True)
            check(bool((np.abs(served - direct) <= limit + BF16_ATOL).all()),
                  f"{name}: served logits differ from the direct forward")
        cycles = []
        for _ in range(2):
            before = allocated_bytes()
            await call("POST", "/v2/repository/models/m4/unload")
            unloaded = allocated_bytes()
            _, ms = await call("POST", "/v2/repository/models/m4/load")
            cycles.append({"allocated_before": before,
                           "allocated_unloaded": unloaded,
                           "allocated_reloaded": allocated_bytes(),
                           "load_ms": ms})
        check(cycles[1]["allocated_reloaded"]
              == cycles[0]["allocated_reloaded"],
              f"memory grew over unload/load cycles: {cycles}")
        check(all(c["allocated_unloaded"] < c["allocated_before"]
                  for c in cycles), f"unload freed nothing: {cycles}")
        states = await index()
        check(states == want, f"index after the m4 cycles {states}")
        ledger["after_cycles"] = check_ledger(repo, hbm, base_requested,
                                              "multi-model cycles")
        return {"per_model_bytes": per_model, "ledger": ledger,
                "budget_bytes": hbm.budget_bytes,
                "load_ms": load_ms, "first_predict_ms": first_predict_ms,
                "allocated": allocated, "m4_cycles": cycles,
                "evictions": hbm.debug()["evictions"],
                "index": states}
    finally:
        await server.stop_async()
        for model in repo.get_models():
            model.unload()


def serve_multi_model(card: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-mms-") as root:
        for i in range(MMS_MODELS):
            os.makedirs(os.path.join(root, f"m{i}"))
            with open(os.path.join(root, f"m{i}", "config.json"), "w") as f:
                json.dump(MMS_CONFIG, f)
        summary = {"card": card, **asyncio.run(drive_repository(root))}
    print("multi_model " + json.dumps(summary), flush=True)
    return summary


# -- phase 8: a demand-paged BERT-base catalog --------------------------------
def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().cpu().contiguous().reshape(-1).view(torch.uint8),
        b.detach().cpu().contiguous().reshape(-1).view(torch.uint8))


def direct_topk(model, ids, shape: str) -> dict:
    """The top-k the restored module computes for one request at a served
    batch shape ("b16s64": every row the request), as the engine serves
    it: the answer of the batch's first row, at every position."""
    batch, seq = map(int, shape[1:].split("s"))
    device = model.device
    x = torch.zeros((batch, seq), dtype=torch.int64, device=device)
    x[:, :len(ids)] = torch.tensor(ids, device=device)
    mask = torch.zeros((batch, seq), dtype=torch.int32, device=device)
    mask[:, :len(ids)] = 1
    with torch.inference_mode():
        values, indices = torch.topk(model.module(x, mask), TOPK, dim=-1)
    return {"values": values[0].float().cpu().tolist(),
            "indices": indices[0].to(torch.int32).cpu().tolist()}


def check_restored_bits(model) -> int:
    """Every parameter and buffer of a resident model against its mmap
    source, bit for bit; returns the bytes compared."""
    host = model.engine.host_params
    check(host is not None, f"{model.name}: no host restore source")
    compared = 0
    for name, t in (list(model.module.named_parameters())
                    + list(model.module.named_buffers())):
        check(bit_equal(t, host[name]),
              f"{model.name}: {name} differs from its mmap source")
        compared += t.numel() * t.element_size()
    return compared


async def drive_residency(root: str) -> dict:
    from kfserving_tpu_torch.engine.hbm import HBMManager
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.predictors.jaxserver.repository import (
        TorchModelRepository,
    )
    from kfserving_tpu_torch.server.app import ModelServer

    hbm = HBMManager(budget_bytes=2 ** 40)      # sized at the first fault
    repo = TorchModelRepository(models_dir=root, hbm=hbm, device="cuda")
    server = ModelServer(http_port=0, registered_models=repo)
    await server.start_async([], host="127.0.0.1")
    port = server.http_port
    names = [f"r{i}" for i in range(RES_MODELS)]
    res = repo.residency

    async def call(method, path, body=None):
        status, resp, ms = await asyncio.to_thread(http_json, port, method,
                                                   path, body)
        check(status == 200, f"{method} {path}: HTTP {status} {resp}")
        return resp, ms

    try:
        base_requested = requested_bytes()
        # The main path's run: the count starts at 0 here; every batch
        # of the phase (cold-fault warmups included) runs 12 layers.
        flash_attention.launches = 0
        for i, name in enumerate(names):
            await call("POST", f"/v2/repository/models/{name}/load")
            # Registered, not built: its cold fault will init these.
            repo.get_model(name).init_seed = i
        check(all(res.state_of(n) == "registered" for n in names)
              and hbm.resident_models() == [],
              f"registration touched the card: {res.debug()}")
        cfg = repo.get_model("r0").config
        vocab = create_model(cfg.architecture,
                             **cfg.arch_kwargs).module.config.vocab_size
        rng = np.random.default_rng(8)
        lengths = dict(zip(names, REQUEST_LENGTHS))
        bodies = {n: rng.integers(1, vocab, size=lengths[n]).tolist()
                  for n in names}
        first, ledger_max, worst_diff = {}, 0, 0.0

        async def predict(name):
            resp, ms = await call("POST", f"/v1/models/{name}:predict",
                                  {"instances": [bodies[name]]})
            pred = resp["predictions"][0]
            seq = repo.get_model(name).engine.seq_buckets.fit(lengths[name])
            check_topk(pred["values"], pred["indices"], seq, vocab,
                       f"residency {name}")
            return pred, ms

        def same_as_first(name, pred, where):
            """Round 1's answer (a b1 batch, as every answer held to it):
            the same top-5 indices, scores within the BERT limit."""
            nonlocal worst_diff
            want = first[name]
            diff = float(np.abs(np.subtract(pred["values"],
                                            want["values"])).max())
            check(diff <= MAX_LOGIT_DIFF, f"{where}: {name} top-5 scores "
                  f"moved by {diff} > {MAX_LOGIT_DIFF}")
            worst_diff = max(worst_diff, diff)
            check(pred["indices"] == want["indices"],
                  f"{where}: {name} top-5 indices differ from round 1's")

        allocated, requested, restored_bytes, rounds = [], [], None, []
        for r in range(RES_ROUNDS):
            round_ms = {}
            for name in names:
                warm0 = res.debug()["models"][name]["fault_ins"]["warm"]
                pred, round_ms[name] = await predict(name)
                if r == 0 and name == names[0]:
                    # The budget: two models' device bytes (parameters and
                    # the warmed graph pool, booked through every restore),
                    # read from the first cold fault
                    # (benchmarks/configs.py:1080-1088), and the shared
                    # cuBLAS workspaces.
                    per_model = ledger_bytes(hbm, name)
                    hbm.budget_bytes = (RES_RESIDENT * per_model
                                        + shared_bytes(hbm))
                ledger_max = max(ledger_max, hbm.used_bytes)
                check(hbm.used_bytes <= hbm.budget_bytes,
                      f"ledger {hbm.used_bytes} over budget "
                      f"{hbm.budget_bytes}")
                if r == 0:
                    first[name] = pred
                    continue
                check(res.debug()["models"][name]["fault_ins"]["warm"]
                      == warm0 + 1, f"round {r + 1}: {name} was not "
                      "warm-faulted")
                same_as_first(name, pred, f"round {r + 1}")
                if r == 1 and name == names[-1]:
                    restored_bytes = check_restored_bits(
                        repo.get_model(name))
            allocated.append(allocated_bytes())
            requested.append(requested_bytes())
            rounds.append({"request_ms": round_ms,
                           "resident": hbm.resident_models(),
                           "ledger": check_ledger(repo, hbm, base_requested,
                                                  f"round {r + 1}")})
        # The same two models are resident after every round: the live
        # tensor bytes must not move, nor the blocks once every request
        # is a warm fault (round 1 allocates its models by cold builds,
        # whose block history differs).  Round 1's models also hold the
        # static tensors of their whole warmed grid in their graph pools,
        # where a restored model holds its one recaptured bucket's: the
        # bytes outside the pools are constant over all ten rounds, and
        # all of them over the warm rounds.
        outside = [req - sum(p["requested"] for p in rnd["ledger"]
                             ["pools"].values())
                   for req, rnd in zip(requested, rounds)]
        check(len(set(outside)) == 1, f"requested bytes outside the graph "
              f"pools moved between rounds: {outside}")
        check(len(set(requested[1:])) == 1,
              f"requested bytes moved between warm rounds: {requested}")
        check(len(set(allocated[1:])) == 1,
              f"memory_allocated moved between warm rounds: {allocated}")
        # The transfer alone, without the fault's admission, eviction and
        # executor hop: offload and restore one idle resident model.
        timed = repo.get_model(hbm.resident_models()[-1])
        restore_ms = []
        for _ in range(3):
            timed.engine.offload()
            restore_ms.append(timed.engine.restore() * 1e3)
        check_restored_bits(timed)

        # 8 concurrent requests to one model on the host: one fault.
        target = next(n for n in names if res.state_of(n) == "host")
        counts0 = dict(res.debug()["models"][target]["fault_ins"])
        hits0 = repo.get_model(target).engine_stats().get("bucket_hits")
        preds = await asyncio.gather(*(predict(target)
                                       for _ in range(RES_COALESCE)))
        model = repo.get_model(target)
        hits = bucket_hits_between(
            hits0, model.engine_stats().get("bucket_hits"))
        # They ran batched, at other GEMM shapes than round 1's b1 (bf16
        # near-ties may reorder there): each answer equals the restored
        # module's own forward at a batch shape the requests ran at, and
        # that module's b1 forward equals round 1's answer.
        launches0 = flash_attention.launches
        direct = {shape: direct_topk(model, bodies[target], shape)
                  for shape in hits}
        b1 = direct_topk(model, bodies[target],
                         f"b1s{model.engine.seq_buckets.fit(lengths[target])}")
        check_launches = flash_attention.launches - launches0
        same_as_first(target, b1, "restored b1 forward")
        coalesced_diff = 0.0
        for pred, _ in preds:
            same = [d for d in direct.values()
                    if d["indices"] == pred["indices"]]
            check(bool(same), f"coalesced: {target} top-5 indices equal "
                  f"no direct forward at the shapes run {sorted(hits)}")
            coalesced_diff = max(coalesced_diff, float(np.abs(np.subtract(
                pred["values"], same[0]["values"])).max()))
        check(coalesced_diff <= MAX_LOGIT_DIFF, f"coalesced: {target} "
              f"scores {coalesced_diff} from the direct forward's")
        counts = res.debug()["models"][target]["fault_ins"]
        coalesce = {k: counts[k] - counts0[k] for k in counts}
        check(coalesce == {"cold": 0, "warm": 1,
                           "coalesced": RES_COALESCE - 1, "error": 0},
              f"{RES_COALESCE} concurrent requests to {target}: {coalesce}")

        # The admission-aware veto (benchmarks/configs.py:1124-1146): the
        # LRU head is held in flight while the others are touched past
        # it; the next fault-in must skip it and evict the next one.
        victim = hbm.debug()["resident"][0]["model"]
        faulting = next(n for n in names if res.state_of(n) == "host")
        skips0 = sum(hbm.eviction_skips.values())
        async with res.serving(victim):
            for entry in hbm.debug()["resident"]:
                if entry["model"] != victim:
                    hbm.touch(entry["model"])
            pred, _ = await predict(faulting)
            same_as_first(faulting, pred, "veto")
            skipped = sum(hbm.eviction_skips.values()) - skips0
            kept = victim in hbm.resident_models()
        check(skipped >= 1 and kept, f"the fault-in of {faulting} did not "
              f"skip the busy {victim} (skips {skipped}, resident "
              f"{hbm.resident_models()})")
        launches = flash_attention.launches - check_launches
        batches = sum(repo.get_model(n).engine.execute_count for n in names)
        layers = repo.get_model("r0").module.config.num_layers
        check(launches == layers * batches,
              f"residency: flash kernel launched {launches} times for "
              f"{batches} batches of {layers} layers")
        debug = res.debug()
        fault_ms = debug["fault_in_ms"]
        # What a warm fault's request takes end to end (the restore, the
        # capture of its bucket, the batch), and one capture alone.
        warm_request = sorted(ms for rnd in rounds[1:]
                              for ms in rnd["request_ms"].values())
        param_bytes = repo.get_model(names[0]).engine.host_param_bytes()
        graph_stats = [repo.get_model(n).engine.graph_stats() for n in names]
        recapture_ms = (sum(g["capture_ms_total"] for g in graph_stats)
                        / sum(g["captures"] for g in graph_stats))
        return {
            "models": RES_MODELS, "per_model_bytes": per_model,
            "param_bytes": param_bytes,
            "budget_bytes": hbm.budget_bytes, "ledger_max_bytes": ledger_max,
            "param_sources": {n: repo.get_model(n).param_source
                              for n in names},
            "rounds": rounds, "allocated_after_rounds": allocated,
            "requested_after_rounds": requested,
            "requested_outside_pools": outside,
            "restored_bytes_checked": restored_bytes,
            "top5_max_score_diff": worst_diff,
            "coalesced": {"model": target, **coalesce,
                          "bucket_hits": hits,
                          "max_score_diff_vs_direct": coalesced_diff},
            "veto": {"held": victim, "faulted": faulting,
                     "skips": skipped},
            "flash_launches": launches, "batches": batches,
            "warm_fault_ms": sorted(res.fault_ms["warm"]),
            "warm_fault_n": fault_ms["warm_count"],
            "warm_fault_p90_ms": percentile(res.fault_ms["warm"], 0.9),
            "warm_fault_max_ms": max(res.fault_ms["warm"]),
            "cold_fault_ms": sorted(res.fault_ms["cold"]),
            "warm_fault_p50_ms": fault_ms["warm_p50"],
            "warm_fault_gb_per_s": param_bytes / fault_ms["warm_p50"] / 1e6,
            "warm_request_ms": warm_request,
            "warm_request_p50_ms": percentile(warm_request, 0.5),
            "capture_ms_mean": recapture_ms,
            "restore_ms": restore_ms,
            "restore_gb_per_s": param_bytes / min(restore_ms) / 1e6,
            "residency": debug,
        }
    finally:
        await server.stop_async()
        for model in repo.get_models():
            model.unload()


def serve_residency(card: str, config: dict = RES_CONFIG) -> dict:
    """Four BERT-base fill-mask models of serve_bert's configuration,
    demand-paged under a budget of two."""
    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-res-") as root:
        for i in range(RES_MODELS):
            os.makedirs(os.path.join(root, f"r{i}"))
            with open(os.path.join(root, f"r{i}", "config.json"), "w") as f:
                json.dump(config, f)
        summary = {"card": card, **asyncio.run(drive_residency(root))}
    print("residency " + json.dumps(summary), flush=True)
    return summary


# -- phase 9: MLP density under demand paging ---------------------------------
async def drive_density(root: str) -> dict:
    from kfserving_tpu_torch.engine.hbm import HBMManager
    from kfserving_tpu_torch.predictors.jaxserver.repository import (
        TorchModelRepository,
    )
    from kfserving_tpu_torch.server.app import ModelServer

    hbm = HBMManager(budget_bytes=2 ** 40)
    repo = TorchModelRepository(models_dir=root, hbm=hbm, device="cuda")
    server = ModelServer(http_port=0, registered_models=repo)
    await server.start_async([], host="127.0.0.1")
    port = server.http_port
    names = [f"m{i}" for i in range(DENSITY_MODELS)]
    x = np.random.default_rng(9).normal(size=(1, 32)).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()

    async def predict(name):
        status, resp, ms = await asyncio.to_thread(
            http_json, port, "POST", f"/v1/models/{name}:predict", body)
        check(status == 200, f"density {name}: HTTP {status} {resp}")
        return np.asarray(resp["predictions"][0], np.float32), ms

    try:
        t0 = time.perf_counter()
        for name in names:
            status, resp, _ = await asyncio.to_thread(
                http_json, port, "POST",
                f"/v2/repository/models/{name}/load")
            check(status == 200, f"density load {name}: {status} {resp}")
        register_s = time.perf_counter() - t0
        # Size the budget off one cold fault: 40% of the catalog fits.
        direct = {}
        for name in names:
            await predict(name)
            if name == names[0]:
                per_model = ledger_bytes(hbm, name)
                hbm.budget_bytes = int(per_model * DENSITY_MODELS
                                       * DENSITY_FRAC) + shared_bytes(hbm)
            # Resident and idle right after its predict: its direct
            # forward is the reference for every later answer.
            direct[name] = (await asyncio.to_thread(
                module_logits, repo.get_model(name).module, x))[0]
        cold_evictions = sum(hbm.evictions.values())
        latencies, checked = [], 0

        async def worker(w: int):
            nonlocal checked
            order = list(names)
            wrng = np.random.default_rng(w)
            for _ in range(DENSITY_PASSES):
                wrng.shuffle(order)
                for name in order:
                    served, ms = await predict(name)
                    latencies.append(ms)
                    limit = BF16_RTOL * np.abs(direct[name]).max() + BF16_ATOL
                    check(bool(np.isfinite(served).all()) and bool(
                        (np.abs(served - direct[name]) <= limit).all()),
                        f"density {name}: served {served} vs direct "
                        f"{direct[name]}")
                    checked += 1

        t0 = time.perf_counter()
        await asyncio.gather(*(worker(w) for w in range(DENSITY_WORKERS)))
        wall_s = time.perf_counter() - t0
        check(hbm.used_bytes <= hbm.budget_bytes,
              f"density ledger {hbm.used_bytes} over {hbm.budget_bytes}")
        debug = repo.residency.debug()
        evictions = sum(hbm.evictions.values())
        check(evictions > cold_evictions and debug["fault_in_ms"][
            "warm_count"] > 0, f"density: no eviction pressure {debug}")
        return {
            "models": DENSITY_MODELS, "per_model_bytes": per_model,
            "budget_bytes": hbm.budget_bytes, "register_all_s": register_s,
            "requests": checked, "workers": DENSITY_WORKERS,
            "wall_s": wall_s, "req_per_s": checked / wall_s,
            "p50_ms": percentile(latencies, 0.5),
            "p99_ms": percentile(latencies, 0.99),
            "fault_in_ms": debug["fault_in_ms"],
            "evictions_cold_pass": cold_evictions,
            "evictions_total": evictions,
            "eviction_skips_total": debug["eviction_skips_total"],
            "eviction_storms": debug["eviction_storms"],
            "resident_at_end": debug["resident"],
        }
    finally:
        await server.stop_async()
        for model in repo.get_models():
            model.unload()


def serve_density(card: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-dens-") as root:
        for i in range(DENSITY_MODELS):
            os.makedirs(os.path.join(root, f"m{i}"))
            with open(os.path.join(root, f"m{i}", "config.json"), "w") as f:
                json.dump(MMS_CONFIG, f)
        summary = {"card": card, **asyncio.run(drive_density(root))}
    print("density " + json.dumps(summary), flush=True)
    return summary


# -- phase 10: the explain verb -------------------------------------------
def load_explainer(name: str, config: dict):
    """A SaliencyExplainer over a temporary artifact of ``config`` (it
    serves predict too), loaded on the card."""
    from kfserving_tpu_torch.explainers import SaliencyExplainer

    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(config, f)
        model = SaliencyExplainer(name, model_dir, device="cuda")
        t0 = time.perf_counter()
        model.load()
        return model, time.perf_counter() - t0


def logit_gradient(module, images: torch.Tensor, scale, classes=None):
    """d sum_i logits[i, c_i] / d images on the card, with c_i the
    argmax (a tie split, as the explainer's amax splits it) unless
    ``classes`` is given; and the logits."""
    x = images.detach().float().requires_grad_()
    with torch.enable_grad():
        logits = module(x * scale if scale is not None else x).float()
        picked = (logits.amax(dim=-1) if classes is None
                  else logits.gather(1, classes[:, None])[:, 0])
        (grad,) = torch.autograd.grad(picked.sum(), x)
    return grad, logits.detach()


def fp32_twin(model):
    """The explainer's module rebuilt in fp32 on the card from the same
    weights (cast), outside autograd."""
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.models import weights

    cfg = model.config
    spec = create_model(cfg.architecture,
                        **dict(cfg.arch_kwargs, dtype="float32"))
    state = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
             for k, v in model.module.state_dict().items()}
    twin = weights.materialize(spec.module, torch.device("cuda"),
                               state_dict=state)
    for p in twin.parameters():
        p.requires_grad_(False)
    return twin


def gradient_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Per image: relative L2 distance ||got - want|| / ||want|| and the
    cosine of the two maps; the worst of each."""
    g, w = got.flatten(1).double(), want.flatten(1).double()
    rel = ((g - w).norm(dim=1) / w.norm(dim=1)).tolist()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=1).tolist()
    return {"rel_l2_max": max(rel), "rel_l2_mean": sum(rel) / len(rel),
            "cosine_min": min(cos)}


def check_gap(gap: dict, rel_l2: float, cosine: float, where: str):
    check(gap["rel_l2_max"] <= rel_l2 and gap["cosine_min"] >= cosine,
          f"{where}: gradient gap {gap} outside rel L2 <= {rel_l2}, "
          f"cosine >= {cosine}")


async def drive_saliency(port: int, name: str, images: np.ndarray,
                         predict_images: np.ndarray):
    """EXPLAIN_ROUNDS x both explain routes with one batch of images, while
    single-image predicts run beside them; returns the maps of every
    response, explain latencies, and the predicts' answers."""
    body = json.dumps({"instances": images.tolist()}).encode()
    paths = (f"/v1/models/{name}:explain", f"/v2/models/{name}/explain")

    async def explains():
        out = []
        for _ in range(EXPLAIN_ROUNDS):
            for path in paths:
                status, resp, ms = await asyncio.to_thread(
                    http_json, port, "POST", path, body)
                check(status == 200, f"{name} {path}: HTTP {status} "
                      f"{str(resp)[:300]}")
                out.append((path, resp, ms))
        return out

    predicts = [(f"/v1/models/{name}:predict",
                 json.dumps({"instances": [img.tolist()]}).encode())
                for img in predict_images]
    explained, (answers, _, _) = await asyncio.gather(
        explains(), drive_images(port, name, predicts, 4))
    return explained, answers


def serve_saliency(card: str, name: str, config: dict,
                   images: np.ndarray) -> dict:
    """One model as a saliency explainer on the port's server: both
    explain routes (predicts interleaved), the maps checked, the bf16
    gradients held against the fp32 twin's, device ms of the forward and
    the backward; for a transformer the K1 launches of the window and
    the K1 Function's gradient against the plain attention's."""
    from kfserving_tpu_torch.models import apply_fn_for
    from kfserving_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    model, load_s = load_explainer(name, config)
    module = model.module
    apply = apply_fn_for(model._spec)
    scale = config.get("scale")
    x = torch.from_numpy(images).to("cuda")
    layers = getattr(getattr(module, "config", None), "num_layers", 0)
    predict_images = images[:EXPLAIN_IMAGES // 2]

    async def drive(port):
        flash_attention.launches = 0
        executed0 = model.engine.execute_count
        out = await drive_saliency(port, name, images, predict_images)
        return (*out, flash_attention.launches,
                model.engine.execute_count - executed0,
                request_counts(await asyncio.to_thread(scrape, port), name))

    try:
        explained, answers, launches, batches, counts = asyncio.run(
            serve_over_http(model, drive))
        want = {"explain 200": 2 * EXPLAIN_ROUNDS,
                "predict 200": len(predict_images)}
        check(counts == want, f"{name}: request_total {counts} != {want}")
        requests = len(explained)
        if layers:
            check(launches == layers * (requests + batches),
                  f"{name}: K1 launched {launches} times for {requests} "
                  f"explains and {batches} predict batches of {layers} "
                  "layers")
        maps = []
        for path, resp, _ in explained:
            exps = resp["explanations"]
            check(len(exps) == len(images) and all(
                e["method"] == "gradient_saliency" for e in exps),
                f"{name} {path}: {len(exps)} explanations")
            m = np.asarray([e["saliency"] for e in exps], np.float32)
            check(m.shape == images.shape and np.isfinite(m).all()
                  and all(np.abs(g).max() > 0 for g in m),
                  f"{name} {path}: maps of shape {m.shape}, finite "
                  f"{bool(np.isfinite(m).all())}")
            maps.append(m)
        served = torch.from_numpy(maps[0]).to("cuda")
        direct, logits = logit_gradient(lambda t: apply(module, t), x,
                                        scale)
        classes = logits.argmax(dim=-1)
        # The predicts' answers against a direct forward of what the
        # served path computes (the uint8 wire scaled by the bf16-rounded
        # scale), but for counted near-ties.
        with torch.inference_mode():
            wire = x[:len(answers)].float()
            if scale is not None:
                wire = wire * float(torch.tensor(scale,
                                                 dtype=torch.bfloat16))
            served_logits = apply(module, wire).float()
        top2 = served_logits.topk(2, dim=-1).values
        near = ((top2[:, 0] - top2[:, 1])
                <= RESNET_TIE_RTOL * served_logits.abs().amax(dim=-1))
        wrong = [i for i, a in enumerate(answers)
                 if a != int(served_logits[i].argmax()) and not near[i]]
        check(not wrong, f"{name}: predicts beside the explains answered "
              f"{answers} at {wrong}, the direct forward "
              f"{served_logits.argmax(dim=-1).tolist()}")
        twin = fp32_twin(model)
        fp32, _ = logit_gradient(twin, x, scale, classes=classes)
        vs_fp32 = gradient_gap(served, fp32)
        # The fp32 gradient's own spread under one bf16 rounding of its
        # input (2^-9 relative noise, seeded): the yardstick of the gap.
        # The limits are SALIENCY_LIMITS or twice that spread, whichever
        # is looser.
        gen = torch.Generator(device="cuda")
        gen.manual_seed(13)
        jitter = 1 + 2 ** -9 * torch.randn(x.shape, generator=gen,
                                           device="cuda")
        fp32_jittered, _ = logit_gradient(twin, x.float() * jitter, scale,
                                          classes=classes)
        fp32_spread = gradient_gap(fp32_jittered, fp32)
        rel_l2, cosine = SALIENCY_LIMITS[name]
        rel_l2 = max(rel_l2, 2 * fp32_spread["rel_l2_max"])
        cosine = min(cosine, 1 - 2 * (1 - fp32_spread["cosine_min"]))
        check_gap(vs_fp32, rel_l2, cosine, f"{name} bf16 vs fp32")
        vs_direct = gradient_gap(served, direct)
        check_gap(vs_direct, rel_l2, cosine, f"{name} served vs direct")
        out = {"card": card, "load_and_warmup_s": load_s,
               "images": list(images.shape), "explains": requests,
               "explain_p50_ms": percentile([ms for *_, ms in explained],
                                            0.5),
               "explain_ms": [ms for *_, ms in explained],
               "predicts_beside": len(answers), "predict_batches": batches,
               "bf16_vs_fp32": vs_fp32, "fp32_input_jitter": fp32_spread,
               "limits": {"rel_l2": rel_l2, "cosine": cosine},
               "served_vs_direct": vs_direct,
               "distinct_classes": len(set(classes.tolist()))}
        if layers:
            out["k1_launches"] = launches
            cfg = module.config
            cfg.attn_fn = lambda q, k, v, mask: flash_attention_plain(
                q, k, v)
            try:
                plain, _ = logit_gradient(lambda t: apply(module, t), x,
                                          scale, classes=classes)
            finally:
                cfg.attn_fn = None
            kernel, _ = logit_gradient(lambda t: apply(module, t), x,
                                       scale, classes=classes)
            out["k1_function_vs_plain"] = gradient_gap(kernel, plain)
            check_gap(out["k1_function_vs_plain"], K1_GRAD_REL_L2,
                      K1_GRAD_COSINE, f"{name} K1 Function vs plain")

        def forward():
            with torch.enable_grad():
                apply(module, x.float().requires_grad_() * (scale or 1.0))

        def forward_backward():
            logit_gradient(lambda t: apply(module, t), x, scale)

        fwd_ms = cuda_time_ms(forward, iters=5, warmup=1)
        total_ms = cuda_time_ms(forward_backward, iters=5, warmup=1)
        out.update(forward_ms=fwd_ms, backward_ms=total_ms - fwd_ms,
                   forward_backward_ms=total_ms)
        del twin
    finally:
        model.unload()
    torch.cuda.empty_cache()
    return out


async def drive_blackbox(port: int, predictor, image: np.ndarray,
                         label: int, root: str) -> dict:
    """Each black-box explainer served on a server of its own, scoring
    its perturbations against the predictor at ``port`` through
    predictor_host; per explainer its wall ms, the predictor requests by
    verb in its window, the images they carried, and its explanation."""
    from kfserving_tpu_torch.explainers import build_explainer
    from kfserving_tpu_torch.server.app import ModelServer

    out = {}
    for kind, cfg_name, cfg, body in (
            ("anchor_images", "anchor_images.json", ANCHOR_IMAGES_CONFIG,
             {"instances": [image.tolist()]}),
            ("lime_images", "lime.json", LIME_CONFIG,
             {"instances": [image.tolist()]}),
            ("square_attack", "art.json", ART_CONFIG,
             {"instances": [image.tolist(), label]})):
        art = os.path.join(root, kind)
        await asyncio.to_thread(write_json, os.path.join(art, cfg_name),
                                cfg)
        explainer = await asyncio.to_thread(
            build_explainer, "resnet", kind, art, f"127.0.0.1:{port}")
        explainer.load()
        server = ModelServer(http_port=0)
        await server.start_async([explainer], host="127.0.0.1")
        try:
            before = request_counts(await asyncio.to_thread(scrape, port),
                                    "resnet")
            images0 = predictor.batcher.instances_batched
            status, resp, ms = await asyncio.to_thread(
                http_json, server.http_port, "POST",
                "/v1/models/resnet:explain", body)
            after = request_counts(await asyncio.to_thread(scrape, port),
                                   "resnet")
        finally:
            await server.stop_async()
            await explainer.close()
        check(status == 200, f"{kind}: HTTP {status} {str(resp)[:300]}")
        window = {k: v - before.get(k, 0) for k, v in after.items()
                  if v - before.get(k, 0)}
        hops = window.get("infer 200", 0)
        check(hops > 0 and set(window) == {"infer 200"},
              f"{kind}: predictor requests in its window {window}; the "
              "binary hop counts as infer only")
        out[kind] = {"wall_ms": ms, "predictor_requests": hops,
                     "images_served": predictor.batcher.instances_batched
                     - images0,
                     "requests_per_s": hops / (ms / 1e3),
                     "explanation": resp}
    return out


def check_blackbox(out: dict, image: np.ndarray, label: int) -> dict:
    """Well-formed explanations; returns their small fields."""
    size = list(image.shape[:2])
    anchor = out["anchor_images"].pop("explanation")["data"]
    check(list(np.shape(anchor["mask"])) == size
          and list(np.shape(anchor["segments"])) == size
          and 0.0 <= anchor["precision"] <= 1.0
          and 0.0 < anchor["coverage"] <= 1.0
          and isinstance(anchor["prediction"], int),
          "anchor_images: malformed " + str(
              {k: v for k, v in anchor.items()
               if k not in ("mask", "segments")}))
    lime = out["lime_images"].pop("explanation")["explanations"]
    check(len(lime["masks"]) == len(lime["top_labels"]) == 2
          and all(list(np.shape(m)) == size for m in lime["masks"])
          and list(np.shape(lime["temp"])) == list(image.shape),
          f"lime_images: top_labels {lime['top_labels']}, masks "
          f"{[np.shape(m) for m in lime['masks']]}")
    attack = out["square_attack"].pop("explanation")["explanations"]
    adv = np.asarray(attack["adversarial_example"])
    check(list(adv.shape) == list(image.shape) and attack["L2 error"] >= 0
          and attack["prediction"] == label
          and np.abs(adv - image).max() <= ART_CONFIG["eps"] + 1e-6,
          f"square_attack: shape {adv.shape}, prediction "
          f"{attack['prediction']} vs {label}, L2 {attack['L2 error']}")
    out["anchor_images"]["anchor"] = {k: anchor[k] for k in (
        "anchor_segments", "precision", "coverage", "prediction",
        "met_threshold")}
    out["lime_images"]["top_labels"] = lime["top_labels"]
    out["lime_images"]["segment_weights"] = lime["segment_weights"]
    out["square_attack"]["attack"] = {k: attack[k] for k in (
        "L2 error", "prediction", "adversarial_prediction", "success",
        "queries")}
    return out


def serve_explain(card: str) -> dict:
    """ResNet-50 (the resnet bench config, its seeded BatchNorm
    statistics: calibrated ones make the random network's gradient
    chaotic) and ViT-B/16 (L = 197) as saliency explainers."""
    rng = np.random.default_rng(10)
    resnet_images = bench_images(
        rng, EXPLAIN_IMAGES, RESNET_CONFIG["arch_kwargs"]["image_size"])
    out = {"resnet": serve_saliency(card, "resnet", RESNET_CONFIG,
                                    resnet_images)}
    print("explain_saliency_resnet " + json.dumps(out["resnet"]),
          flush=True)
    vit_images = np.round(bench_images(
        rng, EXPLAIN_IMAGES, VIT_CONFIG["arch_kwargs"]["image_size"])
        .astype(np.float32) / 255.0, 3)
    out["vit"] = serve_saliency(card, "vit", VIT_CONFIG, vit_images)
    print("explain_saliency_vit " + json.dumps(out["vit"]), flush=True)
    return out


def serve_explain_blackbox(card: str) -> dict:
    model, load_s = load_model("resnet", RESNET_CONFIG)
    rng = np.random.default_rng(11)
    scale = float(torch.tensor(RESNET_CONFIG["scale"], dtype=torch.bfloat16))
    size = RESNET_CONFIG["arch_kwargs"]["image_size"]
    batch = bench_images(rng, 64, size)
    try:
        x = torch.from_numpy(batch).to("cuda").float() * scale
        calibrate_batch_norm(model.module, x)
        torch.cuda.synchronize()
        with torch.inference_mode():
            top2 = model.module(x).float().topk(2, dim=-1).values
        # The explainers' image: the seeded batch's nearest to a decision
        # boundary (the smallest top-2 gap), so that perturbations move
        # the class and the searches go past their first level.
        image = batch[int((top2[:, 0] - top2[:, 1]).argmin())]

        async def drive(port):
            # The attack's target: the served answer for the image.
            status, resp, _ = await asyncio.to_thread(
                http_json, port, "POST", "/v1/models/resnet:predict",
                {"instances": [image.tolist()]})
            check(status == 200, f"resnet predict: HTTP {status}")
            label = int(resp["predictions"][0])
            with tempfile.TemporaryDirectory(
                    prefix="kfs-chip-smoke-explain-") as root:
                return label, await drive_blackbox(port, model, image,
                                                   label, root)

        label, out = asyncio.run(serve_over_http(model, drive))
        out = check_blackbox(out, image, label)
    finally:
        model.unload()
    summary = {"card": card, "predictor_load_s": load_s, **out}
    print("explain_blackbox " + json.dumps(summary), flush=True)
    return summary


def serve_storage(card: str) -> dict:
    """A model artifact tarred and served over http:// by a stdlib
    server: the port's server loads it through Storage.download and
    answers a predict from it; a second pull into the same directory
    stops at the success marker."""
    import http.server
    import tarfile
    import threading

    from kfserving_tpu_torch.predictors.torch_model import TorchModel
    from kfserving_tpu_torch.storage import Storage

    gets = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            gets.append(self.path)
            super().do_GET()

        def log_message(self, *args):
            pass

    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-store-") as root:
        art = os.path.join(root, "artifact")
        os.makedirs(art)
        with open(os.path.join(art, "config.json"), "w") as f:
            json.dump(MMS_CONFIG, f)
        served = os.path.join(root, "served")
        os.makedirs(served)
        with tarfile.open(os.path.join(served, "model.tar"), "w") as tf:
            tf.add(os.path.join(art, "config.json"), arcname="config.json")
        httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), lambda *a: Handler(*a, directory=served))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        uri = f"http://127.0.0.1:{httpd.server_port}/model.tar"
        try:
            model = TorchModel("stored", uri, device="cuda")
            t0 = time.perf_counter()
            model.load()
            load_s = time.perf_counter() - t0
            row = np.random.default_rng(12).normal(
                0, 1, (1, MMS_CONFIG["arch_kwargs"]["input_dim"])
            ).astype(np.float32)

            async def drive(port):
                return await asyncio.to_thread(
                    http_json, port, "POST", "/v1/models/stored:predict",
                    {"instances": row.tolist()})

            try:
                status, resp, _ = asyncio.run(serve_over_http(model, drive))
                with torch.inference_mode():
                    direct = model.module(torch.from_numpy(row).to("cuda"))
            finally:
                model.unload()
            dest = os.path.join(root, "pulled")
            for _ in range(2):
                Storage.download(uri, dest)
        finally:
            httpd.shutdown()
            thread.join()
        markers = [f for f in os.listdir(dest) if f.startswith("SUCCESS.")]
        want = direct.float().cpu().numpy()
        check(status == 200 and np.abs(
            np.asarray(resp["predictions"]) - want).max()
            <= 2 ** -6 * np.abs(want).max(),
            f"stored model: HTTP {status} {resp} vs the direct forward "
            f"{want.tolist()}")
        check(gets == ["/model.tar"] * 2 and len(markers) == 1
              and os.path.exists(os.path.join(dest, "config.json")),
              f"storage pulls {gets}, markers {markers}")
    summary = {"card": card, "uri_scheme": "http", "load_s": load_s,
               "pulls": len(gets), "second_pull": "success marker"}
    print("explain_storage " + json.dumps(summary), flush=True)
    return summary


# -- the serving control plane: chain, activate, recycle ----------------------
# The chain configuration (benchmarks/configs.py:1389-1426): the ViT-B/16
# predictor at the chain bench's configuration (VIT_CONFIG) behind the
# port's image transformer, wired through the IngressRouter by an
# InProcessOrchestrator; the transformer reaches the predictor through the
# router's /direct/predictor lane.  128 requests of one seeded uint8 image
# at concurrency 16 (closed loop), then 20 req/s for 5 s (open loop).
CHAIN_REQUESTS, CHAIN_CONCURRENCY = 128, 16
CHAIN_RATE, CHAIN_RATE_S = 20, 5.0
# activate: the chain's predictor re-applied with min_replicas 0 and the
# autoscaler ticking every ACTIVATE_TICK_S (its 30 idle ticks are the
# idle window), then one request through the router brings it back.
ACTIVATE_TICK_S = 0.05
# recycle: the generate_4k decoder (GEN_CONFIG) as one llmserver replica
# of a SubprocessOrchestrator on the card, with a standby pool of one, a
# persistent KV tier of RECYCLE_TIER_BLOCKS blocks in a temporary
# directory and a RecyclePolicy whose max_requests lands the recycle after
# the first turn.  8 conversations of a RECYCLE_CTX-character context, two
# turns of RECYCLE_TOKENS tokens over SSE through the router; then the
# serving replica is SIGKILLed during a RECYCLE_KILL_TOKENS-token stream.
RECYCLE_CONVS, RECYCLE_CTX, RECYCLE_TOKENS = 8, 1000, 16
RECYCLE_KILL_TOKENS, RECYCLE_TIER_BLOCKS = 1024, 256
RECYCLE_CAPTURE_S, RECYCLE_WAIT_S = 2.0, 180.0
# rollout: ViT-B/16 (VIT_CONFIG) behind a ServingManager's IngressRouter,
# in-process replicas on the card, one replica per revision; traffic of
# ROLLOUT_RATE req/s (V2 binary, one image) on throughout.  Revision 2
# steps through ROLLOUT_POLICY to promotion, revision 3 fails every infer
# and rolls back; then every infer slowed by ROLLOUT_BURN_MS, past the
# ROLLOUT_SLO objective, drives the predictive loop (control windows
# ROLLOUT_WINDOWS_S, ticks of ROLLOUT_TICK_S).
ROLLOUT_RATE, ROLLOUT_CONCURRENCY = 20, 4
ROLLOUT_POLICY = {"steps": [25, 50, 100], "hold_s": 1.5, "settle_s": 0.5,
                  "min_requests": 6, "warmup_probes": 2,
                  "max_error_ratio": 0.05, "max_latency_regression": 4.0,
                  "warmup_timeout_s": 120.0}
ROLLOUT_SLO = {"latency_ms": 250.0, "target": 0.9}
ROLLOUT_BURN_MS = 300.0
ROLLOUT_TICK_S, ROLLOUT_WINDOWS_S, ROLLOUT_EXIT_TICKS = 0.25, [1.0, 4.0], 2
ROLLOUT_WAIT_S = 120.0
# agent: AGENT_MODELS BERT-base fill-mask TrainedModels (RES_CONFIG, each
# its own init seed) booked at AGENT_MODEL_BYTES on one shard; the
# replica's watcher polls the shard's models.json every AGENT_POLL_S;
# AGENT_PREDICTS b1 requests of AGENT_LENGTH ids per model.
AGENT_MODELS, AGENT_MODEL_BYTES, AGENT_POLL_S = 3, 2 ** 30, 0.1
AGENT_PREDICTS, AGENT_LENGTH = 2, 40


def device_used_bytes() -> int:
    """Bytes in use on the card, by every process (mem_get_info)."""
    free, total = torch.cuda.mem_get_info()
    return total - free


async def wait_until(predicate, what: str, timeout_s: float = RECYCLE_WAIT_S):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        result = predicate()
        if result:
            return result
        await asyncio.sleep(0.05)
    check(False, f"{what}: not within {timeout_s} s")


def chain_reference(module, batch: torch.Tensor) -> tuple:
    """The chain's reference logits (fp32): ``module`` called directly,
    with K1 and with the plain attention."""
    from kfserving_tpu_torch.ops.flash_attention import flash_attention_plain

    cfg = module.config
    with torch.inference_mode():
        logits = module(batch).float()
        cfg.attn_fn = lambda q, k, v, mask: flash_attention_plain(q, k, v)
        try:
            plain = module(batch).float()
        finally:
            cfg.attn_fn = None
    return logits, plain


async def chain_requests(port: int, body: bytes, n: int, concurrency: int,
                         rate: float = 0.0):
    """POST ``body`` n times through the port's asyncio client: closed
    loop at ``concurrency``, or open loop at ``rate`` per second.  Returns
    ([(status, headers, answer)], client latencies in ms, wall s)."""
    from kfserving_tpu_torch.server.client import HTTPClient

    client = HTTPClient(timeout=300)
    sem = asyncio.Semaphore(concurrency)
    url = f"http://127.0.0.1:{port}/v1/models/vitchain:predict"
    loop = asyncio.get_running_loop()

    async def one(i):
        if rate:
            await asyncio.sleep(max(0.0, t0 + i / rate - loop.time()))
        async with sem:
            t = time.perf_counter()
            status, headers, data = await client.request(
                "POST", url, body, {"content-type": "application/json"})
            ms = (time.perf_counter() - t) * 1e3
        answer = (int(json.loads(data)["predictions"][0])
                  if status == 200 else data[:300])
        return (status, headers, answer), ms

    t0 = loop.time()
    try:
        results = await asyncio.gather(*(one(i) for i in range(n)))
    finally:
        await client.close()
    wall_s = loop.time() - t0
    return [r for r, _ in results], [ms for _, ms in results], wall_s


def serve_chain(card: str) -> tuple:
    """Lines "chain" and "activate": the transformer -> predictor chain
    through the IngressRouter with in-process replicas on the card, then
    the predictor scaled to zero by the autoscaler and activated again by
    one request."""
    import gc

    from kfserving_tpu_torch.control.autoscaler import Autoscaler
    from kfserving_tpu_torch.control.controller import Controller
    from kfserving_tpu_torch.control.orchestrator import (
        InProcessOrchestrator,
        default_model_factory,
    )
    from kfserving_tpu_torch.control.router import (
        REVISION_HEADER,
        IngressRouter,
    )
    from kfserving_tpu_torch.control.spec import (
        InferenceService,
        PredictorSpec,
        TransformerSpec,
    )
    from kfserving_tpu_torch.examples.image_transformer import (
        ImageTransformer,
    )
    from kfserving_tpu_torch.ops.flash_attention import flash_attention

    model_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-chain-")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(VIT_CONFIG, f)
    image = bench_images(np.random.default_rng(12), 1, 224)[0]
    body = json.dumps({"instances": [image.tolist()]}).encode()
    pcid, tcid = "default/vitchain/predictor", "default/vitchain/transformer"

    def factory(component_id, spec):
        if isinstance(spec, TransformerSpec):
            return ImageTransformer(component_id.split("/")[1],
                                    predictor_host=None)
        return default_model_factory(component_id, spec, device="cuda")

    def served_model(orch, cid):
        return orch.replicas(cid)[0].handle.repository.get_model(
            "vitchain")

    async def run():
        orch = InProcessOrchestrator(model_factory=factory, device="cuda")
        controller = Controller(orch)
        router = IngressRouter(controller)
        await router.start_async()
        port = router.http_port
        try:
            isvc = InferenceService(
                name="vitchain",
                predictor=PredictorSpec(framework="jax",
                                        storage_uri=f"file://{model_dir}"),
                transformer=TransformerSpec())
            t0 = time.perf_counter()
            status = await controller.apply(isvc)
            apply_s = time.perf_counter() - t0
            check(status.ready, f"chain: apply not ready {status}")
            revision = status.components["transformer"].latest_revision
            transformer = served_model(orch, tcid)
            check(transformer.predictor_host
                  == f"127.0.0.1:{port}/direct/predictor",
                  f"chain: transformer's predictor_host "
                  f"{transformer.predictor_host}")
            predictor = served_model(orch, pcid)
            module, engine = predictor.module, predictor.engine
            cfg = module.config
            check((cfg.num_layers, cfg.hidden_size, cfg.seq_len)
                  == (12, 768, 197), "chain: not ViT-B/16 at 224 px")
            # The main path's run: the count starts at 0 here.
            flash_attention.launches = 0
            executed0 = engine.execute_count
            closed = await chain_requests(port, body, CHAIN_REQUESTS,
                                          CHAIN_CONCURRENCY)
            opened = await chain_requests(
                port, body, int(CHAIN_RATE * CHAIN_RATE_S),
                int(CHAIN_RATE * CHAIN_RATE_S), rate=CHAIN_RATE)
            launches = flash_attention.launches
            await asyncio.to_thread(lint_metrics, port, "router")
            batches = engine.execute_count - executed0
            pre = await transformer.preprocess({"instances": [image]})
            batch = torch.from_numpy(np.stack(pre["instances"])).to("cuda")
            logits, plain = await asyncio.to_thread(chain_reference, module,
                                                    batch)
            param_bytes = sum(t.numel() * t.element_size() for t in
                              list(module.parameters())
                              + list(module.buffers()))
            layers = cfg.num_layers
            del predictor, module, engine, transformer, cfg
            chain = {"apply_s": apply_s, "revision": revision,
                     "layers": layers,
                     "closed": closed, "open": opened,
                     "launches": launches, "batches": batches,
                     "logits": logits, "plain": plain,
                     "param_bytes": param_bytes}

            # activate: scale the predictor to zero, then one request.
            isvc.predictor.min_replicas = 0
            await controller.apply(isvc)
            check(len(orch.replicas(pcid)) == 1,
                  "activate: re-applying min_replicas 0 dropped the "
                  "replica")
            gc.collect()
            allocated0 = torch.cuda.memory_allocated()
            scaler = Autoscaler(controller, router,
                                tick_seconds=ACTIVATE_TICK_S)
            t0 = time.perf_counter()
            await scaler.start()
            try:
                await wait_until(lambda: not orch.replicas(pcid),
                                 "activate: scale to zero", 60.0)
            finally:
                await scaler.stop()
            zero_s = time.perf_counter() - t0
            check(len(orch.replicas(tcid)) == 1,
                  "activate: the transformer scaled too")
            gc.collect()
            allocated1 = torch.cuda.memory_allocated()
            flash_attention.launches = 0
            (answer,), (activate_ms,), _ = await chain_requests(
                port, body, 1, 1)
            activate_launches = flash_attention.launches
            check(len(orch.replicas(pcid)) == 1,
                  "activate: no predictor replica after the request")
            activate = {"zero_s": zero_s, "allocated_before": allocated0,
                        "allocated_at_zero": allocated1,
                        "answer": answer, "activate_ms": activate_ms,
                        "launches": activate_launches}
            return chain, activate
        finally:
            await router.stop_async()
            await orch.shutdown()

    try:
        chain, activate = asyncio.run(run())
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    logits, plain = chain["logits"], chain["plain"]
    diff = float((logits - plain).abs().max())
    limit = VIT_LOGIT_RTOL * float(plain.abs().max())
    check(math.isfinite(diff) and diff <= limit,
          f"chain: kernel vs plain logits differ by {diff} > {limit}")
    direct = int(logits.argmax(dim=-1)[0])
    top2 = logits.topk(2, dim=-1).values[0]
    near_tie = float(top2[0] - top2[1]) <= limit
    results = chain["closed"][0] + chain["open"][0]
    ties = 0
    for i, (status, headers, answer) in enumerate(results):
        check(status == 200, f"chain request {i}: HTTP {status} {answer}")
        check(headers.get(REVISION_HEADER) == chain["revision"],
              f"chain request {i}: {REVISION_HEADER} "
              f"{headers.get(REVISION_HEADER)} != {chain['revision']}")
        if answer != direct:
            check(near_tie, f"chain request {i}: answer {answer} != the "
                  f"direct forward's {direct}")
            ties += 1
    layers = chain["layers"]
    check(chain["batches"] > 0
          and chain["launches"] == layers * chain["batches"],
          f"chain: flash kernel launched {chain['launches']} times for "
          f"{chain['batches']} predictor batches of {layers} layers")

    def loop_summary(run):
        res, lat, wall_s = run
        return {"requests": len(res), "wall_s": wall_s,
                "req_per_s": len(res) / wall_s,
                "p50_ms": percentile(lat, 0.5),
                "p99_ms": percentile(lat, 0.99)}

    chain_summary = {
        "card": card, "apply_s": chain["apply_s"],
        "closed_loop": dict(loop_summary(chain["closed"]),
                            concurrency=CHAIN_CONCURRENCY),
        "open_loop": dict(loop_summary(chain["open"]),
                          offered_req_per_s=CHAIN_RATE),
        "predictor_batches": chain["batches"],
        "flash_launches": chain["launches"], "answer": direct,
        "near_tie_answers": ties, "revision": chain["revision"],
        "logits_max_abs_diff_vs_plain": diff, "logit_limit": limit,
    }
    print("chain " + json.dumps(chain_summary), flush=True)
    status, headers, answer = activate["answer"]
    check(status == 200, f"activate: HTTP {status} {answer}")
    check(answer == direct or near_tie,
          f"activate: answer {answer} != the chain's {direct}")
    freed = activate["allocated_before"] - activate["allocated_at_zero"]
    check(freed >= chain["param_bytes"],
          f"activate: memory_allocated fell by {freed} bytes at zero "
          f"replicas, less than the ViT's {chain['param_bytes']}")
    activate_summary = {
        "card": card, "scale_to_zero_s": activate["zero_s"],
        "allocated_before": activate["allocated_before"],
        "allocated_at_zero": activate["allocated_at_zero"],
        "freed_bytes": freed, "param_bytes": chain["param_bytes"],
        "activation_ms": activate["activate_ms"], "answer": answer,
        "flash_launches": activate["launches"],
    }
    print("activate " + json.dumps(activate_summary), flush=True)
    return chain_summary, activate_summary


def replica_children() -> list:
    """Live child processes of this process that run a replica."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z" and \
                b"kfserving_tpu_torch" in cmdline:
            out.append(int(pid))
    return out


def rerun_replica(orch, component_id: str, spec) -> None:
    """A replica that did not come up: run its argv once in the
    foreground (its stderr is discarded under the orchestrator) and print
    why, or that it came up this time."""
    from kfserving_tpu_torch.control.subprocess_orchestrator import (
        _free_port,
    )

    port = _free_port()
    argv = orch._command(component_id, spec, port)
    env = dict(os.environ, **orch.env_overrides)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    came_up = False
    try:
        deadline = time.perf_counter() + 150
        while proc.poll() is None and time.perf_counter() < deadline:
            try:
                if http_raw(port, "GET", "/")[0] == 200:
                    came_up = True
                    break
            except OSError:
                pass
            time.sleep(0.5)
    finally:
        proc.kill()
        out, _ = proc.communicate()
    print(f"replica rerun in the foreground ({'up' if came_up else 'down'},"
          f" rc {proc.returncode}): {' '.join(argv)}\n{out[-6000:]}",
          file=sys.stderr, flush=True)


def recycle_turn(port: int, turn: int, convs, headers=None) -> tuple:
    """One turn of each conversation in order over SSE through the
    router: ({conv: ids}, [TTFT ms])."""
    ids, ttfts = {}, []
    for conv in convs:
        status, events, first, _ = sse_stream(
            port, "/v2/models/gen/generate_stream",
            {"text_input": kv_prompt(conv, turn, RECYCLE_CTX),
             "max_tokens": RECYCLE_TOKENS}, headers)
        check(status == 200, f"recycle conversation {conv} turn {turn}: "
              f"HTTP {status} {events}")
        ids[conv] = stream_tokens(events, f"recycle conversation {conv}",
                                  RECYCLE_TOKENS)
        ttfts.append(first * 1e3)
    return ids, ttfts


def param_source_of(phases: dict) -> str:
    """A replica's param_source read off its startup marks: a hit of the
    mmap param cache marks params_mmap, a converted checkpoint
    checkpoint_restore, a seeded init init_params."""
    for mark, source in (("params_mmap", "mmap"),
                         ("checkpoint_restore", "checkpoint"),
                         ("init_params", "init")):
        if mark in phases:
            return source
    return "unknown"


def serve_recycle(card: str) -> dict:
    """Line "recycle": the generate_4k decoder as a subprocess replica on
    the card behind the IngressRouter.  Turn 0 of 8 conversations; the
    watchdog's recycle activates the armed standby, drains the incumbent
    (its drain exports the conversations into the persistent tier) and
    re-attaches the successor to it; turn 1 (a profiler capture on the
    successor must name K1 and K2); then the successor is SIGKILLed
    during a stream: a request sent after the kill meets the dead
    replica, the router evicts it (the supervisor promotes the re-armed
    standby on that crash report) and retries once with x-kfs-kv-peer
    naming it, which the promoted replica pulls from; the killed stream
    ends with the router's retriable failover event, and the client's
    retry of it is answered on the promoted replica.  Every stream's ids are held against
    a teacher-forced forward of the same seeded weights in this process
    with the plain attention."""
    import signal

    from kfserving_tpu_torch.control.controller import Controller
    from kfserving_tpu_torch.control.router import IngressRouter
    from kfserving_tpu_torch.control.spec import (
        InferenceService,
        PredictorSpec,
    )
    from kfserving_tpu_torch.control.subprocess_orchestrator import (
        RecyclePolicy,
        SubprocessOrchestrator,
    )
    from kfserving_tpu_torch.observability import metrics as obs

    model_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-recycle-")
    kv_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-recycle-kv-")
    trace_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-recycle-trace-")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(GEN_CONFIG, f)
    policy = RecyclePolicy(max_requests=RECYCLE_CONVS, check_interval_s=0.5,
                           min_age_s=0.0)
    orch = SubprocessOrchestrator(
        env_overrides={"KFS_KV_TIER_DIR": kv_dir,
                       "KFS_KV_TIER_BLOCKS": str(RECYCLE_TIER_BLOCKS),
                       "KFS_DRAIN_GRACE_S": "5"},
        recycle=policy, device="cuda")
    cid = "default/gen/predictor"
    convs = range(RECYCLE_CONVS)
    memory = {"before": device_used_bytes()}
    earlier = set(replica_children())
    streams = []    # (prompt, ids) of every stream held against plain

    async def run():
        controller = Controller(orch)
        router = IngressRouter(controller, buffer_deadline_s=RECYCLE_WAIT_S)
        await router.start_async()
        port = router.http_port
        spec = PredictorSpec(framework="generative",
                             storage_uri=f"file://{model_dir}")
        out = {}
        try:
            t0 = time.perf_counter()
            try:
                await controller.apply(InferenceService(name="gen",
                                                        predictor=spec))
            except Exception:
                await asyncio.to_thread(rerun_replica, orch, cid, spec)
                raise
            out["apply_s"] = time.perf_counter() - t0
            incumbent = orch.replicas(cid)[0]
            memory["incumbent"] = device_used_bytes()
            await wait_until(
                lambda: orch._standbys.get((cid, incumbent.revision)),
                "recycle: the standby pool")
            memory["incumbent_and_armed_standby"] = device_used_bytes()
            deleting = orch.delete_replica

            async def measured_delete(replica):
                # Both processes hold the card here: the successor is
                # active, the incumbent not yet drained.
                memory.setdefault("overlap", device_used_bytes())
                await deleting(replica)

            orch.delete_replica = measured_delete
            ids0, ttft0 = await asyncio.to_thread(recycle_turn, port, 0,
                                                  convs)
            streams.extend((kv_prompt(c, 0, RECYCLE_CTX), ids0[c])
                           for c in convs)
            await wait_until(lambda: orch.recycle_count >= 1,
                             "recycle: the watchdog's recycle")
            orch.delete_replica = deleting
            policy.max_requests = None      # one recycle
            successor = orch.replicas(cid)[0]
            check(successor.host != incumbent.host,
                  "recycle: the incumbent still serves")
            memory["successor"] = device_used_bytes()
            status, _, cache = await asyncio.to_thread(
                http_raw, int(successor.host.rsplit(":", 1)[1]), "GET",
                "/debug/cache")
            tier = (json.loads(cache).get("host_tier") or {}).get("gen", {})
            adopted = (tier.get("handoff") or {}).get("adopted", 0)
            check(status == 200 and adopted > 0,
                  f"recycle: the successor adopted {adopted} blocks")
            # Turn 1 under a capture on the successor, with one cold
            # prompt beside it so a bucketed prefill runs in the window.
            sport = int(successor.host.rsplit(":", 1)[1])
            capture = asyncio.ensure_future(asyncio.to_thread(
                http_json, sport, "POST", "/debug/profile/capture",
                {"duration_s": RECYCLE_CAPTURE_S, "log_dir": trace_dir}))
            await asyncio.sleep(0.3)
            cold = asyncio.ensure_future(asyncio.to_thread(
                sse_stream, port, "/v2/models/gen/generate_stream",
                {"text_input": gen_prompt(7777),
                 "max_tokens": RECYCLE_TOKENS}))
            ids1, ttft1 = await asyncio.to_thread(recycle_turn, port, 1,
                                                  convs)
            streams.extend((kv_prompt(c, 1, RECYCLE_CTX), ids1[c])
                           for c in convs)
            status, events, _, _ = await cold
            check(status == 200, f"recycle cold prompt: HTTP {status}")
            streams.append((gen_prompt(7777),
                            stream_tokens(events, "recycle cold prompt",
                                          RECYCLE_TOKENS)))
            status, captured, _ = await capture
            check(status == 200 and captured.get("captured"),
                  f"recycle: profile capture HTTP {status} {captured}")
            out["capture"] = await asyncio.to_thread(kernel_events,
                                                     captured["trace"])
            check(out["capture"]["flash_attention"] > 0
                  and out["capture"]["paged_attention"] > 0,
                  f"recycle: the successor's capture names "
                  f"{out['capture']}")
            # The kill: a long stream, the serving replica SIGKILLed once
            # its first token is out, a second stream (the racer) sent
            # once the process is gone.  The watchdog's tick is slowed
            # first, so the dead replica leaves rotation through the
            # router alone, and the killed stream's liveness probe waits
            # for the promotion: the racer meets the corpse, and the
            # router's own retry of it, naming the corpse in
            # x-kfs-kv-peer, is what evicts it and reaches the promoted
            # standby.
            await wait_until(
                lambda: orch._standbys.get((cid, successor.revision)),
                "recycle: the re-armed standby")
            policy.check_interval_s = 60.0
            await asyncio.sleep(1.0)    # the 0.5 s tick in flight ends
            gate = asyncio.Event()
            probe = router._replica_alive

            async def gated_probe(host):
                await gate.wait()
                return await probe(host)

            router._replica_alive = gated_probe
            retried = obs.revision_requests_total().labels(
                model="gen", revision=successor.revision, status="503")
            retried0 = retried.value
            times = []
            kill_prompt = kv_prompt(0, 2, RECYCLE_CTX)
            killed = asyncio.ensure_future(asyncio.to_thread(
                sse_stream, port, "/v2/models/gen/generate_stream",
                {"text_input": kill_prompt,
                 "max_tokens": RECYCLE_KILL_TOKENS}, None, times))
            await wait_until(lambda: times, "recycle: the first token")
            os.kill(successor.handle.process.pid, signal.SIGKILL)
            t_kill = time.perf_counter()
            await successor.handle.process.wait()
            racer_prompt = kv_prompt(1, 2, RECYCLE_CTX)
            racer = asyncio.ensure_future(asyncio.to_thread(
                sse_stream, port, "/v2/models/gen/generate_stream",
                {"text_input": racer_prompt,
                 "max_tokens": RECYCLE_TOKENS}))
            await wait_until(lambda: orch.promotions >= 1,
                             "recycle: the promotion")
            gate.set()
            status, events, _, _ = await killed
            check(status == 200 and events
                  and events[-1].get("finish_reason") == "failover"
                  and events[-1].get("retriable") is True,
                  f"recycle: the killed stream ended with "
                  f"{events[-1] if events else events}")
            predecessor = events[-1]["predecessor"]
            check(predecessor == successor.host,
                  f"recycle: failover names {predecessor}")
            promoted = (await wait_until(lambda: orch.replicas(cid),
                                         "recycle: a promoted replica"))[0]
            out["promoted_s"] = time.perf_counter() - t_kill
            check(promoted.host not in (successor.host, incumbent.host),
                  f"recycle: promoted {promoted.host}")
            status, events, _, _ = await racer
            check(status == 200, f"recycle racer: HTTP {status} {events}")
            streams.append((racer_prompt, stream_tokens(
                events, "recycle racer", RECYCLE_TOKENS)))
            # The router retried the racer away from the corpse once, and
            # the retry named it: the promoted replica pulled from it.
            # Read before the client's own retry below, which forwards the
            # same hint (a replica pulls once per peer).
            out["router_retries"] = retried.value - retried0
            check(out["router_retries"] == 1,
                  f"recycle: the router retried the racer "
                  f"{out['router_retries']} times, not once")
            pport = int(promoted.host.rsplit(":", 1)[1])
            status, pins, _ = await asyncio.to_thread(
                http_json, pport, "GET", "/debug/flightrecorder?pinned=1")
            pulls = [e for e in pins.get("pinned", [])
                     if e.get("kind") == "kv_handoff_peer_pull"]
            check(any(e.get("peer") == f"http://{predecessor}"
                      for e in pulls),
                  f"recycle: the router's retry carried no x-kfs-kv-peer "
                  f"hint for {predecessor}: {pulls}")
            status, events, _, _ = await asyncio.to_thread(
                sse_stream, port, "/v2/models/gen/generate_stream",
                {"text_input": kill_prompt, "max_tokens": RECYCLE_TOKENS},
                {"x-kfs-kv-peer": f"http://{predecessor}"})
            check(status == 200, f"recycle retry: HTTP {status} {events}")
            streams.append((kill_prompt, stream_tokens(
                events, "recycle retry", RECYCLE_TOKENS)))
            memory["promoted"] = device_used_bytes()
            failover = [e for e in orch.flight_recorder.dump(
                limit=20, pinned_only=True)["pinned"]
                if e.get("kind") == "replica_failover"]
            check(bool(failover) and failover[-1]["outcome"] == "promoted"
                  and failover[-1]["trigger"] == "crash_report",
                  f"recycle: failover pins {failover}")
            out.update(ttft0=ttft0, ttft1=ttft1, failover=failover[-1],
                       breakdown=orch.swap_breakdown[0],
                       adopted=adopted, peer_pulls=pulls,
                       trigger=failover[-1]["trigger"])
            return out
        finally:
            await router.stop_async()
            await orch.shutdown()

    try:
        out = asyncio.run(run())
        left = set(replica_children()) - earlier
        check(not left, f"recycle: replica processes {left} outlived the "
              f"orchestrator's shutdown")
        memory["after_shutdown"] = device_used_bytes()
        reference, load_s = load_generative("gen", GEN_CONFIG)
        try:
            plain = [check_generation_against_plain(reference, prompt, ids)
                     for prompt, ids in streams]
        finally:
            reference.unload()
    finally:
        for d in (model_dir, kv_dir, trace_dir):
            shutil.rmtree(d, ignore_errors=True)
    gb = 1e-9
    summary = {
        "card": card, "apply_s": out["apply_s"],
        "ttft_turn0": ttft_summary(out["ttft0"]),
        "return_ttft_after_recycle": ttft_summary(out["ttft1"]),
        "swap_ms": {k[:-2] + "_ms": v * 1e3
                    for k, v in out["breakdown"].items()
                    if k.endswith("_s")},
        "swap_mode": out["breakdown"]["mode"],
        "successor_phases_s": out["breakdown"].get("successor_phases"),
        # The warm swap's successor: where its parameters came from (its
        # startup marks) and its standby activation.
        "successor_param_source": param_source_of(
            out["breakdown"].get("successor_phases") or {}),
        "standby_activate_s": out["breakdown"].get("activate_s"),
        "adopted_blocks": out["adopted"],
        "promotion_ms": out["failover"]["phases"].get("total_s", 0) * 1e3,
        "promotion_phases_s": out["failover"]["phases"],
        "promotion_trigger": out["trigger"],
        "kill_to_promoted_ms": out["promoted_s"] * 1e3,
        "router_retries": out["router_retries"],
        "capture": out["capture"],
        "device_used_gb": {k: v * gb for k, v in memory.items()
                           if isinstance(v, int)},
        "per_replica_gb": {
            "incumbent": (memory["incumbent"] - memory["before"]) * gb,
            "overlap_both": (memory.get("overlap", 0) - memory["before"])
            * gb},
        "streams_held": len(plain),
        "min_top1_agreement": min(p["top1_agreement"] for p in plain),
        "max_served_logit_gap": max(p["max_served_logit_gap"]
                                    for p in plain),
        "reference_load_s": load_s,
    }
    print("recycle " + json.dumps(summary), flush=True)
    return summary


# -- the control API, rollout, predictive loop and agent ---------------------
def direct_logits(model, image: np.ndarray) -> torch.Tensor:
    """A served ViT's logits on one image, by its module directly."""
    batch = torch.from_numpy(image[None]).to(model.device)
    with torch.inference_mode():
        return model.module(batch).float()[0]


def answer_kind(logits: torch.Tensor, answer: int, rtol: float) -> str:
    """"exact" when `answer` is the argmax of `logits`, "tie" when it is
    another class within the tie limit of the top score, else ""."""
    if answer == int(logits.argmax()):
        return "exact"
    limit = rtol * float(logits.abs().max())
    if 0 <= answer < logits.numel() and \
            float(logits.max() - logits[answer]) <= limit:
        return "tie"
    return ""


def serve_rollout(card: str, config: dict = VIT_CONFIG,
                  device: str = "cuda") -> dict:
    """Line "rollout": a ServingManager on the card driven only through
    the port's KFServingClient (and once through its CLI in a
    subprocess): ViT-B/16 revisions promoted and rolled back by the
    RolloutManager under open-loop traffic, then a fast burn through the
    PredictiveScaler, its standby pool and the brownout gate."""
    from kfserving_tpu_torch.client import ClientError, KFServingClient
    from kfserving_tpu_torch.control.clusterconfig import ClusterConfig
    from kfserving_tpu_torch.control.manager import ServingManager
    from kfserving_tpu_torch.control.orchestrator import (
        default_model_factory,
    )
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.reliability import faults

    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-rollout-")
    dirs = []
    for rev in range(3):
        d = os.path.join(root, f"rev{rev + 1}")
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        dirs.append(d)
    # Each revision serves its own seeded weights.
    seeds = {f"file://{d}": 100 + i for i, d in enumerate(dirs)}
    engines, builds, adopts = [], [], []
    cid = "default/vitroll/predictor"

    def factory(component_id, spec):
        model = default_model_factory(component_id, spec, device=device)
        model.init_seed = seeds[spec.storage_uri]
        return model

    cfg = ClusterConfig()
    cfg.autoscaler.tick_seconds = ROLLOUT_TICK_S
    cfg.autoscaler.predictive_windows_s = list(ROLLOUT_WINDOWS_S)
    cfg.autoscaler.exit_ticks = ROLLOUT_EXIT_TICKS
    saved = os.environ.get("KFS_SLO_OBJECTIVES")
    set_env({"KFS_SLO_OBJECTIVES": json.dumps({"vitroll": ROLLOUT_SLO})})

    async def run():
        manager = ServingManager(cluster_config=cfg, orchestrator="inprocess",
                                 control_port=0, ingress_port=0,
                                 host="127.0.0.1", device=device)
        orch = manager.orchestrator
        orch.model_factory = factory
        manager.rollouts.tick_seconds = ROLLOUT_TICK_S
        build, adopt = orch._build_replica, orch.adopt_standby

        async def timed_build(*args, **kwargs):
            t0 = time.perf_counter()
            replica = await build(*args, **kwargs)
            builds.append(round((time.perf_counter() - t0) * 1e3, 1))
            # Every replica's engine, kept past its teardown: its warmup
            # and served batches all count.
            engines.append(replica.handle.repository.get_model(
                "vitroll").engine)
            return replica

        async def timed_adopt(*args, **kwargs):
            t0 = time.perf_counter()
            replica = await adopt(*args, **kwargs)
            if replica is not None:
                adopts.append(round((time.perf_counter() - t0) * 1e3, 3))
            return replica

        orch._build_replica, orch.adopt_standby = timed_build, timed_adopt
        await manager.start_async()
        control = f"http://127.0.0.1:{manager.api.http_port}"
        client = KFServingClient(
            control, f"http://127.0.0.1:{manager.router.http_port}")
        out = {"requests": [], "direct": {}}
        label = {"phase": "rev1"}
        stop = asyncio.Event()

        def spec(d):
            return {"name": "vitroll", "predictor": {
                "framework": "jax", "storage_uri": f"file://{d}",
                "min_replicas": 1, "max_replicas": 1,
                "container_concurrency": ROLLOUT_CONCURRENCY,
                "rollout": ROLLOUT_POLICY}}

        async def one(image):
            phase = label["phase"]
            try:
                resp = await client.predict_binary(
                    "vitroll", {"input_0": image[None]})
                status, answer = 200, int(resp["outputs"][0]["data"][0])
            except ClientError as e:
                status, answer = e.status, e.message[:200]
            out["requests"].append((phase, status, answer))

        async def traffic(image):
            loop = asyncio.get_running_loop()
            t0, i, pending = loop.time(), 0, set()
            while not stop.is_set():
                await asyncio.sleep(max(0.0, t0 + i / ROLLOUT_RATE
                                        - loop.time()))
                task = asyncio.ensure_future(one(image))
                pending.add(task)
                task.add_done_callback(pending.discard)
                i += 1
            await asyncio.gather(*pending)

        def live(revision):
            return [r for r in orch.replicas(cid) if r.revision == revision]

        async def finished(revision, phase):
            def done():
                return any(h["revision"] == revision and h["phase"] == phase
                           for h in manager.rollouts.report()["history"])
            await wait_until(done, f"rollout: {revision} {phase}",
                             ROLLOUT_WAIT_S)
            body = await client.rollouts()
            return next(h for h in body["history"]
                        if h["revision"] == revision and h["phase"] == phase)

        traffic_task = None
        try:
            t0 = time.perf_counter()
            created = await client.create(spec(dirs[0]))
            await client.wait_isvc_ready("vitroll", timeout_seconds=300)
            out["first_apply_s"] = time.perf_counter() - t0
            rev1 = created["status"]["components"]["predictor"][
                "latest_revision"]
            model1 = live(rev1)[0].handle.repository.get_model("vitroll")
            mcfg = model1.module.config
            out["layers"] = mcfg.num_layers
            out["shape"] = (mcfg.num_layers, mcfg.hidden_size, mcfg.seq_len)
            image = np.round(bench_images(
                np.random.default_rng(31), 1, mcfg.image_size)[0]
                .astype(np.float32) / 255.0, 3)
            out["direct"][rev1] = direct_logits(model1, image)
            # The main path's run: the count starts at 0 here, and every
            # ViT built from now on counts its batches from its start.
            flash_attention.launches = 0
            executed0 = sum(e.execute_count for e in engines)
            traffic_task = asyncio.ensure_future(traffic(image))
            await asyncio.sleep(1.0)

            # Revision 2: warms, steps and promotes with no operator call.
            label["phase"] = "rev2"
            t0 = time.perf_counter()
            created = await client.create(spec(dirs[1]))
            rev2 = created["status"]["components"]["predictor"][
                "latest_revision"]
            check(rev2 != rev1, "rollout: revision 2 minted no revision")
            model2 = live(rev2)[0].handle.repository.get_model("vitroll")
            out["direct"][rev2] = direct_logits(model2, image)
            promoted = await finished(rev2, "promoted")
            out["promote_s"] = time.perf_counter() - t0
            out["rev2_events"] = promoted["events"]

            # Revision 3 fails every infer (a dataplane.infer fault
            # matched to its revision): rolled back, quarantined, its
            # pinned errors kept as evidence.
            label["phase"] = "rev3"
            created = await client.create(spec(dirs[2]))
            rev3 = created["status"]["components"]["predictor"][
                "latest_revision"]
            faults.configure({"dataplane.infer": {
                "error_rate": 1.0, "match": f"revision:{rev3}"}})
            out["rev3_record"] = await finished(rev3, "rolled_back")
            faults.reset()
            got = await client.get("vitroll")
            pstatus = got["status"]["components"]["predictor"]
            out["after_rollback"] = {
                "traffic": [[t["revision"], t["percent"]]
                            for t in pstatus["traffic"]],
                "replicas": sorted(r.revision for r in orch.replicas(cid))}
            out["quarantine"] = (await client.rollouts())["quarantine"]
            # The identical spec again: the quarantine holds it.
            label["phase"] = "reapply"
            again = (await client.create(spec(dirs[2])))["status"][
                "components"]["predictor"]
            await asyncio.sleep(4 * ROLLOUT_TICK_S)
            out["reapply"] = {
                "quarantined_revision": again["quarantined_revision"],
                "traffic": [[t["revision"], t["percent"]]
                            for t in again["traffic"]],
                "active": manager.rollouts.report()["active"],
                "replicas": sorted(r.revision for r in orch.replicas(cid))}
            label["phase"] = "steady"
            res = await asyncio.to_thread(subprocess.run, [
                sys.executable, "-m", "kfserving_tpu_torch.client",
                "--control-url", control, "get", "vitroll"],
                capture_output=True, text=True, timeout=120)
            check(res.returncode == 0, f"rollout: the CLI's get exited "
                  f"{res.returncode}: {res.stderr[-2000:]}")
            cli = json.loads(res.stdout)
            out["cli"] = {"ready": cli["status"]["ready"],
                          "latest_revision": cli["status"]["components"][
                              "predictor"]["latest_revision"]}

            # The burn: every infer slowed past the objective while the
            # service is capped at one replica, so the loop can only
            # pre-arm and shed; then the cap is lifted through the client
            # and the autoscaler's scale-up adopts the armed standby.
            label["phase"] = "burn"
            builds0 = len(builds)
            faults.configure({"dataplane.infer": {
                "latency_ms": ROLLOUT_BURN_MS, "match": "vitroll"}})
            t0 = time.perf_counter()
            await wait_until(
                lambda: (orch.standby_count(cid) >= 1
                         and manager.brownout.level("vitroll") >= 1),
                "predictive: an armed standby and brownout", ROLLOUT_WAIT_S)
            out["arm_and_brownout_s"] = time.perf_counter() - t0
            out["standby_target"] = orch.standby_target(cid)
            out["standbys_armed"] = orch.standby_count(cid)
            await client.patch("vitroll", {"predictor": {"max_replicas": 2}})
            await wait_until(lambda: len(orch.replicas(cid)) >= 2,
                             "predictive: the scale-up", ROLLOUT_WAIT_S)
            out["adoptions"] = orch.standby_adoptions
            # A cold spawn on the scale-up would be one build more than
            # the pool's arming builds.
            out["burn_builds"] = len(builds) - builds0
            label["phase"] = "recover"
            faults.reset()
            t0 = time.perf_counter()
            await wait_until(lambda: manager.brownout.level("vitroll") == 0,
                             "predictive: brownout exit", ROLLOUT_WAIT_S)
            out["exit_s"] = time.perf_counter() - t0
            pred = manager.predictive
            out["decisions"] = [(d["kind"], d.get("action"))
                                for d in pred.decisions]
            out["pre_arm"] = next(d for d in pred.decisions
                                  if d.get("action") == "pre_arm")
            stop.set()
            await traffic_task
            traffic_task = None
            out["batches"] = sum(e.execute_count
                                 for e in engines) - executed0
            # Less revision 2's direct forward (one K1 launch a layer),
            # the comparison's, not the main path's.
            out["launches"] = flash_attention.launches - (
                out["layers"] if device == "cuda" else 0)
            return out
        finally:
            stop.set()
            if traffic_task is not None:
                await asyncio.gather(traffic_task, return_exceptions=True)
            faults.reset()
            await client.close()
            await manager.stop_async()

    try:
        out = asyncio.run(run())
    finally:
        if saved is None:
            os.environ.pop("KFS_SLO_OBJECTIVES", None)
        else:
            os.environ["KFS_SLO_OBJECTIVES"] = saved
        shutil.rmtree(root, ignore_errors=True)

    # Every answer is one revision's direct forward (a counted near-tie
    # aside); only the failing canary answers 500, only brownout 503.
    allowed = {"rev3": (500,), "burn": (503,), "recover": (503,)}
    ties, statuses = 0, {}
    for phase, status, answer in out["requests"]:
        counts = statuses.setdefault(phase, {})
        counts[status] = counts.get(status, 0) + 1
        if status != 200:
            check(status in allowed.get(phase, ()),
                  f"rollout {phase}: HTTP {status} {answer}")
            continue
        kinds = [answer_kind(logits, answer, VIT_LOGIT_RTOL)
                 for logits in out["direct"].values()]
        check(any(kinds), f"rollout {phase}: answer {answer} is no "
              f"revision's direct forward")
        ties += "exact" not in kinds
    rev1, rev2 = list(out["direct"])
    events = out["rev2_events"]
    steps = [e for e in events if e["event"] == "step"]
    check([e["percent"] for e in steps] == ROLLOUT_POLICY["steps"],
          f"rollout: revision 2 stepped {[e['percent'] for e in steps]}")
    ends = steps[1:] + [e for e in events if e["event"] == "promoted"]
    holds = [round(b["ts"] - a["ts"], 3) for a, b in zip(steps, ends)]
    record = out["rev3_record"]
    rev3 = record["revision"]
    first_step = next(e for e in record["events"] if e["event"] == "step")
    reverted = next(e for e in record["events"]
                    if e["event"] == "rolled_back")
    check(record["reason"] in ("error_ratio", "slo_breach"),
          f"rollout: revision 3 rolled back for {record['reason']}")
    check(any(e.get("pinned") == "error" for e in record["evidence"]),
          f"rollout: no pinned error evidence in {record['evidence'][:3]}")
    check(out["after_rollback"] == {"traffic": [[rev2, 100]],
                                    "replicas": [rev2]},
          f"rollout: after the rollback {out['after_rollback']}")
    check(rev3 in out["quarantine"].get(cid, {}),
          f"rollout: quarantine {out['quarantine']}")
    check(out["reapply"] == {"quarantined_revision": rev3,
                             "traffic": [[rev2, 100]], "active": [],
                             "replicas": [rev2]},
          f"rollout: the identical re-apply re-rolled {out['reapply']}")
    check(out["cli"] == {"ready": True, "latest_revision": rev2},
          f"rollout: the CLI's get {out['cli']}")
    actions = {a for _, a in out["decisions"]}
    check({"pre_arm", "brownout_enter", "brownout_exit"} <= actions,
          f"rollout: predictive decisions {out['decisions']}")
    check(out["adoptions"] >= 1 and adopts,
          f"rollout: the scale-up adopted {out['adoptions']} standbys")
    check(out["burn_builds"] <= out["standby_target"],
          f"rollout: {out['burn_builds']} builds for a standby target of "
          f"{out['standby_target']}: the scale-up spawned cold")
    layers = out["layers"]
    if device == "cuda":
        check(out["shape"] == (12, 768, 197), "rollout: not ViT-B/16")
        check(out["batches"] > 0
              and out["launches"] == layers * out["batches"],
              f"rollout: flash kernel launched {out['launches']} times for "
              f"{out['batches']} predictor batches of {layers} layers")
    summary = {
        "card": card, "first_apply_s": out["first_apply_s"],
        "requests": len(out["requests"]), "statuses": statuses,
        "near_tie_answers": ties, "revisions": [rev1, rev2, rev3],
        "apply_to_promoted_s": out["promote_s"],
        "step_percents": [e["percent"] for e in steps],
        "step_holds_s": holds,
        "rev3_reason": record["reason"],
        "fault_to_revert_ms": round(
            (reverted["ts"] - first_step["ts"]) * 1e3, 1),
        "evidence": len(record["evidence"]),
        "arm_and_brownout_s": out["arm_and_brownout_s"],
        "standby_target": out["standby_target"],
        "pre_arm": {k: out["pre_arm"].get(k) for k in (
            "arrival_per_s", "service_ms", "required", "predicted_gap")},
        "adopt_ms": adopts, "build_ms": builds,
        "adoptions": out["adoptions"], "brownout_exit_s": out["exit_s"],
        "decisions": sorted(a for a in actions if a),
        "predictor_batches": out["batches"],
        "flash_launches": out["launches"],
    }
    print("rollout " + json.dumps(summary), flush=True)
    return summary


class CloudEventSink:
    """A stdlib HTTP CloudEvents sink in a thread: every POST's headers
    and body are kept."""

    def __init__(self):
        import http.server
        import threading

        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                received.append(({k.lower(): v for k, v in
                                  self.headers.items()}, body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def serve_agent(card: str, config: dict = RES_CONFIG,
                device: str = "cuda") -> dict:
    """Line "agent": BERT-base TrainedModels applied through the client
    land in a multi-model replica built with --config_dir and --log_url,
    through its watcher, puller and downloader; one is deleted and
    unloads; a stdlib sink gets every payload as CloudEvents."""
    from kfserving_tpu_torch.agent.logger import (
        CE_TYPE_REQUEST,
        CE_TYPE_RESPONSE,
    )
    from kfserving_tpu_torch.client import KFServingClient, isvc_spec
    from kfserving_tpu_torch.control.clusterconfig import ClusterConfig
    from kfserving_tpu_torch.control.manager import ServingManager
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.predictors.jaxserver import __main__ as jaxserver

    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-agent-")
    names = [f"tm{i}" for i in range(AGENT_MODELS)]
    sources = {}
    for name in names:
        d = os.path.join(root, "src", name)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        sources[name] = d
    models_dir = os.path.join(root, "models")
    os.makedirs(models_dir)
    cfg = ClusterConfig()
    cfg.modelconfig_dir = os.path.join(root, "modelconfig")
    sink = CloudEventSink()

    async def run():
        manager = ServingManager(cluster_config=cfg, orchestrator="inprocess",
                                 control_port=0, ingress_port=0,
                                 host="127.0.0.1", device=device)
        await manager.start_async()
        client = KFServingClient(f"http://127.0.0.1:{manager.api.http_port}")
        server = None
        out = {"apply_ms": {}, "first_predict_ms": {}, "sent": [],
               "direct": {}, "batches": {}, "direct_forwards": 0}
        try:
            await client.create(isvc_spec(
                "bertmm", "jax", f"file://{models_dir}", multi_model=True,
                hbm_budget_bytes=AGENT_MODELS * AGENT_MODEL_BYTES))
            args = jaxserver.parser.parse_args([
                "--model_dir", models_dir, "--config_dir",
                os.path.join(cfg.modelconfig_dir,
                             "default-bertmm-shard-0.json"),
                "--log_url", sink.url, "--http_port", "0",
                "--device", device])
            server = jaxserver.build_server(args)
            watcher, puller, request_logger = server.services[-3:]
            watcher.poll_interval = AGENT_POLL_S
            await server.start_async([], host="127.0.0.1")
            repo, port = server.repository, server.http_port
            rng = np.random.default_rng(41)
            # The main path's run: the count starts at 0 here; every
            # batch of the phase (cold-fault warmups included) runs K1 in
            # each layer.
            flash_attention.launches = 0
            for i, name in enumerate(names):
                t0 = time.perf_counter()
                applied = await client.create_trained_model({
                    "name": name, "inference_service": "bertmm",
                    "storage_uri": f"file://{sources[name]}",
                    "memory_bytes": AGENT_MODEL_BYTES})
                check(applied["shard"] == 0, f"agent: {name} on shard "
                      f"{applied['shard']}")
                await wait_until(lambda: repo.is_model_ready(name),
                                 f"agent: {name} loaded", ROLLOUT_WAIT_S)
                out["apply_ms"][name] = round(
                    (time.perf_counter() - t0) * 1e3, 1)
                # Registered, not built: its first predict inits these.
                repo.get_model(name).init_seed = 200 + i
            spec = create_model(config["architecture"],
                                **(config.get("arch_kwargs") or {}))
            vocab = spec.module.config.vocab_size
            layers = spec.module.config.num_layers
            for name in names:
                for r in range(AGENT_PREDICTS):
                    ids = rng.integers(1, vocab, size=AGENT_LENGTH).tolist()
                    body = json.dumps({"instances": [ids]}).encode()
                    t0 = time.perf_counter()
                    status, _, data = await asyncio.to_thread(
                        http_raw, port, "POST", f"/v1/models/{name}:predict",
                        body, {"content-type": "application/json"})
                    ms = (time.perf_counter() - t0) * 1e3
                    check(status == 200, f"agent {name}: HTTP {status} "
                          f"{data[:300]}")
                    if r == 0:
                        out["first_predict_ms"][name] = round(ms, 1)
                    out["sent"].append((name, body, data))
                    model = repo.get_model(name)
                    seq = model.engine.seq_buckets.fit(AGENT_LENGTH)
                    pred = json.loads(data)["predictions"][0]
                    check_topk(pred["values"], pred["indices"], seq, vocab,
                               f"agent {name}")
                    want = direct_topk(model, ids, f"b1s{seq}")
                    out["direct_forwards"] += 1
                    diff = float(np.abs(np.subtract(
                        pred["values"], want["values"])).max())
                    check(pred["indices"] == want["indices"]
                          and diff <= MAX_LOGIT_DIFF,
                          f"agent {name}: served top-5 differs from the "
                          f"direct forward (scores by {diff})")
                    out["direct"][name] = max(out["direct"].get(name, 0.0),
                                              diff)
            out["param_sources"] = {n: repo.get_model(n).param_source
                                    for n in names}
            for name in names:
                out["batches"][name] = repo.get_model(
                    name).engine.execute_count
            # Deleting a TrainedModel unloads it from the replica.
            gone = names[1]
            t0 = time.perf_counter()
            await client.delete_trained_model(gone)
            await wait_until(lambda: repo.get_model(gone) is None,
                             f"agent: {gone} unloaded", ROLLOUT_WAIT_S)
            out["unload_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            body = json.dumps({"instances": [[1, 2, 3]]}).encode()
            status, _, data = await asyncio.to_thread(
                http_raw, port, "POST", f"/v1/models/{gone}:predict", body,
                {"content-type": "application/json"})
            check(status == 404, f"agent: {gone} still answers {status}")
            out["sent"].append((gone, body, data))
            # Less the direct forwards' launches (one a layer each), the
            # comparison's, not the main path's.
            out["launches"] = flash_attention.launches - (
                layers * out["direct_forwards"] if device == "cuda" else 0)
            out["layers"] = layers
            await asyncio.wait_for(request_logger.queue.join(), 60)
            out["logger"] = request_logger.stats()
            out["puller"] = puller.stats()
            return out
        finally:
            if server is not None:
                await server.stop_async()
                for model in list(server.repository.get_models()):
                    model.unload()
            await client.close()
            await manager.stop_async()

    try:
        out = asyncio.run(run())
        events = list(sink.received)
    finally:
        sink.close()
        shutil.rmtree(root, ignore_errors=True)
    sent = out["sent"]
    check(len(events) == 2 * len(sent) and out["logger"]["dropped"] == 0
          and out["logger"]["failed"] == 0,
          f"agent: {len(events)} events for {len(sent)} predicts, logger "
          f"{out['logger']}")
    pairs = {}
    for headers, body in events:
        pairs.setdefault(headers["ce-id"], {})[headers["ce-type"]] = (
            headers, body)
    check(len(pairs) == len(sent) and all(
        set(p) == {CE_TYPE_REQUEST, CE_TYPE_RESPONSE}
        for p in pairs.values()),
        f"agent: {len(pairs)} paired event ids for {len(sent)} predicts")
    got = sorted((p[CE_TYPE_REQUEST][0]["ce-model"], p[CE_TYPE_REQUEST][1],
                  p[CE_TYPE_RESPONSE][1]) for p in pairs.values())
    check(got == sorted(sent), "agent: the sink's request/response bodies "
          "differ from what went over the wire")
    batches = sum(out["batches"].values())
    if device == "cuda":
        check(batches > 0 and out["launches"] == out["layers"] * batches,
              f"agent: flash kernel launched {out['launches']} times for "
              f"{batches} batches of {out['layers']} layers")
    summary = {
        "card": card, "models": len(names),
        "apply_to_ready_ms": out["apply_ms"],
        "first_predict_ms": out["first_predict_ms"],
        "param_sources": out["param_sources"],
        "max_score_diff_vs_direct": out["direct"],
        "unload_ms": out["unload_ms"], "predicts": len(sent),
        "events": len(events), "logger": out["logger"],
        "puller": out["puller"], "batches": batches,
        "flash_launches": out["launches"],
    }
    print("agent " + json.dumps(summary), flush=True)
    return summary


# -- tabular predictors, the torchserver, payload detectors -------------------
# Tree ensembles at the frameworks' default sizes: XGBoost's n_estimators
# 100 and max_depth 6, LightGBM's num_leaves 31, over the 28 features of
# HIGGS (the dataset of LightGBM's published experiments).
TABULAR_SEED = 61
TABULAR_TREES, TABULAR_DEPTH, TABULAR_FEATURES = 100, 6, 28
TABULAR_LGB_LEAVES = 31
TABULAR_PMML_DEPTH = 6
TABULAR_REQUESTS, TABULAR_CONCURRENCY = 64, 8
TABULAR_ROWS = (1, 64)
# KFServing's PyTorch sample and e2e test model (docs/samples/v1alpha2/
# pytorch/cifar10.py): the CIFAR-10 Net, 3 x 32 x 32 inputs, 10 classes.
CIFAR10_NET = '''import torch
import torch.nn as nn
import torch.nn.functional as F


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.pool = nn.MaxPool2d(2, 2)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(16 * 5 * 5, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, 10)

    def forward(self, x):
        x = self.pool(F.relu(self.conv1(x)))
        x = self.pool(F.relu(self.conv2(x)))
        x = x.view(-1, 16 * 5 * 5)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)
'''
TORCHSERVER_SEED = 67
TORCHSERVER_BATCHES = (1, 16)
TORCHSERVER_REQUESTS, TORCHSERVER_CONCURRENCY = 64, 8
# The served fp32 Net on the card against its CPU copy (TF32 off).
TORCHSERVER_RTOL, TORCHSERVER_ATOL = 1e-4, 1e-5
# Detectors: a 2000 x 28 reference; 256 one-row requests, the last 64
# shifted by 3 sigma in 4 features.
DETECTOR_SEED = 71
DETECTOR_REFERENCE = 2000
DETECTOR_REQUESTS, DETECTOR_SHIFTED = 256, 64
DETECTOR_SHIFT, DETECTOR_SHIFTED_FEATURES = 3.0, 4
DETECTOR_WAIT_S = 30.0


def xgb_ensemble(rng, trees: int = TABULAR_TREES, depth: int = TABULAR_DEPTH,
                 features: int = TABULAR_FEATURES,
                 objective: str = "binary:logistic") -> dict:
    """An xgboost JSON model (``save_model``'s schema) of ``trees`` full
    binary trees with ``depth`` levels of splits, seeded."""
    internal, nodes = 2 ** depth - 1, 2 ** (depth + 1) - 1
    out = []
    for _ in range(trees):
        feature = rng.integers(0, features, nodes)
        feature[internal:] = 0
        condition = rng.normal(size=nodes)
        condition[internal:] = rng.normal(scale=0.1, size=nodes - internal)
        out.append({
            "split_indices": feature.tolist(),
            "split_conditions": condition.tolist(),
            "left_children": [2 * i + 1 if i < internal else -1
                              for i in range(nodes)],
            "right_children": [2 * i + 2 if i < internal else -1
                               for i in range(nodes)],
            "default_left": rng.integers(0, 2, nodes).tolist(),
            "base_weights": [0.0] * nodes})
    return {"learner": {
        "gradient_booster": {"name": "gbtree", "model": {
            "trees": out, "tree_info": [0] * trees}},
        "learner_model_param": {"base_score": "0.5", "num_class": "0",
                                "num_feature": str(features)},
        "objective": {"name": objective}}, "version": [2, 0, 0]}


def lgb_ensemble_text(rng, trees: int = TABULAR_TREES,
                      leaves: int = TABULAR_LGB_LEAVES,
                      features: int = TABULAR_FEATURES,
                      objective: str = "binary sigmoid:1") -> str:
    """A LightGBM text model (``save_model``'s format) of ``trees`` trees,
    each grown to ``leaves`` leaves by splitting a random leaf a step;
    numerical splits with NaN as the missing value; seeded."""
    blocks = []
    for t in range(trees):
        feat, thresh, dtype, left, right = [], [], [], [], []
        parent = {0: None}          # leaf -> (internal node, side)
        for n in range(1, leaves):
            leaf, k = int(rng.integers(0, n)), len(feat)
            feat.append(int(rng.integers(0, features)))
            thresh.append(float(rng.normal()))
            # missing type NaN (2 << 2); the default-left bit at random
            dtype.append(8 | 2 * int(rng.integers(0, 2)))
            left.append(~leaf)
            right.append(~n)
            if parent[leaf] is not None:
                node, side = parent[leaf]
                (left if side == 0 else right)[node] = k
            parent[leaf], parent[n] = (k, 0), (k, 1)
        values = rng.normal(scale=0.1, size=leaves)
        blocks.append("\n".join([
            f"Tree={t}", f"num_leaves={leaves}", "num_cat=0",
            "split_feature=" + " ".join(map(str, feat)),
            "threshold=" + " ".join(map(repr, thresh)),
            "decision_type=" + " ".join(map(str, dtype)),
            "left_child=" + " ".join(map(str, left)),
            "right_child=" + " ".join(map(str, right)),
            "leaf_value=" + " ".join(map(repr, values.tolist())),
            "shrinkage=1", ""]))
    head = ["tree", "version=v4", "num_class=1",
            "num_tree_per_iteration=1", "label_index=0",
            f"max_feature_idx={features - 1}", f"objective={objective}",
            "feature_names=" + " ".join(f"f{i}" for i in range(features)),
            ""]
    return "\n".join(head + blocks + ["end of trees", ""])


def pmml_tree_xml(rng, depth: int = TABULAR_PMML_DEPTH,
                  features: int = TABULAR_FEATURES) -> str:
    """A PMML 4.4 TreeModel classifier: a full binary tree of ``depth``
    levels, each split a lessThan / greaterOrEqual pair on one field,
    each leaf a score with a two-class ScoreDistribution; seeded."""
    names = [f"x{i}" for i in range(features)]

    def node(level: int, predicate: str) -> str:
        if level == depth:
            counts = rng.integers(1, 100, 2)
            return (f'<Node score="{"ab"[int(np.argmax(counts))]}">'
                    f'{predicate}<ScoreDistribution value="a" '
                    f'recordCount="{counts[0]}"/><ScoreDistribution '
                    f'value="b" recordCount="{counts[1]}"/></Node>')
        field = names[int(rng.integers(0, features))]
        value = repr(float(rng.normal()))
        return (f'<Node score="a">{predicate}'
                + node(level + 1, f'<SimplePredicate field="{field}" '
                       f'operator="lessThan" value="{value}"/>')
                + node(level + 1, f'<SimplePredicate field="{field}" '
                       f'operator="greaterOrEqual" value="{value}"/>')
                + "</Node>")

    fields = "".join(f'<DataField name="{n}" optype="continuous" '
                     f'dataType="double"/>' for n in names)
    mining = "".join(f'<MiningField name="{n}"/>' for n in names)
    return ('<?xml version="1.0"?>\n'
            '<PMML xmlns="http://www.dmg.org/PMML-4_4" version="4.4">'
            f'<DataDictionary numberOfFields="{features + 1}">{fields}'
            '<DataField name="class" optype="categorical" '
            'dataType="string"/></DataDictionary>'
            '<TreeModel modelName="t" functionName="classification">'
            f'<MiningSchema>{mining}<MiningField name="class" '
            'usageType="target"/></MiningSchema>'
            + node(0, "<True/>") + "</TreeModel></PMML>\n")


def write_tabular_artifacts(root: str, seed: int = TABULAR_SEED) -> dict:
    """{server: model dir} holding the seeded xgboost, LightGBM and PMML
    artifacts."""
    rng = np.random.default_rng(seed)
    files = {"xgb": ("model.json", json.dumps(xgb_ensemble(rng))),
             "lgb": ("model.txt", lgb_ensemble_text(rng)),
             "pmml": ("model.pmml", pmml_tree_xml(rng))}
    dirs = {}
    for name, (filename, text) in files.items():
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        with open(os.path.join(dirs[name], filename), "w") as f:
            f.write(text)
    return dirs


def load_tabular_models(dirs: dict) -> dict:
    """{server: (the port's predictor on its dir, loaded; the evaluator's
    direct predict(rows) that its answers must equal)}."""
    from kfserving_tpu_torch.predictors.lgbserver import LightGBMModel
    from kfserving_tpu_torch.predictors.pmml_eval import (
        PMMLModel as NativePMML,
    )
    from kfserving_tpu_torch.predictors.pmmlserver import PMMLModel
    from kfserving_tpu_torch.predictors.trees import (
        LightGBMEnsemble,
        XGBoostEnsemble,
    )
    from kfserving_tpu_torch.predictors.xgbserver import XGBoostModel

    xgb = XGBoostEnsemble.from_file(os.path.join(dirs["xgb"], "model.json"))
    lgb = LightGBMEnsemble.from_file(os.path.join(dirs["lgb"], "model.txt"))
    pmml = NativePMML(os.path.join(dirs["pmml"], "model.pmml"))
    out = {"xgb": (XGBoostModel("xgb", dirs["xgb"]), xgb.predict),
           "lgb": (LightGBMModel("lgb", dirs["lgb"]), lgb.predict),
           "pmml": (PMMLModel("pmml", dirs["pmml"]),
                    lambda rows: [list(r.values())
                                  for r in pmml.predict(rows)])}
    for name, (model, _) in out.items():
        model.load()
        # This machine has no xgboost, lightgbm or pypmml: each predictor
        # must have taken its native evaluator.
        check(model._native is not None,
              f"tabular {name}: loaded through a framework library, not "
              f"the native evaluator")
    return out


def latency_summary(latencies, wall_s: float) -> dict:
    return {"req_per_s": len(latencies) / wall_s,
            "p50_ms": percentile(latencies, 0.5),
            "p99_ms": percentile(latencies, 0.99)}


def tabular_requests(name: str, batches, wire: str) -> list:
    """One request per batch of rows: V1 JSON instances, or one V2
    binary FP32 tensor."""
    from kfserving_tpu_torch.protocol.v2 import make_binary_request

    out = []
    for rows in batches:
        if wire == "v1":
            out.append((f"/v1/models/{name}:predict",
                        json.dumps({"instances": rows.tolist()}).encode(),
                        {"content-type": "application/json"}))
        else:
            body, hlen = make_binary_request({"input_0": rows})
            out.append((f"/v2/models/{name}/infer", body,
                        {"content-type": "application/octet-stream",
                         "inference-header-content-length": str(hlen)}))
    return out


def serve_tabular(card: str) -> dict:
    """Line "tabular": the port's xgb, lgb and pmml servers over HTTP on
    seeded artifacts; every served answer equals its evaluator's direct
    predict on the same rows; req/s and p50/p99 at concurrency 8 for
    1-row and 64-row requests on V1 JSON and V2 binary, after one
    untimed request per arm."""
    from kfserving_tpu_torch.protocol.v2 import make_response
    from kfserving_tpu_torch.server.app import ModelServer

    print("tabular: the sklearn server is tested on the CPU only (this "
          "machine has no sklearn or joblib to load its artifact)",
          flush=True)
    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-tabular-")
    rng = np.random.default_rng(TABULAR_SEED + 1)
    try:
        models = load_tabular_models(write_tabular_artifacts(root))

        async def run():
            server = ModelServer(http_port=0)
            await server.start_async([m for m, _ in models.values()],
                                     host="127.0.0.1")
            out = {}
            try:
                for name, (_, direct) in models.items():
                    for rows in TABULAR_ROWS:
                        # float32 rows: a V1 JSON body parses to float32
                        # on the server, as the binary wire carries it.
                        batches = [rng.normal(size=(rows, TABULAR_FEATURES))
                                   .astype(np.float32)
                                   for _ in range(TABULAR_REQUESTS + 1)]
                        wants = [direct(x) for x in batches]
                        for wire in ("v1", "v2_binary"):
                            requests = tabular_requests(name, batches, wire)
                            # The first request of each arm warms its
                            # path and is not timed.
                            first, _, _ = await drive_requests(
                                server.http_port, requests[:1], 1)
                            results, lat, wall = await drive_requests(
                                server.http_port, requests[1:],
                                TABULAR_CONCURRENCY)
                            for i, ((status, data), want) in enumerate(
                                    zip(first + results, wants)):
                                check(status == 200,
                                      f"tabular {name} {wire} request {i}: "
                                      f"HTTP {status} {data[:200]!r}")
                                if wire == "v1":
                                    got = json.loads(data)["predictions"]
                                    want = (want.tolist() if isinstance(
                                        want, np.ndarray) else want)
                                else:
                                    got = json.loads(data)["outputs"][0]
                                    want = make_response(name, {
                                        "output_0": np.asarray(want)}
                                    )["outputs"][0]
                                check(got == want,
                                      f"tabular {name} {wire} request "
                                      f"{i}: the served answer differs "
                                      f"from the evaluator's")
                            out[f"{name}_{wire}_rows{rows}"] = \
                                latency_summary(lat, wall)
            finally:
                await server.stop_async()
            return out

        arms = asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = {"card": card, "features": TABULAR_FEATURES,
               "xgb": {"trees": TABULAR_TREES, "depth": TABULAR_DEPTH},
               "lgb": {"trees": TABULAR_TREES,
                       "leaves": TABULAR_LGB_LEAVES},
               "pmml": {"depth": TABULAR_PMML_DEPTH},
               "requests_per_arm": TABULAR_REQUESTS,
               "concurrency": TABULAR_CONCURRENCY,
               "evaluators": "native", "answers_equal_direct": True,
               "arms": arms}
    print("tabular " + json.dumps(summary), flush=True)
    return summary


def serve_torchserver(card: str, device: str = "cuda") -> dict:
    """Line "torchserver": the CIFAR-10 Net of KFServing's PyTorch sample
    (class file and seeded ``model.pt`` written here) served by the
    port's torchserver with ``--device cuda``: its parameters on the
    card; 64 V1 requests each of 1 and 16 images at concurrency 8 (after
    one untimed request each), every
    answer equal to the module called directly on the card and within
    TORCHSERVER_RTOL / _ATOL of its CPU copy; p50/p99, req/s and one b16
    forward's CUDA-event ms."""
    import importlib.util

    from kfserving_tpu_torch.predictors.torchserver import __main__ as ts

    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-torchserver-")
    try:
        with open(os.path.join(root, "cifar10.py"), "w") as f:
            f.write(CIFAR10_NET)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_cifar10", os.path.join(root, "cifar10.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.manual_seed(TORCHSERVER_SEED)
        cpu_net = module.Net().eval()
        torch.save(cpu_net.state_dict(), os.path.join(root, "model.pt"))
        args, _ = ts.parser.parse_known_args([
            "--model_name", "cifar10", "--model_dir", root,
            "--model_class_name", "Net", "--device", device])
        model = ts.PyTorchModel(args.model_name, args.model_dir,
                                args.model_class_name, device=args.device)
        t0 = time.perf_counter()
        model.load()
        load_ms = (time.perf_counter() - t0) * 1e3
        net = model._model
        devices = {p.device.type for p in net.parameters()}
        check(devices == {torch.device(device).type},
              f"torchserver: parameters on {devices}")
        rng = np.random.default_rng(TORCHSERVER_SEED)

        async def run(port):
            out = {}
            for b in TORCHSERVER_BATCHES:
                images = [rng.normal(size=(b, 3, 32, 32)).astype(np.float32)
                          for _ in range(TORCHSERVER_REQUESTS + 1)]
                requests = [("/v1/models/cifar10:predict",
                             json.dumps({"instances": x.tolist()}).encode(),
                             {"content-type": "application/json"})
                            for x in images]
                # The first request (cuDNN's first call at this shape) is
                # not timed.
                first, _, _ = await drive_requests(port, requests[:1], 1)
                results, lat, wall = await drive_requests(
                    port, requests[1:], TORCHSERVER_CONCURRENCY)
                out[b] = (first + results, images, lat, wall)
            return out

        arms = {}
        # Every answer against the module called directly, once the
        # requests are over.
        for b, (results, images, lat, wall) in asyncio.run(
                serve_over_http(model, run)).items():
            worst = 0.0
            for i, ((status, data), x) in enumerate(zip(results, images)):
                check(status == 200, f"torchserver b{b} request {i}: "
                      f"HTTP {status} {data[:200]!r}")
                got = torch.tensor(json.loads(data)["predictions"],
                                   dtype=torch.float32)
                batch = torch.from_numpy(x)
                with torch.no_grad():
                    direct = net(batch.to(device)).cpu()
                    plain = cpu_net(batch)
                err = float((direct - plain).abs().max())
                check(torch.equal(got, direct),
                      f"torchserver b{b} request {i}: the served answer "
                      f"differs from the direct forward on the card by "
                      f"{float((got - direct).abs().max())}")
                check(torch.allclose(direct, plain, rtol=TORCHSERVER_RTOL,
                                     atol=TORCHSERVER_ATOL),
                      f"torchserver b{b} request {i}: the card's forward "
                      f"differs from the CPU copy by {err}")
                worst = max(worst, err)
            arms[f"b{b}"] = dict(latency_summary(lat, wall),
                                 max_abs_err_vs_cpu=worst)
        batch = torch.from_numpy(rng.normal(size=(16, 3, 32, 32)).astype(
            np.float32)).to(device)
        with torch.no_grad():
            forward_ms = (cuda_time_ms(lambda: net(batch))
                          if device == "cuda" else None)
        parameters = sum(p.numel() for p in net.parameters())
        model.unload()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = {"card": card, "model": "CIFAR-10 Net", "device": device,
               "parameters": parameters, "load_ms": load_ms,
               "requests_per_arm": TORCHSERVER_REQUESTS,
               "concurrency": TORCHSERVER_CONCURRENCY,
               "tolerance_vs_cpu": {"rtol": TORCHSERVER_RTOL,
                                    "atol": TORCHSERVER_ATOL},
               "arms": arms, "b16_forward_ms": forward_ms}
    print("torchserver " + json.dumps(summary), flush=True)
    return summary


async def delivered(loggers, n: int) -> None:
    """Wait until every logger has had ``n`` events answered or given up
    on (a sink's answer means its detector scored the payload)."""
    deadline = time.perf_counter() + DETECTOR_WAIT_S
    while any(lg.sent + lg.failed + lg.dropped < n for lg in loggers):
        check(time.perf_counter() < deadline,
              f"detectors: event {n} not delivered in {DETECTOR_WAIT_S} s")
        await asyncio.sleep(0.001)


def serve_detectors(card: str) -> dict:
    """Line "detectors": the port's RequestLogger tees the xgb server's
    request payloads to an outlier and a drift detector served on a
    second server; 256 one-row requests, the last 64 shifted by 3 sigma
    in 4 features.  Events sent and dropped, the outlier rate on the
    clean and shifted parts, the request after which the drift verdict
    flips; the served outlier scores equal the detector's direct scorer,
    and the served drift verdicts equal a detector fed the same rows
    directly."""
    from kfserving_tpu_torch.agent import RequestLogger
    from kfserving_tpu_torch.detectors import KSDriftDetector, OutlierDetector
    from kfserving_tpu_torch.predictors.xgbserver import XGBoostModel
    from kfserving_tpu_torch.server.app import ModelServer

    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-detectors-")
    rng = np.random.default_rng(DETECTOR_SEED)
    n, clean = DETECTOR_REQUESTS, DETECTOR_REQUESTS - DETECTOR_SHIFTED
    try:
        dirs = write_tabular_artifacts(root)
        ref_dir = os.path.join(root, "reference")
        os.makedirs(ref_dir)
        np.save(os.path.join(ref_dir, "train.npy"), rng.normal(
            size=(DETECTOR_REFERENCE, TABULAR_FEATURES)))
        rows = rng.normal(size=(n, TABULAR_FEATURES))
        rows[clean:, :DETECTOR_SHIFTED_FEATURES] += DETECTOR_SHIFT
        rows = rows.astype(np.float32)
        xgb = XGBoostModel("xgb", dirs["xgb"])
        od = OutlierDetector("od", ref_dir)
        dd = KSDriftDetector("dd", ref_dir)
        replay = KSDriftDetector("replay", ref_dir)
        for m in (xgb, od, dd, replay):
            m.load()

        async def run():
            det_server = ModelServer(http_port=0)
            server = ModelServer(http_port=0)
            await det_server.start_async([od, dd], host="127.0.0.1")
            await server.start_async([xgb], host="127.0.0.1")
            loggers = [RequestLogger(
                f"http://127.0.0.1:{det_server.http_port}/v1/models/"
                f"{name}:predict", log_mode="request",
                inference_service="xgb") for name in ("od", "dd")]
            verdicts, replayed = [], []
            try:
                for lg in loggers:
                    await lg.start()
                    lg.attach(server)
                t0 = time.perf_counter()
                for i, row in enumerate(rows):
                    body = json.dumps({"instances": [row.tolist()]})
                    status, _, data = await asyncio.to_thread(
                        http_raw, server.http_port, "POST",
                        "/v1/models/xgb:predict", body.encode(),
                        {"content-type": "application/json"})
                    check(status == 200, f"detectors: xgb request {i}: "
                          f"HTTP {status} {data[:200]!r}")
                    await delivered(loggers, i + 1)
                    verdicts.append((dd.last_result or {}).get("drift"))
                    direct = await replay.predict(json.loads(body))
                    replayed.append(direct.get("drift"))
                wall_s = time.perf_counter() - t0
                stats = [lg.stats() for lg in loggers]
                seen, flagged = od.seen, od.flagged
                # The same rows straight to the outlier route.
                status, _, data = await asyncio.to_thread(
                    http_raw, det_server.http_port, "POST",
                    "/v1/models/od:predict",
                    json.dumps({"instances": rows.tolist()}).encode(),
                    {"content-type": "application/json"})
                check(status == 200, f"detectors: od predict HTTP {status}")
                return (verdicts, replayed, stats, json.loads(data),
                        seen, flagged, wall_s)
            finally:
                for lg in loggers:
                    await lg.stop()
                await server.stop_async()
                await det_server.stop_async()

        (verdicts, replayed, stats, served, seen, flagged,
         wall_s) = asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    scores = od.scorer.score(rows)
    outlier = scores > od.threshold
    check(served["score"] == np.round(scores, 6).tolist()
          and served["outlier"] == outlier.astype(int).tolist(),
          "detectors: served outlier scores differ from the direct scorer")
    sent = sum(s["sent"] for s in stats)
    dropped = sum(s["dropped"] for s in stats)
    check(dropped == 0 and sum(s["failed"] for s in stats) == 0
          and sent == 2 * n, f"detectors: logger stats {stats}")
    # The logged payloads were scored as the direct scorer scores them.
    check(seen == n and flagged == int(outlier.sum()),
          f"detectors: the outlier detector saw {seen} logged rows and "
          f"flagged {flagged}; the direct scorer flags "
          f"{int(outlier.sum())} of {n}")
    check(verdicts == replayed,
          "detectors: served drift verdicts differ from a detector fed "
          "the same rows directly")
    flips = [i for i in range(clean, n) if verdicts[i]]
    check(bool(flips), "detectors: no drift verdict in the shifted part")
    summary = {"card": card, "reference_rows": DETECTOR_REFERENCE,
               "features": TABULAR_FEATURES, "requests": n,
               "shifted": DETECTOR_SHIFTED, "shift_sigma": DETECTOR_SHIFT,
               "shifted_features": DETECTOR_SHIFTED_FEATURES,
               "events_sent": sent, "events_dropped": dropped,
               "outlier_threshold": od.threshold,
               "outlier_rate_clean": float(outlier[:clean].mean()),
               "outlier_rate_shifted": float(outlier[clean:].mean()),
               "drift_window": dd.window_size,
               "drift_verdicts_in_clean": sum(bool(v)
                                              for v in verdicts[:clean]),
               "drift_first_shifted_request": flips[0] + 1 - clean,
               "wall_s": wall_s}
    print("detectors " + json.dumps(summary), flush=True)
    return summary


# -- the V1 JSON codec --------------------------------------------------------
# -- phase 11: multi-rank serving (kfserving_tpu_torch/parallel/) -----------
# BERT-base at the bert phase's config under these meshes, and the
# generate_4k decoder under MESH_GEN.  The card's machine has one card:
# the ranks share it over gloo, named explicitly in each mesh block.
MESH_BERT = ({"tp": 2}, {"sp": 2}, {"dp": 2, "tp": 2})
MESH_GEN = {"tp": 2}
# The BERT burst: each REQUEST_LENGTHS body this many times, at
# MESH_CONCURRENCY requests in flight.
MESH_BURST, MESH_CONCURRENCY = 4, 8
# Two NCCL ranks on cuda:0, each in a process of its own: NCCL is
# expected to refuse the pair (a duplicate GPU).
NCCL_SAME_CARD = """
import datetime, sys, torch, torch.distributed as dist
rank, path = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(4, device="cuda:0")
dist.all_reduce(t)
torch.cuda.synchronize()
print("reduced", t.tolist())
"""
NCCL_SAME_CARD_TIMEOUT_S = 120


def mesh_block(sizes: dict) -> dict:
    """A config's mesh block: ``sizes`` with every rank on cuda:0, over
    gloo."""
    n = math.prod(sizes.values())
    return dict(sizes, devices=["cuda:0"] * n, backend="gloo")


def check_nccl_same_card() -> dict:
    """Start two NCCL ranks on cuda:0: (the outcome, exit codes, the
    error line NCCL gave)."""
    with tempfile.TemporaryDirectory(prefix="kfs-nccl-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", NCCL_SAME_CARD, str(rank), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        outputs, codes = [], []
        for proc in procs:
            try:
                out, _ = proc.communicate(timeout=NCCL_SAME_CARD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            outputs.append(out)
            codes.append(proc.returncode)
    lines = [ln.strip() for out in outputs for ln in out.splitlines()
             if re.search(r"(?i)duplicate gpu|ncclInvalidUsage|nccl error",
                          ln)]
    refused = any(code != 0 for code in codes)
    return {"outcome": "refused" if refused else "accepted",
            "exit_codes": codes, "error": lines[0][:300] if lines else None}


# A one-rank NCCL mesh on cuda:0 in a process of its own (it exits
# without destroy_process_group, which waits on the captured graph's
# NCCL work): the tp all-reduce and the ring exchange
# (parallel/mesh.py) eagerly, then captured into one CUDA graph and
# replayed, each result checked.  Prints one JSON line.
NCCL_GRAPH = """
import json, os, sys, time, torch, torch.distributed as dist
from kfserving_tpu_torch.parallel.mesh import build_mesh, exchange
mesh = build_mesh(tp=1, devices=["cuda:0"], backend="nccl")
group = mesh.get_group("tp")
x = torch.randn(4096, device="cuda")
y = torch.empty_like(x)

def program():
    y.copy_(x)
    dist.all_reduce(y, group=group)
    (z,) = exchange([y], 0, 0, group)()
    return z

eager = program()
torch.cuda.synchronize()
out = {"backend": dist.get_backend(group),
       "eager_equal": bool(torch.equal(eager, x))}
stream = torch.cuda.Stream()
stream.wait_stream(torch.cuda.current_stream())
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph, stream=stream):
    z = program()
x.copy_(torch.randn(4096, device="cuda"))
graph.replay()
torch.cuda.synchronize()
out["replay_equal"] = bool(torch.equal(z, x))
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range(20):
    graph.replay()
end.record()
torch.cuda.synchronize()
out["replay_ms"] = start.elapsed_time(end) / 20
print(json.dumps(out), flush=True)
os._exit(0)
"""
NCCL_GRAPH_TIMEOUT_S = 180


def check_nccl_graph() -> dict:
    proc = subprocess.run([sys.executable, "-c", NCCL_GRAPH],
                          capture_output=True, text=True,
                          timeout=NCCL_GRAPH_TIMEOUT_S, cwd=os.getcwd())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"nccl one-rank graph: exit {proc.returncode} "
          f"{proc.stderr[-2000:]}")
    out = json.loads(lines[-1])
    check(out["eager_equal"] and out["replay_equal"],
          f"nccl one-rank all-reduce + exchange changed the data: {out}")
    return dict(out, captured=True)


def follower_counts(leader) -> list:
    """Every rank's K1/K2 launch counts and bytes, rank 0 first."""
    return [read_launches()] + [r["launches"]
                                for r in leader.ask(("report",))]


def reset_mesh_launches(leader) -> None:
    reset_launches()
    leader.ask(("reset_counts",))


def processes_gone(pids) -> list:
    """The pids that still exist (each should be gone)."""
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        alive.append(pid)
    return alive


async def mesh_bert_answers(model, bodies, burst: int) -> dict:
    """Each body once, one at a time, then ``burst`` copies of each at
    MESH_CONCURRENCY: (index, top-k answer) pairs, the burst's wall
    seconds."""
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    sem = asyncio.Semaphore(MESH_CONCURRENCY)

    async def predict(i):
        async with sem:
            status, resp, _ = await asyncio.to_thread(
                http_json, port, "POST", f"/v1/models/{model.name}:predict",
                {"instances": [bodies[i]]})
        check(status == 200, f"mesh bert body {i}: HTTP {status} {resp}")
        return i, resp["predictions"][0]

    try:
        singles = [await predict(i) for i in range(len(bodies))]
        t0 = time.perf_counter()
        done = await asyncio.gather(*(predict(i) for i in range(len(bodies))
                                      for _ in range(burst)))
        wall_s = time.perf_counter() - t0
    finally:
        await server.stop_async()
    return {"answers": singles + list(done), "wall_s": wall_s,
            "burst_requests": len(bodies) * burst}


def hold_bert_answers(answers, reference, bodies, vocab: int,
                      where: str) -> dict:
    """Every served answer against the unsharded model's answer for the
    same body: the top-k scores under ``agreement`` over each real
    position, the top-1 tokens' agreement share."""
    worst_err = worst_share = 0.0
    agree = total = 0
    for i, pred in answers:
        n = len(bodies[i])
        got_v = np.asarray(pred["values"])[:n]
        check_topk(pred["values"], pred["indices"], len(pred["values"]),
                   vocab, f"{where} body {i}")
        want_v = np.asarray(reference[i]["values"])[:n]
        err, _, share = agreement(
            torch.tensor(got_v).to(torch.bfloat16),
            torch.tensor(want_v).to(torch.bfloat16), 0.0,
            f"{where} body {i}")
        worst_err, worst_share = max(worst_err, err), max(worst_share,
                                                          share)
        got_i = np.asarray(pred["indices"])[:n, 0]
        want_i = np.asarray(reference[i]["indices"])[:n, 0]
        agree += int((got_i == want_i).sum())
        total += n
    share_top1 = agree / total
    check(share_top1 >= MIN_TOP1_AGREEMENT,
          f"{where}: top-1 agreement {share_top1} < {MIN_TOP1_AGREEMENT}")
    return {"answers": len(answers), "max_abs_err": worst_err,
            "share_of_limit": worst_share, "top1_agreement": share_top1}


def mesh_bert(card: str) -> dict:
    config = BERT_CONFIG
    rng = np.random.default_rng(13)
    ref, _ = load_model("bert", config)
    cfg = ref.module.config
    try:
        bodies = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                  for n in REQUEST_LENGTHS]
        run = asyncio.run(mesh_bert_answers(ref, bodies, burst=0))
        reference = dict(run["answers"])
        ref_bytes = ref.engine.param_bytes()
    finally:
        ref.unload()
    rows = {}
    for sizes in MESH_BERT:
        name = json.dumps(sizes, sort_keys=True)
        model, load_s = load_model(
            "bert", dict(config, mesh=mesh_block(sizes)))
        leader = model.engine._leader
        try:
            n_ranks = math.prod(sizes.values())
            check(leader is not None and len(leader.pids) == n_ranks - 1,
                  f"mesh {name}: {n_ranks - 1} followers expected")
            # The main path's run: every rank's counts start at 0 here.
            reset_mesh_launches(leader)
            executed0 = model.engine.execute_count
            run = asyncio.run(mesh_bert_answers(model, bodies, MESH_BURST))
            batches = model.engine.execute_count - executed0
            counts = follower_counts(leader)
            reports = leader.ask(("report",))
            rank_bytes = [model.engine.param_bytes()] + [
                r["param_bytes"] for r in reports]
            pids = leader.pids
            held = hold_bert_answers(run["answers"], reference, bodies,
                                     cfg.vocab_size, f"mesh {name}")
        finally:
            model.unload()
        alive = processes_gone(pids)
        check(not alive, f"mesh {name}: followers {alive} outlived the "
              "model")
        # Under sp the ring fold (plain torch) replaces K1.
        want_k1 = 0 if sizes.get("sp", 1) > 1 else cfg.num_layers * batches
        check(all(c["flash_attention"] == want_k1
                  and c["paged_attention"] == 0 for c in counts),
              f"mesh {name}: launches per rank {counts}, want K1 "
              f"{want_k1} ({batches} batches)")
        rows[name] = {
            "ranks": n_ranks, "devices": mesh_block(sizes)["devices"],
            "backend": "gloo", "graphs": False, "load_s": load_s,
            "batches": batches, "launches_per_rank": counts,
            "param_bytes_per_rank": rank_bytes,
            "unsharded_param_bytes": ref_bytes,
            "req_per_s": run["burst_requests"] / run["wall_s"],
            "burst_requests": run["burst_requests"], "held": held,
            "followers_left": len(alive)}
    return rows


async def mesh_generate_streams(model) -> dict:
    """The generate phase's traffic: a warm-up stream, then
    GEN_REQUESTS streams at GEN_CONCURRENCY (the launch window is read
    around them)."""
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    path = f"/v2/models/{model.name}/generate_stream"
    engine = model.engine
    leader = engine._leader
    try:
        status, events, _, _ = await asyncio.to_thread(
            sse_stream, port, path,
            {"text_input": gen_prompt(9999), "max_tokens": GEN_MAX_TOKENS})
        check(status == 200, f"mesh warm-up stream: HTTP {status}")
        stream_tokens(events, "mesh warm-up stream")
        if leader is not None:
            await asyncio.to_thread(reset_mesh_launches, leader)
        before = engine.stats()
        sem = asyncio.Semaphore(GEN_CONCURRENCY)

        async def one(i):
            async with sem:
                return await asyncio.to_thread(
                    sse_stream, port, path,
                    {"text_input": gen_prompt(i),
                     "max_tokens": GEN_MAX_TOKENS})

        t0 = time.perf_counter()
        streams = await asyncio.gather(*(one(i)
                                         for i in range(GEN_REQUESTS)))
        wall_s = time.perf_counter() - t0
        # Every slot free: no wave is dispatched while the counts are
        # read.
        for _ in range(200):
            if all(slot is None for slot in engine._slots):
                break
            await asyncio.sleep(0.05)
        after = engine.stats()
        counts = (await asyncio.to_thread(follower_counts, leader)
                  if leader is not None else None)
        check(engine.stats()["decode_steps"] == after["decode_steps"],
              "mesh: a decode wave ran while the counts were read")
    finally:
        await server.stop_async()
    tokens = []
    for i, (status, events, _, _) in enumerate(streams):
        check(status == 200, f"mesh stream {i}: HTTP {status} {events}")
        tokens.append(stream_tokens(events, f"mesh stream {i}"))
    ttfts = sorted(first for _, _, first, _ in streams)
    generated = sum(len(t) for t in tokens)
    return {"tokens": tokens, "before": before, "after": after,
            "counts": counts, "wall_s": wall_s,
            "tokens_per_s": generated / wall_s, "generated": generated,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
            "ttft_max_ms": ttfts[-1] * 1e3}


def hold_greedy_tokens(module, tokenizer, streams, prompts=None) -> dict:
    """Each stream's tokens against the unsharded model teacher-forced
    over the stream's own context (``prompts[i]``, else
    ``gen_prompt(i)``): every token its greedy choice but for near-ties
    (top-2 within RESNET_TIE_RTOL of the largest |logit|), counted."""
    ties = positions = 0
    for i, served in enumerate(streams):
        prompt = tokenizer.encode(prompts[i] if prompts is not None
                                  else gen_prompt(i))
        ids = torch.tensor([prompt + served[:-1]], device="cuda")
        with torch.inference_mode():
            logits = module(ids)[0, len(prompt) - 1:].float()
        served_t = torch.tensor(served, device="cuda")
        top = logits.max(dim=-1).values
        gap = top - logits.gather(-1, served_t[:, None])[:, 0]
        limit = RESNET_TIE_RTOL * logits.abs().amax(dim=-1)
        differ = logits.argmax(dim=-1) != served_t
        far = (differ & (gap > limit)).nonzero().flatten().tolist()
        check(not far, f"mesh stream {i}: tokens at {far[:5]} are not the "
              f"unsharded model's greedy choice (gaps "
              f"{[float(gap[j]) for j in far[:5]]})")
        ties += int(differ.sum())
        positions += len(served)
    return {"streams": len(streams), "positions": positions,
            "near_ties": ties, "tie_rtol": RESNET_TIE_RTOL}


def mesh_generate(card: str) -> dict:
    config = GEN_CONFIG
    ref, _ = load_generative("gen4k", config)
    name = json.dumps(MESH_GEN, sort_keys=True)
    try:
        ref_bytes = {"param_bytes": ref.engine.param_bytes(),
                     "cache_bytes": ref.engine.cache_bytes()}
        model, load_s = load_generative(
            "gen4k", config, mesh=mesh_block(MESH_GEN))
        leader = model.engine._leader
        try:
            check(leader is not None and len(leader.pids) == 1,
                  f"mesh {name}: one follower expected")
            cfg = model.module.config
            run = asyncio.run(mesh_generate_streams(model))
            reports = leader.ask(("report",))
            rank_bytes = [{"param_bytes": model.engine.param_bytes(),
                           "cache_bytes": model.engine.cache_bytes()}] + [
                {k: r[k] for k in ("param_bytes", "cache_bytes")}
                for r in reports]
            pids = leader.pids
        finally:
            model.unload()
        alive = processes_gone(pids)
        check(not alive, f"mesh {name}: followers {alive} outlived the "
              "model")
        held = hold_greedy_tokens(ref.module, ref.tokenizer, run["tokens"])
    finally:
        ref.unload()
    before, after = run["before"], run["after"]
    waves = after["decode_steps"] - before["decode_steps"]
    prefills = after["prefills"] - before["prefills"]
    want = {"flash_attention": cfg.num_layers * prefills,
            "paged_attention": (cfg.num_layers * waves
                                * after["steps_per_call"])}
    check(waves > 0 and prefills > 0
          and all(c == want for c in run["counts"]),
          f"mesh {name}: launches per rank {run['counts']}, want {want}"
          f" ({prefills} prefills, {waves} waves)")
    heads = cfg.num_heads // MESH_GEN["tp"]
    check(all(b["cache_bytes"] * MESH_GEN["tp"] == ref_bytes["cache_bytes"]
              for b in rank_bytes),
          f"mesh {name}: KV pool bytes per rank {rank_bytes} are not "
          f"1/{MESH_GEN['tp']} of {ref_bytes['cache_bytes']}")
    return {name: {
        "ranks": MESH_GEN["tp"],
        "devices": mesh_block(MESH_GEN)["devices"],
        "backend": "gloo", "graphs": False, "load_s": load_s,
        "heads_per_rank": heads, "requests": GEN_REQUESTS,
        "concurrency": GEN_CONCURRENCY, "prefills": prefills,
        "decode_waves": waves, "launches_per_rank": run["counts"],
        "bytes_per_rank": rank_bytes, "unsharded_bytes": ref_bytes,
        "tokens_per_s": run["tokens_per_s"],
        "generated_tokens": run["generated"], "wall_s": run["wall_s"],
        "ttft_p50_ms": run["ttft_p50_ms"], "ttft_max_ms": run["ttft_max_ms"],
        "held": held, "followers_left": len(alive)}}


# -- line "mesh_modes": the generator's other modes under MESH_GEN ----------
# Each mode at its published configuration (above), GPT-2-small width,
# with the traffic cut (never a width) so the line takes about two
# minutes: dense 4 streams of 32 tokens; chunked 2 live streams (48
# tokens) and one cold 3900-token prompt (8 tokens) landing among them;
# speculative 2 prompts of 32 tokens in the ngram and self-draft arms;
# the tier 6 conversations' turn 0 through the 72-block pool, then turn
# 1 of the first 2 (their chains spilled: a fault-back); the handoff 3
# conversations exported under tp2 and adopted by an unsharded engine.
MODES_DENSE = (4, 32)
MODES_COLD_LIVE = (2, 48)
MODES_SPEC = (2, 32)
MODES_TIER_CONVS, MODES_TIER_RETURNS, MODES_HANDOFF_CONVS = 6, 2, 3
MODES_KV_TOKENS = 8


def plain_decoder(config: dict):
    """The unsharded decoder of ``config`` on the seeded init every
    GenerativeModel of it loads (through the param cache)."""
    from kfserving_tpu_torch.engine import param_cache
    from kfserving_tpu_torch.models import create_model

    spec = create_model(config["architecture"], **config["arch_kwargs"])
    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-") as d:
        module, _, _ = param_cache.load_or_materialize(
            config["architecture"], config["arch_kwargs"], spec, d,
            torch.device("cuda"))
    return module


def mode_launches(after: dict, before: dict, layers: int,
                  steps: int, spec_k: int, draft: bool,
                  paged: bool) -> dict:
    """K1 and K2 launches a rank makes for the dispatches between two
    stats: K1 once per layer per bucketed prefill and per draft forward
    (K per draft wave, on rank 0 alone: ``draft``); K2 once per layer
    per decode step of a plain paged wave and per verified position of
    a spec wave (chunks attend by gather, dense waves by masked
    attention)."""
    prefills = after["prefills"] - before["prefills"]
    waves = after["decode_steps"] - before["decode_steps"]
    spec_waves = ((after.get("speculative") or {}).get("waves", 0)
                  - (before.get("speculative") or {}).get("waves", 0))
    k2 = layers * (steps * (waves - spec_waves) + (spec_k + 1) * spec_waves)
    return {"flash_attention": layers * (prefills + (spec_k * spec_waves
                                                     if draft else 0)),
            "paged_attention": k2 if paged else 0}


async def mode_streams(model, bodies, concurrency: int,
                       sequential: bool = False,
                       last_lands: bool = False) -> dict:
    """The bodies as SSE generate streams through the model's server
    (at ``concurrency``, or one after another; ``last_lands``: the last
    body once every other stream has a token out), every rank's launch
    counts read from 0 around them: ids, TTFTs in body order, stats
    before and after, counts per rank."""
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    path = f"/v2/models/{model.name}/generate_stream"
    engine = model.engine
    leader = engine._leader
    sem = asyncio.Semaphore(concurrency)

    async def one(body):
        async with sem:
            return await asyncio.to_thread(sse_stream, port, path, body)

    try:
        await asyncio.to_thread(reset_mesh_launches, leader)
        before = engine.stats()
        if sequential:
            streams = [await one(b) for b in bodies]
        elif last_lands:
            live = [asyncio.ensure_future(one(b)) for b in bodies[:-1]]
            for _ in range(6000):
                if engine.tokens_generated - before["tokens_generated"] \
                        >= len(live):
                    break
                await asyncio.sleep(0.01)
            cold = await one(bodies[-1])
            streams = list(await asyncio.gather(*live)) + [cold]
        else:
            streams = await asyncio.gather(*(one(b) for b in bodies))
        for _ in range(200):
            if all(slot is None for slot in engine._slots):
                break
            await asyncio.sleep(0.05)
        after = engine.stats()
        counts = await asyncio.to_thread(follower_counts, leader)
    finally:
        await server.stop_async()
    ids = []
    for i, (status, events, _, _) in enumerate(streams):
        check(status == 200, f"{model.name} stream {i}: HTTP {status} "
              f"{events}")
        ids.append(stream_tokens(events, f"{model.name} stream {i}",
                                 bodies[i]["max_tokens"]))
    return {"ids": ids, "ttft_ms": [s[2] * 1e3 for s in streams],
            "before": before, "after": after, "counts": counts}


def mode_row(name: str, run: dict, config: dict, load_s: float,
             spec_k: int = 0, draft: bool = False, held=None) -> dict:
    """A mode's row: its launches on every rank against the dispatches'
    count (rank 0's stats; every rank runs them, and rank 0 alone the
    draft), the tokens and each stream's TTFT.  No rate: a few short
    streams measure start-up and first tokens, not throughput."""
    before, after = run["before"], run["after"]
    want = [mode_launches(after, before,
                          config["arch_kwargs"]["num_layers"],
                          config["steps_per_call"], spec_k,
                          draft and rank == 0,
                          config.get("block_size") is not None)
            for rank in range(len(run["counts"]))]
    check(run["counts"] == want,
          f"mesh_modes {name}: launches per rank {run['counts']}, "
          f"want {want}")
    return {"load_s": load_s, "streams": len(run["ids"]),
            "generated_tokens": sum(len(t) for t in run["ids"]),
            "ttft_ms": run["ttft_ms"],
            "prefills": after["prefills"] - before["prefills"],
            "decode_waves": after["decode_steps"] - before["decode_steps"],
            "launches_per_rank": run["counts"], "held": held}


def load_mesh(name: str, config: dict, **extra):
    model, load_s = load_generative(name, config, mesh=mesh_block(MESH_GEN),
                                    **extra)
    check(model.engine._leader is not None
          and len(model.engine._leader.pids) == 1,
          f"mesh_modes {name}: one follower expected")
    return model, load_s


def close_mesh(model) -> list:
    """Unload a mesh model: the pids of followers that outlived it."""
    pids = list(model.engine._leader.pids)
    asyncio.run(model.close())
    model.unload()
    return processes_gone(pids)


def mode_dense(ref) -> dict:
    n, tokens = MODES_DENSE
    prompts = [dense_prompt(i) for i in range(n)]
    model, load_s = load_mesh("modes-dense", DENSE_CONFIG)
    try:
        check(model.engine.block_size is None, "dense: the engine paged")
        run = asyncio.run(mode_streams(
            model, [{"text_input": p, "max_tokens": tokens}
                    for p in prompts], n))
    finally:
        alive = close_mesh(model)
    held = hold_greedy_tokens(ref, model.tokenizer, run["ids"], prompts)
    return dict(mode_row("dense", run, DENSE_CONFIG, load_s, held=held),
                followers_left=len(alive))


def mode_chunked(ref) -> dict:
    n, tokens = MODES_COLD_LIVE
    config = dict(COLD_CONFIG, prefill_chunk_tokens=COLD_CHUNK)
    prompts = [live_prompt(i) for i in range(n)] + [cold_prompt(0)]
    bodies = [{"text_input": p, "max_tokens": tokens} for p in prompts[:n]]
    bodies.append({"text_input": prompts[-1], "max_tokens": 8})
    model, load_s = load_mesh("modes-chunked", config)
    try:
        run = asyncio.run(mode_streams(model, bodies, len(bodies),
                                       last_lands=True))
    finally:
        alive = close_mesh(model)
    cp_before = run["before"]["chunked_prefill"]
    cp = run["after"]["chunked_prefill"]
    chunks = cp["chunks_dispatched"] - cp_before["chunks_dispatched"]
    want = -(-(COLD_LEN + 1) // COLD_CHUNK)
    check(chunks == want, f"mesh_modes chunked: {chunks} chunks for the "
          f"cold prompt, want {want}")
    held = hold_greedy_tokens(ref, model.tokenizer, run["ids"], prompts)
    return dict(mode_row("chunked", run, config, load_s, held=held),
                chunks=chunks,
                cold_ttft_ms=run["ttft_ms"][-1], followers_left=len(alive))


def mode_spec(ref) -> dict:
    n, tokens = MODES_SPEC
    prompts = [spec_prompt(i) for i in range(n)]
    arms = {"ngram": {"tokens": SPEC_K},
            "draft": {"tokens": SPEC_K, "draft": {
                "architecture": SPEC_CONFIG["architecture"],
                "arch_kwargs": SPEC_CONFIG["arch_kwargs"],
                "window": SPEC_WINDOW}}}
    out = {}
    for arm, spec in arms.items():
        model, load_s = load_mesh(f"modes-spec-{arm}", SPEC_CONFIG,
                                  speculative=spec)
        try:
            reports = model.engine._leader.ask(("report",))
            booked = [model.engine.draft_param_bytes()] + [
                r["draft_param_bytes"] for r in reports]
            run = asyncio.run(mode_streams(
                model, [{"text_input": p, "max_tokens": tokens}
                        for p in prompts], n))
        finally:
            alive = close_mesh(model)
        spec_st = run["after"]["speculative"]
        spec_waves = spec_st["waves"] - run["before"]["speculative"]["waves"]
        check(spec_waves > 0, f"mesh_modes speculative {arm}: no spec wave")
        # Rank 0 alone holds a draft; the followers get its proposals.
        check((booked[0] > 0) == (arm == "draft")
              and not any(booked[1:]),
              f"mesh_modes speculative {arm}: draft bytes per rank "
              f"{booked}")
        held = hold_greedy_tokens(ref, model.tokenizer, run["ids"], prompts)
        out[arm] = dict(mode_row(f"speculative {arm}", run, SPEC_CONFIG,
                                 load_s, spec_k=SPEC_K,
                                 draft=arm == "draft", held=held),
                        spec_waves=spec_waves,
                        acceptance_rate=spec_st.get("acceptance_rate"),
                        draft_param_bytes_per_rank=booked,
                        followers_left=len(alive))
    return out


def tier_bodies(setup: dict, convs, turn: int) -> list:
    return [{"text_input": kv_prompt(c, turn, setup["ctx_len"]),
             "max_tokens": MODES_KV_TOKENS} for c in convs]


def mode_tier(ref) -> dict:
    setup = KVTIER_SETUP
    config = setup["config"]
    first = tier_bodies(setup, range(MODES_TIER_CONVS), 0)
    back = tier_bodies(setup, range(MODES_TIER_RETURNS), 1)
    model, load_s = load_mesh("modes-tier", config,
                              host_tier_blocks=setup["tier_blocks"])
    try:
        run = asyncio.run(mode_streams(model, first + back, 1,
                                       sequential=True))
        st = model.engine.stats()
    finally:
        alive = close_mesh(model)
    ht, ev = st["host_tier"], st["paged"]["evictions"]
    check(ev["capacity_spilled"] > 0 and ht["faulted_blocks"] > 0
          and ht["fault_failures"] == 0 and ht["spill_failures"] == 0,
          f"mesh_modes tier: host tier {ht}, evictions {ev}")
    held = hold_greedy_tokens(ref, model.tokenizer, run["ids"],
                              [b["text_input"] for b in first + back])
    return dict(mode_row("tier", run, config, load_s, held=held),
                spilled_blocks=ev["capacity_spilled"],
                faulted_blocks=ht["faulted_blocks"],
                tokens_saved=st["paged"]["host_tier_tokens_saved"],
                return_ttft_ms=run["ttft_ms"][MODES_TIER_CONVS:],
                followers_left=len(alive))


def mode_handoff(ref) -> dict:
    """Turn 0 of each conversation under tp2, the export into a
    persistent tier, then an unsharded engine on the same directory
    adopting it and serving turn 1 by fault-back."""
    from kfserving_tpu_torch.engine.kv_tier import payload_digest

    setup = KVHANDOFF_SETUP
    config = setup["config"]
    convs = range(MODES_HANDOFF_CONVS)
    kv_dir = tempfile.mkdtemp(prefix="kfs-chip-smoke-kv-")
    tier = {"host_tier_blocks": setup["tier_blocks"],
            "host_tier_dir": kv_dir}
    try:
        model, load_s = load_mesh("modes-handoff", config, **tier)
        try:
            run = asyncio.run(mode_streams(
                model, tier_bodies(setup, convs, 0), 1, sequential=True))
            t0 = time.perf_counter()
            export = model.engine.export_kv(setup["export_budget_s"])
            export_ms = (time.perf_counter() - t0) * 1e3
            kv = model.engine.kv_tier
            exported = {c: payload_digest(kv.read(bytes.fromhex(c)))
                        for c in kv.chains()}
        finally:
            alive = close_mesh(model)
        check(export["exported"] > 0 and export["dropped"] == 0
              and export["failed"] == 0,
              f"mesh_modes handoff: export {export}")
        successor, _ = load_generative("modes-handoff", config, **tier)
        try:
            kv = successor.engine.kv_tier
            adopted = dict(kv.handoff)
            digests = {c: payload_digest(kv.read(bytes.fromhex(c)))
                       for c in kv.chains()}

            async def turn1():
                from kfserving_tpu_torch.server.app import ModelServer

                server = ModelServer(http_port=0)
                await server.start_async([successor], host="127.0.0.1")
                try:
                    return await drive_kv_turns(
                        server.http_port, "modes-handoff",
                        dict(setup, tokens=MODES_KV_TOKENS), 1, convs)
                finally:
                    await server.stop_async()

            ids1, ttft1 = asyncio.run(turn1())
            faulted = successor.engine.stats()["host_tier"]["faulted_blocks"]
            asyncio.run(successor.close())
        finally:
            successor.unload()
    finally:
        shutil.rmtree(kv_dir, ignore_errors=True)
    check(adopted["adopted"] == export["exported"] and digests == exported,
          f"mesh_modes handoff: adopted {adopted} after exporting {export}")
    check(faulted > 0, "mesh_modes handoff: the successor faulted nothing "
          "back")
    prompts = ([kv_prompt(c, 0, setup["ctx_len"]) for c in convs]
               + [kv_prompt(c, 1, setup["ctx_len"]) for c in convs])
    held = hold_greedy_tokens(ref, successor.tokenizer,
                              run["ids"] + [ids1[c] for c in convs],
                              prompts)
    return dict(mode_row("handoff", run, config, load_s, held=held),
                export=export, export_ms=export_ms, adopted=adopted,
                successor_faulted_blocks=faulted,
                successor_ttft_ms=ttft1, followers_left=len(alive))


def mesh_modes(card: str) -> dict:
    """Line ``mesh_modes``: dense slots, chunked prefill, speculative
    decoding (ngram and self-draft), the host KV tier and KV handoff,
    each under MESH_GEN at its published configuration; every streamed
    token held against the unsharded decoder's greedy choice teacher-
    forced (near-ties counted), every rank's K1/K2 launches against the
    dispatches.  A mode that fails fails the run."""
    out = {"card": card, "mesh": MESH_GEN, "backend": "gloo",
           "graphs": False}
    ref = plain_decoder(DENSE_CONFIG)
    out["dense"] = mode_dense(ref)
    ref = plain_decoder(SPEC_CONFIG)
    out["speculative"] = mode_spec(ref)
    ref = plain_decoder(COLD_CONFIG)
    out["chunked"] = mode_chunked(ref)
    out["tier"] = mode_tier(ref)
    out["handoff"] = mode_handoff(ref)
    del ref
    rows = [out["dense"], out["chunked"], out["tier"], out["handoff"]] + \
        list(out["speculative"].values())
    left = sum(r["followers_left"] for r in rows)
    check(left == 0, f"mesh_modes: {left} followers outlived their model")
    out["launches"] = {
        k: sum(c[k] for r in rows for c in r["launches_per_rank"])
        for k in ("flash_attention", "paged_attention")}
    print("mesh_modes " + json.dumps(out), flush=True)
    return out


def serve_mesh(card: str) -> dict:
    """Line ``mesh``; returns it with every rank's launches summed
    (``launches``)."""
    summary = {"card": card,
               "nccl_two_ranks_one_card": check_nccl_same_card(),
               "nccl_one_rank_graph": check_nccl_graph()}
    from kfserving_tpu_torch.parallel.follower import stop_forkserver

    try:
        summary["bert"] = mesh_bert(card)
        summary["generate"] = mesh_generate(card)
        modes = mesh_modes(card)
    finally:
        # The followers' forkserver goes with the phase.
        stop_forkserver()
    rows = list(summary["bert"].values()) + list(
        summary["generate"].values())
    summary["launches"] = {
        k: sum(c[k] for row in rows for c in row["launches_per_rank"] or [])
        + modes["launches"][k] for k in ("flash_attention", "paged_attention")}
    summary["modes_launches"] = modes["launches"]
    print("mesh " + json.dumps(summary), flush=True)
    return summary


# -- line "metrics_lint": the exposition linter over the served scrapes ------
# Filled by the BERT, generate_4k and chain phases: each lints its server's
# (the chain's: the router's) /metrics scrape once its run is over.
METRICS_LINT: dict = {}


def lint_metrics(port: int, where: str) -> None:
    """``tools/check_metrics.lint_exposition`` over one ``/metrics``
    scrape; any problem fails the run."""
    from kfserving_tpu_torch.tools.check_metrics import lint_exposition

    status, _, data = http_raw(port, "GET", "/metrics")
    check(status == 200, f"{where}: /metrics HTTP {status}")
    lines = data.decode().splitlines()
    problems = lint_exposition("\n".join(lines))
    check(not problems, f"{where}: /metrics lint: {problems[:5]}")
    METRICS_LINT[where] = {
        "families": sum(line.startswith("# TYPE ") for line in lines),
        "samples": sum(bool(line) and not line.startswith("#")
                       for line in lines),
        "problems": len(problems)}


def report_metrics_lint(card: str) -> dict:
    wanted = {"bert", "gen4k", "gen_d256", "router"}
    check(wanted <= set(METRICS_LINT), f"metrics_lint: scrapes of "
          f"{sorted(wanted - set(METRICS_LINT))} were not linted")
    summary = {"card": card, "scrapes": METRICS_LINT}
    print("metrics_lint " + json.dumps(summary), flush=True)
    return summary


# -- line "openapi": the schema tool on meta tensors -------------------------
def serve_openapi(card: str) -> dict:
    """``tools/torch2openapi.generate`` for the served BERT-base, ResNet-50
    and ViT-B/16 configurations: the probe runs each module on meta
    tensors, so the card's allocated bytes do not move."""
    from kfserving_tpu_torch.tools import torch2openapi

    out = {}
    for name, config in (("bert", BERT_CONFIG), ("resnet50", RESNET_CONFIG),
                         ("vit", VIT_CONFIG)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        doc = torch2openapi.generate(name, config["architecture"],
                                     config.get("arch_kwargs", {}))
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        check(after == before, f"openapi {name}: memory_allocated moved "
              f"from {before} to {after} bytes")
        sig = doc["x-model-signature"]
        check(f"/v1/models/{name}:predict" in doc["paths"]
              and f"/v2/models/{name}/infer" in doc["paths"]
              and sig["inputs"] and sig["outputs"],
              f"openapi {name}: incomplete document")
        out[name] = {"ms": ms, "inputs": sig["inputs"],
                     "outputs": sig["outputs"]}
    summary = {"card": card, "models": out,
               "allocated_bytes": torch.cuda.memory_allocated()}
    print("openapi " + json.dumps(summary), flush=True)
    return summary


# -- line "checkpoint": HF checkpoints converted, loaded and served ----------
CKPT_SEED = 83
CKPT_IMAGES, CKPT_CONCURRENCY = 32, 16
HF_RESNET_DEPTHS = (3, 4, 6, 3)


def _normal(rng, shape, std: float) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(std))


def hf_bert_state_dict(rng) -> dict:
    """A seeded HF BertForMaskedLM state dict (``bert.*`` and ``cls.*``
    keys, fp32) at BERT-base widths: Linear kernels N(0, 1/fan_in),
    embeddings N(0, 1/hidden), biases N(0, 0.02), LayerNorm scales 1 and
    shifts 0; the MLM decoder tied to the word embeddings."""
    vocab, hidden, inter, num_layers = 30522, 768, 3072, 12
    sd = {}

    def linear(prefix, out, inp):
        sd[f"{prefix}.weight"] = _normal(rng, (out, inp), inp ** -0.5)
        sd[f"{prefix}.bias"] = _normal(rng, (out,), 0.02)

    def norm(prefix):
        sd[f"{prefix}.weight"] = torch.ones(hidden)
        sd[f"{prefix}.bias"] = torch.zeros(hidden)

    emb = "bert.embeddings"
    for name, rows in (("word", vocab), ("position", 512),
                       ("token_type", 2)):
        sd[f"{emb}.{name}_embeddings.weight"] = _normal(
            rng, (rows, hidden), hidden ** -0.5)
    norm(f"{emb}.LayerNorm")
    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{p}.attention.self.{name}", hidden, hidden)
        linear(f"{p}.attention.output.dense", hidden, hidden)
        norm(f"{p}.attention.output.LayerNorm")
        linear(f"{p}.intermediate.dense", inter, hidden)
        linear(f"{p}.output.dense", hidden, inter)
        norm(f"{p}.output.LayerNorm")
    linear("cls.predictions.transform.dense", hidden, hidden)
    norm("cls.predictions.transform.LayerNorm")
    sd["cls.predictions.bias"] = _normal(rng, (vocab,), 0.02)
    sd["cls.predictions.decoder.weight"] = sd[f"{emb}.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    return sd


def hf_resnet_blocks() -> list:
    """HF ResNet-50's bottleneck prefixes, in the port's block order."""
    return [f"resnet.encoder.stages.{s}.layers.{i}"
            for s, n in enumerate(HF_RESNET_DEPTHS) for i in range(n)]


def hf_resnet_bn_names() -> dict:
    """The port ResNet-50's BatchNorm names -> HF's normalization
    prefixes."""
    names = {"bn_init": "resnet.embedder.embedder.normalization"}
    for i, p in enumerate(hf_resnet_blocks()):
        for j in range(3):
            names[f"blocks.{i}.bn{j + 1}"] = f"{p}.layer.{j}.normalization"
        if p.endswith(".layers.0"):
            names[f"blocks.{i}.norm_proj"] = f"{p}.shortcut.normalization"
    return names


def hf_resnet_state_dict(rng, classes: int = 1000) -> dict:
    """A seeded HF ResNetForImageClassification state dict (``resnet.*``
    and ``classifier.*`` keys, fp32) at ResNet-50's widths: conv kernels
    N(0, 2/fan_in), BatchNorm scales U(0.5, 1), shifts N(0, 0.1), running
    mean 0 and variance 1 (calibrated before the conversion)."""
    sd = {}

    def conv_bn(prefix, out, inp, k):
        sd[f"{prefix}.convolution.weight"] = _normal(
            rng, (out, inp, k, k), (2.0 / (inp * k * k)) ** 0.5)
        p = f"{prefix}.normalization"
        sd[f"{p}.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.0, out).astype(np.float32))
        sd[f"{p}.bias"] = _normal(rng, (out,), 0.1)
        sd[f"{p}.running_mean"] = torch.zeros(out)
        sd[f"{p}.running_var"] = torch.ones(out)
        sd[f"{p}.num_batches_tracked"] = torch.tensor(0)

    conv_bn("resnet.embedder.embedder", 64, 3, 7)
    in_ch = 64
    for p in hf_resnet_blocks():
        stage = int(p.split(".")[3])
        width = 64 * 2 ** stage
        conv_bn(f"{p}.layer.0", width, in_ch, 1)
        conv_bn(f"{p}.layer.1", width, width, 3)
        conv_bn(f"{p}.layer.2", 4 * width, width, 1)
        if p.endswith(".layers.0"):
            conv_bn(f"{p}.shortcut", 4 * width, in_ch, 1)
        in_ch = 4 * width
    sd["classifier.1.weight"] = _normal(rng, (classes, in_ch),
                                        in_ch ** -0.5)
    sd["classifier.1.bias"] = _normal(rng, (classes,), 0.02)
    return sd


def in_memory_module(arch: str, arch_kwargs: dict, sd: dict):
    """The served architecture on the card holding ``sd`` mapped in
    memory (HF layout -> Flax tree -> the port's names), no file."""
    from kfserving_tpu_torch.models import create_model, weights
    from kfserving_tpu_torch.tools import convert

    spec = create_model(arch, **arch_kwargs)
    variables = convert.CONVERTERS[arch](sd, arch_kwargs)
    state = weights.FLAX_CONVERTERS[arch](variables)
    return weights.materialize(spec.module, torch.device("cuda"), state)


def run_convert(sd: dict, arch: str, arch_kwargs: dict, extra: dict,
                root: str) -> dict:
    """``python -m kfserving_tpu_torch.tools.convert`` on ``sd`` saved as
    a torch state dict: its report line plus the process's wall s."""
    bin_path = os.path.join(root, f"{arch}.bin")
    torch.save(sd, bin_path)
    out_dir = os.path.join(root, arch)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kfserving_tpu_torch.tools.convert",
         "--arch", arch, "--torch_checkpoint", bin_path, "--out_dir",
         out_dir, "--arch_kwargs", json.dumps(arch_kwargs),
         "--config_extra", json.dumps(extra)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"convert {arch}: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(report["out_dir"] == out_dir, f"convert {arch}: {report}")
    bin_bytes = os.path.getsize(bin_path)
    os.remove(bin_path)
    return dict(report, process_s=wall_s, bin_bytes=bin_bytes)


def timed_map(model_dir: str, arch: str) -> dict:
    """The checkpoint's mapping onto the port's names, timed alone: every
    leaf of the mapped file copied into an owned fp32 array, the one step
    of the read that moves the bytes (the decode before it only makes
    views of the mapped file).  The file was just written, so the page
    cache is warm."""
    from kfserving_tpu_torch.models import weights

    path = os.path.join(model_dir, "checkpoint.msgpack")
    tree = weights.read_flax_msgpack(path)
    t0 = time.perf_counter()
    state = weights.FLAX_CONVERTERS[arch](tree)
    s = time.perf_counter() - t0
    leaves = {np.asarray(v).__array_interface__["data"][0]: np.asarray(v)
              for v in state.values()}     # a tied leaf once
    nbytes = sum(v.nbytes for v in leaves.values())
    return {"checkpoint_bytes": os.path.getsize(path), "state_bytes": nbytes,
            "map_ms": s * 1e3, "map_gb_per_s": nbytes / s / 1e9,
            "page_cache": "warm"}


def load_split(model, seconds: float) -> dict:
    """One ``TorchModel.load`` split at its own startup marks (ms
    resolution): the config, the meta-device module and the checkpoint's
    digest, decode and mapping; the copy of the mapped state onto the
    card (``weights.materialize``) with its GB/s; the param cache's
    store; and the rest (the engine's warm-up and graph capture)."""
    from kfserving_tpu_torch import startup

    marks = startup.phases()
    order = ["load_start", "download", "checkpoint_restore", "init_params",
             "param_cache_store"]
    check(all(marks[a] <= marks[b] for a, b in zip(order, order[1:])),
          f"checkpoint: the load's startup marks are out of order: "
          f"{ {k: marks.get(k) for k in order} }")
    spans = {"checkpoint_ms": marks["checkpoint_restore"] - marks["download"],
             "to_device_ms": marks["init_params"]
             - marks["checkpoint_restore"],
             "cache_store_ms": marks["param_cache_store"]
             - marks["init_params"]}
    spans = {k: v * 1e3 for k, v in spans.items()}
    spans["engine_ms"] = seconds * 1e3 - sum(spans.values())
    tensors = {t.data_ptr(): t for t in model.module.state_dict().values()}
    nbytes = sum(t.nbytes for t in tensors.values())     # a tied leaf once
    spans["to_device_gb_per_s"] = nbytes / spans["to_device_ms"] / 1e6
    return dict(spans, load_ms=seconds * 1e3, device_bytes=nbytes)


def bit_equal_modules(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
        for k in sa)


async def drive_checkpoint(bert, resnet, images, rng, vocab: int) -> dict:
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([bert, resnet], host="127.0.0.1")
    port = server.http_port
    try:
        bodies = [rng.integers(1, vocab, size=n).tolist()
                  for n in REQUEST_LENGTHS for _ in range(2)]
        path = f"/v2/models/{bert.name}/infer"
        requests = [(path, json.dumps({"inputs": [{
            "name": "input_ids", "shape": [1, len(ids)],
            "datatype": "INT32", "data": ids}]}).encode(),
            {"content-type": "application/json"}) for ids in bodies]
        # The main path's run: every count starts at 0 here.
        reset_launches()
        executed0 = bert.engine.execute_count
        results, _, _ = await drive_requests(port, requests, 8)
        launches = read_launches()
        batches = bert.engine.execute_count - executed0
        served = []
        for ids, (status, data) in zip(bodies, results):
            check(status == 200, f"checkpoint bert: HTTP {status} "
                  f"{data[:200]!r}")
            outs = {o["name"]: o for o in json.loads(data)["outputs"]}
            bucket = bert.engine.seq_buckets.fit(len(ids))
            values = np.reshape(outs["values"]["data"], (bucket, TOPK))
            indices = np.reshape(outs["indices"]["data"], (bucket, TOPK))
            check_topk(values, indices, bucket, vocab, "checkpoint bert")
            served.append({"values": values, "indices": indices})
        answers, _, _ = await drive_binary_images(
            port, resnet.name, images, CKPT_CONCURRENCY)
    finally:
        await server.stop_async()
    return {"bodies": bodies, "served": served, "launches": launches,
            "batches": batches, "answers": answers}


def serve_checkpoint(card: str) -> dict:
    """Seeded HF-layout BERT-base and ResNet-50 state dicts converted by
    ``python -m kfserving_tpu_torch.tools.convert``, loaded from their
    checkpoints through the port's server and served: BERT over V2 JSON,
    ResNet over the V2 binary wire.  Both loaded modules equal, bit for
    bit, the same weights mapped in memory; their forwards equal that
    module's; BERT's served top-k holds against the plain attention and
    ResNet's argmax against the in-memory forward but for counted
    near-ties."""
    from kfserving_tpu_torch.predictors.torch_model import TorchModel

    bert_arch, resnet_arch = {}, dict(RESNET_CONFIG["arch_kwargs"])
    device = "cuda"
    rng = np.random.default_rng(CKPT_SEED)
    bert_sd = hf_bert_state_dict(rng)
    resnet_sd = hf_resnet_state_dict(rng)
    scale = float(torch.tensor(RESNET_CONFIG["scale"], dtype=torch.bfloat16))
    size = resnet_arch.get("image_size", 224)
    # Calibrate the random network's BatchNorm statistics in memory (its
    # answers then depend on the image) and write them into the HF dict.
    ref_resnet = in_memory_module("resnet50", dict(resnet_arch,
                                                   torch_padding=True),
                                  resnet_sd)
    calib = torch.from_numpy(bench_images(rng, 64, size)).to(device)
    calibrate_batch_norm(ref_resnet, calib.float() * scale)
    for port_name, hf_name in hf_resnet_bn_names().items():
        for ours, theirs in (("mean", "running_mean"), ("var", "running_var")):
            resnet_sd[f"{hf_name}.{theirs}"] = ref_resnet.get_buffer(
                f"{port_name}.{ours}").float().cpu().clone()
    extra = {k: v for k, v in BERT_CONFIG.items() if k != "architecture"}
    rextra = {k: v for k, v in RESNET_CONFIG.items()
              if k not in ("architecture", "arch_kwargs")}
    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-ckpt-")
    models = []
    try:
        conv = {"bert": run_convert(bert_sd, "bert", bert_arch, extra, root),
                "resnet50": run_convert(resnet_sd, "resnet50", resnet_arch,
                                        rextra, root)}
        maps = {arch: timed_map(os.path.join(root, arch), arch)
                for arch in conv}
        # The in-memory twin of the served BERT, built with the arch
        # kwargs the converter wrote (the erf GELU of an HF checkpoint).
        with open(os.path.join(root, "bert", "config.json")) as f:
            written = json.load(f)["arch_kwargs"]
        check(written == dict(bert_arch, gelu_approximate=False),
              f"checkpoint bert: config arch_kwargs {written}")
        ref_bert = in_memory_module("bert", written, bert_sd)
        loads = {}
        for arch, name in (("bert", "bert_ckpt"), ("resnet50", "resnet_ckpt")):
            model = TorchModel(name, os.path.join(root, arch), device=device)
            t0 = time.perf_counter()
            model.load()
            models.append(model)
            loads[arch] = load_split(model, time.perf_counter() - t0)
            check(model.param_source == "checkpoint",
                  f"checkpoint {arch}: param_source {model.param_source}")
        bert, resnet = models
        cfg = bert.module.config
        check((cfg.num_layers, cfg.hidden_size, cfg.num_heads,
               cfg.vocab_size) == (12, 768, 12, 30522),
              "checkpoint: not BERT-base")
        check(cfg.gelu_approximate is False,
              "checkpoint: the converted BERT kept the tanh GELU")
        check(resnet.module.torch_padding,
              "checkpoint: the converted ResNet lost torch_padding")
        for arch, model, ref in (("bert", bert, ref_bert),
                                 ("resnet50", resnet, ref_resnet)):
            check(bit_equal_modules(model.module, ref),
                  f"checkpoint {arch}: the loaded weights differ from the "
                  "same weights mapped in memory")
        images = bench_images(rng, CKPT_IMAGES, size)
        run = asyncio.run(drive_checkpoint(bert, resnet, images, rng,
                                           cfg.vocab_size))
        k1 = run["launches"]["flash_attention"]
        check(run["batches"] > 0 and k1 == cfg.num_layers * run["batches"],
              f"checkpoint bert: flash kernel launched "
              f"{k1} times for {run['batches']} batches of "
              f"{cfg.num_layers} layers")
        check(run["launches"]["paged_attention"] == 0,
              "checkpoint: the paged kernel ran on the predict path")
        # Served against the plain attention, and the loaded module's
        # forward against the in-memory one's on the same padded batch.
        longest = max(range(len(run["bodies"])),
                      key=lambda i: len(run["bodies"][i]))
        reference = check_against_plain(bert, run["bodies"][longest],
                                        run["served"][longest])
        ids = run["bodies"][longest]
        bucket = bert.engine.seq_buckets.fit(len(ids))
        x = torch.zeros((1, bucket), dtype=torch.int64, device=device)
        x[0, :len(ids)] = torch.tensor(ids, device=device)
        mask = (x != 0).to(torch.int32)
        batch = torch.from_numpy(images).to(device).float() * scale
        with torch.inference_mode():
            bert_logits = ref_bert(x, mask).float()
            bert_diff = float((bert.module(x, mask).float()
                               - bert_logits).abs().max())
            resnet_logits = ref_resnet(batch).float()
            resnet_diff = float((resnet.module(batch).float()
                                 - resnet_logits).abs().max())
        # Bit-equal weights on the same kernels: equal forwards, but for a
        # library's run-to-run reduction order.
        resnet_limit = RESNET_TIE_RTOL * float(resnet_logits.abs().max())
        check(bert_diff <= MAX_LOGIT_DIFF and resnet_diff <= resnet_limit,
              f"checkpoint: a loaded module's forward differs from the "
              f"in-memory one's by {bert_diff} (bert) / {resnet_diff} "
              f"(resnet, limit {resnet_limit})")
        kinds = [answer_kind(resnet_logits[i], a, RESNET_TIE_RTOL)
                 for i, a in enumerate(run["answers"])]
        check(all(kinds), f"checkpoint resnet: served argmax off the "
              f"in-memory forward at {[i for i, k in enumerate(kinds) if not k]}")
        distinct = len(set(run["answers"]))
        check(distinct > 1, "checkpoint resnet: every image got one answer")
    finally:
        for model in models:
            model.unload()
        shutil.rmtree(root, ignore_errors=True)
    summary = {
        "card": card, "convert": conv, "map": maps, "load": loads,
        "bert_requests": len(run["bodies"]), "bert_batches": run["batches"],
        "flash_launches": run["launches"]["flash_attention"],
        "reference": reference, "resnet_images": len(images),
        "resnet_near_ties": kinds.count("tie"),
        "resnet_distinct_answers": distinct,
        "vs_in_memory_max_abs_diff": {"bert": bert_diff,
                                      "resnet": resnet_diff},
    }
    print("checkpoint " + json.dumps(summary), flush=True)
    return summary


# -- line "grpc": the V2 gRPC front end over BERT-base and generate_4k ------
GRPC_REQUESTS, GRPC_CONCURRENCY = 32, 8
GRPC_STREAMS = 8


async def drive_grpc(bert, gen, vocab: int) -> dict:
    import grpc

    from kfserving_tpu_torch.protocol.grpc import kfs_generate_pb2 as gpb
    from kfserving_tpu_torch.protocol.grpc import pb2
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0, grpc_port=0)
    await server.start_async([bert, gen], host="127.0.0.1")
    port = server.http_port
    channel = grpc.aio.insecure_channel(f"127.0.0.1:{server.grpc_port}")
    infer = channel.unary_unary(
        "/inference.GRPCInferenceService/ModelInfer",
        request_serializer=pb2.ModelInferRequest.SerializeToString,
        response_deserializer=pb2.ModelInferResponse.FromString)
    stream = channel.unary_stream(
        "/kfserving.generate.GenerationService/GenerateStream",
        request_serializer=gpb.GenerateRequest.SerializeToString,
        response_deserializer=gpb.GenerateStreamResponse.FromString)
    rng = np.random.default_rng(89)
    bodies = [rng.integers(1, vocab, size=REQUEST_LENGTHS[
        i % len(REQUEST_LENGTHS)]).astype(np.int32)
        for i in range(GRPC_REQUESTS)]
    try:
        sem = asyncio.Semaphore(GRPC_CONCURRENCY)

        async def one(i, ids):
            req = pb2.ModelInferRequest(model_name=bert.name, id=f"g{i}")
            t = req.inputs.add(name="input_ids", datatype="INT32",
                               shape=[1, len(ids)])
            if i % 2:
                req.raw_input_contents.append(ids.tobytes())
            else:
                t.contents.int_contents.extend(ids.tolist())
            async with sem:
                t0 = time.perf_counter()
                resp = await infer(req)
                return resp, (time.perf_counter() - t0) * 1e3

        reset_launches()
        executed0 = bert.engine.execute_count
        t0 = time.perf_counter()
        done = await asyncio.gather(*(one(i, ids)
                                      for i, ids in enumerate(bodies)))
        infer_wall_s = time.perf_counter() - t0
        infer_launches = read_launches()
        batches = bert.engine.execute_count - executed0
        served = []
        for i, ((resp, _), ids) in enumerate(zip(done, bodies)):
            outs = {o.name: o for o in resp.outputs}
            bucket = bert.engine.seq_buckets.fit(len(ids))
            if i % 2:
                raw = dict(zip([o.name for o in resp.outputs],
                               resp.raw_output_contents))
                values = np.frombuffer(raw["values"], np.float32)
                indices = np.frombuffer(raw["indices"], np.int32)
            else:
                values = np.asarray(outs["values"].contents.fp32_contents)
                indices = np.asarray(outs["indices"].contents.int_contents)
            check(list(outs["values"].shape) == [1, bucket, TOPK]
                  and resp.id == f"g{i}", f"grpc infer {i}: shape "
                  f"{list(outs['values'].shape)}, id {resp.id!r}")
            values = values.reshape(bucket, TOPK)
            indices = indices.reshape(bucket, TOPK)
            check_topk(values, indices, bucket, vocab, f"grpc infer {i}")
            served.append({"values": values, "indices": indices})

        async def generate(i):
            out = {"ids": [], "text": "", "first_s": None}
            t0 = time.perf_counter()
            async for msg in stream(gpb.GenerateRequest(
                    model_name=gen.name, text_input=gen_prompt(i),
                    max_tokens=GEN_MAX_TOKENS)):
                if out["first_s"] is None:
                    out["first_s"] = time.perf_counter() - t0
                if msg.HasField("token") and msg.token.id >= 0:
                    out["ids"].append(msg.token.id)
                if msg.finish_reason:
                    out["finish_reason"] = msg.finish_reason
                    out["generated_text"] = msg.generated_text
                    out["token_count"] = msg.token_count
            return out

        before = gen.engine.stats()
        reset_launches()
        t0 = time.perf_counter()
        grpc_streams = await asyncio.gather(*(generate(i)
                                              for i in range(GRPC_STREAMS)))
        stream_wall_s = time.perf_counter() - t0
        stream_launches = read_launches()
        after = gen.engine.stats()
        for i, s in enumerate(grpc_streams):
            check(s.get("finish_reason") in ("eos", "length")
                  and s["token_count"] == len(s["ids"]) <= GEN_MAX_TOKENS,
                  f"grpc stream {i}: {s.get('finish_reason')}, "
                  f"{s.get('token_count')} for {len(s['ids'])} ids")
        http_streams = []
        for i in range(GRPC_STREAMS):
            status, events, _, _ = await asyncio.to_thread(
                sse_stream, port, f"/v2/models/{gen.name}/generate_stream",
                {"text_input": gen_prompt(i), "max_tokens": GEN_MAX_TOKENS})
            check(status == 200, f"grpc: SSE stream {i}: HTTP {status}")
            http_streams.append(stream_tokens(events, f"SSE stream {i}"))
    finally:
        await channel.close()
        await server.stop_async()
    return {"bodies": bodies, "served": served,
            "infer_launches": infer_launches, "batches": batches,
            "infer_req_per_s": len(bodies) / infer_wall_s,
            "infer_p50_ms": percentile([ms for _, ms in done], 0.5),
            "streams": grpc_streams, "http_streams": http_streams,
            "stream_launches": stream_launches,
            "stream_tokens_per_s": sum(len(s["ids"]) for s in grpc_streams)
            / stream_wall_s,
            "ttft_p50_ms": percentile([s["first_s"] * 1e3
                                       for s in grpc_streams], 0.5),
            "before": before, "after": after}


def serve_grpc(card: str):
    """BERT-base and the generate_4k decoder behind ``grpc_port``: 32
    ``ModelInfer`` requests (raw and typed INT32) at concurrency 8, then
    8 ``GenerateStream`` streams of 48 tokens at once, each stream's ids
    equal to the same prompt's HTTP SSE ids (or both the greedy choice
    teacher-forced but for counted near-ties).  Runs only where grpc
    and protobuf import; elsewhere prints why and returns None."""
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError as e:
        print(json.dumps({"grpc": f"not run: grpcio not installed ({e})"}),
              flush=True)
        return None
    bert, _ = load_model("bert", BERT_CONFIG)
    gen, _ = load_generative("gen4k", GEN_CONFIG)
    try:
        cfg, gcfg = bert.module.config, gen.module.config
        check((cfg.num_layers, cfg.hidden_size, cfg.num_heads)
              == (12, 768, 12), "grpc: not BERT-base")
        run = asyncio.run(drive_grpc(bert, gen, cfg.vocab_size))
        k1 = run["infer_launches"]["flash_attention"]
        check(run["batches"] > 0 and k1 == cfg.num_layers * run["batches"],
              f"grpc infer: flash kernel launched {k1} times for "
              f"{run['batches']} batches")
        reference = check_against_plain(bert, run["bodies"][-1].tolist(),
                                        run["served"][-1])
        before, after = run["before"], run["after"]
        waves = after["decode_steps"] - before["decode_steps"]
        prefills = after["prefills"] - before["prefills"]
        want = {"flash_attention": gcfg.num_layers * prefills,
                "paged_attention": (gcfg.num_layers * waves
                                    * after["steps_per_call"])}
        check(waves > 0 and prefills > 0 and run["stream_launches"] == want,
            f"grpc streams: launches {run['stream_launches']}, want {want}")
        grpc_ids = [s["ids"] for s in run["streams"]]
        equal = sum(a == b for a, b in zip(grpc_ids, run["http_streams"]))
        held = None
        if equal < GRPC_STREAMS:
            held = {"grpc": hold_greedy_tokens(gen.module, gen.tokenizer,
                                               grpc_ids),
                    "http": hold_greedy_tokens(gen.module, gen.tokenizer,
                                               run["http_streams"])}
    finally:
        bert.unload()
        gen.unload()
    summary = {
        "card": card, "infer_requests": GRPC_REQUESTS,
        "concurrency": GRPC_CONCURRENCY, "infer_batches": run["batches"],
        "infer_req_per_s": run["infer_req_per_s"],
        "infer_p50_ms": run["infer_p50_ms"], "reference": reference,
        "streams": GRPC_STREAMS, "max_tokens": GEN_MAX_TOKENS,
        "stream_tokens_per_s": run["stream_tokens_per_s"],
        "ttft_p50_ms": run["ttft_p50_ms"], "prefills": prefills,
        "decode_waves": waves, "streams_equal_to_sse": equal,
        "held_where_unequal": held,
        "launches": {"infer": run["infer_launches"],
                     "streams": run["stream_launches"]},
    }
    print("grpc " + json.dumps(summary), flush=True)
    return summary


# -- line "hf_tokenizer": an hf:<local dir> tokenizer behind generate_4k ----
HF_TOKENIZER_SEED, HF_STREAMS = 97, 4


def write_hf_tokenizer(path: str, vocab_size: int) -> None:
    """A byte-level BPE of exactly ``vocab_size`` ids, saved with
    ``PreTrainedTokenizerFast.save_pretrained``: ids 0 and 1 are <s> and
    </s>, then the 256 byte symbols, then seeded merges of two earlier
    tokens.  Every id the decoder can pick decodes to bytes, many of them
    pieces of multi-byte characters."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    rng = np.random.default_rng(HF_TOKENIZER_SEED)
    tokens = ["<s>", "</s>"] + sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    while len(tokens) < vocab_size:
        a, b = (tokens[i] for i in rng.integers(2, len(tokens), 2))
        if a + b not in vocab:
            vocab[a + b] = len(tokens)
            tokens.append(a + b)
            merges.append((a, b))
    tok = Tokenizer(models.BPE(vocab, merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(["<s>", "</s>"])
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                            eos_token="</s>").save_pretrained(path)


def serve_hf_tokenizer(card: str):
    """The generate_4k decoder served with an ``hf:<local dir>``
    tokenizer of its 32000 ids: 4 SSE streams of 48 tokens at once.  The
    prompt's ids equal ``transformers``' own encode; each stream's text is
    the tokenizer's decode of its ids; every id is the greedy choice of
    the model teacher-forced over the prompt (but for counted near-ties);
    K1 and K2 launch as in the generate phase.  Runs only where
    transformers and tokenizers import; elsewhere prints why and returns
    None."""
    try:
        import tokenizers  # noqa: F401
        import transformers  # noqa: F401
    except ImportError as e:
        print(json.dumps({"hf_tokenizer": "not run: transformers or "
                          f"tokenizers not installed ({e})"}), flush=True)
        return None
    from transformers import AutoTokenizer

    vocab = GEN_CONFIG["arch_kwargs"]["vocab_size"]
    root = tempfile.mkdtemp(prefix="kfs-chip-smoke-hf-")
    try:
        t0 = time.perf_counter()
        write_hf_tokenizer(root, vocab)
        write_s = time.perf_counter() - t0
        gen, load_s = load_generative("gen4k", GEN_CONFIG,
                                      tokenizer=f"hf:{root}")
        try:
            tok = gen.tokenizer
            check((tok.vocab_size, tok.bos_id, tok.eos_id) == (vocab, 0, 1),
                  f"hf_tokenizer: vocab {tok.vocab_size}, bos {tok.bos_id}, "
                  f"eos {tok.eos_id}")
            ref = AutoTokenizer.from_pretrained(root, local_files_only=True)
            prompt_ids = [tok.encode(gen_prompt(i))
                          for i in range(HF_STREAMS)]
            check(all(ids == [0] + ref.encode(gen_prompt(i),
                                              add_special_tokens=False)
                      for i, ids in enumerate(prompt_ids)),
                  "hf_tokenizer: the served encode differs from "
                  "transformers'")
            run = asyncio.run(drive_hf_streams(gen))
            texts = []
            for i, events in enumerate(run["streams"]):
                ids = stream_tokens(events, f"hf stream {i}")
                text = "".join(e["token"]["text"] for e in events
                               if e.get("token"))
                check(text == tok.decode(ids) == ref.decode(
                    ids, skip_special_tokens=True)
                    == events[-1]["generated_text"],
                    f"hf stream {i}: streamed text {text!r} is not the "
                    f"decode of its ids {tok.decode(ids)!r}")
                texts.append((ids, text))
            gcfg = gen.module.config
            before, after = run["before"], run["after"]
            waves = after["decode_steps"] - before["decode_steps"]
            prefills = after["prefills"] - before["prefills"]
            want = {"flash_attention": gcfg.num_layers * prefills,
                    "paged_attention": (gcfg.num_layers * waves
                                        * after["steps_per_call"])}
            check(waves > 0 and prefills > 0 and run["launches"] == want,
                  f"hf streams: launches {run['launches']}, want {want}")
            held = hold_greedy_tokens(gen.module, tok,
                                      [ids for ids, _ in texts])
        finally:
            gen.unload()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = {
        "card": card, "vocab": vocab, "write_s": write_s,
        "load_and_warmup_s": load_s,
        "prompt_tokens": [len(ids) for ids in prompt_ids],
        "streams": HF_STREAMS, "max_tokens": GEN_MAX_TOKENS,
        "tokens": [len(ids) for ids, _ in texts],
        # Ids that alone decode to a partial or invalid UTF-8 sequence.
        "replacement_pieces": sum("\ufffd" in tok.decode([i])
                                  for ids, _ in texts for i in ids),
        "text_chars": [len(text) for _, text in texts],
        "prefills": prefills, "decode_waves": waves, "held": held,
        "launches": run["launches"],
    }
    print("hf_tokenizer " + json.dumps(summary), flush=True)
    return summary


async def drive_hf_streams(gen) -> dict:
    from kfserving_tpu_torch.server.app import ModelServer

    server = ModelServer(http_port=0)
    await server.start_async([gen], host="127.0.0.1")
    path = f"/v2/models/{gen.name}/generate_stream"
    try:
        async def one(i):
            status, events, _, _ = await asyncio.to_thread(
                sse_stream, server.http_port, path,
                {"text_input": gen_prompt(i), "max_tokens": GEN_MAX_TOKENS})
            check(status == 200, f"hf stream {i}: HTTP {status} {events}")
            return events

        before = gen.engine.stats()
        # The main path's run: every count starts at 0 here.
        reset_launches()
        streams = await asyncio.gather(*(one(i) for i in range(HF_STREAMS)))
        launches = read_launches()
        after = gen.engine.stats()
    finally:
        await server.stop_async()
    return {"streams": streams, "launches": launches, "before": before,
            "after": after}


def check_codec(card: str) -> dict:
    """The port's native codec builds here (the host C compiler against
    this interpreter's Python.h) and parses a seeded 224 x 224 x 3 uint8
    V1 body to the same array as its pure-Python fallback; host us per
    body of each."""
    from kfserving_tpu_torch.csrc import build
    from kfserving_tpu_torch.protocol import native

    t0 = time.perf_counter()
    check(native.available(), "the native tensorjson codec did not build "
          f"or load: {build.build_logs.get('tensorjson', '')[-2000:]}")
    build_s = time.perf_counter() - t0
    image = np.random.default_rng(7).integers(0, 256, (1, 224, 224, 3))
    body = json.dumps({"instances": image.tolist()}).encode()
    parsers = {"native": lambda: native.parse_v1(body, "u1"),
               "python": lambda: native._parse_v1_py(body, "u1")}
    arrays, us = {}, {}
    for name, parse in parsers.items():
        arrays[name] = parse()
        t0 = time.perf_counter()
        for _ in range(CODEC_ITERS[name]):
            parse()
        us[name] = (time.perf_counter() - t0) / CODEC_ITERS[name] * 1e6
    (fast, key), (slow, slow_key) = arrays["native"], arrays["python"]
    check(key == slow_key == "instances" and fast.dtype == slow.dtype
          == np.uint8 and fast.shape == slow.shape == image.shape
          and np.array_equal(fast, slow) and np.array_equal(fast, image),
          "native and pure-Python parses of one body differ")
    summary = {"card": card, "body_bytes": len(body),
               "build_and_load_s": build_s,
               "native_us_per_body": us["native"],
               "python_us_per_body": us["python"],
               "speedup": us["python"] / us["native"]}
    print("codec " + json.dumps(summary), flush=True)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    from kfserving_tpu_torch.csrc import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libraries = build.build_all()
    print(f"built {sorted(libraries)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.perf_counter() - t0, 1)

    phase("codec", check_codec, card)
    kernels = [phase("flash_attention", check_flash_attention),
               phase("paged_attention", check_paged_attention)]
    torch.cuda.empty_cache()
    # Every model loads through the mmap param cache: a private one.
    cache = tempfile.mkdtemp(prefix="kfs-chip-smoke-params-")
    os.environ["KFS_PARAM_CACHE"] = cache
    try:
        tiny = phase("tiny_models", load_tiny_models, card)
        serving = phase("bert", serve_bert, card)
        generating = phase("generate", serve_generate, card)
        gemma = phase("generate_d256", serve_generate, card, "gen_d256",
                      GEMMA_CONFIG, GEMMA_WIDTHS)
        observing = phase("observe", serve_observe, card)
        dense = phase("generate_dense", serve_generate_dense, card)
        cold = phase("generate_cold4k", serve_cold4k, card)
        spec = phase("specdec", serve_specdec, card)
        kvtier = phase("kvtier", serve_kvtier, card)
        kvhandoff = phase("kvhandoff", serve_kvhandoff, card)
        resnet = phase("resnet", serve_resnet, card)
        vit = phase("vit", serve_vit, card)
        vit_h14 = phase("vit_h14", serve_vit, card, "vit_h14",
                        VIT_H14_CONFIG, VIT_H14_WIDTHS)
        explain = phase("explain", serve_explain, card)
        phase("explain_blackbox", serve_explain_blackbox, card)
        phase("explain_storage", serve_storage, card)
        phase("multi_model", serve_multi_model, card)
        residency = phase("residency", serve_residency, card)
        phase("density", serve_density, card)
        chain, activate = phase("chain_activate", serve_chain, card)
        phase("recycle", serve_recycle, card)
        rolling = phase("rollout", serve_rollout, card)
        agent = phase("agent", serve_agent, card)
        # No path of these three runs K1 or K2: counted from 0 around them.
        reset_launches()
        phase("tabular", serve_tabular, card)
        phase("torchserver", serve_torchserver, card)
        phase("detectors", serve_detectors, card)
        host_paths = read_launches()
        check(not any(host_paths.values()), f"tabular, torchserver and "
              f"detectors launched K1 or K2: {host_paths}")
        meshes = phase("mesh", serve_mesh, card)
        checkpoint = phase("checkpoint", serve_checkpoint, card)
        phase("openapi", serve_openapi, card)
        grpc_run = phase("grpc", serve_grpc, card)
        hf_run = phase("hf_tokenizer", serve_hf_tokenizer, card)
        phase("metrics_lint", report_metrics_lint, card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    # K1 and K2 run on these serving paths; each path's count was read
    # from 0 just before it ran.
    generative = ([generating["launches"], gemma["launches"],
                   observing["launches"], dense["launches"]]
                  + [arm["launches"] for arm in cold["arms"].values()]
                  + [arm["launches"] for arm in spec["arms"].values()]
                  + [kvtier["launches"], kvhandoff["launches"]])
    kernels[0]["launches"] = (serving["flash_launches"]
                              + vit["flash_launches"]
                              + vit_h14["flash_launches"]
                              + explain["vit"]["k1_launches"]
                              + residency["flash_launches"]
                              + chain["flash_launches"]
                              + activate["flash_launches"]
                              + rolling["flash_launches"]
                              + agent["flash_launches"]
                              + sum(g["flash_attention"] for g in generative)
                              + meshes["launches"]["flash_attention"]
                              + checkpoint["flash_launches"])
    kernels[1]["launches"] = (sum(g["paged_attention"] for g in generative)
                              + meshes["launches"]["paged_attention"])
    # grpc runs only where grpcio imports, hf_tokenizer where transformers
    # does.
    optional = []
    if grpc_run is not None:
        optional += grpc_run["launches"].values()
    if hf_run is not None:
        optional.append(hf_run["launches"])
    for part in optional:
        kernels[0]["launches"] += part["flash_attention"]
        kernels[1]["launches"] += part["paged_attention"]
    print("graphs " + json.dumps({
        "card": card,
        "predict": {"bert": serving["graphs"], "resnet": resnet["graphs"],
                    "vit": vit["graphs"]},
        "compile_cache": {"bert": serving["compile_cache"],
                          "resnet": resnet["compile_cache"],
                          "vit": vit["compile_cache"]},
        "decode_wave": {
            "greedy": generating["graphs"]["greedy"],
            "seeded": generating["graphs"]["seeded"],
            "wave_graphs": generating["graphs"]["graph_stats"],
            "graph_wave_ms": generating["device"]["graph_wave_ms"],
            "graph_wave_busy_ms": generating["device"]["graph_wave_busy_ms"],
            "eager_wave_ms": generating["device"]["wave_ms"],
            "eager_wave_busy_ms":
                generating["device"]["wave_kernel_busy_ms"],
            "host_syncs": generating["device"]["graph_wave_host_syncs"]},
        "residency": {k: residency[k] for k in (
            "warm_fault_n", "warm_fault_p50_ms", "warm_request_p50_ms",
            "capture_ms_mean")},
        "launches": {"flash_attention": kernels[0]["launches"],
                     "paged_attention": kernels[1]["launches"]},
        "generator": {"dense_wave": dense["graphs"],
                      "chunk": cold["chunk_graph"],
                      "spec": spec["graphs"]},
        "tiny_models": {k: v.get("warmup_flash_launches")
                        for k, v in tiny.items()}}),
        flush=True)
    print("stages " + json.dumps({
        "card": card, "resnet_json_req_per_s": resnet["req_per_s"],
        "resnet_binary_req_per_s": resnet["binary"]["req_per_s"],
        "engine_stage_means": {
            "bert": serving["engine_stage_means"],
            "resnet": resnet["engine_stage_means"],
            "vit": vit["engine_stage_means"]}}), flush=True)
    print("phase_seconds " + json.dumps(
        dict(seconds, total=round(sum(seconds.values()), 1))), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)   # as nvidia-smi prints it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
