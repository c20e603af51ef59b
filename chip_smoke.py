#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``kfserving_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, each fatal on
failure:

1. print the card's name and power limit; build every kernel under
   ``kfserving_tpu_torch/csrc/`` with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and time kernel, plain version and the library
   call that computes the same function (a yardstick only);
3. serve BERT-base fill-mask (full width, seeded random init, bf16) through
   the port's ModelServer, send V1 and V2 requests over HTTP, check the
   answers, check that every encoder layer of every executed batch
   launched the flash kernel, and hold the served model against the same
   weights run with the plain attention;
4. print one ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device.  Imports
nothing of JAX.
"""

import asyncio
import http.client
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its operand type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain version: max abs error allowed, by dtype.  bf16: the
# output is rounded to bf16 (one ulp is 2^-7 at magnitude 1) and P is
# rounded to bf16 in both; fp32: the kernel splits operands into bf16
# hi + lo halves (about 16 mantissa bits).
TOLERANCE = {"bfloat16": 2e-2, "float32": 2e-4}

SEQ_BUCKETS = [32, 64, 128, 256, 512]
BATCH_BUCKETS = [1, 4, 16]
REQUEST_LENGTHS = [24, 48, 100, 200, 450]
TOPK = 5
# Served model vs the same weights with plain attention (both bf16): the
# share of positions whose top-1 token agrees, and the largest logit gap.
MIN_TOP1_AGREEMENT = 0.9
MAX_LOGIT_DIFF = 0.5


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


# -- phase 2: kernels against their plain versions ---------------------------
def attention_bound_ms(B, H, L, D, dtype, causal, lengths) -> tuple:
    """Least time for this call's work: (ms, "bytes" | "operations")."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if lengths is not None:
        keys = [min(int(n), L) for n in lengths.tolist()]
        pairs = sum(L * n for n in keys)
        kv_rows = sum(keys)
    elif causal:
        pairs = B * L * (L + 1) // 2
        kv_rows = B * L
    else:
        pairs = B * L * L
        kv_rows = B * L
    ops = 4 * H * D * pairs
    nbytes = (2 * B * L + 2 * kv_rows) * H * D * itemsize
    if lengths is not None:
        nbytes += 4 * B
    op_s = ops / PEAK_OPS_PER_S[str(dtype).split(".")[-1]]
    byte_s = nbytes / PEAK_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations"
    return byte_s * 1e3, "bytes"


def check_flash_attention() -> dict:
    import torch.nn.functional as F

    from kfserving_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, H, L, D, dtype, causal, lengths
        ("L128 bf16 kv_lengths", 16, 12, 128, 64, bf16, False, True),
        ("L128 bf16 causal", 16, 12, 128, 64, bf16, True, False),
        ("L512 bf16 causal", 16, 12, 512, 64, bf16, True, False),
        ("L512 bf16 full", 16, 12, 512, 64, bf16, False, False),
        ("L512 fp32 D128 kv_lengths", 16, 12, 512, 128, fp32, False, True),
        # The serving path's largest shape; its row goes in the
        # kernels line.
        ("L512 bf16 kv_lengths", 16, 12, 512, 64, bf16, False, True),
    ]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []
    for name, B, H, L, D, dtype, causal, ragged in cases:
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda",
                               dtype=dtype) for _ in range(3))
        lengths = None
        if ragged:
            lengths = torch.randint(1, L + 1, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            lengths[0], lengths[1], lengths[2] = L, 0, L // 2 + 3
        out = flash_attention(q, k, v, causal=causal, kv_lengths=lengths)
        ref = flash_attention_plain(q, k, v, causal=causal,
                                    kv_lengths=lengths)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        tol = TOLERANCE[str(dtype).split(".")[-1]]
        check(err <= tol, f"{name}: max abs error {err} > {tol}")
        if ragged:
            check(bool((out[1] == 0).all()),
                  f"{name}: the zero-length row is not 0")
        ms = cuda_time_ms(lambda: flash_attention(
            q, k, v, causal=causal, kv_lengths=lengths))
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, kv_lengths=lengths), iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if ragged:
            keys = torch.arange(L, device="cuda")
            mask = (keys[None, :] < lengths[:, None])[:, None, None, :]
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal))
        bound_ms, bound_by = attention_bound_ms(B, H, L, D, dtype, causal,
                                                lengths)
        row = {"case": name, "max_abs_err": err, "tolerance": tol,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        print("flash_attention " + json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, out, ref
    main_row = results[-1]
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
    }


# -- phase 3: BERT-base through the port's server ----------------------------
def http_json(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        payload = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        conn.request(method, path, body=payload,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        latency_ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    return resp.status, (json.loads(data) if data else None), latency_ms


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
    finally:
        await server.stop_async()
    latencies = sorted(lat for lat, _ in done)
    return {"launches": launches, "batches": batches,
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


def serve_bert(card: str) -> dict:
    from kfserving_tpu_torch.predictors.torch_model import TorchModel

    with tempfile.TemporaryDirectory(prefix="kfs-chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump({"architecture": "bert", "seq_buckets": SEQ_BUCKETS,
                       "batch_buckets": BATCH_BUCKETS,
                       "max_batch_size": 16, "output": "topk",
                       "topk": TOPK}, f)
        model = TorchModel("bert", model_dir, device="cuda")
        t0 = time.perf_counter()
        model.load()
        load_s = time.perf_counter() - t0
    cfg = model.module.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads)
          == (12, 768, 12), "not BERT-base")
    rng = np.random.default_rng(0)
    try:
        run = asyncio.run(drive_server(model, cfg.vocab_size, rng))
        check(run["batches"] > 0, "no batch executed")
        check(run["launches"] >= cfg.num_layers * run["batches"],
              f"flash kernel launched {run['launches']} times for "
              f"{run['batches']} batches of {cfg.num_layers} layers")
        reference = check_against_plain(model, run["bodies"][100],
                                        run["served"][100])
        stats = model.engine_stats()
        largest = time_largest_bucket(model)
    finally:
        model.unload()
    summary = {
        "card": card, "load_and_warmup_s": load_s,
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
    }
    print("serving " + json.dumps(summary), flush=True)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    from kfserving_tpu_torch.csrc import build

    os.environ.pop("KFS_DISABLE_FLASH", None)
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
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    kernels = [check_flash_attention()]
    serving = serve_bert(card)
    kernels[0]["launches"] = serving["flash_launches"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)   # as nvidia-smi prints it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
