"""Times the paged decode kernel's hopper path under other split plans.

    python3 -m kfserving_tpu_torch.tools.paged_sweep [--iters N]

Needs a CUDA card.  Builds the kernels, prints the paged kernel's ptxas
report, then for each decode case (seeded pools at the decoder's shapes)
and each plan (stage bytes, ring stages, CTAs per SM, consumer threads,
span tokens) prints one JSON line: the plan and its device time per call from
torch.profiler (the kernels' summed durations, and each kernel's), taken
twice, the second round in reverse order.  The default plan's line is
marked.  Beside the default plan it times a build whose consumers skip
the arithmetic (-DKFS_PAGED_LOADS_ONLY=1: the copies, the ring and the
merge alone) and torch.sum over a contiguous tensor of the same bytes (a
streaming read on this card).  Every output of the served build is held
against ``paged_attention_plain`` within the bf16 limit.  Last, the wrapper is captured in a CUDA graph, the lengths are
changed in place and the replay is held against the plain version.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

from kfserving_tpu_torch.ops import paged_attention as pa

# bf16 against the fp32 plain version: 2 ** -6 of the vector's largest
# element plus 1e-5 (chip_smoke.py's limit).
BF16_RTOL, BF16_ATOL = 2 ** -6, 1e-5
B, MB, BS = 8, 32, 128
DECODE = [3021 + 4 * i for i in range(B)]
CASES = {
    "b8 decode ~3045 bf16": (12, 64, DECODE),
    "tp2 rank: b8 decode ~3045 bf16 H6": (6, 64, DECODE),
    "b8 decode ~3045 bf16 D128": (12, 128, DECODE),
    "b1 4096 bf16": (12, 64, [4096]),
}
# (stage bytes, ring stages, CTAs per SM, consumer threads, span tokens)
# of each plan timed beside split_plan's default.
VARIANTS = [
    (48 * 1024, 2, 1, 512, 32),
    (48 * 1024, 2, 1, 512, 128),
    (48 * 1024, 2, 1, 512, 256),
    (48 * 1024, 3, 1, 512, 64),
    (48 * 1024, 2, 1, 256, 64),
    (24 * 1024, 4, 2, 256, 64),
    (96 * 1024, 2, 1, 512, 64),
]


def make_case(gen, H, D, lengths):
    rows = len(lengths)
    nb = rows * MB + 8
    q = torch.randn((rows, 1, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    pool_k, pool_v = (torch.randn((nb + 1, BS, H, D), generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(2))
    table = torch.randperm(nb, generator=gen, device="cuda")[:rows * MB]
    table = table.reshape(rows, MB).to(torch.int32).contiguous()
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool_k, pool_v, table, lengths


def share_of_limit(out, ref) -> float:
    err = (out.float() - ref.float()).abs()
    limit = BF16_RTOL * ref.float().abs().amax(-1, keepdim=True) + BF16_ATOL
    return float((err / limit).max())


def device_ms(fn, iters: int) -> tuple:
    """(ms per call, ms per call of each device kernel by short name)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.split("<")[0].split("::")[-1]
            kernels[name] = (kernels.get(name, 0.0)
                             + e.self_device_time_total / 1e3 / iters)
    return sum(kernels.values()), kernels


def loads_only_kernel():
    """The hopper entry point of a build with -DKFS_PAGED_LOADS_ONLY=1:
    its consumers skip the arithmetic, so its time is that of the copies,
    the ring and the merge alone."""
    from kfserving_tpu_torch.csrc import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "libpaged_attention-loads-only.so")
    cmd = build.nvcc_command(build.find_nvcc(), "paged_attention", out)
    subprocess.run(cmd + ["-DKFS_PAGED_LOADS_ONLY=1"], check=True,
                   capture_output=True, timeout=600)
    return pa.bind(ctypes.CDLL(out), "kfs_paged_attention_hopper")


def yardsticks(case, plan, loads_only, iters: int) -> dict:
    """The default plan's time beside its loads-only build's, and a
    streaming read of the same bytes: torch.sum over one contiguous bf16
    tensor of the case's valid K and V."""
    q, _, _, _, lengths = case
    _, _, H, D = q.shape
    tokens = sum(min(max(int(n), 0), MB * BS) for n in lengths.tolist())
    flat = torch.ones(2 * tokens * H * D, dtype=torch.bfloat16,
                      device="cuda")
    return {
        "ms": device_ms(lambda: pa.launch_hopper(*case, plan), iters)[0],
        "loads_only_ms": device_ms(lambda: pa.launch_hopper(
            *case, plan, kernel=loads_only), iters)[0],
        "stream_read_ms": device_ms(
            lambda: flat.sum(dtype=torch.float32), iters)[1].get(
                "reduce_kernel"),
        "stream_read_bytes": flat.numel() * 2}


def graph_check(gen) -> dict:
    args = make_case(gen, 12, 64, DECODE)
    q, pool_k, pool_v, table, lengths = args
    pa.paged_attention_kernel(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention_kernel(*args)
    shares = []
    for new in ([5, 4096, 0, 129, 1, 2000, 4097, 3000], DECODE):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args)
        shares.append(share_of_limit(out, ref))
        zero = [r for r, n in enumerate(new) if n == 0]
        if any(bool((out[r] != 0).any()) for r in zero):
            raise SystemExit("graph replay: a zero-length row is not 0")
    return {"graph_replay_share_of_limit": shares}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("paged_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from kfserving_tpu_torch.csrc import build

    build.build_all(["paged_attention"])
    for line in build.build_logs.get("paged_attention", "").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("ptxas " + line.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    loads_only = loads_only_kernel()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = 0.0
    for name, (H, D, lengths) in CASES.items():
        case = make_case(gen, H, D, lengths)
        ref = pa.paged_attention_plain(*case)
        rows = len(lengths)
        default = pa.split_plan(rows, H, D, BS, MB, sms)
        plans = [default]
        for stage_bytes, stages, per_sm, consumers, span in VARIANTS:
            try:
                plan = pa.split_plan(rows, H, D, BS, MB, sms,
                                     stage_bytes=stage_bytes, stages=stages,
                                     ctas_per_sm=per_sm, consumers=consumers,
                                     span_tokens=span)
            except ValueError:  # the ring overflows a CTA's shared memory
                continue
            if plan not in plans:
                plans.append(plan)
        # Two rounds, the second in reverse order: the spread between a
        # plan's two times is the noise its comparison must beat.
        times = {plan: [] for plan in plans}
        for order in (plans, plans[::-1]):
            for plan in order:
                out = pa.launch_hopper(*case, plan)
                torch.cuda.synchronize()
                share = share_of_limit(out, ref)
                worst = max(worst, share)
                times[plan].append(device_ms(
                    lambda: pa.launch_hopper(*case, plan), args.iters))
        print("paged_sweep " + json.dumps({
            "case": name, **yardsticks(case, default, loads_only,
                                       args.iters)}), flush=True)
        for plan in plans:
            print("paged_sweep " + json.dumps({
                "case": name, "plan": dataclasses.asdict(plan),
                "default": plan == default,
                "ms": [ms for ms, _ in times[plan]],
                "kernels_ms": [k for _, k in times[plan]]}), flush=True)
    graph = graph_check(gen)
    print("paged_sweep " + json.dumps(graph), flush=True)
    worst = max([worst] + graph["graph_replay_share_of_limit"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"ok": worst <= 1.0, "worst_share_of_limit": worst,
                      "card": card}), flush=True)
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
