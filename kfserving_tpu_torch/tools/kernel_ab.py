"""Times K2 (paged decode attention) of this checkout against another
checkout's on one card, in turns: other, this, this, other.

    python3 -m kfserving_tpu_torch.tools.kernel_ab OTHER_ROOT

Needs a CUDA card.  Each turn is a process of its own, run from a
checkout's root: it builds that checkout's paged kernel and runs its
``chip_smoke.check_paged_attention()``, which holds every case against the
plain version and prints a row per case ("paged_attention {...}") with the
kernel's profiled device time.  Prints one JSON line per case that both
checkouts run: the four times in turn order and each side's mean, then the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TURN = ("from kfserving_tpu_torch.csrc import build; "
        "build.build_all(['paged_attention']); "
        "import chip_smoke as cs; cs.check_paged_attention()")


def turn(root: str) -> dict:
    """Case name -> the kernel's device ms, from one run in ``root``."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_ab: the turn in {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("paged_attention {"):
            row = json.loads(line[len("paged_attention "):])
            rows[row["case"]] = row["ms"]
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the checkout to compare")
    args = parser.parse_args()
    other = os.path.abspath(args.other)
    order = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    turns = [(side, turn(root)) for side, root in order]
    common = [case for case in turns[0][1] if case in turns[1][1]]
    for case in common:
        times = [(side, rows[case]) for side, rows in turns]
        mean = {s: sum(ms for side, ms in times if side == s) / 2
                for s in ("other", "this")}
        print("kernel_ab " + json.dumps({
            "case": case, "turns": times, "other_ms": mean["other"],
            "this_ms": mean["this"],
            "this_to_other": mean["this"] / mean["other"]}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
