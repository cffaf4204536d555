#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers compared
with the reference on sound runs of the program over many seeds, and on the
control (the program with a lower precision switched on, by default its
bf16 band storage, held to the reference at the configuration's float32).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--seconds 2] [--first-seed N] [--out FILE]

Each seed is one short window at the cell's own load, in this one process
(the program's kernels are built once).  Prints one JSON line per run and a
summary: per number, the largest reading of the sound runs (the lower end
of its limit) and the smallest of the control's (the upper end).  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = {"storage": "bfloat16"}


def readings(cell: str, seeds, control_seeds, seconds: float, devices=None, size=None,
             log=None):
    """(sound, control): lists of {"seed", "correct", "attempted", "checks"}
    of runs of ``cell``, the control's with ``CONTROL`` in the program's
    fields."""
    from benchmark.harness import cell as cell_mod

    kw = {} if log is None else {"log": log}
    sound, ctrl = [], []
    for group, fields, out in ((seeds, None, sound),
                               (control_seeds, CONTROL, ctrl)):
        for seed in group:
            r = cell_mod.run(cell, seed, seconds, False, time.perf_counter(), devices=devices,
                             size=size, program_fields=fields, **kw)
            out.append({"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                        "checks": {k: v["value"] for k, v in r["checks"].items()}})
    return sound, ctrl


def summary(sound, ctrl) -> dict:
    names = sound[0]["checks"] if sound else ctrl[0]["checks"]
    return {k: {"lower_max_sound": max(r["checks"][k] for r in sound) if sound else None,
                "upper_min_control": min(r["checks"][k] for r in ctrl) if ctrl else None}
            for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    first = args.first_seed
    seeds = [first + 7919 * i for i in range(args.seeds)]
    cseeds = [first + 104729 + 7919 * i for i in range(args.control_seeds)]
    sound, ctrl = readings(args.workload, seeds, cseeds, args.seconds)
    lines = [json.dumps({"run": "sound", **r}) for r in sound]
    lines += [json.dumps({"run": "control", **r}) for r in ctrl]
    lines.append(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                             "summary": summary(sound, ctrl)}))
    text = "\n".join(lines) + "\n"
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
