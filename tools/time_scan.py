#!/usr/bin/env python3
"""Time ``run_federated``'s eager vmap path against the scan engine on the
card: the ``train`` job of ``chip_smoke.py`` (fed-100m at full width and
depth, 4 clients, 3 rounds of 5 local steps of 8×256, flash) in turns —
eager vmap, scan in one chunk, scan in chunks of one, scan without
prefetch — then one profiled job of each engine (device time, the
device's idle share, the host's stream syncs and the costliest host ops):

    python tools/time_scan.py [--turns N]

Prints one JSON line per turn and per profile, then the card's name and
power limit.  The jobs are host-bound and spread from run to run: compare
engines inside one call only.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the engines timed in each turn: (label, FedConfig fields)
ENGINES = (("eager vmap", {}),
           ("scan, one chunk", dict(engine="scan", chunk_rounds=3)),
           ("scan, chunks of one", dict(engine="scan", chunk_rounds=1)),
           ("scan, one chunk, no prefetch",
            dict(engine="scan", chunk_rounds=3, scan_prefetch=False)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_scan: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.models.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("fed-100m")

    def job(**kw):
        return cs.train_job(torch, cfg, dev, "flash", cs.TRAIN, "vmap", **kw)

    with contextlib.redirect_stdout(io.StringIO()):
        job()                         # builds the kernels, warms the card
    for turn in range(args.turns):
        for label, kw in ENGINES:
            out, wall = job(**kw)
            print(json.dumps({"turn": turn, "engine": label,
                              "round_wall_s": [r.wall_s
                                               for r in out["history"]],
                              "job_wall_s": wall}), flush=True)
    for label, kw in ENGINES[:2]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            job(**kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        split = cs.device_split(prof, wall_us, 0)
        ops = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)
        print(json.dumps({
            "profile": label,
            **{k: v for k, v in split.items() if k != "top"},
            "stream_syncs": sum(e.count for e in ops
                                if e.key == "cudaStreamSynchronize"),
            "host_top": [{"op": e.key, "calls": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in ops[:12]]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
