#!/usr/bin/env python3
"""Time the wkv6 kernel of one tree of this repository on the card, at the
shape ``chip_smoke.py`` times it (``WKV6_FULL``: the rwkv6-1.6b prefill,
B=8, T=512, H=32, hd=64; bf16 r/k/v/u, f32 w and state) and at B=1 and
32, so that two trees can be compared inside one run on one card:

    python tools/time_wkv6.py [--tree DIR] [--label NAME]

``DIR`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under it.  Prints
one JSON line per batch size with the launch's block count (one per
(b, h)), the card's bound, the device time
in µs (the events of ``chip_smoke.time_ms``; at B=8 the operands are
cycled through more copies than the L2 holds) and the SHA-256 of the final
state and of y (their first 16 hex digits; every tree gets the same inputs
from the same seed, so equal digests mean bitwise equal outputs).  The
prefill shape's y and state are held to ``wkv6_ref`` first, at the
tolerance of ``chip_smoke.wkv6_check``.  Then the card's name and power
limit.  To compare a change with its parent, run parent, change, change,
parent in one call.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def lines(torch, cs, bounds, wkv_ops, wkv_ref, dev, base: dict):
    """Check at the prefill shape, then time at B = 8, 1, 32."""
    _, t, h, hd = cs.WKV6_FULL
    for b in (8, 1, 32):
        gen = torch.Generator(device=dev).manual_seed(15 + b)
        bd = bounds.wkv6(b, h, t, hd, "bfloat16")
        copies = cs.copies_for(bd.nbytes) if b == 8 else 1
        sets = [cs.wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen)
                for _ in range(copies)]
        line = {**base, "kernel": "wkv6", "b": b, "t": t, "h": h, "hd": hd,
                "blocks": b * h}
        if b == 8:
            errs, bad, _, finite, _ = cs.wkv6_check(torch, wkv_ops, wkv_ref,
                                                    sets[0])
            cs.require(bad == 0 and finite,
                       f"{base}: wkv6 disagrees with wkv6_ref: {errs}")
            line["max_abs_err"] = errs
        y, state = wkv_ops.wkv6(*sets[0])
        cs.holds_used()
        cs.emit({**line, "us": 1e3 * cs.time_ms(torch, wkv_ops.wkv6, sets),
                 "bound_us": 1e3 * bd.ms,
                 "state_sha256": cs.digest(torch, state),
                 "y_sha256": cs.digest(torch, y),
                 "stream_hold_x": cs.holds_used()})
        del sets, y, state
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_wkv6: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import bounds
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    dev = torch.device("cuda", 0)
    label = args.label or args.tree
    lines(torch, cs, bounds, wkv_ops, wkv_ref, dev, {"tree": label})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
