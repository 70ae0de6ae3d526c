#!/usr/bin/env python3
"""Time the decode kernels of one tree of this repository on the card, at
the shapes ``chip_smoke.py`` times them, so that two trees can be compared
inside one run on one card:

    python tools/time_decode.py [--tree DIR] [--label NAME] [--sweep]
                                [--profile]

``DIR`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under it.  Prints
one JSON line per kernel and shape: the grouped GEMV at
``chip_smoke.GEMV_TIMED`` (LLaMA-7B ``wq``, 8 rows of 8 users, bf16) beside
``x@W`` alone, and decode attention at each ``chip_smoke.ATTN_TIMED`` shape
beside SDPA (with the tree's split plan and the card's capacity per
cluster size, where it has them), each with the card's bound, the device time in µs (the events
of ``chip_smoke.time_ms``, operands cycled through more copies than the L2
holds) and the output's SHA-256 (its first 16 hex digits; every tree gets
the same inputs from the same seed, so equal digests mean bitwise equal
outputs).  A shape the tree's kernel refuses is printed with the refusal.
Then the card's name and power limit.  To compare a change with its
parent, run parent, change, change, parent in one call.

``--profile`` adds the serve profile of ``chip_smoke.phase_profile``
(LLaMA-7B at full width and depth, 3 decode steps of 8 slots): device time
per step and the decode kernels' shares of it.  ``--sweep`` (a tree whose
ops have ``gemv_plan`` and ``attn_plan``) adds the GEMV at every K split
count from 1 to ``GEMV_MAX_SPLITS``, its second (combine) kernel alone,
and decode attention at both shapes split over every count of blocks from
1 to ``ATTN_MAX_SPLITS``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gemv_lines(torch, cs, ops, bounds, dev, label, sweep):
    bsz, k, n, r, m = cs.GEMV_TIMED
    sets = cs.gemv_timed_sets(torch, dev,
                              torch.Generator(device=dev).manual_seed(4))

    def call(*t):
        return ops.grouped_dense(*t, scaling=2.0)
    bd = bounds.grouped_gemv(bsz, k, n, r, len(set(sets[0][0].tolist())),
                             "bfloat16")
    cs.emit({"tree": label, "kernel": "grouped_gemv", "shape": "serve wq",
             "us": 1e3 * cs.time_ms(torch, call, sets),
             "x@W_us": 1e3 * cs.time_ms(torch, lambda rows, x, w, *_: x @ w,
                                        sets),
             "bound_us": 1e3 * bd.ms,
             "sha256": cs.digest(torch, call(*sets[0]))})
    if not sweep:
        return
    plan = ops.gemv_plan
    for splits in range(1, ops.GEMV_MAX_SPLITS + 1):
        depth = ops._cdiv(ops._cdiv(k, splits),
                          ops.GEMV_STAGE_K) * ops.GEMV_STAGE_K
        if ops._cdiv(k, depth) != splits:
            continue
        ops.gemv_plan = lambda *_, s=splits, d=depth: (s, d)
        cs.emit({"tree": label, "kernel": "grouped_gemv", "shape": "serve wq",
                 "splits": splits, "depth": depth,
                 "planned": plan(bsz, k, n, 2, ops._sms(dev.index or 0)),
                 "us": 1e3 * cs.time_ms(torch, call, sets)})
    ops.gemv_plan = plan
    from repro_torch.kernels import ffi
    fn = ffi.fn("grouped_gemv", "grouped_gemv_combine_launch",
                [ffi.I] + [ffi.VP] * 6 + [ffi.I] * 4 + [ffi.F, ffi.I, ffi.VP])
    splits = plan(bsz, k, n, 2, ops._sms(dev.index or 0))[0]
    part, xa_part = ops.gemv_scratch(splits, bsz, n, r, dev)
    part.zero_()
    xa_part.zero_()

    def combine(rows, x, w, a, c, b):
        out = torch.empty((bsz, n), dtype=x.dtype, device=dev)
        ffi.check("grouped_gemv", fn(
            1, rows.data_ptr(), c.data_ptr(), b.data_ptr(), part.data_ptr(),
            xa_part.data_ptr(), out.data_ptr(), bsz, n, r, m, 2.0, splits,
            ffi.stream()))
    cs.emit({"tree": label, "kernel": "grouped_gemv", "shape": "serve wq",
             "part": "combine kernel alone", "splits": splits,
             "us": 1e3 * cs.time_ms(torch, combine, sets)})


def attn_lines(torch, F, cs, ops, bounds, dev, label, sweep):
    for shape, (b, h, kh, hd, ring) in cs.ATTN_TIMED.items():
        line = {"tree": label, "kernel": "decode_attention", "shape": shape,
                "b": b, "h": h, "kh": kh, "hd": hd, "ring": ring}
        sets = cs.attn_timed_sets(torch, dev, b, h, kh, hd, ring,
                                  torch.Generator(device=dev).manual_seed(3))

        def call(q, k, v, idx, mask):
            return ops.decode_attention(q, k, v, idx)
        try:
            out = call(*sets[0])
        except ValueError as e:              # a head dim the tree refuses
            cs.emit({**line, "refused": str(e)})
            continue
        bd = bounds.decode_attention(b, h, kh, hd, b * ring, "bfloat16")
        if hasattr(ops, "attn_capacity"):
            line["splits"] = ops.attn_plan(b, kh, h // kh,
                                           ops.attn_capacity(dev))
            line["capacity"] = ops.attn_capacity(dev)
        cs.emit({**line, "us": 1e3 * cs.time_ms(torch, call, sets),
                 "sdpa_us": 1e3 * cs.time_ms(
                     torch, lambda *t: cs.sdpa_decode(F, *t), sets),
                 "bound_us": 1e3 * bd.ms, "sha256": cs.digest(torch, out)})
        if sweep:
            plan = ops.attn_plan
            for cand in range(1, ops.ATTN_MAX_SPLITS + 1):
                ops.attn_plan = lambda *_, c=cand: c
                cs.emit({**line, "splits": cand,
                         "us": 1e3 * cs.time_ms(torch, call, sets)})
            ops.attn_plan = plan
        del sets, out
        torch.cuda.empty_cache()


def profile_line(torch, cs, dev, label):
    from repro_torch.core.adapter_bank import random_bank
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.config import get_config
    state = cs.serve_engine(torch, serve, model, random_bank, get_config,
                            dev)
    prof = cs.phase_profile(torch, state, dev)
    steps = prof["steps"]
    cs.emit({"tree": label, "kind": "serve profile",
             "device_us_per_step": prof["device_us"] / steps,
             "wall_us_per_step": prof["wall_us"] / steps,
             **{k: v for k, v in prof.items() if k.endswith("_share")}})
    del state
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_decode: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import bounds
    from repro_torch.kernels.decode_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    label = args.label or args.tree
    gemv_lines(torch, cs, ops, bounds, dev, label, args.sweep)
    attn_lines(torch, F, cs, ops, bounds, dev, label, args.sweep)
    if args.profile:
        profile_line(torch, cs, dev, label)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
