#!/usr/bin/env python3
"""Time the flash-attention kernels of one tree of this repository on the
card, at the shapes ``chip_smoke.py`` times them (``FLASH_TIMED``, causal:
f32 B=8, H=12, K=4, hd=64, S=256 and 512; h2o-danube-3-4b heads, H=32,
K=8, hd=120, bf16 1x8192 with window 4096 and f32 4x256;
recurrentgemma-2b heads, H=10, K=1, hd=256, bf16 1x4096 with window
2048), so that two trees can be compared inside one run on one card:

    python tools/time_flash.py [--tree DIR] [--label NAME] [--sweep]
    python tools/time_flash.py [--tree DIR] [--label NAME] --digest

``DIR`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under it.  Prints
one JSON line per shape with the device time in µs of the forward kernel
and ``scaled_dot_product_attention``'s forward, the dq kernel, the dk/dv
kernel, ``flash_attention_bwd`` as the model runs it (``softmax_delta`` +
dq + dk/dv) and SDPA's backward (all three gradients) on the same inputs,
each timed by
``chip_smoke.time_ms`` (operands cycled through more copies than the L2
holds, the stream held while the host enqueues) with the holds it used,
the forward's SHA-256 (out and lse; every tree gets the same inputs from
the same seed, so equal digests mean bitwise equal outputs) and, where the
tree counts them, the routes; then the card's name and power limit.  Each
tree's out, dq, dk and dv are held to the plain version first
(``chip_smoke.hold_flash``: elementwise at the dtype's tolerance, and in
every 64-row tile relative to the f32 plain version's size).  To compare a change with its parent, run parent,
change, change, parent in one call.

``--digest`` prints instead, for ``chip_smoke.FLASH_DIGEST_CASES`` (hd
64, 128, 120 and 256, f32 and bf16), the SHA-256 of the forward's and the
backward's outputs, and times nothing: a tree whose digests equal
another's computes bitwise the same values there.  A tree whose kernels
refuse a head dim of ``FLASH_TIMED`` prints the refusal for that shape.

``--sweep`` adds the forward at the first shape with the batch at 2, 4,
8, 16 and 32, causal and not: under a causal band its blocks carry 1 to
4 k tiles, so a time that grows slower than the tile products (10 per
(b, h) causal, 16 not) shows the critical path or an unfilled card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--digest", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    label = args.label or args.tree
    if args.digest:
        for line in cs.flash_digests(torch, fa_ops, dev):
            cs.emit({"tree": label, **line})
        print(cs.card_line(), flush=True)
        return 0
    routes = getattr(fa_ops, "ROUTES", None) or {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for (b, s, h, kh, hd, dt, window) in cs.FLASH_TIMED:
        if hd not in getattr(fa_ops, "HEAD_DIMS", (hd,)):
            cs.emit({"tree": label, "hd": hd, "refused": f"head_dim {hd} "
                     f"not in {fa_ops.HEAD_DIMS}"})
            continue
        kw = dict(window=window)
        calls = cs.flash_bwd_calls(fa_ops, window)
        iters = 10 if s >= 4096 else 60
        sets = cs.flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen,
                                   dt, window)
        q, k, v, do, out, lse, delta = sets[0]
        (want_out, _), want = cs.flash_plain(torch, fa_ref, q, k, v, do,
                                             causal=True, **kw)
        before = dict(routes)
        fwd = fa_ops.flash_attention_fwd(q, k, v, **kw)
        got = (calls["flash_dq"](*sets[0]), *calls["flash_dkv"](*sets[0]))
        took = {key: routes[key] - before[key] for key in before}
        checked, rel, bad = cs.hold_flash(torch, (fwd[0], *got),
                                          (want_out, *want), dt)
        cs.require(bad == 0, f"{args.tree}: the kernels disagree with the "
                   f"plain version at S={s} hd={hd}: {checked}, relative "
                   f"{rel}")
        del want_out, want, got
        graphs, sdpa_bwd = cs.sdpa_bwd_graphs(
            torch, F, sets[:2] if s >= 4096 else sets, window)
        cs.holds_used()
        us = {"flash_fwd": 1e3 * cs.time_ms(
                  torch, lambda q, k, v, *_: fa_ops.flash_attention_fwd(
                      q, k, v, **kw), sets, iters),
              "sdpa_fwd": 1e3 * cs.time_ms(
                  torch, lambda q, k, v, *_: cs.sdpa_causal(F, q, k, v,
                                                            window),
                  sets, iters)}
        us.update({name: 1e3 * cs.time_ms(torch, fn, sets, iters)
                   for name, fn in calls.items()})
        us["sdpa_bwd"] = 1e3 * cs.time_ms(torch, sdpa_bwd, graphs, iters)
        cs.emit({"tree": label, "b": b, "s": s, "h": h,
                 "kh": kh, "hd": hd, "dtype": dt, "causal": True,
                 "window": window, "us": us, "fwd_over_sdpa_fwd":
                     us["flash_fwd"] / us["sdpa_fwd"], "bwd_over_sdpa_bwd":
                     us["flash_bwd"] / us["sdpa_bwd"],
                 "fwd_sha256": cs.digest(torch, *fwd),
                 "routes": took, "max_abs_err": checked, "rel_err": rel,
                 "stream_hold_x": cs.holds_used()})
        del sets, graphs, fwd
        torch.cuda.empty_cache()
    if args.sweep:
        _, s, h, kh, hd, _, _ = cs.FLASH_TIMED[0]
        for causal in (True, False):
            for b in (2, 4, 8, 16, 32):
                one = 4 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
                sets = [cs.flash_inputs(torch, dev, b, s, h, kh, hd,
                                        torch.float32, gen)[:3]
                        for _ in range(cs.copies_for(one))]
                cs.emit({"tree": label, "sweep": "fwd",
                         "b": b, "s": s, "causal": causal,
                         "us": 1e3 * cs.time_ms(
                             torch, lambda q, k, v: fa_ops.flash_attention_fwd(
                                 q, k, v, causal=causal), sets),
                         "stream_hold_x": cs.holds_used()})
                del sets
                torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
