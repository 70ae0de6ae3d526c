#!/usr/bin/env python3
"""Time the tri-LoRA kernels of one tree of this repository on the card, at
the shapes ``chip_smoke.py`` times them (``TRI_LORA_TIMED``), so that two
trees can be compared inside one run on one card:

    python tools/time_tri_lora.py [--tree DIR] [--label NAME] [--sweep]
                                  [--dw-splits] [--host]

``DIR`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under it.  Prints
one JSON line per shape with the kernel's device time in µs (the events of
``chip_smoke.time_ms``, operands cycled through more copies than the L2
holds), the output's SHA-256 (its first 16 hex digits; every tree gets the
same inputs from the same seed, so equal digests mean bitwise equal
outputs) and, where the tree counts them, the forward's route; then the
card's name and power limit.  To compare a change with its parent, run
parent, change, change, parent in one call.  ``--sweep`` adds the bf16
forward at the rwkv6-1.6b prefill width with ranks 1 and 64 and with half
and twice the contraction, and the f32 forward at wq with rank 1 (what the
rank-r seed and the main loop cost); and, at each bf16 shape of
``TRI_LORA_TIMED``, the forward on the same values one bf16 element past a
16-byte boundary, a view TMA cannot read (the SIMT route), with its error
against the aligned call and, at the decode shape, the host time of one
call on each route.  ``--dw-splits`` (a tree whose ops have
``dw_capacity``) adds dW at each dW shape of ``TRI_LORA_TIMED`` launched
with every split count from 1 to ``DW_MAX_SPLITS`` (clusters of that
many blocks), beside the blocks the card holds at once in such clusters
and the count ``dw_plan`` picks.  ``--host`` adds to every line the host
time of one enqueued call (``chip_smoke.host_us``).
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: --sweep: the bf16 forward (f32 adapters) around the prefill shape, and
#: the f32 forward at wq with rank 1
SWEEP = tuple((f"sweep r={r} K={k}", "tri_lora_fwd", 4096, k, 2048, r,
               "bfloat16", "float32")
              for k, r in ((2048, 1), (2048, 64), (1024, 8), (4096, 8))) + (
    ("sweep wq r=1", "tri_lora_fwd", 2048, 768, 768, 1, "float32",
     "float32"),)


def unaligned(torch, x):
    """x's values in a view one element past a 16-byte boundary."""
    m, k = x.shape
    buf = torch.empty((m, k + 8), dtype=x.dtype, device=x.device)
    view = buf[:, 1:k + 1]
    view.copy_(x)
    return view


def digest(torch, t) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def dw_split_sweep(torch, cs, tl_ops, dev, gen) -> None:
    """dW at each dW shape of TRI_LORA_TIMED with every split count."""
    from repro_torch.kernels import ffi
    cap = tl_ops.dw_capacity(dev)
    fn = ffi.fn("tri_lora", "tri_lora_dw_launch",
                [ffi.I] + [ffi.VP, ffi.LL] * 3 + [ffi.I] * 5 + [ffi.VP])
    for label, name, m, k, n, r, dtype, small in cs.TRI_LORA_TIMED:
        if name != "tri_lora_dw":
            continue
        sets = cs.tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small,
                                      gen)
        for splits in range(1, tl_ops.DW_MAX_SPLITS + 1):
            rows = -(-m // splits)
            rows = -(-rows // tl_ops.DW_SLAB) * tl_ops.DW_SLAB

            def call(x, w, a, b, p, q, g, rows=rows):
                out = torch.empty((k, n), dtype=x.dtype, device=dev)
                ffi.check("tri_lora", fn(
                    ffi.DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0),
                    g.data_ptr(), g.stride(0), out.data_ptr(), out.stride(0),
                    m, k, n, -(-m // rows), rows, ffi.stream()))
                return out
            cs.emit({"kernel": name, "shape": label, "m": m, "k": k, "n": n,
                     "splits": -(-m // rows), "capacity": cap[splits],
                     "planned": tl_ops.dw_plan(m, k, n, cap)[0],
                     "us": 1e3 * cs.time_ms(torch, call, sets)})
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--dw-splits", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_tri_lora: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.tri_lora import ops as tl_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernel, _, _ = cs.tri_lora_calls(torch, tl_ops)
    routes = getattr(tl_ops, "ROUTES", None) or {}

    def timed(fn, sets):
        before = dict(routes)
        got = fn(*sets[0])
        took = [key for key in before if routes[key] > before[key]]
        return got, took, 1e3 * cs.time_ms(torch, fn, sets)

    gen = torch.Generator(device=dev).manual_seed(9)
    for label, name, m, k, n, r, dtype, small in (
            cs.TRI_LORA_TIMED + (SWEEP if args.sweep else ())):
        sets = cs.tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small,
                                      gen)
        got, took, us = timed(kernel[name], sets)
        line = {"tree": args.label or args.tree, "kernel": name,
                "shape": label, "m": m, "k": k, "n": n, "r": r,
                "dtype": dtype, "route": took, "us": us,
                "sha256": digest(torch, got)}
        if args.host:
            line["host_us"] = cs.host_us(torch, kernel[name], sets[0])
        if args.sweep and dtype == "bfloat16" and not label.startswith(
                "sweep"):
            moved = [(unaligned(torch, x), *rest) for x, *rest in sets]
            simt, line["unaligned_route"], line["unaligned_us"] = timed(
                kernel[name], moved)
            line["unaligned_max_abs_err"] = float(
                (simt.float() - got.float()).abs().max())
            if m <= 64:
                line["host_us"] = cs.host_us(torch, kernel[name], sets[0])
                line["unaligned_host_us"] = cs.host_us(torch, kernel[name],
                                                       moved[0])
            del moved, simt
        cs.emit(line)
        del sets, got
        torch.cuda.empty_cache()
    if args.dw_splits:
        dw_split_sweep(torch, cs, tl_ops, dev, gen)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
