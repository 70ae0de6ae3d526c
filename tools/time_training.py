#!/usr/bin/env python3
"""Run the ``train`` and ``lm_train`` phases of ``chip_smoke.py`` for one
tree of this repository on the card (and, where the tree has them, their
``client_parallelism="vmap"`` runs: ``train_vmap``, ``lm_train_vmap``) and
print their trained tokens/s, so that the host-bound training paths of two
trees can be compared inside one run on one card:

    python tools/time_training.py [--tree DIR] [--label NAME]

``DIR`` is the root of a checkout (default: this one); its
``chip_smoke.py`` and ``src/repro_torch`` are imported and its kernels are
built under it, so each tree runs its own phases with all their checks.
Prints one JSON line and then the card's name and power limit.
The phases are host-bound and their spread between runs is wide: run
parent and change in turns, several times each, in one call (one process
per tree and turn).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_training: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.tri_lora import ops as tl_ops
    from repro_torch.models.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        train = cs.phase_train(torch, fa_ops, tl_ops, get_config, dev)
        lm = cs.phase_lm_train(torch, fa_ops, tl_ops, get_config, dev)
        if hasattr(cs, "phase_train_vmap"):
            cs.phase_train_vmap(torch, fa_ops, tl_ops, get_config, dev,
                                train[1])
            cs.phase_lm_train(torch, fa_ops, tl_ops, get_config, dev,
                              "vmap", lm[1])
    tok_s = {}
    for line in lines.getvalue().splitlines():
        obj = json.loads(line) if line.startswith("{") else {}
        if obj.get("phase") in ("train", "train_vmap", "lm_train"):
            vmap = obj["phase"] == "lm_train" and obj.get(
                "client_parallelism") == "vmap"
            tok_s[obj["phase"] + ("_vmap" if vmap else "")] = \
                obj["trained_tok_per_s"]
    print(json.dumps({"tree": args.label or args.tree,
                      "trained_tok_per_s": tok_s}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
