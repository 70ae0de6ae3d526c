"""Federated CE-LoRA fine-tuning from the command line (PyTorch port).

    python -m repro_torch.launch.federated --arch fed-100m --reduced \\
        --clients 4 --rounds 3 --local-steps 5 --batch 8 --seq 64 \\
        --device cpu                                  # tiny, plain path
    python -m repro_torch.launch.federated --arch fed-100m \\
        --clients 4 --rounds 3 --local-steps 5 --batch 8 --seq 256
                                                      # full width, the card

Builds the synthetic federated classification task (label skew and
concept drift, ``data.synthetic.make_federated_classification``), a
random backbone of ``--arch``, and runs :func:`repro_torch.core.federated.
run_federated` on the eager engine (``--client-parallelism vmap``, the
default, or ``loop``), one line per round.
Runs on ``--device cuda`` unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.baselines import STRATEGIES
from repro_torch.core.fed_model import FedTask
from repro_torch.core.federated import FedConfig, run_federated
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models.attention import IMPLS
from repro_torch.models.config import get_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="fed-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny variant (2 layers, width 256)")
    ap.add_argument("--method", default="celora", choices=sorted(STRATEGIES))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--attn-impl", default="flash", choices=IMPLS)
    ap.add_argument("--client-parallelism", default="vmap",
                    choices=["loop", "vmap"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ctrain, ctest, _ = synthetic.make_federated_classification(
        args.seed, args.clients, args.n_train, args.n_test, args.seq,
        cfg.vocab_size, args.classes, drift=0.5)
    task = FedTask.create(torch.Generator(device=dev).manual_seed(args.seed),
                          cfg, args.classes)
    fed = FedConfig(method=args.method, n_clients=args.clients,
                    rounds=args.rounds, local_steps=args.local_steps,
                    batch_size=args.batch, lr=args.lr, seed=args.seed,
                    participation=args.participation,
                    attn_impl=args.attn_impl,
                    client_parallelism=args.client_parallelism)
    t0 = time.perf_counter()
    out = run_federated(task, fed, ctrain, ctest, device=dev, verbose=True)
    print(f"{cfg.name} on {dev}: {args.rounds} rounds in "
          f"{time.perf_counter() - t0:.2f} s, final mean acc "
          f"{out['mean_acc']:.3f}, uplink {out['uplink_bytes_per_round']} "
          f"B/round")
    return out


if __name__ == "__main__":
    main()
