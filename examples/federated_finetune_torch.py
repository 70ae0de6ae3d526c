"""End-to-end driver on the PyTorch port: federated CE-LoRA fine-tuning of
the ~100M ``fed-100m`` decoder for a few hundred total steps on synthetic
LM data (4 clients × 10 rounds × 20 local steps = 800 client-steps), with
the personalized C-aggregation between rounds and a checkpoint at the end.

The same run as ``examples/federated_finetune.py``, through
``repro_torch.launch.train.run``; the checkpoint goes to
``build/examples/celora_fed100m.npz`` unless ``--ckpt`` names another file.

Run:  PYTHONPATH=src python examples/federated_finetune_torch.py [--fast]
          [--device cpu]
"""
import argparse
from pathlib import Path

from repro_torch.launch.train import run

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="2 clients, 3 rounds of 5 steps, the reduced arch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "examples" /
                                          "celora_fed100m.npz"))
    args = ap.parse_args(argv)
    Path(args.ckpt).parent.mkdir(parents=True, exist_ok=True)
    fast = args.fast
    out = run(arch="fed-100m",
              clients=2 if fast else 4,
              rounds=3 if fast else 10,
              local_steps=5 if fast else 20,
              batch=4 if fast else 8,
              seq=128 if fast else 256,
              method="celora",
              ckpt=args.ckpt,
              reduced=fast,
              device=args.device)

    first = out["history"][0]["loss"]
    last = out["history"][-1]["loss"]
    print(f"\nfederated fine-tune: loss {first:.3f} -> {last:.3f}")
    if not last < first:
        raise SystemExit("training did not reduce loss")
    print("OK")
    return out


if __name__ == "__main__":
    main()
