"""Gradient-inversion (DLG) demo on the PyTorch port — paper Fig. 5.

Attacks each federated method's per-round payload gradients and prints how
much of the private batch's token content each one leaks.  The same steps
as ``examples/privacy_attack.py``, on ``repro_torch``; the attack is plain
tensor algebra (a double backward), so no kernel of the port runs.

Run:  PYTHONPATH=src python examples/privacy_attack_torch.py [--device cpu]
"""
import argparse

from repro_torch.core.privacy import run_dlg_experiment


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    res = run_dlg_experiment(seed=0, n_steps=args.steps, device=args.device)
    print("method        precision  recall  F1    (lower = better privacy)")
    for m, v in res.items():
        print(f"{m:12s}  {v['precision']:.3f}      {v['recall']:.3f}   "
              f"{v['f1']:.3f}")
    assert res["celora"]["f1"] <= res["fedpetuning"]["f1"] + 0.05, \
        "CE-LoRA should leak no more than FedPETuning"
    print("OK — transmitting only C resists reconstruction best")
    return res


if __name__ == "__main__":
    main()
