"""Quickstart on the PyTorch port: tri-LoRA in 60 seconds.

1. Build a small model from a registered architecture config.
2. Run a forward pass — the tri-LoRA adapter starts at ΔW = 0.
3. Take one adapter-only training step.
4. Show CE-LoRA's federated payload: only the r×r C matrices.
5. Merge the adapter into the base weights (paper eqn 10).

The same steps as ``examples/quickstart.py``, on ``repro_torch``.  On the
card every adapted projection runs the tri-LoRA kernels.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core import tri_lora
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import get_config
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. any registered arch works; `.reduced()` gives the CPU-sized variant
    cfg = get_config("qwen3-32b").reduced()
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    # 2. forward
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    loss, _ = model.loss_fn(cfg, params["adapter"], params["base"], batch)
    print(f"initial loss: {float(loss):.3f}  "
          f"(≈ ln V = {math.log(cfg.vocab_size):.3f})")

    # 3. one AdamW step on the ADAPTER ONLY (base stays frozen)
    opt = adamw(lr=1e-3)
    state = opt.init(params["adapter"])
    adapter = tree_map(lambda t: t.detach().requires_grad_(True),
                       params["adapter"])
    leaves = tree_leaves(adapter)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(model.loss_fn(
        cfg, adapter, params["base"], batch)[0], leaves)))
    upd, state = opt.update(tree_map(lambda t: grads[id(t)], adapter), state,
                            params["adapter"])
    adapter = apply_updates(params["adapter"], upd)
    with torch.no_grad():
        loss2, _ = model.loss_fn(cfg, adapter, params["base"], batch)
    print(f"after 1 adapter step: {float(loss2):.3f}")

    # 4. the federated payload — this is ALL that CE-LoRA sends per round
    n_payload = tri_lora.payload_num_params(adapter)
    n_full = tri_lora.full_lora_num_params(adapter)
    print(f"CE-LoRA uplink: {n_payload} floats "
          f"(vs {n_full} for FedPETuning — {n_full / n_payload:.0f}x less)")

    # 5. merge for inference (eqn 10): W_i = W + A_i·C_i·B_i
    a0 = tree_map(lambda t: t[0], tri_lora.adapters_of(adapter)[0])
    w = torch.zeros((a0["A"].shape[0], a0["B"].shape[1]), device=dev)
    merged = tri_lora.merge(w, a0, cfg.lora_alpha / cfg.lora_rank)
    print(f"merged ΔW for one projection: shape {tuple(merged.shape)}, "
          f"|ΔW| = {float(merged.abs().max()):.2e}")
    return {"loss": float(loss), "loss_after_step": float(loss2),
            "payload": n_payload, "full": n_full}


if __name__ == "__main__":
    main()
