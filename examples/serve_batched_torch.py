"""Batched serving example on the PyTorch port: prefill-free greedy decode
with a KV cache on a reduced SWA architecture (exercises the ring cache),
then the same prompts through the RWKV6 SSM (O(1) state decode).

The same steps as ``examples/serve_batched.py``, on ``repro_torch``.  On
the card every decode step runs the decode-attention kernel (h2o-danube)
and the tri-LoRA kernels on every adapted projection.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import model
from repro_torch.models.config import get_config

ARCHS = ("h2o-danube-3-4b", "rwkv6-1.6b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    outs = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        t0 = time.time()
        out = generate(cfg, params, prompts, gen=12, device=dev)
        print(f"{arch:20s} generated {tuple(out.shape)} in "
              f"{time.time() - t0:.1f}s; no NaNs: "
              f"{not bool((out < 0).any())}")
        outs[arch] = out.cpu().numpy()
    print("OK")
    return outs


if __name__ == "__main__":
    main()
