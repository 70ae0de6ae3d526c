"""Dry run on ``meta``: PyTorch port of ``repro.launch.dryrun``.

For every (architecture × input shape) combination at the production mesh
(16×16, or 2×16×16 with ``--multi-pod``) it builds the params
(``model.abstract_params``), the partition specs (:mod:`.sharding`) and
the step's inputs on the ``meta`` device — nothing is allocated — and
traces one step under ``torch.utils.flop_counter.FlopCounterMode``: the
train step (loss, adapter gradients, AdamW), prefill, one decode step, or
with ``--fed`` the federated pod-round step at ``train_4k``.  Each combo
writes one JSON record:

* ``arch``, ``variant``, ``shape``, ``mesh``, ``layout``, ``fed``,
  ``n_devices`` — the JAX package's keys;
* ``trace_s`` in place of its ``lower_s`` / ``compile_s``;
* ``memory.argument_size_in_bytes`` — the step's arguments per device,
  from the specs: each leaf's bytes over the product of the mesh axes it
  is split on;
* ``cost.flops`` — the counter's total for one step (matmuls, einsums
  and attention; elementwise work is not counted);
* ``attn_impl`` — the attention route traced: on ``meta`` the plain path
  (``ref``), which counts the full S×S logits;
* ``traced`` — the stack depths traced.  The layer groups of a stack are
  identical, so a step's count is affine in their number: a stack of G
  groups is traced at 1 and 2 groups (and an encoder's likewise) and the
  count extrapolated, exactly; stacks of at most 2 groups are traced
  whole.

There is no HLO (``--no-hlo`` is accepted and changes nothing).  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod] [--fed] [--out-dir D]

Records land in ``<out-dir>/<mesh>[_fed]/<arch>__<shape>.json`` (default
``build/dryrun``).  Exits 1 if any combo fails.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import model
from repro_torch.models.config import ModelConfig, get_config
from repro_torch.tree import tree_leaves, tree_map

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                   "dryrun")

#: the serving layout drops FSDP when the frozen weights take at most this
#: many bytes per chip at 1/|model| (the JAX package's threshold)
SERVE_FSDP_BYTES = 6e9


# ---------------------------------------------------------------------------
# FLOPs of one step
# ---------------------------------------------------------------------------

def trace_flops(cfg: ModelConfig, kind: str, inputs: dict, *,
                attn_impl: str = "ref", microbatches: int = 1,
                mesh=None, payload_dtype=None) -> int:
    """FLOPs of one step of ``kind`` ("train", "prefill", "decode" or
    "fed") on ``inputs`` — ``params``, ``batch`` and for decode ``cache``
    (tensors on ``meta`` or real ones) — as ``FlopCounterMode`` counts
    them.  The fed step's pod-stacked adapter and optimizer state and its
    (n_pods, n_pods) weights are made alongside ``params``."""
    params, batch = inputs["params"], inputs["batch"]
    dev = tree_leaves(params["base"])[0].device
    counter = FlopCounterMode(display=False)
    if kind == "fed":
        step = st.make_fed_round_step(cfg, mesh, attn_impl=attn_impl,
                                      payload_dtype=payload_dtype)
        n = step.n_pods
        ad_p = tree_map(lambda t: t[None].expand((n,) + tuple(t.shape)),
                        params["adapter"])
        os_p = step.optimizer.init(ad_p)
        w = torch.full((n, n), 1.0 / n, dtype=torch.float32, device=dev)
        with counter:
            step(params, ad_p, os_p, batch, w)
    elif kind == "train":
        step = st.make_train_step(cfg, attn_impl=attn_impl,
                                  microbatches=microbatches)
        opt_state = step.optimizer.init(params["adapter"])
        with counter:
            step(params, opt_state, batch)
    elif kind == "prefill":
        step = st.make_prefill_step(cfg, attn_impl=attn_impl)
        with counter:
            step(params, batch)
    else:
        step = st.make_serve_step(cfg)
        with counter:
            step(params, inputs["cache"], batch)
    return int(counter.get_total_flops())


def _cut(cfg: ModelConfig, groups: int, enc_groups: int) -> ModelConfig:
    """``cfg`` with its decoder stack cut to ``groups`` layer groups (the
    remainder layers kept) and its encoder to ``enc_groups`` layers."""
    _, pattern, rem = cfg.stack_plan()
    kw = {"n_layers": len(pattern) * groups + len(rem)}
    if cfg.enc_dec:
        kw["n_enc_layers"] = enc_groups
    return cfg.with_overrides(**kw)


def step_flops(cfg: ModelConfig, kind: str,
               make_inputs: Callable[[ModelConfig], dict],
               **kw) -> tuple[int, list]:
    """(FLOPs of one step, the (groups, encoder layers) traced):
    :func:`trace_flops` on ``make_inputs(cfg)``, or, for stacks of more
    than 2 groups, at depths 1 and 2 and extrapolated — exact, since the
    groups are identical and the count is affine in their number."""
    g = cfg.stack_plan()[0]
    ge = cfg.n_enc_layers if cfg.enc_dec else 1
    if g <= 2 and ge <= 2:
        return trace_flops(cfg, kind, make_inputs(cfg), **kw), [[g, ge]]

    def at(a, b):
        c = _cut(cfg, a, b)
        return trace_flops(c, kind, make_inputs(c), **kw)
    f11 = at(1, 1)
    flops, traced = f11, [[1, 1]]
    if g > 1:
        flops += (g - 1) * (at(2, 1) - f11)
        traced.append([2, 1])
    if ge > 1:
        flops += (ge - 1) * (at(1, 2) - f11)
        traced.append([1, 2])
    return flops, traced


# ---------------------------------------------------------------------------
# bytes per device
# ---------------------------------------------------------------------------

def bytes_per_device(tree, spec_tree, mesh) -> int:
    """Σ over the tensors of ``tree``: their bytes over the number of ways
    their spec (the matching leaf of ``spec_tree``) splits them."""
    total = [0]

    def one(t, spec):
        if isinstance(t, torch.Tensor):
            total[0] += (t.numel() * t.element_size()
                         // shd.shard_factor(spec, mesh))
    tree_map(one, tree, spec_tree,
             is_leaf=lambda x: isinstance(x, torch.Tensor))
    return total[0]


def _replicated(tree):
    return tree_map(lambda t: shd.P(*(None,) * t.dim()), tree)


def _count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# one combo
# ---------------------------------------------------------------------------

def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                fed: bool = False, serve_layout: str = "auto",
                train_layout: str = "mixed", fed_bf16: bool = False,
                microbatches: int = 1, attn_impl: Optional[str] = None,
                art_dir: Optional[str] = ART) -> dict:
    """Trace one combo and write its record (under ``art_dir`` unless it
    is None); returns the record."""
    t0 = time.time()
    cfg = st.shape_variant(get_config(arch), shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sh = st.SHAPES[shape_name]
    baxes = batch_axes(mesh)
    impl = attn_impl or "ref"

    params = model.abstract_params(cfg)
    pspec = shd.param_specs(params, mesh, cfg)
    batch = st.input_specs(cfg, shape_name)
    bspec = shd.batch_specs(batch, mesh, baxes)
    layout = "mixed"
    kw: dict = {"attn_impl": impl}

    def meta_inputs(c):
        out = {"params": model.abstract_params(c),
               "batch": st.input_specs(c, shape_name)}
        if sh.kind == "decode" and not fed:
            out["cache"] = st.abstract_cache(c, shape_name)
        return out

    if fed:
        if not multi_pod:
            raise ValueError("the federated round step needs the pod axis "
                             "(--multi-pod)")
        kind = "fed"
        payload = torch.bfloat16 if fed_bf16 else None
        kw.update(mesh=mesh, payload_dtype=payload)
        step = st.make_fed_round_step(cfg, mesh, payload_dtype=payload)
        n_pods = step.n_pods
        ad_p = st.pod_stacked_adapter(cfg, n_pods)
        os_p = st.pod_stacked_opt_state(cfg, n_pods, step.optimizer)
        w = torch.empty((n_pods, n_pods), dtype=torch.float32, device="meta")
        args = [(params, pspec), (ad_p, shd.leading_axis_specs(ad_p, "pod")),
                (os_p, shd.leading_axis_specs(os_p, "pod")), (batch, bspec),
                (w, shd.P(None, None))]
    elif sh.kind == "train":
        kind = "train"
        kw["microbatches"] = microbatches
        opt_state = st.make_train_step(cfg).optimizer.init(params["adapter"])
        if train_layout == "dp":
            # pure data parallelism: params replicated, the batch over
            # (data × model)
            layout = "dp"
            dp = ("data", "model")
            args = [(params, _replicated(params)),
                    (opt_state, _replicated(opt_state)),
                    (batch, tree_map(lambda t: shd.P(dp, *(None,) * (
                        t.dim() - 1)), batch))]
        else:
            args = [(params, pspec),
                    (opt_state, shd.param_specs(opt_state, mesh, cfg)),
                    (batch, bspec)]
    elif sh.kind == "prefill":
        kind = "prefill"
        args = [(params, pspec), (batch, bspec)]
    else:
        kind = "decode"
        cache = st.abstract_cache(cfg, shape_name)
        cspec = shd.cache_specs(cache, mesh, cfg, baxes)
        if serve_layout == "auto":
            # the weights replicated over `data` pay off only when they are
            # a small share of a chip next to the KV cache
            use_fsdp = (_count_params(params) * 2 / mesh.shape["model"]
                        > SERVE_FSDP_BYTES)
        else:
            use_fsdp = serve_layout == "fsdp"
        layout = "fsdp" if use_fsdp else "replicated-data"
        args = [(params, shd.param_specs(params, mesh, cfg, fsdp=use_fsdp)),
                (cache, cspec), (batch, bspec)]

    t1 = time.time()
    flops, traced = step_flops(cfg, kind, meta_inputs, **kw)
    rec = {
        "arch": arch, "variant": cfg.name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "layout": layout, "fed": fed, "n_devices": mesh.size,
        "trace_s": round(time.time() - t1, 2),
        "setup_s": round(t1 - t0, 2),
        "attn_impl": impl, "traced": traced,
        "memory": {"argument_size_in_bytes": sum(
            bytes_per_device(t, s, mesh) for t, s in args)},
        "cost": {"flops": float(flops)},
    }
    if art_dir is not None:
        out_dir = os.path.join(art_dir, rec["mesh"] + ("_fed" if fed else ""))
        os.makedirs(out_dir, exist_ok=True)
        stem = f"{arch.replace('/', '_')}__{shape_name}"
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(st.SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="all assigned (arch × shape) combos")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fed", action="store_true",
                    help="federated pod-round step (multi-pod only)")
    ap.add_argument("--no-hlo", action="store_true",
                    help="accepted for the JAX package's CLI; there is no "
                         "HLO here")
    ap.add_argument("--train-layout", default="mixed",
                    choices=["mixed", "dp"])
    ap.add_argument("--fed-bf16", action="store_true",
                    help="cast the federated C payload to bf16")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches for train")
    ap.add_argument("--attn-impl", default=None,
                    choices=["ref", "blockwise", "blockwise_cv",
                             "blockwise_hp"],
                    help="attention route to trace (default: ref, the "
                         "plain path, counting the full S×S logits)")
    ap.add_argument("--out-dir", default=ART,
                    help="record root (default: <repo>/build/dryrun)")
    args = ap.parse_args(argv)

    if args.all:
        shapes = ["train_4k"] if args.fed else list(st.SHAPES)
        combos = [(a, s) for a in ASSIGNED for s in shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    n_ok = 0
    t0 = time.time()
    for arch, shape in combos:
        try:
            rec = lower_combo(arch, shape, multi_pod=args.multi_pod,
                              fed=args.fed, train_layout=args.train_layout,
                              fed_bf16=args.fed_bf16,
                              microbatches=args.microbatch,
                              attn_impl=args.attn_impl,
                              art_dir=args.out_dir)
            arg_b = rec["memory"]["argument_size_in_bytes"]
            print(f"OK   {arch:24s} {shape:12s} mesh={rec['mesh']}"
                  f" trace={rec['trace_s']}s flops={rec['cost']['flops']:.3e}"
                  f" args/dev={arg_b / 2**30:.2f}GiB", flush=True)
            n_ok += 1
        except Exception:
            print(f"FAIL {arch:24s} {shape:12s}", flush=True)
            traceback.print_exc()
    print(f"{n_ok}/{len(combos)} combos traced in "
          f"{time.time() - t0:.1f}s")
    return 0 if n_ok == len(combos) else 1


if __name__ == "__main__":
    raise SystemExit(main())
