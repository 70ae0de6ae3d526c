"""Multi-tenant personalized serving entry points (PyTorch port).

  python -m repro_torch.launch.serve --arch celora-llama-7b \\
      --users 8 --requests 16 --slots 8 --prompt-len 128 --gen 32
  python -m repro_torch.launch.serve --arch fed-100m --reduced \\
      --batch 4 --prompt-len 32 --gen 16            # single-adapter path
  python -m repro_torch.launch.serve --arch h2o-danube-3-4b --users 4 \\
      --requests 8 --slots 4 --prompt-len 64 --gen 16  # sliding window
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 8 \\
      --prompt-len 32 --gen 32                      # RG-LRU hybrid
  python -m repro_torch.launch.serve --arch qwen2-vl-72b --reduced \\
      --users 4 --requests 8 --slots 4              # M-RoPE (t = h = w)

Three inference modes for paper eqn (10)'s per-client adapters:

* :func:`generate` — single-adapter batched greedy decode (adapters stay
  factored; every row shares one adapter tree); attention, RWKV-6 and
  RG-LRU hybrid stacks alike, the recurrent ones carrying their state.
  M-RoPE configs decode text positions (t, t, t).  An encoder-decoder
  config decodes against the zero cross K/V of a fresh cache, so its
  cross-attention term is exactly zero, as in the JAX package.
* :class:`ServeEngine` — the multi-tenant path (attention stacks only,
  full or sliding-window, dense or MoE, as in the JAX package): a seeded
  stream of requests from DISTINCT users is decoded in one
  continuously-batched loop, each batch slot applying its own tri-LoRA row
  from an
  :class:`~repro_torch.core.adapter_bank.AdapterBank` (on CUDA through the
  grouped GEMV and decode-attention kernels).  Finished requests free their
  slot for the next arrival; a reused slot restarts at position 0 and the
  ring validity mask (``slot <= idx``) hides every stale KV entry.
* :func:`serve_naive` — the baseline: per user, merge that user's adapter
  into the base weights (eqn. 10) and decode batch-1, sequentially.

Every entry point runs on ``device="cuda"`` unless the caller asks for the
CPU, and raises when asked for a card that is not there.

The decode step is a cached program (:mod:`repro_torch.core.jit_cache`,
the JAX package's jitted step): on a card one CUDA graph a signature,
replayed each step, with the KV cache donated, so the graph writes the
caller's cache in place and never copies it.  :func:`generate`'s program
is cached in ``_DECODE_CACHE``, anchored on ``(params["base"],
params["adapter"], cfg)``; each :class:`ServeEngine` owns its program,
which goes with the engine.  A program keeps its cache after the call
(until it is evicted or cleared); a second call at the same shapes zeroes
that cache in place and replays the same graph, so only one cache is ever
alive per program.  On the CPU the program is the step itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import jit_cache
from repro_torch.core.adapter_bank import AdapterBank, random_bank
from repro_torch.device import check_on, resolve_device
from repro_torch.models import model, transformer
from repro_torch.models.config import get_config
from repro_torch.tree import tree_leaves


#: :func:`generate`'s decode-step programs; each holds its donated cache,
#: so few
_DECODE_CACHE = jit_cache.JitCache(maxsize=4)


def _fresh_cache(programs: jit_cache.JitCache, anchors: tuple, key,
                 make, dev: torch.device) -> dict:
    """A decode cache as ``make(device)`` builds it (all zeros, as
    :func:`model.init_decode_cache` makes them): the one a live program
    of ``key`` holds, zeroed in place, where there is one (no second cache,
    no copy, no new capture); else a new one."""
    kept = jit_cache.held(programs, anchors, key, 0, make("meta"))
    if kept is None:
        return make(dev)
    for t in tree_leaves(kept):
        t.zero_()
    return kept


def _generate_step(cfg, base: dict, adapter: dict, cache: dict,
                   token: torch.Tensor, positions: torch.Tensor):
    """:func:`generate`'s program: one token through ``model.decode_step``
    → (logits (B, 1, V), cache)."""
    return model.decode_step(cfg, base, adapter, cache,
                             {"token": token, "positions": positions})


@torch.inference_mode()
def generate(cfg, params: dict, prompts, gen: int, *,
             device="cuda") -> torch.Tensor:
    """Greedy decode.  prompts: (B, P) int.  Returns (B, P+gen) int32 tokens
    on ``device``.  The prompt is fed one token per step, as in the JAX
    package; each step is one call of the cached decode program, the cache
    donated."""
    dev = resolve_device(device)
    check_on(params, dev, "params")
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.asarray(prompts))
    prompts = prompts.to(device=dev, dtype=torch.int32)
    b, p = prompts.shape
    anchors = (params["base"], params["adapter"], cfg)
    step = jit_cache.jit(
        _DECODE_CACHE, anchors, ("generate",),
        functools.partial(_generate_step, cfg, params["base"],
                          params["adapter"]), donate_argnums=(0,))
    cache = _fresh_cache(
        _DECODE_CACHE, anchors, ("generate",),
        lambda d: model.init_decode_cache(cfg, b, p + gen, device=d), dev)
    # each prompt column as a (B, 1) tensor of its own: one signature for
    # every step's token
    out = [prompts[:, i:i + 1].clone(memory_format=torch.contiguous_format)
           for i in range(p)]
    for t in range(p + gen - 1):
        pos = torch.full((b, 1, 3) if cfg.pos_type == "mrope" else (b, 1), t,
                         dtype=torch.int32, device=dev)
        logits, cache = step(cache, out[t], pos)
        if t >= p - 1 and t + 1 >= len(out):
            # first maximal index on ties, as jnp.argmax
            out.append(torch.argmax(logits[:, -1], dim=-1,
                                    keepdim=True).to(torch.int32))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# request stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    user_id: str
    prompt: np.ndarray           # (P,) int32
    gen: int


def make_requests(bank: AdapterBank, n: int, *, prompt_len: int, gen: int,
                  vocab: int, seed: int = 0) -> List[Request]:
    """Seeded arrival order: each request draws a user from the bank and a
    random prompt — the same numpy stream as the JAX package's."""
    rng = np.random.default_rng(seed)
    users = sorted(bank.users)
    return [Request(rid=i, user_id=users[int(rng.integers(len(users)))],
                    prompt=rng.integers(0, vocab, (prompt_len,)).astype(
                        np.int32),
                    gen=gen)
            for i in range(n)]


# ---------------------------------------------------------------------------
# batched heterogeneous engine
# ---------------------------------------------------------------------------

def _with_positions(cache: dict, pos: torch.Tensor) -> dict:
    """Install per-slot positions into every cache ``idx`` leaf — (q, B)
    for stacked layer groups, (B,) for tail blocks; every other leaf (K/V,
    a cross block's ``xk`` / ``xv``) stays."""
    groups = cache["groups"]
    if groups is not None:
        groups = {k: {**c, "idx": pos.expand(c["k"].shape[0], pos.shape[0])}
                  for k, c in groups.items()}
    tail = tuple({**c, "idx": pos} for c in cache["tail"])
    return {"groups": groups, "tail": tail}


def _kv(cache: dict) -> dict:
    """``cache`` without its ``idx`` leaves: the buffers the engine's step
    writes in place (its positions come from the slots each step)."""
    def strip(c):
        return {k: v for k, v in c.items() if k != "idx"}
    groups = cache["groups"]
    return {"groups": None if groups is None
            else {k: strip(c) for k, c in groups.items()},
            "tail": tuple(strip(c) for c in cache["tail"])}


def _engine_step(cfg, base: dict, bank_dec: dict, kv: dict,
                 tok: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor):
    """:class:`ServeEngine`'s program: one token for every slot, each
    through its own bank row, at its own ring position → (next tokens
    (B,), the K/V written in place)."""
    cache = _with_positions(kv, pos)
    positions = (pos[:, None, None].expand(pos.shape[0], 1, 3)
                 if cfg.pos_type == "mrope" else pos[:, None])
    logits, cache = model.decode_step(
        cfg, base, bank_dec, cache, {"token": tok, "positions": positions},
        adapter_rows=rows)
    return torch.argmax(logits[:, -1], dim=-1), _kv(cache)


class ServeEngine:
    """Continuous-batching decode over a stacked adapter bank.

    ``slots`` concurrent sequences share one decode step; every step each
    slot applies its own bank row (grouped tri-LoRA) and advances its own
    ring position (ragged ``idx``).  Idle slots carry row/pos -1 — the
    masked-slot sentinel of the kernels.  Greedy decode only: the point is
    token-exact equivalence to the per-user oracle.  ``steps`` counts the
    decode steps taken.  Each step is one call of the engine's own decode
    program, the K/V donated; the program and its K/V go with the engine.
    """

    def __init__(self, cfg, base: dict, bank: AdapterBank, *, slots: int = 8,
                 max_len: int = 128, device="cuda"):
        if not set(cfg.kinds()) <= set(transformer.ATTN_KINDS):
            raise NotImplementedError(
                f"ServeEngine serves attention stacks only (grouped adapter "
                f"banks need attention blocks, as in the JAX package); "
                f"{cfg.name!r} has kinds {sorted(set(cfg.kinds()))}: use "
                f"generate() (ROADMAP, Queue 1: 'reference limits "
                f"kept')")
        self.device = resolve_device(device)
        check_on(base, self.device, "base params")
        check_on(bank.tree, self.device, "adapter bank")
        self.cfg, self.base, self.bank = cfg, base, bank
        self.slots, self.max_len = slots, max_len
        self._bank_dec = bank.decode_tree()
        self._programs = jit_cache.JitCache(maxsize=1)
        self._program = jit_cache.jit(
            self._programs, (), ("engine",),
            functools.partial(_engine_step, cfg, base, self._bank_dec),
            donate_argnums=(0,))
        self.steps = 0

    def _step(self, cache, tok, pos, rows):
        """One decode step: (next tokens (B,), the cache's K/V without
        its ``idx`` leaves, which the next step takes as its cache)."""
        return self._program(_kv(cache), tok, pos, rows)

    @torch.inference_mode()
    def run(self, requests: Sequence[Request],
            progress: bool = False) -> Dict[int, np.ndarray]:
        """Drain the request stream; returns {rid: (P+gen,) tokens}."""
        for r in requests:
            need = len(r.prompt) + r.gen
            if need > self.max_len:
                raise ValueError(f"request {r.rid} needs {need} positions "
                                 f"> max_len={self.max_len}")
        dev = self.device
        queue = list(requests)
        cache = _fresh_cache(
            self._programs, (), ("engine",),
            lambda d: _kv(model.init_decode_cache(self.cfg, self.slots,
                                                  self.max_len, device=d)),
            dev)
        active: List[Optional[Request]] = [None] * self.slots
        emitted: Dict[int, List[int]] = {}
        pos = np.full((self.slots,), -1, np.int32)
        rows = np.full((self.slots,), -1, np.int32)
        tok = np.zeros((self.slots,), np.int32)
        done: Dict[int, np.ndarray] = {}

        while queue or any(a is not None for a in active):
            for s in range(self.slots):       # admit arrivals into free slots
                if active[s] is None and queue:
                    r = queue.pop(0)
                    active[s] = r
                    emitted[r.rid] = list(r.prompt)
                    pos[s] = 0                # slot REUSE: ring restarts; the
                    rows[s] = self.bank.lookup(r.user_id)   # validity mask
                    tok[s] = int(r.prompt[0])  # (slot <= idx) hides stale KV
            nxt, cache = self._step(
                cache, torch.from_numpy(tok[:, None].copy()).to(dev),
                torch.from_numpy(pos.copy()).to(dev),
                torch.from_numpy(rows.copy()).to(dev))
            self.steps += 1
            nxt = nxt.cpu().numpy()
            for s in range(self.slots):
                r = active[s]
                if r is None:
                    continue
                t = int(pos[s])
                total = len(r.prompt) + r.gen
                if t < len(r.prompt) - 1:     # still feeding the prompt
                    tok[s] = int(r.prompt[t + 1])
                else:                         # greedy continuation
                    emitted[r.rid].append(int(nxt[s]))
                    tok[s] = int(nxt[s])
                pos[s] += 1
                if len(emitted[r.rid]) >= total:
                    done[r.rid] = np.asarray(emitted.pop(r.rid), np.int32)
                    if progress:
                        print(f"#   finished rid={r.rid} user={r.user_id} "
                              f"({len(done)}/{len(requests)})")
                    active[s] = None          # freed: next arrival reuses it
                    pos[s], rows[s], tok[s] = -1, -1, 0
        return done


def serve_naive(cfg, base: dict, bank: AdapterBank,
                requests: Sequence[Request], *,
                device="cuda") -> Dict[int, np.ndarray]:
    """The merged-adapter baseline: per request, fold that user's adapter
    into W (paper eqn. 10) and decode batch-1 — no cross-user batching."""
    sc = cfg.lora_alpha / cfg.lora_rank
    ng, nt = model._none_adapters_like(cfg, base.get("groups") is not None)
    none_ad = {"groups": ng, "tail": nt}
    merged_cache: Dict[int, dict] = {}
    out: Dict[int, np.ndarray] = {}
    with torch.inference_mode():
        for r in requests:
            row = bank.lookup(r.user_id)
            if row not in merged_cache:
                merged_cache[row] = bank.merged_base(base, row, sc)
            params = {"base": merged_cache[row], "adapter": none_ad}
            toks = generate(cfg, params, r.prompt[None], r.gen, device=device)
            out[r.rid] = toks[0].cpu().numpy().astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fed-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--users", type=int, default=0,
                    help="multi-tenant mode: serve a seeded request stream "
                         "from this many distinct users")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        params = model.init_params(cfg, gen)

    if args.users:                      # multi-tenant request-stream path
        with torch.inference_mode():
            bank = random_bank(cfg, args.users, gen)
        reqs = make_requests(bank, args.requests,
                             prompt_len=args.prompt_len, gen=args.gen,
                             vocab=cfg.vocab_size, seed=args.seed)
        eng = ServeEngine(cfg, params["base"], bank, slots=args.slots,
                          max_len=args.prompt_len + args.gen, device=dev)
        t0 = time.perf_counter()
        done = eng.run(reqs, progress=True)
        dt = time.perf_counter() - t0
        n_new = sum(r.gen for r in reqs)
        print(f"served {len(done)} requests from {args.users} users in "
              f"{dt:.1f}s over {eng.steps} steps ({n_new / max(dt, 1e-9):.1f} "
              f"tok/s, {args.slots} slots, {dev})")
        print("sample:", done[reqs[0].rid][-args.gen:])
        return

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen, device=dev)
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    print(f"generated {tuple(out.shape)} in {dt:.1f}s "
          f"({1e3 * dt / max(n_new, 1):.1f} ms/token, batched, {dev})")
    print("sample:", out[0, -args.gen:].cpu().numpy())


if __name__ == "__main__":
    main()
