#!/usr/bin/env python3
"""Full-width run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
versions, serves and trains.

    python3 chip_smoke.py

Phases, one JSON line each (several for the case phases):
  build        build every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
  hold_check   time_ms's gap test must fire on a host-bound call and stay
               quiet on a device-bound one
  kernels      the decode kernels against their plain PyTorch versions on
               the card at the serving path's shapes (and edge cases), with
               their times, the plain versions', one PyTorch library call's
               and the card's bound
  flash_cases  the flash forward (out, lse) and backward (dq, dk, dv)
               kernels against the plain version: f32/bf16, causal /
               window 64 and 96 / non-causal, GQA 12/4, 32/32, 8/1 and
               16/1 (MQA), hd 64/128, S 256/512 and ragged 200; the
               backward twice (bitwise equal), on the 16-byte route, and
               the last case again on unaligned views (scalar route)
  flash_timing forward, dq, dk/dv, the backward as the model runs it
               (softmax_delta + dq + dk/dv) and forward+backward at the
               train shape (B=8, S=256, H=12, K=4, hd=64, f32) and at
               S=512, beside the bound, the plain version and
               scaled_dot_product_attention (forward; backward, the
               library time of dq and dk/dv)
  serve        multi-tenant LLaMA-7B decode at full width and depth (bf16,
               random weights): 16 requests from 8 users through 8 slots;
               every request must finish and every step must launch both
               kernels
  profile      device time by kernel and device idle share over a few steps
  oracle       the same width in f32 at 2 layers: ServeEngine tokens must
               equal the merged-weights serve_naive tokens request for
               request
  tri_lora_cases  the tri-LoRA forward, dx and dW kernels and the rank-r
               grads through autograd against the plain forward and the
               analytic backward: f32/bf16, the JAX kernel-test shapes, the
               training shapes (2048x768x768 and x256, r=8), ragged
               77x100x130 r=16, dW in clusters of 7 and 3 splits, decode
               M=1 and 8 at K=N=4096 (bf16); then
               the bf16 forward at rwkv6-1.6b width with f32 adapters on
               the prefill's strided (B,T,5,D) views and the decode rows
               (wgmma route) and on a view TMA cannot read (SIMT route);
               each line names the forward's route
  tri_lora_timing each kernel beside the bound, the plain version and one
               torch call (addmm / x.T@g): at the training shapes of wq
               (forward, dx, dW; x@w alone as a floor) and wk/wv (forward,
               dx, dW), f32, and the forward at the rwkv6-1.6b prefill
               (M=4096) and decode (M=8) shapes, bf16 with f32 adapters;
               each output held to the plain version's (gradients with the
               absolute part scaled), dx and dW bitwise the same on a
               second call, and the host time of a decode-shape call
  train        CE-LoRA ``run_federated`` on fed-100m at full width and
               depth (f32, random backbone): 4 clients, 3 rounds of 5 local
               steps of batch 8 at sequence 256, attn_impl="flash"; exact
               flash and tri-LoRA launch counts, a profile window, and the
               same job with attn_impl="ref" on the card as its reference
  lm_train     the causal-LM driver ``launch.train.run`` on fed-100m at full
               width and depth: 4 clients, 3 rounds of 5 local steps of
               8x256, celora, int8 uplink, flash; exact launch counts, a
               falling loss, the byte ledger, a checkpoint that verifies and
               restores, and a profile window of train.local_fit
  pretrain     ``FedTask.create`` with two 8x256 warm-up batches: the
               backbone trains, so every projection runs the dW kernel too
  card_vs_cpu  one loss and its adapter gradients at full width and depth
               on the card (all kernels) and on the CPU (plain versions)
  wkv6_cases   the wkv6 kernel (y and final state) against the plain scan:
               the JAX kernel-test shapes, T = 1, ragged T, extreme decay,
               the rwkv6-1.6b prefill shape in bf16/f32, strided views of
               one (B,T,3D) buffer; one launch per call
  wkv6_timing  the kernel at B=8 T=512 H=32 hd=64 beside the corrected
               bound and the plain versions (no PyTorch call computes it)
  rwkv_prefill rwkv6-1.6b at full width and depth (bf16, random weights):
               model.forward over 8x512 tokens with use_rwkv_kernel=True,
               exactly 24 wkv6 and 96 tri-LoRA forward launches (all 96 on
               the wgmma route), every wkv6 call against wkv6_ref on its own
               inputs, the same weights in f32 within 2e-2 of the plain
               path's logits, and a profile window with the tri-LoRA and
               wkv6 kernels' shares of device time
  rwkv_decode  serve.generate at full width and depth: 8 prompts of 32
               tokens and 32 new ones, 96 tri-LoRA forward launches on the
               wgmma route and 0 wkv6 launches every step
  rwkv_oracle  the same width in f32 at 2 layers (B=2, T=200): card vs CPU
               logits within 1e-4 of the largest, token-by-token decode on
               the card vs the forward at 2e-3
Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
the result line.  Exits non-zero, printing no result, on any failure and
when no CUDA device is present.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2,
                                                               atol=2e-2)}
ATTN_SRC = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
GEMV_SRC = "src/repro_torch/kernels/decode_attention/csrc/grouped_gemv.cu"
ATTN_TPU = "src/repro/kernels/decode_attention/decode_attention.py:57"
GEMV_TPU = "src/repro/kernels/decode_attention/grouped.py:67"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_TPU = {name: f"src/repro/kernels/flash_attention/flash_attention.py:{n}"
             for name, n in (("flash_fwd", 124), ("flash_dq", 176),
                             ("flash_dkv", 214), ("flash_bwd", 255))}
#: (B, S, H, K, hd, causal, window) of the flash kernel cases
FLASH_CASES = (
    (4, 256, 12, 4, 64, True, 0),       # the train phase's shape
    (2, 512, 12, 4, 64, True, 64),      # sliding window
    (4, 200, 12, 4, 64, True, 0),       # ragged: no multiple of the tile
    (2, 256, 12, 4, 64, False, 0),      # non-causal
    (2, 200, 12, 4, 64, False, 0),      # non-causal ragged: keys masked
    (2, 256, 32, 32, 128, True, 0),     # LLaMA-7B heads
    (1, 512, 32, 32, 128, True, 64),
    (2, 200, 32, 32, 128, False, 0),
    (2, 200, 16, 1, 64, True, 0),       # MQA: 16 heads on one KV head
    (1, 512, 8, 1, 128, True, 96),      # a group of 8, window 96
)
#: the train phase's attention shape and the kernel table's bound shape
FLASH_TIMED = ((8, 256, 12, 4, 64), (8, 512, 12, 4, 64))
#: the flash kernels (all, then the backward's two) whose share of device
#: time the training profiles report
FLASH_SHARES = ("flash_", "bwd::flash_")
TRI_LORA_SRC = "src/repro_torch/kernels/tri_lora/csrc/tri_lora.cu"
TRI_LORA_TPU = {name: f"src/repro/kernels/tri_lora/tri_lora.py:{n}"
                for name, n in (("tri_lora_fwd", 55), ("tri_lora_dx", 107),
                                ("tri_lora_dw", 154))}
#: (M, K, N, r) of the tri-LoRA cases: the JAX package's kernel-test shapes,
#: the training shapes of fed-100m wq/wo and wk/wv, a ragged shape, and M
#: that dW splits into clusters of 7 (ragged last split) and 3 blocks; the
#: decode shapes (LLaMA-7B width, bf16 only) follow
TRI_LORA_CASES = ((64, 64, 64, 4), (96, 160, 130, 8), (32, 256, 64, 16),
                  (128, 64, 192, 2), (2048, 768, 768, 8),
                  (2048, 768, 256, 8), (77, 100, 130, 16),
                  (2000, 768, 512, 8), (800, 256, 192, 8))
TRI_LORA_DECODE = ((1, 4096, 4096, 8), (8, 4096, 4096, 8))
#: (label, kernel, M, K, N, r, dtype of x/W/g, dtype of the adapters) at
#: which the tri-LoRA kernels are timed: the training shapes of fed-100m
#: (wq/wo and wk/wv, f32) and the rwkv6-1.6b prefill (8x512
#: tokens) and decode (8 rows) shapes of the time mix (bf16, f32 adapters
#: as rwkv_params makes them)
TRI_LORA_TIMED = (
    ("wq", "tri_lora_fwd", 2048, 768, 768, 8, "float32", "float32"),
    ("wq", "tri_lora_dx", 2048, 768, 768, 8, "float32", "float32"),
    ("wq", "tri_lora_dw", 2048, 768, 768, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_fwd", 2048, 768, 256, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_dx", 2048, 768, 256, 8, "float32", "float32"),
    ("wk/wv", "tri_lora_dw", 2048, 768, 256, 8, "float32", "float32"),
    ("rwkv prefill", "tri_lora_fwd", 4096, 2048, 2048, 8, "bfloat16",
     "float32"),
    ("rwkv decode", "tri_lora_fwd", 8, 2048, 2048, 8, "bfloat16", "float32"),
)
WKV6_SRC = "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"
WKV6_TPU = "src/repro/kernels/rwkv6/rwkv6.py:79"
#: (B, T, H, hd) of the wkv6 cases in f32 with a non-zero state: the JAX
#: package's kernel-test shapes (tests/test_kernels.py), T = 1, and hd 64
#: at a T that is no multiple of the 32-step chunk
WKV6_CASES = ((2, 64, 2, 16), (2, 80, 2, 16), (2, 33, 1, 8),
              (2, 128, 4, 32), (2, 1, 2, 64), (2, 77, 3, 64))
#: the rwkv6-1.6b prefill shape (bf16 r/k/v/u, f32 w), at which the
#: kernel is checked and timed
WKV6_FULL = (8, 512, 32, 64)
#: the rwkv phases' jobs: a prefill of 8 sequences of 512 tokens, a decode
#: of 8 prompts of 32 tokens and 32 new ones, and the f32 oracle at 2
#: layers over 2 sequences of 200 tokens (ragged against 32 and 64)
RWKV_PREFILL = dict(batch=8, seq=512)
RWKV_DECODE = dict(batch=8, prompt_len=32, gen=32)
RWKV_ORACLE = dict(layers=2, batch=2, seq=200)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

#: the stream hold of time_ms, in clock cycles (~30 ms at H100 clocks), and
#: the most it is doubled to before a run that leaves the device a gap fails
HOLD_CYCLES = 60_000_000
HOLD_MAX_X = 16
#: [hold, calls] of each time_ms run since the last :func:`holds_used`, the
#: hold as a multiple of HOLD_CYCLES; negative where the device may have
#: waited for the host even at the largest hold (a plain version, its host
#: time included)
HOLDS: list = []


def time_ms(torch, fn, inputs, iters: int = 60, *,
            plain: bool = False) -> float:
    """Device time of one ``fn(*inputs[i])`` call, cycling through
    ``inputs`` (copies that together exceed the 50 MB L2, so each call reads
    its operands from device memory as the serving path does).  A sleep
    kernel holds the stream while the host enqueues the calls, so the
    events time the device and not the host's launch rate.  An event marks
    the end of each call on the stream; once a call is enqueued, the mark
    of the call before it (the hold's end, for the first) must still be
    pending.  If the device has reached it, the device may have waited for
    the host between the two calls: a gap.  The host may also block on the
    full launch queue before the hold ends (a call of many launches); the
    marks of the calls just before stay pending, so that is no gap.  On a
    gap the run is repeated with twice the hold and half the calls (at
    least 8), up to HOLD_MAX_X times HOLD_CYCLES, and fails beyond that.
    A ``plain`` version (a yardstick of correctness, not of speed) is timed
    all the same, its host time included, and its hold recorded as
    negative.  The hold and the calls used are appended to HOLDS."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    hold, calls = 1, iters
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        marks = [torch.cuda.Event() for _ in range(calls)]
        torch.cuda._sleep(HOLD_CYCLES * hold)
        start.record()
        gap, last = False, start
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
            gap = gap or last.query()       # the device got there first
            marks[i].record()
            last = marks[i]
        end.record()
        torch.cuda.synchronize()
        if not gap or (plain and hold == HOLD_MAX_X):
            HOLDS.append([-hold if gap else hold, calls])
            return start.elapsed_time(end) / calls
        require(hold < HOLD_MAX_X,
                f"the device reached the end of a call before the host had "
                f"enqueued the next, even behind a "
                f"{HOLD_MAX_X}x{HOLD_CYCLES}-cycle hold")
        hold, calls = 2 * hold, max(min(8, iters), calls // 2)


def holds_used() -> list:
    """The [hold, calls] of the time_ms runs since the last call,
    emptied."""
    used = list(HOLDS)
    HOLDS.clear()
    return used


def phase_hold_check(torch, dev) -> None:
    """time_ms's gap test on two calls of known kind: a small kernel and
    then 2 ms on the host (the device waits for the host, so the hold must
    grow), and a 4096x4096 f32 matmul (the host keeps ahead of the device
    at the first hold)."""
    x = torch.zeros(1 << 20, device=dev)
    a = torch.randn(4096, 4096, device=dev)

    def host_bound(x):
        x.add_(1)
        time.sleep(2e-3)
    host_ms = time_ms(torch, host_bound, [(x,)])
    device_ms = time_ms(torch, lambda a: a @ a, [(a,)])
    holds = holds_used()
    emit({"phase": "hold_check", "host_bound_ms": host_ms,
          "device_bound_ms": device_ms, "stream_hold_x": holds})
    require(holds[0][0] > 1, f"time_ms saw no gap in a host-bound run: "
                             f"{holds[0]}")
    require(holds[1] == [1, 60], f"time_ms saw a gap in a device-bound "
                                 f"run: {holds[1]}")


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


def compare(torch, got, want, dtype_name):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    return float(err.max()), int(bad.sum())


def compare_scaled(torch, got, want, dtype_name):
    """As :func:`compare`, with the absolute part scaled by the reference's
    largest entry (how tests/test_kernels.py holds a gradient)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[dtype_name]["rtol"]
    scale = max(1.0, float(want.abs().max()))
    return float(err.max()), int((err > tol * scale + tol * want.abs()).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    built = build.build_all()
    info = {}
    for name, b in built.items():
        regs = [ln.split("Used ")[1].split(",")[0] for ln in b.log.splitlines()
                if "Used " in ln]
        spills = [ln for ln in b.log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        info[name] = {"seconds": round(b.seconds, 3), "registers": regs,
                      "spill_lines": spills}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": info})


def attn_cases(torch, ops, ref, dev):
    """Kernel vs plain version: LLaMA-7B width and 12/4 GQA, f32 and bf16,
    ragged idx with a masked row, a wrapped ring, a scalar idx."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (b, h, kh, hd, ring, idx) in (
                (8, 32, 32, 128, 160, [5, 200, -1, 159, 0, 77, 100, 158]),
                (8, 32, 32, 128, 160, 37),
                (4, 12, 4, 64, 100, [5, 140, -1, 99])):
            def rn(*s):
                return torch.randn(s, generator=g, device=dev).to(dt)
            q, k, v = rn(b, 1, h, hd), rn(b, ring, kh, hd), rn(b, ring, kh, hd)
            idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, idx_t)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, idx_t)
            err, nbad = compare(torch, got, want, dt_name)
            masked = [i for i, x in enumerate(torch.atleast_1d(idx_t).tolist())
                      if x < 0]
            zero = all(bool((got[i] == 0).all()) for i in masked)
            case = dict(b=b, h=h, kh=kh, hd=hd, ring=ring,
                        idx=idx if isinstance(idx, int) else "ragged")
            emit({"phase": "kernels", "kernel": "decode_attention",
                  "dtype": dt_name, **case, "max_abs_err": err,
                  "n_out_of_tol": nbad, "masked_rows_zero": zero,
                  "tol": TOL[dt_name]})
            require(nbad == 0 and zero,
                    f"decode_attention disagrees with its plain version: "
                    f"{case} {dt_name} err={err} bad={nbad} zero={zero}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    return worst


def gemv_cases(torch, ops, ref, dev):
    """Kernel vs plain version at the serving widths (K=N=4096, and
    K=11008), ragged K/N (odd N, 20 rows) and 40 rows (two 32-row groups)
    — r=8, m=8 bank rows."""
    g = torch.Generator(device=dev).manual_seed(2)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (kk, n, rows) in ((4096, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
                              (11008, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
                              (300, 71, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 2),
                              (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 4)):
            m, r = 8, 8
            x = torch.randn((len(rows), kk), generator=g, device=dev).to(dt)
            w = (torch.randn((kk, n), generator=g, device=dev)
                 / math.sqrt(kk)).to(dt)
            a = torch.randn((m, kk, r), generator=g, device=dev) / math.sqrt(r)
            c = torch.eye(r, device=dev) + 0.1 * torch.randn(
                (m, r, r), generator=g, device=dev)
            bb = 0.02 * torch.randn((m, r, n), generator=g, device=dev)
            rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
            got = ops.grouped_dense(rows_t, x, w, a, c, bb, scaling=2.0)
            torch.cuda.synchronize()
            want = ref.grouped_gemv_ref(rows_t, x, w, a, c, bb, scaling=2.0)
            err, nbad = compare(torch, got, want, dt_name)
            zero = bool((got[rows_t < 0] == 0).all())
            case = dict(rows=len(rows), k=kk, n=n, r=r, m=m)
            emit({"phase": "kernels", "kernel": "grouped_gemv",
                  "dtype": dt_name, **case, "max_abs_err": err,
                  "n_out_of_tol": nbad, "masked_rows_zero": zero,
                  "tol": TOL[dt_name]})
            require(nbad == 0 and zero,
                    f"grouped_gemv disagrees with its plain version: {case} "
                    f"{dt_name} err={err} bad={nbad} zero={zero}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    return worst


def time_attention(torch, F, ops, ref, bounds, dev):
    """The serving path's call: B=8 slots, H=K=32, hd=128, ring 160, bf16,
    every ring full (the most a step of the serve phase reads)."""
    b, h, kh, hd, ring = 8, 32, 32, 128, 160
    g = torch.Generator(device=dev).manual_seed(3)
    kv_bytes = 2 * b * ring * kh * hd * 2
    sets = []
    for _ in range(copies_for(kv_bytes)):
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((b, 1, h, hd), (b, ring, kh, hd),
                             (b, ring, kh, hd)))
        idx = torch.full((b,), ring - 1, dtype=torch.int32, device=dev)
        valid = (torch.arange(ring, device=dev)[None, :] <= idx[:, None]) | \
            (idx[:, None] >= ring)
        sets.append((q, k, v, idx, valid[:, None, None, :]))
    q, k, v, idx, _ = sets[0]
    err = float((ops.decode_attention(q, k, v, idx).float()
                 - ref.decode_attention_ref(q, k, v, idx).float()).abs().max())

    def lib(q, k, v, idx, mask):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    n_valid = sum(min(int(i) + 1, ring) for i in idx.tolist())
    return dict(
        name="decode_attention", route="cuda", source=ATTN_SRC,
        replaces=ATTN_TPU, max_abs_err=err,
        ms=time_ms(torch, lambda q, k, v, i, m: ops.decode_attention(
            q, k, v, i), sets),
        plain_ms=time_ms(torch, lambda q, k, v, i, m: ref.decode_attention_ref(
            q, k, v, i), sets, plain=True),
        library_ms=time_ms(torch, lib, sets), stream_hold_x=holds_used(),
        **bound(bounds.decode_attention(b, h, kh, hd, n_valid, "bfloat16")))


def time_gemv(torch, ops, ref, bounds, dev):
    """The serving path's call: the bank GEMV of ``wq`` at LLaMA-7B width —
    8 slots of 8 distinct users, K=N=4096 bf16, r=8, m=8."""
    bsz, kk, n, r, m = 8, 4096, 4096, 8, 8
    g = torch.Generator(device=dev).manual_seed(4)
    sets = []
    for _ in range(copies_for(kk * n * 2)):
        x = torch.randn((bsz, kk), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((kk, n), generator=g, device=dev)
             / math.sqrt(kk)).to(torch.bfloat16)
        a = torch.randn((m, kk, r), generator=g, device=dev) / math.sqrt(r)
        c = torch.eye(r, device=dev) + 0.1 * torch.randn(
            (m, r, r), generator=g, device=dev)
        b = 0.02 * torch.randn((m, r, n), generator=g, device=dev)
        rows = torch.arange(bsz, dtype=torch.int32, device=dev)
        sets.append((rows, x, w, a, c, b))
    err = float((ops.grouped_dense(*sets[0], scaling=2.0).float()
                 - ref.grouped_gemv_ref(*sets[0], scaling=2.0).float()
                 ).abs().max())
    users = len(set(sets[0][0].tolist()))
    return dict(
        name="grouped_gemv", route="cuda", source=GEMV_SRC,
        replaces=GEMV_TPU, max_abs_err=err,
        ms=time_ms(torch, lambda *t: ops.grouped_dense(*t, scaling=2.0), sets),
        plain_ms=time_ms(torch, lambda *t: ref.grouped_gemv_ref(
            *t, scaling=2.0), sets, plain=True),
        library_ms=time_ms(torch, lambda rows, x, w, *_: x @ w, sets),
        stream_hold_x=holds_used(),
        **bound(bounds.grouped_gemv(bsz, kk, n, r, users, "bfloat16")))


# ---------------------------------------------------------------------------
# flash attention: cases and timing
# ---------------------------------------------------------------------------

def flash_inputs(torch, dev, b, s, h, kh, hd, dtype, gen):
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for sh in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd),
                       (b, s, h, hd))]


def unaligned_view(torch, t):
    """t's values in a view whose rows start one element past a 16-byte
    boundary (the backward's scalar route)."""
    buf = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                      device=t.device)
    view = buf[..., 1:]
    view.copy_(t)
    return view


def flash_cases(torch, fa_ops, fa_ref, dev):
    """Kernels vs plain version: out and lse of the forward, dq/dk/dv of
    the backward, per case and dtype; the backward again on the same
    inputs, which must give bitwise the same dq, dk and dv; each case once
    more on unaligned views of the same values at the last case's shape,
    through the backward's scalar route.  lse is f32 in both dtypes and is
    held to the f32 tolerance."""
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for i, (b, s, h, kh, hd, causal, window) in enumerate(
                FLASH_CASES + FLASH_CASES[-1:]):
            route = "scalar" if i == len(FLASH_CASES) else "vec"
            q, k, v, do = flash_inputs(torch, dev, b, s, h, kh, hd, dt, gen)
            if route == "scalar":
                q, k, v, do = (unaligned_view(torch, t) for t in (q, k, v, do))
            kw = dict(causal=causal, window=window)
            fa_ops.reset_launches()
            out, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
            grads = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            routes = dict(fa_ops.ROUTES)
            same = all(torch.equal(x, y) for x, y in zip(grads, again))
            want_out, want_lse = fa_ref.flash_attention_fwd_ref(q, k, v,
                                                                **kw)
            want_grads = fa_ref.flash_attention_bwd_ref(q, k, v, do, **kw)
            errs, bad = {}, 0
            for name, got, want, tol_dt in (
                    ("out", out, want_out, dt_name),
                    ("lse", lse, want_lse, "float32"),
                    *((n, g, w, dt_name) for n, g, w in
                      zip(("dq", "dk", "dv"), grads, want_grads))):
                errs[name], nbad = compare(torch, got, want, tol_dt)
                bad += nbad
            case = dict(b=b, s=s, h=h, kh=kh, hd=hd, causal=causal,
                        window=window)
            emit({"phase": "flash_cases", "dtype": dt_name, **case,
                  "routes": routes, "bwd_bitwise_repeatable": same,
                  "max_abs_err": errs, "n_out_of_tol": bad,
                  "tol": TOL[dt_name], "lse_tol": TOL["float32"]})
            require(bad == 0, f"flash kernels disagree with the plain "
                    f"version: {case} {dt_name} errors {errs}")
            require(same, f"flash backward not bitwise repeatable: {case} "
                    f"{dt_name}")
            want_routes = {"bwd_vec": 0, "bwd_scalar": 0}
            want_routes[f"bwd_{route}"] = 4
            require(routes == want_routes, f"flash backward routes {routes}, "
                    f"expected {want_routes}: {case} {dt_name}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), *errs.values())
    return worst


def flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen):
    """Copies of (q, k, v, dO, out, lse, delta), f32 causal, that together
    exceed the L2, at one FLASH_TIMED shape."""
    one = 4 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
    sets = []
    for _ in range(copies_for(one)):
        q, k, v, do = flash_inputs(torch, dev, b, s, h, kh, hd,
                                   torch.float32, gen)
        out, lse = fa_ops.flash_attention_fwd(q, k, v)
        sets.append((q, k, v, do, out, lse, fa_ops.softmax_delta(out, do)))
    return sets


def flash_bwd_calls(fa_ops):
    """The backward as timed, each a function of one set: the dq kernel,
    the dk/dv kernel, and ``flash_attention_bwd`` as the model runs it
    (``softmax_delta``, dq, dk/dv)."""
    return {
        "flash_dq": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_dq(q, k, v, do, lse, delta),
        "flash_dkv": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_dkv(q, k, v, do, lse, delta),
        "flash_bwd": lambda q, k, v, do, o, lse, delta:
            fa_ops.flash_attention_bwd(q, k, v, o, lse, do)}


def sdpa_causal(F, q, k, v):
    """scaled_dot_product_attention on the model-layout tensors (transposed
    views), causal, grouped-query."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)


def sdpa_bwd_graphs(torch, F, sets):
    """One SDPA forward graph per set, and the call that runs its backward
    (all three gradients) again and again."""
    def graph(q, k, v, do, *_):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return leaves, sdpa_causal(F, *leaves), do.transpose(1, 2)

    def run(leaves, y, dy):
        torch.autograd.grad(y, leaves, dy, retain_graph=True)
    return [graph(*t) for t in sets], run


def time_flash(torch, F, fa_ops, fa_ref, bounds, dev):
    """f32 causal at the train phase's shape and at S=512: each kernel, the
    forward, the backward as the model runs it (``flash_attention_bwd``:
    ``softmax_delta`` + dq + dk/dv) and forward+backward, the plain
    version and SDPA (``is_causal=True, enable_gqa=True`` on the
    model-layout tensors, transposed views).  Returns the kernel-table rows
    at the train shape; dq's and dk/dv's library time is SDPA's backward,
    which computes all three gradients."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = None
    bwd = flash_bwd_calls(fa_ops)
    for (b, s, h, kh, hd) in FLASH_TIMED:
        sets = flash_timed_sets(torch, fa_ops, dev, b, s, h, kh, hd, gen)
        q, k, v, do, out, lse, delta = sets[0]
        want_out, _ = fa_ref.flash_attention_fwd_ref(q, k, v)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, do)
        fa_ops.reset_launches()
        dq = bwd["flash_dq"](*sets[0])
        dk, dv = bwd["flash_dkv"](*sets[0])
        routes = dict(fa_ops.ROUTES)
        checked = [compare(torch, got, w, "float32")
                   for got, w in zip((dq, dk, dv), want)]
        require(all(bad == 0 for _, bad in checked),
                f"the timed backward disagrees with the plain version at "
                f"S={s}: {checked}")
        err = {"flash_fwd": float((out - want_out).abs().max()),
               "flash_dq": checked[0][0],
               "flash_dkv": max(checked[1][0], checked[2][0])}
        err["flash_bwd"] = max(err["flash_dq"], err["flash_dkv"])

        def plain_graph(q, k, v, do, *_):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return leaves, fa_ref.flash_attention_ref(*leaves), do

        def grad_of(graphs):
            def run(leaves, y, dy):
                torch.autograd.grad(y, leaves, dy, retain_graph=True)
            return run

        plain_graphs = [plain_graph(*t) for t in sets[:4]]
        sdpa_graphs, sdpa_bwd = sdpa_bwd_graphs(torch, F, sets)
        t = {
            "flash_fwd": time_ms(torch, lambda q, k, v, *_:
                                 fa_ops.flash_attention_fwd(q, k, v), sets),
            **{n: time_ms(torch, fn, sets) for n, fn in bwd.items()},
            "fwd_bwd": time_ms(torch, lambda q, k, v, do, *_:
                               fa_ops.flash_attention_bwd(
                                   q, k, v, *fa_ops.flash_attention_fwd(
                                       q, k, v), do), sets),
            "plain_fwd": time_ms(torch, lambda q, k, v, *_:
                                 fa_ref.flash_attention_fwd_ref(q, k, v),
                                 sets, iters=20, plain=True),
            "plain_bwd": time_ms(torch, grad_of(plain_graphs), plain_graphs,
                                 iters=20, plain=True),
            "plain_fwd_bwd": time_ms(torch, lambda q, k, v, do, *_:
                                     fa_ref.flash_attention_bwd_ref(
                                         q, k, v, do), sets, iters=20,
                                     plain=True),
            "sdpa_fwd": time_ms(torch, lambda q, k, v, *_:
                                sdpa_causal(F, q, k, v), sets),
            "sdpa_bwd": time_ms(torch, sdpa_bwd, sdpa_graphs),
        }
        del plain_graphs, sdpa_graphs
        bd = {"flash_fwd": bounds.flash_fwd(b, h, kh, s, hd, "float32"),
              "flash_dq": bounds.flash_dq(b, h, kh, s, hd, "float32"),
              "flash_dkv": bounds.flash_dkv(b, h, kh, s, hd, "float32"),
              "flash_bwd": bounds.flash_bwd(b, h, kh, s, hd, "float32")}
        bd_ms = {n: x.ms for n, x in bd.items()} | {
            "fwd_bwd": bd["flash_fwd"].ms + bd["flash_bwd"].ms}
        emit({"phase": "flash_timing", "b": b, "s": s, "h": h, "kh": kh,
              "hd": hd, "dtype": "float32", "causal": True,
              "kernel_ms": {n: t[n] for n in ("flash_fwd", "flash_dq",
                                              "flash_dkv", "flash_bwd",
                                              "fwd_bwd")},
              "bound_ms": bd_ms,
              "plain_ms": {"fwd": t["plain_fwd"], "bwd": t["plain_bwd"],
                           "fwd_bwd": t["plain_fwd_bwd"]},
              "sdpa_ms": {"fwd": t["sdpa_fwd"], "bwd": t["sdpa_bwd"]},
              "bwd_over_sdpa_bwd": t["flash_bwd"] / t["sdpa_bwd"],
              "routes": routes, "max_abs_err": err,
              "stream_hold_x": holds_used()})
        require(routes == {"bwd_vec": 2, "bwd_scalar": 0},
                f"the timed backward took routes {routes}")
        if rows is None:          # the train phase's shape
            rows = [dict(name=n, route="cuda", source=FLASH_SRC,
                         replaces=FLASH_TPU[n], max_abs_err=err[n], ms=t[n],
                         plain_ms=t["plain_fwd" if n == "flash_fwd"
                                    else "plain_bwd"],
                         library_ms=t["sdpa_fwd" if n == "flash_fwd"
                                      else "sdpa_bwd"], **bound(bd[n]))
                    for n in ("flash_fwd", "flash_dq", "flash_dkv",
                              "flash_bwd")]
            for r in rows[1:3]:
                r["note"] = ("library_ms is SDPA's whole backward (dq, dk "
                             "and dv); compare it with flash_bwd")
            rows[3].update(launch_key="flash_dq", note=(
                "softmax_delta + flash_dq + flash_dkv as the model runs "
                "them; launches counts its calls (one dq and one dk/dv "
                "launch each)"))
        del sets
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# tri-LoRA projection: cases and timing
# ---------------------------------------------------------------------------

def tri_lora_inputs(torch, dev, m, k, n, r, dtype, gen):
    """x, W, A, C, B and the cotangent at the JAX package's kernel-test
    scales (tests/test_kernels.py)."""
    def rn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)
    return (rn((m, k)), rn((k, n), 0.05), rn((k, r), 0.2), rn((r, r), 0.2),
            rn((r, n), 0.2), rn((m, n)))


def tri_lora_cases(torch, tl_ops, tl_ref, dev):
    """The op on the card (forward kernel; dx and dW kernels and the rank-r
    grads through autograd) against the plain forward and the analytic
    backward on the same inputs.  The forward is held to the kernel
    tolerance; each gradient to it with the absolute part scaled by the
    gradient's largest entry (tests/test_kernels.py)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    s = 2.0
    worst = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (m, k, n, r) in TRI_LORA_CASES + (
                TRI_LORA_DECODE if dt_name == "bfloat16" else ()):
            x, w, a, c, b, ct = tri_lora_inputs(torch, dev, m, k, n, r, dt,
                                                gen)
            leaves = [t.detach().requires_grad_(True) for t in (x, w, a, c, b)]
            before = {**tl_ops.LAUNCHES, **tl_ops.ROUTES}
            y = tl_ops.tri_lora_matmul(*leaves, s)
            grads = torch.autograd.grad(y, leaves, ct)
            torch.cuda.synchronize()
            launched = {key: tl_ops.LAUNCHES[key] - before[key]
                        for key in tl_ops.LAUNCHES}
            route = [key for key in tl_ops.ROUTES
                     if tl_ops.ROUTES[key] > before[key]]
            want_y = tl_ref.tri_lora_matmul_ref(x, w, a, c, b, s)
            want = tl_ref.tri_lora_bwd_ref(x, w, a, c, b, ct, s)
            errs, bad = {}, 0
            errs["y"], bad = compare(torch, y.detach(), want_y, dt_name)
            tol = TOL[dt_name]["rtol"]
            for name, got, ref_g in zip(("dx", "dw", "da", "dc", "db"),
                                        grads, want):
                errs[name], out = compare_scaled(torch, got, ref_g, dt_name)
                bad += out
            case = dict(m=m, k=k, n=n, r=r)
            emit({"phase": "tri_lora_cases", "dtype": dt_name, **case,
                  "max_abs_err": errs, "n_out_of_tol": bad, "tol": tol,
                  "launches": launched, "route": route,
                  "dw_splits": tl_ops.dw_plan(m, k, n,
                                              tl_ops.dw_capacity(dev))[0]})
            require(bad == 0, f"tri-LoRA kernels disagree with the plain "
                    f"version: {case} {dt_name} errors {errs}")
            require(launched == {"tri_lora_fwd": 1, "tri_lora_dx": 1,
                                 "tri_lora_dw": 1},
                    f"tri-LoRA launches {launched} for one forward and "
                    f"backward")
            worst[dt_name] = max(worst.get(dt_name, 0.0), *errs.values())
    for name, x, w, a, c, b, want_route in tri_lora_route_inputs(torch, dev,
                                                                 gen):
        before = dict(tl_ops.ROUTES)
        y = tl_ops.tri_lora_matmul(x, w, a, c, b, s)
        torch.cuda.synchronize()
        route = [key for key in before if tl_ops.ROUTES[key] > before[key]]
        err, bad = compare(torch, y, tl_ref.tri_lora_matmul_ref(
            x, w, a, c, b, s), "bfloat16")
        emit({"phase": "tri_lora_cases", "case": name, "dtype": "bfloat16",
              "m": x.shape[0] * (x.shape[1] if x.dim() == 3 else 1),
              "k": w.shape[0], "n": w.shape[1], "r": b.shape[0],
              "adapter_dtype": str(b.dtype).split(".")[-1],
              "max_abs_err": {"y": err}, "n_out_of_tol": bad,
              "tol": TOL["bfloat16"]["rtol"], "route": route})
        require(bad == 0, f"tri-LoRA forward disagrees with the plain "
                f"version: {name}, error {err}")
        require(route == [want_route], f"{name} took the route {route}, "
                f"not {want_route}")
        worst["bfloat16"] = max(worst["bfloat16"], err)
    return worst


def tri_lora_route_inputs(torch, dev, gen):
    """Forward cases of the RWKV time mix at rwkv6-1.6b width (bf16, f32
    adapters): the prefill's strided views of one (B,T,5,D) buffer at the
    prefill's 8x512 tokens (M = 4096, row stride 5·D, read in place by
    TMA), the decode rows, and the same values one bf16 element past a
    16-byte boundary (the SIMT route)."""
    d, r = 2048, 8
    mixed = torch.randn((8, 512, 5, d), generator=gen, device=dev).to(
        torch.bfloat16)
    _, w, a, c, b, _ = tri_lora_inputs(torch, dev, 8, d, d, r,
                                       torch.bfloat16, gen)
    a, c, b = a.float(), c.float(), b.float()
    shifted = torch.empty((8 * 512, d + 8), dtype=torch.bfloat16,
                          device=dev)[:, 1:d + 1]
    shifted.copy_(mixed[..., 1, :].reshape(-1, d))
    return (("rwkv_prefill_view", mixed[..., 1, :], w, a, c, b, "fwd_wgmma"),
            ("rwkv_decode_rows", mixed[:, -1, 2, :], w, a, c, b,
             "fwd_wgmma"),
            ("unaligned_view", shifted, w, a, c, b, "fwd_simt"))


def tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small, gen):
    """Enough copies of (x, w, a, b, p, q, g) to exceed the L2 cache: x, W
    and g in ``dtype``, the adapters in ``small``, P and Q as the op makes
    them (s = 2, rounded to ``dtype``)."""
    dt, st = getattr(torch, dtype), getattr(torch, small)
    sets = []
    for _ in range(copies_for(torch.finfo(dt).bits // 8
                              * (m * k + k * n + m * n))):
        x, w, a, c, b, g = tri_lora_inputs(torch, dev, m, k, n, r, dt, gen)
        a, c, b = (t.float().to(st) for t in (a, c, b))
        p = (2.0 * (x.float() @ a.float()) @ c.float()).to(dt)
        q = (2.0 * (g.float() @ b.float().T) @ c.float().T).to(dt)
        sets.append((x, w, a, b, p, q, g))
    return sets


def tri_lora_calls(torch, tl_ops):
    """The kernel, its plain version (the same products in f32) and one
    PyTorch call computing the same function, per kernel name."""
    def f32(t):
        return t.float()
    kernel = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_fwd(
            x, w, p, b),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_dx(
            g, w, q, a),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: tl_ops.tri_lora_dw(x, g)}
    plain = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: (
            f32(x) @ f32(w) + f32(p) @ f32(b)).to(x.dtype),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: (
            f32(g) @ f32(w).T + f32(q) @ f32(a).T).to(g.dtype),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: (
            f32(x).T @ f32(g)).to(x.dtype)}
    library = {
        "tri_lora_fwd": lambda x, w, a, b, p, q, g: torch.addmm(
            p @ b.to(p.dtype), x, w),
        "tri_lora_dx": lambda x, w, a, b, p, q, g: torch.addmm(
            q @ a.T.to(q.dtype), g, w.T),
        "tri_lora_dw": lambda x, w, a, b, p, q, g: x.T @ g}
    return kernel, plain, library


def host_us(torch, fn, args, calls: int = 200) -> float:
    """Host time of one enqueued call (no synchronisation inside)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_tri_lora(torch, tl_ops, bounds, dev):
    """Each kernel at each TRI_LORA_TIMED shape beside its plain version,
    one PyTorch library call and the bound, with the route the forward
    took; at the wq shape ``x@w`` alone as a floor; at the decode shape the
    host time of one call (the wgmma route encodes two tensor maps a call).
    Each output is held to the plain version's on the same inputs: the
    forward to the kernel tolerance, dx and dW with its absolute part
    scaled by the largest entry, as in ``tri_lora_cases``; dx and dW must
    give the same bits on a second call.  Returns the kernel-table
    rows."""
    gen = torch.Generator(device=dev).manual_seed(9)
    kernel, plain, library = tri_lora_calls(torch, tl_ops)
    rows = []
    for label, name, m, k, n, r, dtype, small in TRI_LORA_TIMED:
        sets = tri_lora_timed_sets(torch, dev, m, k, n, r, dtype, small, gen)
        before = dict(tl_ops.ROUTES)
        got = kernel[name](*sets[0])
        route = [key for key in before if tl_ops.ROUTES[key] > before[key]]
        check = compare if name == "tri_lora_fwd" else compare_scaled
        err, bad = check(torch, got, plain[name](*sets[0]), dtype)
        require(bad == 0, f"{name} at the {label} shape disagrees with the "
                f"plain version: {bad} entries out of tolerance, error {err}")
        same = name == "tri_lora_fwd" or torch.equal(got,
                                                      kernel[name](*sets[0]))
        require(same, f"{name} at the {label} shape is not bitwise "
                f"repeatable")
        t = {"kernel": time_ms(torch, kernel[name], sets),
             "plain": time_ms(torch, plain[name], sets, plain=True),
             "library": time_ms(torch, library[name], sets)}
        bd = {"tri_lora_fwd": bounds.tri_lora_matmul(m, k, n, r, dtype),
              "tri_lora_dx": bounds.tri_lora_dx(m, k, n, r, dtype),
              "tri_lora_dw": bounds.tri_lora_dw(m, k, n, dtype)}[name]
        line = {"phase": "tri_lora_timing", "kernel": name, "shape": label,
                "m": m, "k": k, "n": n, "r": r, "dtype": dtype,
                "adapter_dtype": small, "route": route,
                **{f"{key}_us": 1e3 * v for key, v in t.items()},
                "bound_us": 1e3 * bd.ms, "bound_by": bd.by,
                "max_abs_err": err, "n_out_of_tol": bad,
                "tol": TOL[dtype]["rtol"], "bitwise_repeatable": same}
        if name == "tri_lora_dw":
            line["splits"] = tl_ops.dw_plan(m, k, n,
                                            tl_ops.dw_capacity(dev))[0]
            line["dw_capacity"] = tl_ops.dw_capacity(dev)
        if label == "wq" and name == "tri_lora_fwd":
            line["x_at_w_floor_us"] = 1e3 * time_ms(
                torch, lambda x, w, *_: x @ w, sets)
        if dtype == "bfloat16" and m <= 64:
            line["host_us"] = host_us(torch, kernel[name], sets[0])
        line["stream_hold_x"] = holds_used()
        emit(line)
        rows.append(dict(name=name, route="cuda", source=TRI_LORA_SRC,
                         replaces=TRI_LORA_TPU[name], max_abs_err=err,
                         ms=t["kernel"], plain_ms=t["plain"],
                         library_ms=t["library"], shape=label, **bound(bd)))
        del sets, got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# wkv6: cases and timing
# ---------------------------------------------------------------------------

def wkv6_inputs(torch, dev, b, t, h, hd, dtype, gen, s_scale=0.1):
    """r, k, v, u in ``dtype``; w = sigmoid(2·N) in f32; state 0.1·N f32
    (the JAX package's kernel-test distributions)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (rn(b, t, h, hd).to(dtype) for _ in range(3))
    w = torch.sigmoid(2 * rn(b, t, h, hd))
    u = (0.5 * rn(h, hd)).to(dtype)
    return r, k, v, w, u, s_scale * rn(b, h, hd, hd)


def wkv6_check(torch, wkv_ops, wkv_ref, ins, plain_ins=None):
    """One op call against ``wkv6_ref`` (on ``plain_ins`` if given: the
    same values laid out contiguously): errors of y and the final state,
    each held to rtol = atol = 1e-4 with the absolute part scaled by the
    reference's largest entry, and the launches of the call."""
    n0 = wkv_ops.LAUNCHES["wkv6"]
    y, s = wkv_ops.wkv6(*ins)
    torch.cuda.synchronize()
    launched = wkv_ops.LAUNCHES["wkv6"] - n0
    want = wkv_ref.wkv6_ref(*(plain_ins or ins))
    errs, bad = {}, 0
    for name, got, ref_t in (("y", y, want[0]), ("state", s, want[1])):
        scale = max(1.0, float(ref_t.abs().max()))
        err = (got - ref_t).abs()
        errs[name] = float(err.max())
        bad += int((err > 1e-4 * scale + 1e-4 * ref_t.abs()).sum())
    finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    return errs, bad, launched, finite


def wkv6_cases(torch, wkv_ops, wkv_ref, dev):
    """The kernel against the plain scan on the card: the JAX test shapes,
    T = 1 and a ragged T in f32 with a non-zero state; extreme decay
    (w = 1e-6); the full prefill shape in the model's types; r, k and v
    as strided views of one (B, T, 3·D) buffer."""
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = [(f"f32 B={b} T={t} H={h} hd={hd}",
              wkv6_inputs(torch, dev, b, t, h, hd, torch.float32, gen), None)
             for (b, t, h, hd) in WKV6_CASES]
    b, t, h, hd = 1, 64, 1, 8
    cases.append(("extreme decay w=1e-6", (
        torch.full((b, t, h, hd), 0.5, device=dev),
        torch.full((b, t, h, hd), 0.5, device=dev),
        torch.ones((b, t, h, hd), device=dev),
        torch.full((b, t, h, hd), 1e-6, device=dev),
        torch.zeros((h, hd), device=dev),
        torch.zeros((b, h, hd, hd), device=dev)), None))
    b, t, h, hd = WKV6_FULL
    cases.append((f"bf16 r/k/v/u, f32 w: B={b} T={t} H={h} hd={hd}",
                  wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen),
                  None))
    b, t, h, hd = 2, 100, 4, 64
    wide = torch.randn((b, t, 3 * h * hd), generator=gen, device=dev).to(
        torch.bfloat16)
    r, k, v = (wide[..., i * h * hd:(i + 1) * h * hd].view(b, t, h, hd)
               for i in range(3))
    _, _, _, w, u, s0 = wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16,
                                    gen)
    cases.append(("strided views of a (B,T,3D) bf16 buffer",
                  (r, k, v, w, u, s0),
                  (r.contiguous(), k.contiguous(), v.contiguous(), w, u, s0)))
    worst = 0.0
    for name, ins, plain in cases:
        errs, bad, launched, finite = wkv6_check(torch, wkv_ops, wkv_ref,
                                                 ins, plain)
        emit({"phase": "wkv6_cases", "case": name,
              "strides": list(ins[0].stride()), "max_abs_err": errs,
              "n_out_of_tol": bad, "launches": launched, "finite": finite,
              "tol": "rtol=atol=1e-4, atol scaled by the largest entry"})
        require(bad == 0 and finite, f"wkv6 disagrees with wkv6_ref: {name} "
                f"errors {errs}, {bad} out of tolerance, finite={finite}")
        require(launched == 1, f"wkv6 launched {launched} kernels in one "
                f"call ({name})")
        worst = max(worst, *errs.values())
    return worst


def time_wkv6(torch, wkv_ops, wkv_ref, rwkv, bounds, dev, card: str):
    """The kernel at the rwkv6-1.6b prefill shape (B=8, T=512, H=32,
    hd=64; bf16 r/k/v/u, f32 w and state) beside the corrected bound, the
    op's plain version (the chunk-32 log-space recurrence, what the CPU
    runs) and the plain scan it is held to.  No single PyTorch call
    computes WKV6.  Returns the kernel-table row."""
    b, t, h, hd = WKV6_FULL
    gen = torch.Generator(device=dev).manual_seed(15)
    bd = bounds.wkv6(b, h, t, hd, "bfloat16")
    sets = [wkv6_inputs(torch, dev, b, t, h, hd, torch.bfloat16, gen)
            for _ in range(copies_for(bd.nbytes))]
    y, _ = wkv_ops.wkv6(*sets[0])
    err = float((y - wkv_ref.wkv6_ref(*sets[0])[0]).abs().max())
    ms = time_ms(torch, wkv_ops.wkv6, sets)
    chunked_ms = time_ms(torch, lambda *a: rwkv.wkv_chunked(*a, chunk=32),
                         sets, iters=5, plain=True)
    scan_ms = time_ms(torch, wkv_ref.wkv6_ref, sets, iters=3, plain=True)
    scaling = {}                  # the kernel's time against its block count
    for bb in (1, 32):
        ins = wkv6_inputs(torch, dev, bb, t, h, hd, torch.bfloat16, gen)
        scaling[f"b{bb}_blocks{bb * h}_us"] = 1e3 * time_ms(
            torch, wkv_ops.wkv6, [ins])
    emit({"phase": "wkv6_timing", "card": card, "b": b, "t": t, "h": h,
          "hd": hd, "dtypes": "r/k/v/u bf16, w/state/y f32",
          "kernel_us": 1e3 * ms, "bound_us": 1e3 * bd.ms,
          "bound_by": bd.by, "x_bound": ms / bd.ms,
          "plain_chunked32_us": 1e3 * chunked_ms,
          "plain_scan_us": 1e3 * scan_ms, "kernel_by_batch": scaling,
          "library": "no single PyTorch call computes WKV6",
          "max_abs_err": err, "stream_hold_x": holds_used()})
    del sets
    torch.cuda.empty_cache()
    return dict(name="wkv6", route="cuda", source=WKV6_SRC,
                replaces=WKV6_TPU, max_abs_err=err, ms=ms,
                plain_ms=chunked_ms, library_ms=None, **bound(bd))


# ---------------------------------------------------------------------------
# the RWKV-6 family: prefill, decode, oracle
# ---------------------------------------------------------------------------

def rwkv_params(torch, model, cfg, dev, seed, *, perturb_base: bool):
    """Random params drawn on the card from a seeded generator, with the
    adapters moved off their zero-delta init (B = 0.01·N, C = I + 0.05·N).
    With ``perturb_base`` every backbone parameter JAX initialises to zero
    or a constant is moved off it too: the ddlerp lerps and low-rank B,
    the decay base and its low-rank B, the bonus u, so the data-dependent
    decay and the bonus term run."""
    from repro_torch.tree import tree_map_with_path

    gen = torch.Generator(device=dev).manual_seed(seed)

    def noise(t, scale):
        return (scale * torch.randn(t.shape, generator=gen, device=dev)).to(
            t.dtype)

    def move(path, t):
        name = path[-1]
        if name == "B":
            return noise(t, 0.01)
        if name == "C":
            return t + noise(t, 0.05)
        if not perturb_base:
            return t
        if name in ("mu_x", "mu", "u", "mu_k", "mu_r"):
            return t + noise(t, 0.5)
        if name in ("mix_b", "w_b"):
            return t + noise(t, 0.1)
        if name == "w0":
            return (torch.rand(t.shape, generator=gen, device=dev) * 4.5
                    - 4.0).to(t.dtype)
        return t

    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        return tree_map_with_path(move, params)


def phase_rwkv_prefill(torch, wkv_ops, wkv_ref, tl_ops, model, get_config,
                       dev):
    """rwkv6-1.6b at full width and depth, bf16, random weights with
    adapters B ≠ 0: ``model.forward`` over 8×512 tokens with
    ``use_rwkv_kernel=True`` (24 wkv6 and 96 tri-LoRA forward launches),
    the plain path (``wkv_chunked``) on the same tokens, and a profile
    window of one kernel forward.

    Checks: the launches; every wkv6 call of that forward against
    ``wkv6_ref`` on its own inputs (the real activations of all 24
    layers), y and state within 1e-4 with the absolute part scaled by the
    largest entry; and the same weights in f32, where the kernel path's
    logits must match the plain path's within 2e-2 of the largest logit.
    The bf16 logits of the two paths are reported but not held to each
    other: the random bf16 model turns any difference of an f32 sum's
    order into bf16 rounding flips that grow over 24 layers (the plain
    scan and the plain chunked recurrence part by ~50 % of the largest
    logit in bf16, and each bf16 path by ~60 % from the f32 logits).  To
    show that spread on every run, the plain scan also runs the forward
    (``wkv_scan`` in place of ``wkv_chunked``) in f32 and bf16, and its
    distance from the chunked path is reported beside the kernel's."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from repro_torch.models import rwkv
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("rwkv6-1.6b")
    job = RWKV_PREFILL
    t0 = time.perf_counter()
    params = rwkv_params(torch, model, cfg, dev, 16, perturb_base=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_weights = sum(t.numel() for t in tree_leaves(params["base"]))
    toks = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (job["batch"], job["seq"])), device=dev)

    def fwd(kernel, p=params, c=cfg):
        return model.forward(c, p["base"], p["adapter"], {"tokens": toks},
                             use_rwkv_kernel=kernel)[0]

    def scan_fwd(p, c):
        """The plain path with the per-step scan in place of the chunked
        recurrence (both plain versions of the same function)."""
        chunked = rwkv.wkv_chunked
        rwkv.wkv_chunked = lambda *a, chunk=64: rwkv.wkv_scan(*a)
        try:
            return fwd(False, p, c)
        finally:
            rwkv.wkv_chunked = chunked

    calls, kernel = [], wkv_ops.wkv6

    def recorded(*ins):                       # keep each call's operands
        out = kernel(*ins)
        calls.append((ins, out))
        return out

    with torch.inference_mode():
        wkv_ops.reset_launches()              # counts of the main path only
        tl_ops.reset_launches()
        wkv_ops.wkv6 = recorded
        try:
            t0 = time.perf_counter()
            logits = fwd(True)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        finally:
            wkv_ops.wkv6 = kernel
        launches = {**wkv_ops.LAUNCHES, **tl_ops.LAUNCHES}
        routes = dict(tl_ops.ROUTES)
        call_errs, call_bad = [], 0
        for ins, out in calls:
            want = wkv_ref.wkv6_ref(*ins)
            for got, ref_t in zip(out, want):
                scale_c = max(1.0, float(ref_t.abs().max()))
                e = (got - ref_t).abs()
                call_errs.append(float(e.max()) / scale_c)
                call_bad += int((e > 1e-4 * scale_c + 1e-4 * ref_t.abs()).sum())
        del calls, ins, out, want, got, ref_t, e
        torch.cuda.reset_peak_memory_stats()  # without the recorded calls
        t0 = time.perf_counter()
        fwd(True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        wkv_ops.reset_launches()
        plain = fwd(False)
        torch.cuda.synchronize()
        plain_launches = dict(wkv_ops.LAUNCHES)
        t0 = time.perf_counter()
        fwd(False)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd(True)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        cfg32 = cfg.with_overrides(param_dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        ref32 = fwd(False, p32, cfg32)
        kern32 = fwd(True, p32, cfg32)
        scan32 = scan_fwd(p32, cfg32)
        del p32
        scan16 = scan_fwd(params, cfg)
    scale = float(ref32.abs().max())
    err32 = float((kern32 - ref32).abs().max())
    scan_err32 = float((scan32 - ref32).abs().max())
    scan_err16 = float((scan16 - plain).abs().max())
    err = float((logits - ref32).abs().max())
    plain_err = float((plain - ref32).abs().max())
    del kern32, ref32, scan32, scan16
    finite = bool(torch.isfinite(logits).all())
    tokens = job["batch"] * job["seq"]
    expected = {"wkv6": cfg.n_layers, "tri_lora_fwd": 4 * cfg.n_layers,
                "tri_lora_dx": 0, "tri_lora_dw": 0}
    emit({"phase": "rwkv_prefill", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "hd": cfg.hd, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "weights": n_weights,
          "weight_gb": n_weights * 2 / 1e9, **job, "init_s": init_s,
          "first_wall_s": first_s, "wall_s": wall, "tok_per_s": tokens / wall,
          "plain_wall_s": plain_wall, "plain_tok_per_s": tokens / plain_wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "routes": routes,
          "plain_wkv6_launches": plain_launches,
          "wkv6_calls_checked": len(call_errs) // 2,
          "wkv6_calls_max_err_over_max": max(call_errs),
          "wkv6_calls_n_out_of_tol": call_bad,
          "logits_max_abs": scale,
          "f32_kernel_vs_plain_over_max": err32 / scale,
          "f32_scan_vs_plain_over_max": scan_err32 / scale,
          "bf16_scan_vs_plain_over_max": scan_err16 / scale,
          "bf16_kernel_vs_f32_over_max": err / scale,
          "bf16_plain_vs_f32_over_max": plain_err / scale,
          "bf16_kernel_vs_bf16_plain_over_max":
              float((logits - plain).abs().max()) / scale,
          "finite": finite,
          "profile": {"window": "one forward, use_rwkv_kernel=True",
                      **device_split(prof, window_us, 12,
                                     shares=("tri_lora", "wkv6"))}})
    require(launches == expected,
            f"rwkv_prefill launches {launches} != expected {expected}")
    require(routes == {"fwd_wgmma": 4 * cfg.n_layers, "fwd_simt": 0},
            f"rwkv_prefill forward routes {routes}: every tri-LoRA forward "
            f"of the bf16 prefill must take the wgmma route")
    require(plain_launches == {"wkv6": 0},
            f"the plain path launched {plain_launches}")
    require(finite and tuple(logits.shape) == (job["batch"], job["seq"],
                                               cfg.vocab_size),
            f"prefill logits {tuple(logits.shape)}, finite={finite}")
    require(len(call_errs) == 2 * cfg.n_layers and call_bad == 0,
            f"wkv6 disagrees with wkv6_ref on the forward's own inputs: "
            f"{call_bad} entries out of tolerance over {len(call_errs) // 2} "
            f"calls, worst {max(call_errs)} of the largest entry")
    require(err32 <= 2e-2 * scale, f"f32 kernel and plain logits differ by "
            f"{err32} (largest logit {scale})")
    return launches, params


def phase_rwkv_decode(torch, wkv_ops, tl_ops, serve, get_config, params,
                      dev):
    """``serve.generate`` at full width and depth, bf16: 8 prompts of 32
    tokens and 32 new ones.  Every decode step must launch exactly 96
    tri-LoRA forward kernels and no wkv6 kernel (decode runs the one-step
    recurrence)."""
    import numpy as np

    cfg = get_config("rwkv6-1.6b")
    job = RWKV_DECODE
    prompts = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (job["batch"], job["prompt_len"]))
    per_step, step_ms = [], []
    decode_step = serve.model.decode_step

    def counts():
        return {**wkv_ops.LAUNCHES, **tl_ops.LAUNCHES, **tl_ops.ROUTES}

    def counted(*args, **kw):
        before = counts()
        t = time.perf_counter()
        out = decode_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        per_step.append({k: v - before[k] for k, v in counts().items()})
        return out

    wkv_ops.reset_launches()                  # counts of the main path only
    tl_ops.reset_launches()
    serve.model.decode_step = counted
    try:
        t0 = time.perf_counter()
        out = serve.generate(cfg, params, prompts, job["gen"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve.model.decode_step = decode_step
    launches = {**wkv_ops.LAUNCHES, **tl_ops.LAUNCHES}
    steps = len(per_step)
    want_step = {"wkv6": 0, "tri_lora_fwd": 4 * cfg.n_layers,
                 "tri_lora_dx": 0, "tri_lora_dw": 0,
                 "fwd_wgmma": 4 * cfg.n_layers, "fwd_simt": 0}
    srt = sorted(step_ms)
    emit({"phase": "rwkv_decode", "arch": cfg.name, **job, "steps": steps,
          "out_shape": list(out.shape), "wall_s": wall,
          "ms_per_step": 1e3 * wall / steps, "step_ms_p50": srt[steps // 2],
          "step_ms_p95": srt[int(0.95 * (steps - 1))],
          "first_step_ms": step_ms[0],
          "tok_per_s": job["batch"] * job["gen"] / wall,
          "launches": launches, "launches_per_step": want_step,
          "sample": out[0, -8:].tolist()})
    require(tuple(out.shape) == (job["batch"], job["prompt_len"] + job["gen"])
            and steps == job["prompt_len"] + job["gen"] - 1,
            f"generate returned {tuple(out.shape)} after {steps} steps")
    require(all(p == want_step for p in per_step),
            f"decode steps launched {[p for p in per_step if p != want_step][:3]}"
            f" (each step must launch {want_step})")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token ids out of range")
    return launches


def phase_rwkv_oracle(torch, wkv_ops, model, get_config, dev):
    """rwkv6-1.6b's full width in f32 at 2 layers, B=2, T=200: the card's
    forward (wkv6 and tri-LoRA kernels) against the CPU's (plain versions)
    on the same parameters within 1e-4 of the largest logit, then
    token-by-token decode on the card against that forward at rtol = atol
    = 2e-3 (tests/test_decode_consistency.py)."""
    import numpy as np

    from repro_torch.tree import tree_map

    job = RWKV_ORACLE
    cfg = get_config("rwkv6-1.6b").with_overrides(n_layers=job["layers"],
                                                  param_dtype="float32")
    params = rwkv_params(torch, model, cfg, dev, 18, perturb_base=True)
    b, t = job["batch"], job["seq"]
    toks = np.random.default_rng(18).integers(0, cfg.vocab_size, (b, t))

    def fwd(where):
        p = tree_map(lambda a: a.to(where), params)
        with torch.inference_mode():
            return model.forward(cfg, p["base"], p["adapter"],
                                 {"tokens": torch.as_tensor(toks,
                                                            device=where)},
                                 use_rwkv_kernel=True)[0].cpu()

    wkv_ops.reset_launches()
    card = fwd(dev)
    card_launches = dict(wkv_ops.LAUNCHES)
    cpu = fwd(torch.device("cpu"))
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, b, t, device=dev)
        tok_d = torch.as_tensor(toks, device=dev)
        steps = []
        for i in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": tok_d[:, i:i + 1],
                 "positions": torch.full((b, 1), i, dtype=torch.int32,
                                         device=dev)})
            steps.append(lg[:, 0].cpu())
    dec = torch.stack(steps, dim=1)
    dec_err = (dec - card).abs()
    dec_bad = int((dec_err > 2e-3 + 2e-3 * card.abs()).sum())
    emit({"phase": "rwkv_oracle", "arch": cfg.name, "dtype": "float32",
          **job, "d_model": cfg.d_model, "card_wkv6_launches": card_launches,
          "card_vs_cpu_max_abs_err": err, "logits_max_abs": scale,
          "card_vs_cpu_over_max": err / scale,
          "decode_vs_forward_max_abs_err": float(dec_err.max()),
          "decode_n_out_of_tol": dec_bad, "decode_tol": "rtol=atol=2e-3"})
    require(card_launches == {"wkv6": job["layers"]},
            f"the card's forward launched {card_launches}")
    require(err <= 1e-4 * scale, f"card vs CPU logits differ by {err} "
            f"(largest logit {scale})")
    require(dec_bad == 0, f"decode differs from the forward: "
            f"{float(dec_err.max())}, {dec_bad} out of tolerance")


def bound(b) -> dict:
    """The card's least time for this run's inputs (kernels/bounds.py)."""
    return {"bound_ms": b.ms, "bound_by": b.by, "bytes": b.nbytes,
            "flops": b.flops}


def phase_serve(torch, ops, serve, model, random_bank, get_config, dev):
    """LLaMA-7B at full width and depth, bf16, random weights."""
    cfg = get_config("celora-llama-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, 8, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    from repro_torch.tree import tree_leaves
    n_weights = sum(t.numel() for t in tree_leaves(params["base"]))
    reqs = serve.make_requests(bank, 16, prompt_len=128, gen=32,
                               vocab=cfg.vocab_size, seed=0)
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=8, max_len=160,
                            device=dev)
    step_ms = []
    step = eng._step

    def timed_step(*args):                    # the engine syncs each step
        t = time.perf_counter()               # anyway (it reads the tokens)
        out = step(*args)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        return out

    eng._step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # counts of the main path only
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srt = sorted(step_ms)
    launches = dict(ops.LAUNCHES)
    steps = eng.steps
    n_layers, n_targets = cfg.n_layers, len(cfg.lora_targets)
    lens = sorted({len(v) for v in done.values()})
    new_tokens = sum(r.gen for r in reqs)
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "weights": n_weights,
          "weight_gb": round(n_weights * 2 / 1e9, 3), "users": 8,
          "requests": len(reqs), "finished": len(done), "token_lengths": lens,
          "slots": 8, "prompt_len": 128, "gen": 32, "steps": steps,
          "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
          "step_ms_p50": srt[len(srt) // 2],
          "step_ms_p95": srt[int(0.95 * (len(srt) - 1))],
          "step_ms_max": srt[-1], "first_step_ms": step_ms[0],
          "tok_per_s": new_tokens / wall,
          "slot_tokens_per_s": steps * 8 / wall, "init_s": init_s,
          "launches": launches,
          "expected_launches": {"grouped_gemv": n_targets * n_layers * steps,
                                "decode_attention": n_layers * steps},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    require(len(done) == len(reqs) and lens == [160],
            f"serve finished {len(done)}/{len(reqs)} requests, lengths {lens}")
    require(launches["grouped_gemv"] == n_targets * n_layers * steps
            and launches["decode_attention"] == n_layers * steps,
            f"launch counts {launches} over {steps} steps")
    require(all(bool(((v >= 0) & (v < cfg.vocab_size)).all())
                for v in done.values()), "token ids out of range")
    return launches, (cfg, params, bank, eng)


def device_split(prof, wall_us: float, top: int, shares=()) -> dict:
    """Device time by kernel name over a profiled window, the window's
    wall time and the device's idle share in it; for each substring in
    ``shares``, the share of device time of the kernels whose names hold
    it."""
    by_name: dict = {}
    for e in prof.events():                   # device-side kernel events
        if getattr(e.device_type, "name", "") != "CUDA":
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows_out = sorted(((k, us, n) for k, (us, n) in by_name.items()),
                      key=lambda r: -r[1])
    dev_total = sum(us for _, us, _ in rows_out)
    share = {f"{key}_share": sum(us for k, us, _ in rows_out if key in k)
             / dev_total for key in shares if dev_total}
    return {**share, "wall_us": wall_us,
            "device_us": dev_total if rows_out else None,
            "device_idle_share": (1 - dev_total / wall_us)
            if rows_out else None,
            "top": [{"kernel": k[:80], "us": round(t, 1), "count": n}
                    for k, t, n in rows_out[:top]]}


def phase_profile(torch, state, dev):
    """Device time by kernel over 3 steps of the serve engine with all 8
    slots active at position 120, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, bank, eng = state
    from repro_torch.models import model
    cache = model.init_decode_cache(cfg, 8, 160, device=dev)
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    rows = torch.arange(8, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for p in range(118, 120):             # warm
            eng._step(cache, tok, torch.full((8,), p, dtype=torch.int32,
                                             device=dev), rows)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for p in range(120, 123):
                eng._step(cache, tok, torch.full((8,), p, dtype=torch.int32,
                                                 device=dev), rows)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "profile", "steps": 3, **device_split(prof, wall_us, 14)})


def phase_oracle(torch, ops, serve, random_bank, get_config, model, dev):
    """f32, full width, 2 layers: ServeEngine ≡ serve_naive per request."""
    cfg = get_config("celora-llama-7b").with_overrides(
        n_layers=2, param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        params = model.init_params(cfg, gen)
        bank = random_bank(cfg, 4, gen)
    reqs = serve.make_requests(bank, 8, prompt_len=16, gen=8,
                               vocab=cfg.vocab_size, seed=1)
    ops.reset_launches()
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=4, max_len=24,
                            device=dev)
    got = eng.run(reqs)
    engine_launches = dict(ops.LAUNCHES)
    want = serve.serve_naive(cfg, params["base"], bank, reqs, device=dev)
    same = [bool(np_equal(got[r.rid], want[r.rid])) for r in reqs]
    emit({"phase": "oracle", "arch": cfg.name, "dtype": "float32",
          "layers": 2, "d_model": cfg.d_model, "users": 4,
          "requests": len(reqs), "slots": 4, "prompt_len": 16, "gen": 8,
          "engine_steps": eng.steps, "engine_launches": engine_launches,
          "token_identical": sum(same),
          "sample": [int(t) for t in got[reqs[0].rid][-8:]]})
    require(all(same) and len(got) == len(reqs),
            f"ServeEngine diverged from serve_naive on "
            f"{[r.rid for r, s in zip(reqs, same) if not s]}")


# ---------------------------------------------------------------------------
# train: CE-LoRA federated rounds on fed-100m
# ---------------------------------------------------------------------------

#: the train phase's job: 4 clients, 3 rounds of 5 local steps of batch 8
#: at sequence 256, 64 train and 32 test sequences per client, 4 classes.
#: lr 1e-3: at 5e-3 AdamW's steps overshoot on the random full-width
#: backbone and the rounds amplify rounding differences (flash and ref then
#: part by ~0.1 in loss by round 1, on the card and with plain PyTorch on
#: both sides on the CPU alike)
TRAIN = dict(clients=4, rounds=3, local_steps=5, batch=8, seq=256,
             n_train=64, n_test=32, classes=4, lr=1e-3)


def train_job(torch, cfg, dev, attn_impl: str, job: dict = TRAIN):
    """``run_federated`` (celora, loop path, eager engine) on ``cfg`` with
    a random backbone; returns (result, wall seconds)."""
    from repro_torch.core.fed_model import FedTask
    from repro_torch.core.federated import FedConfig, run_federated
    from repro_torch.data import synthetic

    ctrain, ctest, _ = synthetic.make_federated_classification(
        0, job["clients"], job["n_train"], job["n_test"], job["seq"],
        cfg.vocab_size, job["classes"], drift=0.5)
    task = FedTask.create(torch.Generator(device=dev).manual_seed(0), cfg,
                          job["classes"])
    fed = FedConfig(method="celora", n_clients=job["clients"],
                    rounds=job["rounds"], local_steps=job["local_steps"],
                    batch_size=job["batch"], lr=job["lr"], seed=0,
                    client_parallelism="loop", attn_impl=attn_impl)
    t0 = time.perf_counter()
    out = run_federated(task, fed, ctrain, ctest, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_profile(torch, cfg, dev, job: dict = TRAIN):
    """Device time by kernel and the device's idle share over one client's
    local fit of 3 steps and its eval batch (``lora_loc``: no server
    work), run through ``run_federated`` with attn_impl="flash"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fed_model import FedTask
    from repro_torch.core.federated import FedConfig, run_federated
    from repro_torch.data import synthetic

    ctrain, ctest, _ = synthetic.make_federated_classification(
        1, 1, job["n_train"], job["n_test"], job["seq"], cfg.vocab_size,
        job["classes"])
    task = FedTask.create(torch.Generator(device=dev).manual_seed(1), cfg,
                          job["classes"])
    fed = FedConfig(method="lora_loc", n_clients=1, rounds=1, local_steps=3,
                    batch_size=job["batch"], attn_impl="flash")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(task, fed, ctrain, ctest, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"window": "lora_loc, 1 client, 3 local steps + 1 eval batch",
            **device_split(prof, wall_us, 12, shares=FLASH_SHARES)}


def phase_train(torch, fa_ops, tl_ops, get_config, dev):
    """fed-100m at full width and depth through the flash and tri-LoRA
    kernels, then the same job through the plain reference attention on
    the card (its projections still run the tri-LoRA kernels)."""
    cfg = get_config("fed-100m")
    job = TRAIN
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    out, wall = train_job(torch, cfg, dev, "flash")
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    flash_routes = dict(fa_ops.ROUTES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    steps = sum(len(r.sampled) for r in hist) * job["local_steps"]
    evals = sum(r.evaluated for r in hist) * job["clients"]
    layers, proj = cfg.n_layers, cfg.n_layers * len(cfg.lora_targets)
    # the S^data feature batches (one per client) run the frozen backbone
    # with no adapter: flash, but plain x@W projections.  Layer 0's q/k/v
    # inputs come from the frozen embedding and need no gradient.
    expected = {"flash_fwd": layers * (steps + evals + job["clients"]),
                "flash_dq": layers * steps, "flash_dkv": layers * steps,
                "tri_lora_fwd": proj * (steps + evals),
                "tri_lora_dx": (proj - 3) * steps, "tri_lora_dw": 0}
    tokens = steps * job["batch"] * job["seq"]
    rounds = [{"round": r.round, "wall_s": r.wall_s,
               "train_loss": r.train_loss, "mean_acc": r.mean_acc,
               "uplink_bytes": r.uplink_bytes,
               "downlink_bytes": r.downlink_bytes} for r in hist]
    prof = train_profile(torch, cfg, dev, job)
    ref, ref_wall = train_job(torch, cfg, dev, "ref")
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.param_dtype,
          "layers": layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "lora_rank": cfg.lora_rank,
          "method": "celora", "attn_impl": "flash", **job,
          "rounds_detail": rounds, "wall_s": wall,
          "trained_tokens": tokens, "trained_tok_per_s": tokens / wall,
          "round_wall_s_sum": sum(r.wall_s for r in hist),
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "flash_bwd_routes": flash_routes,
          "profile": prof,
          "ref": {"attn_impl": "ref", "wall_s": ref_wall,
                  "train_loss": [r.train_loss for r in ref["history"]],
                  "mean_acc": [r.mean_acc for r in ref["history"]]}})
    require(launches == expected,
            f"train launches {launches} != expected {expected}")
    require(flash_routes == {"bwd_vec": 2 * layers * steps, "bwd_scalar": 0},
            f"train flash backward routes {flash_routes}: every dq and dk/dv "
            f"launch should take the 16-byte route")
    for a, b in zip(hist, ref["history"]):
        require((a.sampled, a.participants, a.dropped, a.uplink_bytes,
                 a.downlink_bytes, a.uplink_elems)
                == (b.sampled, b.participants, b.dropped, b.uplink_bytes,
                    b.downlink_bytes, b.uplink_elems),
                f"round {a.round}: the flash and ref ledgers differ")
        require(abs(a.train_loss - b.train_loss)
                <= 1e-3 + 1e-3 * abs(b.train_loss),
                f"round {a.round}: flash loss {a.train_loss} vs ref "
                f"{b.train_loss}")
        require(max(abs(x - y) for x, y in zip(a.accs, b.accs)) <= 0.05,
                f"round {a.round}: flash accs {a.accs} vs ref {b.accs}")
    losses = [r.train_loss for r in hist]
    require(all(b < a for a, b in zip(losses, losses[1:])),
            f"train loss did not decrease over the rounds: {losses}")
    return launches


#: the lm_train phase's job: the causal-LM driver's call at full width and
#: depth, through the flash kernels, with the int8 uplink codec
LM_TRAIN = dict(arch="fed-100m", clients=4, rounds=3, local_steps=5,
                batch=8, seq=256, method="celora", uplink_codec="int8",
                attn_impl="flash")


def phase_lm_train(torch, fa_ops, tl_ops, get_config, dev):
    """``launch.train.run`` on fed-100m: exact kernel launches, a falling
    loss, the int8 byte ledger, a checkpoint that verifies and restores;
    then the device-time split of one client's local steps."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    job = LM_TRAIN
    cfg = get_config(job["arch"])
    path = ROOT / "build" / "chip_smoke" / "lm_train.npz"
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()                   # counts of the main path only
    tl_ops.reset_launches()
    t0 = time.perf_counter()
    out = train.run(**job, ckpt=str(path), verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    steps = sum(len(r["participants"]) for r in hist) * job["local_steps"]
    layers, proj = cfg.n_layers, cfg.n_layers * len(cfg.lora_targets)
    expected = {"flash_fwd": layers * steps, "flash_dq": layers * steps,
                "flash_dkv": layers * steps, "tri_lora_fwd": proj * steps,
                "tri_lora_dx": (proj - 3) * steps, "tri_lora_dw": 0}
    tokens = steps * job["batch"] * job["seq"]
    restored = checkpoint.restore(str(path),
                                  {"adapter_client0": out["adapters"][0]})
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(restored["adapter_client0"]),
        tree_leaves(out["adapters"][0])))

    # train.local_fit of client 0, 3 steps, inside the profiler
    from repro_torch.data import synthetic
    from repro_torch.optim import adamw
    batches = synthetic.lm_batches(synthetic.make_lm_data(
        0, 20_000, cfg.vocab_size), job["batch"], job["seq"])
    drawn = [next(batches) for _ in range(3)]
    toks, labs = (torch.as_tensor(np.stack([b[k] for b in drawn]),
                                  device=dev) for k in ("tokens", "labels"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        train.local_fit(out["cfg"], out["base"], adamw(lr=3e-3),
                        out["adapters"][0], toks, labs)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    emit({"phase": "lm_train", **job, "layers": layers,
          "d_model": cfg.d_model, "rounds_detail": hist, "wall_s": wall,
          "round_wall_s": [r["wall_s"] for r in hist],
          "trained_tokens": tokens, "trained_tok_per_s": tokens / wall,
          "peak_mem_gb": peak, "launches": launches,
          "expected_launches": expected, "checkpoint_restored": same,
          "checkpoint_meta": checkpoint.metadata(str(path)),
          "profile": {"window": "train.local_fit, 1 client, 3 steps",
                      **device_split(prof, window_us, 12,
                                     shares=FLASH_SHARES)}})
    require(launches == expected,
            f"lm_train launches {launches} != expected {expected}")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"lm_train loss did not fall: {[r['loss'] for r in hist]}")
    # per client: 4 stacked C leaves of 8 layers x 8x8 = 512 int8 codes and
    # 8 bf16 tile scales (528 B) up, 512 f32 (2048 B) down
    require(all(r["uplink_bytes"] == 8448 and r["downlink_bytes"] == 32768
                for r in hist),
            f"lm_train bytes {[(r['uplink_bytes'], r['downlink_bytes']) for r in hist]}")
    require(same, "the checkpoint did not restore client 0's adapter")
    return launches


def phase_pretrain(torch, tl_ops, get_config, dev):
    """``FedTask.create`` with two warm-up batches of 8×256 at full width:
    the backbone trains, so every projection runs the forward, dx and dW
    kernels."""
    from repro_torch.core.fed_model import FedTask
    from repro_torch.data import synthetic
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    cfg = get_config("fed-100m")
    data = synthetic.make_classification_data(12, 16, 256, cfg.vocab_size, 4)
    batches = [{"tokens": data.tokens[i:i + 8], "labels": data.labels[i:i + 8]}
               for i in (0, 8)]
    tl_ops.reset_launches()                   # counts of the path only
    t0 = time.perf_counter()
    task = FedTask.create(torch.Generator(device=dev).manual_seed(12), cfg,
                          4, pretrain_batches=batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tl_ops.LAUNCHES)
    init = model.init_params(cfg, torch.Generator(device=dev).manual_seed(12))
    moved = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(task.base), tree_leaves(init["base"])))
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(task.base))
    per_step = cfg.n_layers * len(cfg.lora_targets)
    expected = {k: per_step * len(batches) for k in launches}
    emit({"phase": "pretrain", "arch": cfg.name, "batches": [2, 8, 256],
          "wall_s": wall, "launches": launches, "expected_launches": expected,
          "base_leaves_moved": moved, "finite": finite})
    require(launches == expected,
            f"pretrain launches {launches} != expected {expected}")
    require(finite and moved > 0, "the warm-up did not train the backbone")
    return launches


def phase_card_vs_cpu(torch, tl_ops, model, get_config, dev):
    """One ``loss_fn`` and its adapter gradients on fed-100m at full width
    and depth (f32, a batch of 2×256): on the card through the tri-LoRA and
    flash kernels, on the CPU through their plain versions.  C and B are
    moved off their zero-delta init (C = I + 0.05·N, B = 0.01·N, a delta
    of a few percent of x·W, as after some training) so that dA and dC are
    not zero.  A delta as large as x·W itself (B = 0.05·N with A shifted
    too) saturates the random backbone's attention, and there f32 on the
    CPU alone is 6e-4 of the largest entry away from f64 at 4 layers."""
    import numpy as np

    from repro_torch.core.tri_lora import is_adapter
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("fed-100m")
    gen = torch.Generator(device=dev).manual_seed(10)
    params = model.init_params(cfg, gen)

    def noise(t, scale):
        return scale * torch.randn(t.shape, generator=gen, device=dev)

    params["adapter"] = tree_map(
        lambda a: {"A": a["A"], "C": a["C"] + noise(a["C"], 0.05),
                   "B": noise(a["B"], 0.01)},
        params["adapter"], is_leaf=is_adapter)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 257))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads(where):
        base = tree_map(lambda t: t.to(where), params["base"])
        ad = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                      params["adapter"])
        b = {key: torch.as_tensor(v, device=where) for key, v in
             batch.items()}
        loss, _ = model.loss_fn(cfg, ad, base, b, attn_impl="flash")
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        return float(loss.detach()), [g.cpu() for g in grads]

    tl_ops.reset_launches()
    loss_card, grads_card = loss_and_grads(dev)
    launched = dict(tl_ops.LAUNCHES)
    loss_cpu, grads_cpu = loss_and_grads(torch.device("cpu"))
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(grads_card, grads_cpu)]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    projections = cfg.n_layers * len(cfg.lora_targets)
    emit({"phase": "card_vs_cpu", "arch": cfg.name, "batch": [2, 256],
          "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": rel,
          "grad_leaves": len(errs), "grad_max_err_over_max": max(errs),
          "launches": launched})
    require(rel <= 1e-4, f"card loss {loss_card} vs CPU {loss_cpu}")
    require(max(errs) <= 1e-3,
            f"adapter gradients differ by {max(errs)} of their largest entry")
    require(launched["tri_lora_fwd"] == projections
            and launched["tri_lora_dx"] == projections - 3
            and launched["tri_lora_dw"] == 0,
            f"one loss and gradient launched {launched}")


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def card_line() -> str:
    run = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(run.returncode == 0, f"nvidia-smi failed: {run.stderr}")
    return run.stdout.strip().splitlines()[0]


START = time.perf_counter()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.adapter_bank import random_bank
    from repro_torch.kernels import bounds, build
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.tri_lora import ops as tl_ops
    from repro_torch.kernels.tri_lora import ref as tl_ref
    from repro_torch.launch import serve
    from repro_torch.models import model, rwkv
    from repro_torch.models.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        phase_build(build)
        phase_hold_check(torch, dev)
        attn_err = attn_cases(torch, ops, ref, dev)
        gemv_err = gemv_cases(torch, ops, ref, dev)
        flash_err = flash_cases(torch, fa_ops, fa_ref, dev)
        tri_lora_err = tri_lora_cases(torch, tl_ops, tl_ref, dev)
        wkv6_err = wkv6_cases(torch, wkv_ops, wkv_ref, dev)
        card = card_line()
        rows = [time_attention(torch, F, ops, ref, bounds, dev),
                time_gemv(torch, ops, ref, bounds, dev)]
        flash_rows = time_flash(torch, F, fa_ops, fa_ref, bounds, dev)
        tri_lora_rows = time_tri_lora(torch, tl_ops, bounds, dev)
        wkv6_row = time_wkv6(torch, wkv_ops, wkv_ref, rwkv, bounds, dev, card)
        for r in rows:
            emit({"phase": "kernels", "timing": r["name"],
                  "kernel_ms": r["ms"], **{k: v for k, v in r.items()
                                           if k not in ("name", "ms")}})
        launches, state = phase_serve(torch, ops, serve, model, random_bank,
                                      get_config, dev)
        phase_profile(torch, state, dev)
        del state
        gc.collect()          # the timed engine sits in a reference cycle
        torch.cuda.empty_cache()
        phase_oracle(torch, ops, serve, random_bank, get_config, model, dev)
        torch.cuda.empty_cache()
        launches.update(phase_train(torch, fa_ops, tl_ops, get_config, dev))
        # this slice's paths: the LM driver (forward and dx) and the
        # backbone warm-up (dW)
        lm = phase_lm_train(torch, fa_ops, tl_ops, get_config, dev)
        launches.update(tri_lora_fwd=lm["tri_lora_fwd"],
                        tri_lora_dx=lm["tri_lora_dx"])
        launches["tri_lora_dw"] = phase_pretrain(torch, tl_ops, get_config,
                                                 dev)["tri_lora_dw"]
        phase_card_vs_cpu(torch, tl_ops, model, get_config, dev)
        # this slice's paths: the RWKV-6 prefill (wkv6 and tri-LoRA
        # forward), its decode and the f32 oracle
        gc.collect()
        torch.cuda.empty_cache()
        rwkv_launches, rwkv_p = phase_rwkv_prefill(
            torch, wkv_ops, wkv_ref, tl_ops, model, get_config, dev)
        launches["wkv6"] = rwkv_launches["wkv6"]
        decode_launches = phase_rwkv_decode(torch, wkv_ops, tl_ops, serve,
                                            get_config, rwkv_p, dev)
        del rwkv_p
        torch.cuda.empty_cache()
        phase_rwkv_oracle(torch, wkv_ops, model, get_config, dev)
    except Exception:                       # report, print no result, fail
        traceback.print_exc()
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows += flash_rows + tri_lora_rows + [wkv6_row]
    path_launches = {"rwkv prefill": rwkv_launches,
                     "rwkv decode": decode_launches}
    for r in rows:                    # the launches of the row's own path
        r["launches"] = path_launches.get(r.get("shape"), launches)[
            r.get("launch_key", r["name"])]
    emit({"phase": "summary", "max_abs_err_by_dtype": {
        "decode_attention": attn_err, "grouped_gemv": gemv_err,
        "flash_attention": flash_err, "tri_lora": tri_lora_err,
        "wkv6": wkv6_err}, "wall_s": time.perf_counter() - START})
    emit({"kernels": [{k: r[k] for k in keys + ("shape", "note") if k in r}
                      for r in rows]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
