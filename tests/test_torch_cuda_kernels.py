"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports neither ``jax`` nor the JAX package, so it also runs
on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances are the JAX kernel tolerances, 2e-5 in f32 and 2e-2 in bf16
(tests/test_kernels.py), with TF32 off; 1e-4 for the WKV recurrence, with
the absolute part scaled by the largest entry (its state grows over
hundreds of steps).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.adapter_bank import random_bank
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.kernels.tri_lora import ops as tl_ops
from repro_torch.kernels.tri_lora import ref as tl_ref
from repro_torch.launch import serve
from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig, get_config
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
NO_GROUPED = {"tri_lora_fwd_grouped": 0, "tri_lora_dx_grouped": 0}
NO_GROUPED_ROUTES = {"fwd_grouped_wgmma": 0, "fwd_grouped_simt": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("b,h,kh,hd,ring,idx", [
    (8, 32, 32, 128, 160, [5, 200, -1, 159, 0, 77, 100, 158]),
    (4, 12, 4, 64, 100, [5, 140, -1, 99]),
    (2, 8, 2, 64, 33, 40),                     # scalar idx, wrapped ring
    # h2o-danube-3-4b heads (hd 120, groups of 4) over a 4,096 ring and
    # recurrentgemma-2b's (hd 256, 10 on 1) over 2,048: the split route
    (8, 32, 8, 120, 4096, [5, 5000, -1, 4095, 0, 2047, 3000, 4094]),
    (8, 10, 1, 256, 2048, [2047, -1, 0, 100, 9000, 1500, 2046, 31]),
    (2, 32, 8, 120, 300, 1000),                # scalar idx, wrapped
    (3, 10, 1, 256, 64, 17),                   # scalar idx
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, b, h, kh, hd, ring, idx,
                                               dtype):
    g = torch.Generator(device=cuda).manual_seed(b + h + ring)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, 1, h, hd), (b, ring, kh, hd), (b, ring, kh, hd)))
    idx_t = torch.tensor(idx, dtype=torch.int32, device=cuda)
    n0 = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, idx_t)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == n0 + 1
    _close(got, ref.decode_attention_ref(q, k, v, idx_t), dtype)
    for row, i in enumerate(np.broadcast_to(idx, (b,))):
        if i < 0:
            assert not got[row].any()


def test_decode_attention_kernel_reads_cache_by_strides(cuda):
    """A cache slice of a stacked (layers, B, R, K, hd) buffer and a
    non-contiguous view give the same answer as a contiguous copy."""
    g = torch.Generator(device=cuda).manual_seed(0)
    stacked = torch.randn((3, 2, 48, 4, 64), generator=g, device=cuda)
    q = torch.randn((2, 1, 4, 64), generator=g, device=cuda)
    idx = torch.tensor([10, 47], dtype=torch.int32, device=cuda)
    k = stacked[1]
    v = stacked[2].transpose(0, 1).contiguous().transpose(0, 1)  # strided
    want = ref.decode_attention_ref(q, k.contiguous(), v.contiguous(), idx)
    _close(ops.decode_attention(q, k, v, idx), want, torch.float32)


def _attn_inputs(dev, b, h, kh, hd, ring, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, 1, h, hd), (b, ring, kh, hd), (b, ring, kh, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,hd,ring,idx", [
    (8, 32, 32, 128, 160, [159] * 8),            # the serving shape
    (8, 32, 8, 120, 4096, [4095, 100, -1, 9000, 0, 3000, 4094, 2048]),
    (8, 10, 1, 256, 2048, 2047),                 # split route, scalar idx
])
def test_decode_attention_is_bitwise_repeatable(cuda, dtype, b, h, kh, hd,
                                                ring, idx):
    """Splits combined in split order, no atomics: equal bits call to
    call."""
    q, k, v = _attn_inputs(cuda, b, h, kh, hd, ring, dtype, hd + ring)
    idx_t = torch.tensor(idx, dtype=torch.int32, device=cuda)
    first = ops.decode_attention(q, k, v, idx_t)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(q, k, v, idx_t), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 120, 256])
def test_decode_attention_unaligned_cache_takes_scalar_route(cuda, dtype,
                                                             hd):
    """A cache whose base is one element past a 16-byte boundary takes the
    scalar route and gives the 16-byte route's bits on the same values."""
    b, h, kh, ring = 3, 8, 2, 300
    q, k, v = _attn_inputs(cuda, b, h, kh, hd, ring, dtype, hd)
    idx = torch.tensor([299, 40, 1000], dtype=torch.int32, device=cuda)
    buf = torch.zeros(2 * k.numel() + 1, dtype=dtype, device=cuda)
    ku = buf[1:1 + k.numel()].view(k.shape)
    vu = buf[1 + k.numel():].view(v.shape)
    ku.copy_(k)
    vu.copy_(v)
    ops.reset_launches()
    got_u = ops.decode_attention(q, ku, vu, idx)
    assert ops.ROUTES["attn_scalar"] == 1 and ops.ROUTES["attn_vec"] == 0
    got = ops.decode_attention(q, k, v, idx)
    torch.cuda.synchronize()
    assert ops.ROUTES["attn_vec"] == 1
    assert torch.equal(got_u, got)
    _close(got, ref.decode_attention_ref(q, k, v, idx), dtype)


@pytest.mark.parametrize("k,n,rows", [
    (4096, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
    (11008, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
    (300, 71, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 2),   # odd N, 20 rows
    (100, 70, [-1]),                                   # only a masked row
    (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 4),  # 40 rows: 2 groups
    (300, 71, [7, 6, -1, 5, 4, 3, 2, 1, 0, 0] * 7),     # 70 rows: 3 groups
    (4096, 4096, [5]),                                  # 1 row
    (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7]),
    (4096, 4096, [7, 6, -1, 5, 4, 3, 2, 1] * 4),        # 32 rows: 1 group
    (1000, 520, [1, 2, -1, 0, 3, 4, 5, 6, 7, 7, 6, 5, 4, 3, 2, 1, 0]),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemv_kernel_matches_plain(cuda, k, n, rows, dtype):
    g = torch.Generator(device=cuda).manual_seed(k + n)
    m, r = 8, 8
    x = torch.randn((len(rows), k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda)
         / math.sqrt(k)).to(dtype)
    a = torch.randn((m, k, r), generator=g, device=cuda) / math.sqrt(r)
    c = torch.eye(r, device=cuda) + 0.1 * torch.randn((m, r, r), generator=g,
                                                       device=cuda)
    b = 0.02 * torch.randn((m, r, n), generator=g, device=cuda)
    rows_t = torch.tensor(rows, dtype=torch.int32, device=cuda)
    n0 = ops.LAUNCHES["grouped_gemv"]
    got = ops.grouped_dense(rows_t, x, w, a, c, b, scaling=2.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["grouped_gemv"] == n0 + 1
    _close(got, ref.grouped_gemv_ref(rows_t, x, w, a, c, b, scaling=2.0),
           dtype)
    assert not got[rows_t < 0].any()


def _gemv_inputs(dev, bsz, k, n, dtype, seed, m=8, r=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((bsz, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=g, device=dev)
         / math.sqrt(k)).to(dtype)
    a = torch.randn((m, k, r), generator=g, device=dev) / math.sqrt(r)
    c = torch.eye(r, device=dev) + 0.1 * torch.randn((m, r, r), generator=g,
                                                      device=dev)
    b = 0.02 * torch.randn((m, r, n), generator=g, device=dev)
    rows = torch.arange(bsz, dtype=torch.int32, device=dev) % m
    rows[1 % bsz] = -1
    return rows, x, w, a, c, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (300, 71)])
def test_grouped_gemv_unaligned_w_takes_scalar_route(cuda, dtype, k, n):
    """A column slice of a wider W one element past a 16-byte boundary
    takes the scalar route and gives the 16-byte route's bits (same order
    of sums) on the same values."""
    rows, x, w, a, c, b = _gemv_inputs(cuda, 8, k, n, dtype, k + n)
    wide = torch.zeros((k, n + 9), dtype=dtype, device=cuda)
    view = wide[:, 1:n + 1]
    view.copy_(w)
    aligned = torch.zeros((k, n + 8), dtype=dtype, device=cuda)[:, :n]
    aligned.copy_(w)
    ops.reset_launches()
    got_view = ops.grouped_dense(rows, x, view, a, c, b, scaling=2.0)
    assert ops.ROUTES["gemv_scalar"] == 1 and ops.ROUTES["gemv_vec"] == 0
    got = ops.grouped_dense(rows, x, aligned, a, c, b, scaling=2.0)
    torch.cuda.synchronize()
    assert ops.ROUTES["gemv_vec"] == (1 if (n + 8) % 8 == 0 else 0)
    assert torch.equal(got_view, got)
    _close(got, ref.grouped_gemv_ref(rows, x, w, a, c, b, scaling=2.0),
           dtype)
    assert not got[rows < 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemv_is_bitwise_repeatable(cuda, dtype):
    """Split-K sums in split order, no atomics: equal bits call to call."""
    ins = _gemv_inputs(cuda, 8, 4096, 4096, dtype, 3)
    first = ops.grouped_dense(*ins, scaling=2.0)
    for _ in range(3):
        assert torch.equal(ops.grouped_dense(*ins, scaling=2.0), first)


def test_grouped_gemv_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x = torch.zeros((2, 16), device=cuda)
    w = torch.zeros((16, 8), device=cuda)
    a, c, b = (torch.zeros(s, device=cuda) for s in
               ((1, 16, 2), (1, 2, 2), (1, 2, 8)))
    rows = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.grouped_dense(rows, x, w, a.double(), c, b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_dense(rows, x, w.t().contiguous().t(), a, c, b)
    with pytest.raises(ValueError, match="rows"):
        ops.grouped_dense(torch.zeros(3, dtype=torch.int32, device=cuda),
                          x, w, a, c, b)
    # many tokens a sequence are not the GEMV's: dense sends them to the
    # grouped tri-LoRA kernels (vectorized clients)
    before = (ops.LAUNCHES["grouped_gemv"],
              tl_ops.LAUNCHES["tri_lora_fwd_grouped"])
    layers.dense(torch.zeros((2, 3, 16), device=cuda), w,
                 adapter={"A": a, "C": c, "B": b}, adapter_rows=rows)
    assert (ops.LAUNCHES["grouped_gemv"],
            tl_ops.LAUNCHES["tri_lora_fwd_grouped"]) == (before[0],
                                                         before[1] + 1)


@pytest.mark.parametrize("n,slots", [(5, 2), (45, 40)])
def test_engine_on_the_card_matches_naive_and_counts_launches(cuda, n, slots):
    """Small model (hd=64) through ServeEngine on the card: tokens equal
    serve_naive's, and every step launches both kernels per layer; 40 slots
    take two 32-row groups of the GEMV kernel."""
    cfg = ModelConfig(name="tiny-gpu", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab_size=512, param_dtype="float32",
                      lora_rank=4, lora_targets=("wq", "wk", "wv", "wo"))
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.inference_mode():
        params = model.init_params(cfg, g)
        bank = random_bank(cfg, 3, g)
    reqs = serve.make_requests(bank, n, prompt_len=4, gen=4,
                               vocab=cfg.vocab_size, seed=0)
    ops.reset_launches()
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=slots,
                            max_len=8, device=cuda)
    got = eng.run(reqs)
    assert ops.LAUNCHES == {"grouped_gemv": 4 * 2 * eng.steps,
                            "decode_attention": 2 * eng.steps}
    want = serve.serve_naive(cfg, params["base"], bank, reqs, device=cuda)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])


# ---------------------------------------------------------------------------
# flash attention: forward (out, lse) and backward (dq, dk, dv)
# ---------------------------------------------------------------------------

#: (B, S, H, K, hd, causal, window): GQA 12/4 at fed-100m width, 32/32 at
#: LLaMA-7B width, window 64, non-causal, and ragged lengths (200, 77) that
#: are no multiple of the 64-row tile; h2o-danube-3-4b's heads (32/8, hd
#: 120, computed at 128 with 8 pad channels) causal, windowed and ragged
#: non-causal; recurrentgemma-2b's heads (10 on 1, hd 256, 32-row tiles)
#: causal, windowed and ragged, and a group of 4 at hd 256 non-causal
FLASH_CASES = [
    (2, 256, 12, 4, 64, True, 0),
    (1, 512, 12, 4, 64, True, 64),
    (2, 200, 12, 4, 64, True, 0),
    (2, 256, 32, 32, 128, True, 0),
    (1, 200, 32, 32, 128, True, 64),
    (2, 256, 12, 4, 64, False, 0),
    (2, 77, 8, 2, 128, False, 0),
    (2, 256, 32, 8, 120, True, 0),
    (1, 300, 32, 8, 120, True, 96),
    (2, 77, 8, 2, 120, False, 0),
    (2, 256, 10, 1, 256, True, 0),
    (1, 300, 10, 1, 256, True, 96),
    (2, 77, 8, 2, 256, False, 0),
]


def _flash_inputs(dev, b, s, h, kh, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dtype)
                   for sh in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd),
                              (b, s, h, hd)))
    return q, k, v, do


@pytest.mark.parametrize("b,s,h,kh,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, b, s, h, kh, hd, causal, window,
                                   dtype):
    """Forward output and lse, and dq/dk/dv, against the plain version on
    the same card inputs."""
    q, k, v, do = _flash_inputs(cuda, b, s, h, kh, hd, dtype, s + h + hd)
    fa_ops.reset_launches()
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, out, lse, do,
                                            causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    want_out, want_lse = fa_ref.flash_attention_fwd_ref(
        q, k, v, causal=causal, window=window)
    _close(out, want_out, dtype)
    _close(lse, want_lse, torch.float32)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                          window=window)
    for got_g, want_g in zip((dq, dk, dv), want):
        _close(got_g, want_g, dtype)


def test_flash_autograd_matches_plain_grads(cuda):
    """The autograd Function: one forward and one dq + one dk/dv launch per
    backward, gradients equal to the plain version's."""
    q, k, v, do = _flash_inputs(cuda, 2, 128, 12, 4, 64, torch.float32, 7)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.reset_launches()
    out = fa_ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, causal=True)
    for leaf, want_g in zip(leaves, want):
        _close(leaf.grad, want_g, torch.float32)


def test_flash_non_causal_ragged_masks_by_real_length(cuda):
    """Non-causal attention at a length that is no tile multiple: the kernel
    masks the keys beyond the real length itself, so its output equals
    attention over exactly the real keys (the JAX wrapper pads k and masks
    padded keys only under causality, flash_attention/ops.py:79-81)."""
    q, k, v, _ = _flash_inputs(cuda, 2, 77, 8, 2, 64, torch.float32, 11)
    out, _ = fa_ops.flash_attention_fwd(q, k, v, causal=False)
    # the plain softmax over the 77 real keys, in float64
    qg = q.double().reshape(2, 77, 2, 4, 64)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / 8.0
    want = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(logits, -1),
                        v.double()).reshape(2, 77, 8, 64)
    _close(out, want, torch.float32)


def test_flash_wrapper_refuses_what_the_kernels_cannot_take(cuda):
    q = torch.zeros((1, 16, 4, 64), device=cuda)
    k = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q[..., :32], k[..., :32], k[..., :32])
    q96 = torch.zeros((1, 16, 4, 96), device=cuda)
    k96 = torch.zeros((1, 16, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa_ops.flash_attention(q96, k96, k96)
    with pytest.raises(ValueError, match="dtypes"):
        fa_ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="query heads"):
        fa_ops.flash_attention(q[:, :, :3], k, k)
    with pytest.raises(ValueError, match="unit stride"):
        fa_ops.flash_attention(q, k.transpose(1, 3).contiguous()
                               .transpose(1, 3)[..., :64], k)


def test_fed_task_grads_through_flash_kernels_match_ref(cuda):
    """A small model (hd 64) on the card: FedTask.loss and its adapter and
    head gradients through the flash kernels equal those through the plain
    reference attention; one forward and one dq + dk/dv launch per layer,
    and with ``cfg.remat`` (on by default) one more forward per layer for
    the recompute in the backward."""
    from repro_torch.core.fed_model import FedTask
    from repro_torch.tree import tree_leaves, tree_map
    cfg = ModelConfig(name="tiny-gpu", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab_size=512, param_dtype="float32",
                      lora_rank=4, lora_targets=("wq", "wk", "wv", "wo"))
    g = torch.Generator(device=cuda).manual_seed(0)
    task = FedTask.create(g, cfg, 3)
    client = task.init_client(g)
    client["adapter"] = tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=g, device=cuda), client["adapter"])
    toks = torch.randint(0, 512, (4, 200), generator=g, device=cuda)
    labels = torch.tensor([0, 2, 1, 2], device=cuda)
    out = {}
    for impl in ("flash", "ref"):
        tr = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      client)
        fa_ops.reset_launches()
        loss, _ = task._replace(cfg=cfg.with_overrides(attn_impl=impl)).loss(
            tr, toks, labels)
        loss.backward()
        torch.cuda.synchronize()
        out[impl] = (loss.item(), [t.grad for t in tree_leaves(tr)],
                     dict(fa_ops.LAUNCHES))
    assert cfg.remat
    assert out["flash"][2] == {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
    assert out["ref"][2] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    np.testing.assert_allclose(out["flash"][0], out["ref"][0], rtol=1e-5)
    for a, b in zip(out["flash"][1], out["ref"][1]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


def _flash_bwd_vs_plain(q, k, v, do, dtype, causal=True, window=0):
    """The backward kernels' (dq, dk, dv) held to the plain version's."""
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     window=window)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                          window=window)
    for got_g, want_g in zip(got, want):
        _close(got_g, want_g, dtype)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_is_bitwise_repeatable(cuda, dtype):
    """Two forward calls on the same inputs give bitwise-equal out and lse,
    on the 16-byte route, causal and windowed."""
    q, k, v, _ = _flash_inputs(cuda, 2, 200, 12, 4, 64, dtype, 23)
    for window in (0, 64):
        fa_ops.reset_launches()
        first = fa_ops.flash_attention_fwd(q, k, v, window=window)
        second = fa_ops.flash_attention_fwd(q, k, v, window=window)
        assert fa_ops.ROUTES["fwd_vec"] == 2
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("hd", [64, 120, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_unaligned_view_takes_scalar_route(cuda, dtype, hd):
    """q, k and v one element past a 16-byte boundary take the forward's
    scalar route, which matches the plain version and gives bitwise the
    16-byte route's out and lse; the 16-byte entry point refuses them."""
    q, k, v, _ = _flash_inputs(cuda, 2, 200, 12, 4, hd, dtype, 19)

    def moved(t):
        buf = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                          device=t.device)
        buf[..., 1:] = t
        return buf[..., 1:]
    views = [moved(t) for t in (q, k, v)]
    assert fa_ops.fwd_route(*views) == "scalar"
    fa_ops.reset_launches()
    out, lse = fa_ops.flash_attention_fwd(*views)
    assert fa_ops.ROUTES == {"fwd_vec": 0, "fwd_scalar": 1, "bwd_vec": 0,
                             "bwd_scalar": 0}
    want_out, want_lse = fa_ref.flash_attention_fwd_ref(q, k, v)
    _close(out, want_out, dtype)
    _close(lse, want_lse, torch.float32)
    vec_out, vec_lse = fa_ops.flash_attention_fwd(q, k, v)
    assert torch.equal(out, vec_out) and torch.equal(lse, vec_lse)
    fn = fa_ops.ffi.fn("flash_attention", "flash_fwd_launch",
                       [fa_ops._I, fa_ops._I] + [fa_ops._VP] * 5
                       + [fa_ops._I] * 5 + [fa_ops._LL] * 9
                       + [fa_ops._F, fa_ops._I, fa_ops._I, fa_ops._VP])
    code = fn(fa_ops.ffi.DTYPE_CODE[dtype], hd, views[0].data_ptr(),
              k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              2, 200, 200, 12, 4, *fa_ops._strides(views[0]),
              *fa_ops._strides(k), *fa_ops._strides(v), hd ** -0.5, 1, 0,
              fa_ops.ffi.stream())
    assert code != 0


@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_bitwise_repeatable(cuda, dtype, hd):
    """Two backward calls on the same inputs give bitwise-equal dq, dk and
    dv: the dk/dv cluster sums its heads' partials in rank order and no
    f32 sum uses atomics."""
    q, k, v, do = _flash_inputs(cuda, 2, 200, 12, 4, hd, dtype, 21)
    out, lse = fa_ops.flash_attention_fwd(q, k, v)
    first = fa_ops.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa_ops.flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,kh", [(12, 12), (12, 4), (16, 2), (16, 1)],
                         ids=["G1", "G3", "G8", "MQA16"])
def test_flash_backward_groups_at_ragged_length(cuda, h, kh):
    """GQA groups of 1, 3, 8 and 16 (MQA: a cluster of 8 whose blocks take
    two heads each) at S=200, no multiple of the 64-row tile."""
    q, k, v, do = _flash_inputs(cuda, 2, 200, h, kh, 64, torch.float32,
                                h + kh)
    fa_ops.reset_launches()
    _flash_bwd_vs_plain(q, k, v, do, torch.float32)
    assert fa_ops.ROUTES == {"fwd_vec": 1, "fwd_scalar": 0, "bwd_vec": 2,
                             "bwd_scalar": 0}


def test_flash_backward_long_causal_sequence(cuda):
    """S=1024 causal: 16 tiles a side, more dq and dk/dv blocks than one
    wave of the card, with band lengths 1 to 16."""
    q, k, v, do = _flash_inputs(cuda, 4, 1024, 12, 4, 64, torch.float32, 5)
    _flash_bwd_vs_plain(q, k, v, do, torch.float32)


@pytest.mark.parametrize("s,window", [(512, 64), (512, 32), (300, 96)])
def test_flash_backward_window_straddles_tiles(cuda, s, window):
    """Sliding windows whose edge cuts through 64-wide tiles: a tile pair
    can lie partly inside the band for one q tile and wholly outside for
    the next."""
    q, k, v, do = _flash_inputs(cuda, 2, s, 12, 4, 64, torch.float32,
                                s + window)
    _flash_bwd_vs_plain(q, k, v, do, torch.float32, window=window)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_backward_fewer_queries_than_keys(cuda, window):
    """Sq < Skv: the causal rows are the last Sq of the sequence, so the
    band is offset by Skv - Sq, no multiple of the tile; keys before the
    first row's band get zero dk and dv."""
    g = torch.Generator(device=cuda).manual_seed(window + 3)
    q, do = (torch.randn((2, 100, 12, 64), generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn((2, 228, 4, 64), generator=g, device=cuda)
            for _ in range(2))
    _flash_bwd_vs_plain(q, k, v, do, torch.float32, window=window)


@pytest.mark.parametrize("hd", [64, 120, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_unaligned_view_takes_scalar_route(cuda, dtype, hd):
    """Operands one element past a 16-byte boundary take the scalar route,
    which gives bitwise the 16-byte route's values; the 16-byte entry point
    itself refuses them."""
    q, k, v, do = _flash_inputs(cuda, 2, 200, 12, 4, hd, dtype, 17)

    def moved(t):
        buf = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                          device=t.device)
        buf[..., 1:] = t
        return buf[..., 1:]
    views = [moved(t) for t in (q, k, v, do)]
    assert fa_ops.bwd_route(*views) == "scalar"
    fa_ops.reset_launches()
    got = _flash_bwd_vs_plain(*views, dtype)
    assert fa_ops.ROUTES == {"fwd_vec": 0, "fwd_scalar": 1, "bwd_vec": 0,
                             "bwd_scalar": 2}
    out, lse = fa_ops.flash_attention_fwd(q, k, v)
    for a, b in zip(got, fa_ops.flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(a, b)
    delta = fa_ops.softmax_delta(out, do)
    fn = fa_ops._bwd_fn("dq", "vec", 7)
    dq = torch.empty(q.shape, dtype=dtype, device=cuda)
    code = fn(fa_ops.ffi.DTYPE_CODE[dtype], hd, views[0].data_ptr(),
              k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(),
              *fa_ops._bwd_args(views[0], k, v, do, True, 0))
    assert code != 0


# ---------------------------------------------------------------------------
# tri-LoRA projection: forward, dx and dW kernels
# ---------------------------------------------------------------------------

def _tri_lora_inputs(dev, m, k, n, r, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)
    return (rn((m, k)), rn((k, n), 0.05), rn((k, r), 0.2), rn((r, r), 0.2),
            rn((r, n), 0.2), rn((m, n)))


@pytest.mark.parametrize("m,k,n,r", [
    (64, 64, 64, 2), (96, 160, 130, 8), (77, 100, 130, 16),  # ragged edges
    (2048, 768, 256, 8), (1, 4096, 4096, 8), (8, 300, 70, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tri_lora_kernels_match_plain(cuda, m, k, n, r, dtype):
    """The op's forward kernel, and the dx and dW kernels with the rank-r
    grads through autograd, against the plain forward and the analytic
    backward; gradients at the JAX kernel tests' magnitude-scaled
    tolerance; one launch of each kernel."""
    x, w, a, c, b, ct = _tri_lora_inputs(cuda, m, k, n, r, dtype, m + k + r)
    leaves = [t.detach().requires_grad_(True) for t in (x, w, a, c, b)]
    tl_ops.reset_launches()
    y = tl_ops.tri_lora_matmul(*leaves, 2.0)
    grads = torch.autograd.grad(y, leaves, ct)
    torch.cuda.synchronize()
    assert tl_ops.LAUNCHES == {"tri_lora_fwd": 1, "tri_lora_dx": 1,
                               "tri_lora_dw": 1, **NO_GROUPED}
    _close(y.detach(), tl_ref.tri_lora_matmul_ref(x, w, a, c, b, 2.0), dtype)
    tol = TOL[dtype]["rtol"]
    for got, want in zip(grads, tl_ref.tri_lora_bwd_ref(x, w, a, c, b, ct,
                                                        2.0)):
        assert got.dtype == want.dtype
        scale = max(1.0, float(want.float().abs().max()))
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol * scale)


def test_tri_lora_kernels_read_by_strides(cuda):
    """A row slice of a wider buffer (row stride > K) and a weight slice of
    a stacked (layers, K, N) tensor give the contiguous copies' answers."""
    g = torch.Generator(device=cuda).manual_seed(3)
    wide = torch.randn((40, 96), generator=g, device=cuda)
    x = wide[:, 16:80]                                  # stride (96, 1)
    w = torch.randn((3, 64, 48), generator=g, device=cuda)[1] * 0.1
    a = torch.randn((64, 4), generator=g, device=cuda)
    c = torch.eye(4, device=cuda)
    b = torch.randn((4, 48), generator=g, device=cuda) * 0.1
    p = 1.5 * (x @ a) @ c
    _close(tl_ops.tri_lora_fwd(x, w, p, b),
           tl_ops.tri_lora_fwd(x.contiguous(), w.contiguous(), p, b),
           torch.float32)
    gy = torch.randn((40, 48), generator=g, device=cuda)
    _close(tl_ops.tri_lora_dw(x, gy), x.contiguous().T @ gy, torch.float32)


def test_tri_lora_mixed_dtypes_and_rank_limits(cuda):
    """A bf16 model with f32 adapters (the serving decode path) runs the
    kernels; ranks outside 1..64 and non-unit inner strides raise."""
    x, w, _, _, _, _ = _tri_lora_inputs(cuda, 8, 256, 128, 8,
                                        torch.bfloat16, 5)
    _, _, a, c, b, _ = _tri_lora_inputs(cuda, 8, 256, 128, 8, torch.float32,
                                        6)
    y = tl_ops.tri_lora_matmul(x, w, a, c, b, 2.0)
    assert y.dtype == torch.bfloat16
    _close(y, tl_ref.tri_lora_matmul_ref(x, w, a, c, b, 2.0), torch.bfloat16)
    with pytest.raises(ValueError, match="rank"):
        tl_ops.tri_lora_fwd(x, w, torch.zeros((8, 65), device=cuda,
                                              dtype=x.dtype),
                            torch.zeros((65, 128), device=cuda))
    with pytest.raises(ValueError, match="unit"):
        tl_ops.tri_lora_dw(x.T.contiguous().T, torch.zeros(
            (8, 128), device=cuda, dtype=x.dtype))


def test_dense_on_the_card_runs_the_tri_lora_kernels(cuda):
    """``layers.dense`` with one adapter on CUDA launches the forward
    kernel, and in the backward dx only where x needs a gradient and dW
    only where W does; the result matches the CPU's plain dense."""
    x, w, a, c, b, _ = _tri_lora_inputs(cuda, 24, 64, 48, 4, torch.float32,
                                        7)
    bias = torch.randn(48, device=cuda)
    ad = {"A": a.requires_grad_(True), "C": c.requires_grad_(True),
          "B": b.requires_grad_(True)}
    tl_ops.reset_launches()
    y = layers.dense(x.reshape(2, 12, 64), w, bias=bias, adapter=ad,
                     lora_scaling=2.0)
    torch.autograd.grad(y.sum(), list(ad.values()))
    assert tl_ops.LAUNCHES == {"tri_lora_fwd": 1, "tri_lora_dx": 0,
                               "tri_lora_dw": 0, **NO_GROUPED}
    want = layers.dense(x.cpu().reshape(2, 12, 64), w.cpu(),
                        bias=bias.cpu(),
                        adapter={k: v.detach().cpu() for k, v in ad.items()},
                        lora_scaling=2.0)
    _close(y.detach().cpu(), want, torch.float32)
    xg = x.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)
    tl_ops.reset_launches()
    y = layers.dense(xg, wg, adapter=ad, lora_scaling=2.0)
    torch.autograd.grad(y.sum(), [xg, wg])
    assert tl_ops.LAUNCHES == {"tri_lora_fwd": 1, "tri_lora_dx": 1,
                               "tri_lora_dw": 1, **NO_GROUPED}


def _fwd_routed(cuda, x, w, a, c, b, dtype):
    """The op's forward on x (any view) against the plain forward; returns
    the routes it took."""
    before = dict(tl_ops.ROUTES)
    y = tl_ops.tri_lora_matmul(x, w, a, c, b, 2.0)
    torch.cuda.synchronize()
    _close(y, tl_ref.tri_lora_matmul_ref(x, w, a, c, b, 2.0), dtype)
    return {key: tl_ops.ROUTES[key] - before[key] for key in before}


@pytest.mark.parametrize("m,k,n,r,b_dtype", [
    (4100, 1032, 2056, 8, torch.float32),     # ragged M, N and K (x8)
    (4100, 2048, 2048, 16, torch.bfloat16),   # rwkv6-1.6b width
    (65, 1032, 2056, 64, torch.bfloat16),     # one row past a 64-row tile
    (65, 2048, 2048, 1, torch.float32),
    (1, 2048, 2048, 8, torch.bfloat16),       # one decode row
    (1, 1032, 2056, 64, torch.float32),
    (8, 2048, 2048, 8, torch.float32),        # the RWKV decode shape
    (8, 1032, 2056, 16, torch.bfloat16)])
def test_tri_lora_forward_wgmma_route(cuda, m, k, n, r, b_dtype):
    """bf16 operands TMA can read take the wgmma kernel, with B (and the
    adapter) in f32 or bf16 and never rounded to bf16 in the kernel."""
    x, w, a, c, b, _ = _tri_lora_inputs(cuda, m, k, n, r, torch.bfloat16,
                                        m + k + r)
    a, c, b = (t.float().to(b_dtype) for t in (a, c, b))
    routes = _fwd_routed(cuda, x, w, a, c, b, torch.bfloat16)
    assert routes == {"fwd_wgmma": 1, "fwd_simt": 0,
                      **NO_GROUPED_ROUTES}


def _grouped_inputs(dev, groups, rows, k, n, r, dtype, seed):
    """x, W, the stacked factors as strided views of a (G, 2, …) stack
    (layer 1 of a stacked client state), the cotangent, int32 groups."""
    x, w, _, _, _, ct = _tri_lora_inputs(dev, len(groups) * rows, k, n, r,
                                         dtype, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    g_n = max(groups) + 1
    a, c, b = ((0.2 * torch.randn((g_n, 2) + shape, generator=g,
                                  device=dev)).to(dtype)[:, 1]
               for shape in ((k, r), (r, r), (r, n)))
    return x, w, a, c, b, ct, torch.tensor(groups, dtype=torch.int32,
                                           device=dev)


@pytest.mark.parametrize("groups,rows,k,n,r", [
    ([i // 8 for i in range(32)], 256, 768, 256, 8),   # train_vmap wk/wv
    ([0, 1, 2], 100, 96, 130, 8),                      # tiles straddle
    ([0, 0, 1, -1, 2, 1], 40, 64, 72, 4),              # masked rows
    ([2, 0, 1, -1, 0, 2, 1, 1], 1, 128, 96, 8)])       # a row a group
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_tri_lora_kernels_match_plain(cuda, groups, rows, k, n, r,
                                              dtype):
    """The grouped forward and dx kernels (one adapter per group of rows,
    the factors read through their client stride), dW over all rows and
    the rank-r grads against the plain grouped forward and backward; one
    launch of each kernel."""
    x, w, a, c, b, ct, gi = _grouped_inputs(cuda, groups, rows, k, n, r,
                                            dtype, rows + k)
    leaves = [t.detach().requires_grad_(True) for t in (x, w, a, c, b)]
    tl_ops.reset_launches()
    y = tl_ops.grouped_tri_lora_matmul(
        leaves[0].reshape(len(groups), rows, k), *leaves[1:], gi, 2.0)
    grads = torch.autograd.grad(y, leaves, ct.reshape(y.shape))
    torch.cuda.synchronize()
    assert tl_ops.LAUNCHES == {"tri_lora_fwd": 0, "tri_lora_dx": 0,
                               "tri_lora_dw": 1, "tri_lora_fwd_grouped": 1,
                               "tri_lora_dx_grouped": 1}
    _close(y.detach().reshape(x.shape[0], n),
           tl_ref.grouped_tri_lora_matmul_ref(x, w, a, c, b, gi, rows, 2.0),
           dtype)
    tol = TOL[dtype]["rtol"]
    for got, want in zip(grads, tl_ref.grouped_tri_lora_bwd_ref(
            x, w, a, c, b, gi, ct, rows, 2.0)):
        scale = max(1.0, float(want.float().abs().max()))
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("rows,route", [(256, "wgmma"), (100, "simt")])
def test_grouped_forward_routes(cuda, rows, route):
    """bf16 groups whose rows fill whole wgmma tiles take the wgmma
    kernel; others the SIMT kernel, chosen before the launch."""
    x, w, a, c, b, _, gi = _grouped_inputs(cuda, [0, 1, -1, 2], rows, 512,
                                           512, 8, torch.bfloat16, 21)
    before = dict(tl_ops.ROUTES)
    y = tl_ops.grouped_tri_lora_matmul(x.reshape(4, rows, 512), w, a, c, b,
                                       gi, 2.0)
    torch.cuda.synchronize()
    _close(y.reshape(x.shape[0], -1), tl_ref.grouped_tri_lora_matmul_ref(
        x, w, a, c, b, gi, rows, 2.0), torch.bfloat16)
    assert {k: tl_ops.ROUTES[k] - before[k] for k in before} == {
        "fwd_wgmma": 0, "fwd_simt": 0, "fwd_grouped_wgmma": route == "wgmma",
        "fwd_grouped_simt": route == "simt"}


def test_grouped_dense_on_the_card(cuda):
    """``layers.dense`` in grouped mode: many tokens a sequence (training)
    run the grouped tri-LoRA kernels, one token a sequence with no
    gradient (serving) the grouped GEMV."""
    x, w, a, c, b, _, gi = _grouped_inputs(cuda, [1, 0, 2, 1], 16, 64, 48,
                                           4, torch.float32, 31)
    ad = {"A": a, "C": c, "B": b}
    tl_ops.reset_launches()
    ops.reset_launches()
    y = layers.dense(x.reshape(4, 16, 64), w, adapter=ad, lora_scaling=2.0,
                     adapter_rows=gi)
    want = layers.dense(x.cpu().reshape(4, 16, 64), w.cpu(),
                        adapter={k: v.cpu() for k, v in ad.items()},
                        lora_scaling=2.0, adapter_rows=gi.cpu())
    _close(y.cpu(), want, torch.float32)
    layers.dense(x[:4].reshape(4, 1, 64), w,   # the GEMV reads a dense bank
                 adapter={k: v.contiguous() for k, v in ad.items()},
                 lora_scaling=2.0, adapter_rows=gi)
    assert tl_ops.LAUNCHES["tri_lora_fwd_grouped"] == 1
    assert ops.LAUNCHES["grouped_gemv"] == 1


def test_enc_dec_adapter_rows_on_the_card_match_each_client_alone(cuda):
    """whisper-small reduced (2 + 2 layers, f32) on the card, two clients'
    batches under ``adapter_rows``: every adapted projection, the cross
    block's (its queries and its own encoder rows) included, runs the
    grouped tri-LoRA kernels (as many grouped forwards and dx as one
    client alone runs single ones, no single one), and each client's
    loss and adapter gradients equal its run alone on the card, within
    1e-3 of each leaf's largest entry (f32 round-off through the model:
    the CPU's f32 grouped and single paths part by up to 1.8e-4)."""
    from repro_torch.tree import tree_leaves
    cfg = get_config("whisper-small").reduced()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(cfg, g)
    ads = [tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=g, device=cuda), params["adapter"])
        for _ in range(2)]
    stacked = tree_map(lambda a, b: torch.stack([a, b]).requires_grad_(True),
                       *ads)
    toks = torch.randint(0, cfg.vocab_size, (4, 13), generator=g,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.randn((4, cfg.enc_frames, cfg.d_model),
                                   generator=g, device=cuda)}
    tl_ops.reset_launches()
    loss, _ = model.loss_fn(cfg, stacked, params["base"], batch,
                            adapter_rows=model.client_rows(2, 2, cuda))
    grads = torch.autograd.grad(loss.sum(), tree_leaves(stacked))
    grouped = dict(tl_ops.LAUNCHES)
    for i in range(2):
        ad = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      ads[i])
        tl_ops.reset_launches()
        one, _ = model.loss_fn(cfg, ad, params["base"],
                               {k: v[2 * i:2 * i + 2]
                                for k, v in batch.items()})
        np.testing.assert_allclose(loss[i].item(), one.item(), rtol=1e-5)
        for a, b in zip(grads, torch.autograd.grad(one, tree_leaves(ad)),
                        strict=True):
            err = float((a[i] - b).abs().max())
            assert err <= 1e-3 * float(b.abs().max()), err
        single = dict(tl_ops.LAUNCHES)
    assert grouped["tri_lora_fwd"] == grouped["tri_lora_dx"] == 0
    assert grouped["tri_lora_fwd_grouped"] == single["tri_lora_fwd"] > 0
    assert grouped["tri_lora_dx_grouped"] == single["tri_lora_dx"] > 0


def test_tri_lora_forward_wgmma_reads_a_strided_view(cuda):
    """x as the model's ``mixed[..., i, :]`` of one (B,T,5,D) buffer: the
    tensor map takes the row stride 5·D, nothing is copied, and the result
    is the contiguous copy's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    d, n, r = 1024, 1024, 8
    mixed = torch.randn((2, 33, 5, d), generator=g, device=cuda).to(
        torch.bfloat16)
    _, w, a, c, b, _ = _tri_lora_inputs(cuda, 66, d, n, r, torch.bfloat16, 12)
    a, c, b = a.float(), c.float(), b.float()
    xv = mixed[..., 2, :]
    assert xv.reshape(-1, d).stride(0) == 5 * d
    assert xv.reshape(-1, d).data_ptr() == xv.data_ptr()
    routes = _fwd_routed(cuda, xv, w, a, c, b, torch.bfloat16)
    assert routes == {"fwd_wgmma": 1, "fwd_simt": 0,
                      **NO_GROUPED_ROUTES}
    torch.testing.assert_close(tl_ops.tri_lora_matmul(xv, w, a, c, b, 2.0),
                               tl_ops.tri_lora_matmul(xv.contiguous(), w, a,
                                                      c, b, 2.0),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n,r,dtype", [
    (64, 100, 96, 8, torch.bfloat16),         # row stride 200 bytes
    (2048, 768, 768, 8, torch.float32),       # fed-100m wq/wo
    (2048, 768, 256, 8, torch.float32),       # wk/wv
    (77, 100, 130, 16, torch.float32),
    (4100, 256, 200, 64, torch.float32)])
def test_tri_lora_forward_simt_route(cuda, m, k, n, r, dtype):
    """f32, and bf16 that TMA cannot read, take the register-tiled
    kernel."""
    x, w, a, c, b, _ = _tri_lora_inputs(cuda, m, k, n, r, dtype, m + n)
    routes = _fwd_routed(cuda, x, w, a, c, b, dtype)
    assert routes == {"fwd_wgmma": 0, "fwd_simt": 1,
                      **NO_GROUPED_ROUTES}


@pytest.mark.parametrize("m,k,n,dtype", [
    (2048, 768, 768, torch.float32),          # 8 splits of 256 rows
    (2048, 768, 256, torch.float32),          # 8 splits of 256 rows
    (100, 768, 256, torch.float32),           # M below one split
    (600, 130, 70, torch.bfloat16),           # 2 splits, ragged edges
    (2000, 768, 512, torch.float32),          # 7 splits, ragged last one
    (800, 256, 192, torch.bfloat16)])         # 3 splits
def test_tri_lora_dw_split_is_deterministic(cuda, m, k, n, dtype):
    """dW split over M and summed in split order by a cluster of blocks
    (any count of them up to 8): within the kernel tolerance of xᵀ@g
    (absolute part scaled by the largest entry), bitwise the same on a
    second call, one count per op call."""
    x, _, _, _, _, gy = _tri_lora_inputs(cuda, m, k, n, 1, dtype, m + k)
    splits, rows = tl_ops.dw_plan(m, k, n, tl_ops.dw_capacity(x.device))
    assert (splits > 1) == (m >= 2 * tl_ops.DW_MIN_ROWS)
    n0 = tl_ops.LAUNCHES["tri_lora_dw"]
    first = tl_ops.tri_lora_dw(x, gy)
    second = tl_ops.tri_lora_dw(x, gy)
    torch.cuda.synchronize()
    assert tl_ops.LAUNCHES["tri_lora_dw"] == n0 + 2
    assert torch.equal(first, second)
    want = x.float().T @ gy.float()
    tol = TOL[dtype]["rtol"]
    np.testing.assert_allclose(first.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol,
                               atol=tol * max(1.0, float(want.abs().max())))


def test_tri_lora_dw_capacity_reads_the_card(cuda):
    """The occupancy calculator gives the dW kernel a positive capacity for
    every cluster size, none above that of single blocks."""
    cap = tl_ops.dw_capacity(cuda)
    assert sorted(cap) == list(range(1, tl_ops.DW_MAX_SPLITS + 1))
    assert all(0 < c <= cap[1] for c in cap.values())


def _dx_plain(g, w, q, a):
    return (g.float() @ w.float().T + q.float() @ a.float().T).to(g.dtype)


def _dx_operands(cuda, m, k, n, r, dtype, a_dtype, seed):
    _, w, _, c, b, gy = _tri_lora_inputs(cuda, m, k, n, r, dtype, seed)
    a = _tri_lora_inputs(cuda, m, k, n, r, a_dtype, seed + 1)[2]
    q = (2.0 * (gy.float() @ b.float().T) @ c.float().T).to(dtype)
    return gy, w, q, a


@pytest.mark.parametrize("m,k,n,r", [
    (96, 160, 130, 8), (77, 100, 130, 16),    # N = 130: the scalar copies
    (2048, 768, 768, 8), (2048, 768, 256, 8),  # fed-100m wq/wo, wk/wv
    (1, 64, 64, 1), (130, 1000, 64, 64)])
@pytest.mark.parametrize("dtype,a_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])         # f32 adapters in a bf16 model
def test_tri_lora_dx_matches_plain(cuda, m, k, n, r, dtype, a_dtype):
    """dx = g@Wᵀ + Q@Aᵀ against its plain version in f32, A never rounded
    to g's type; at the gradient tolerance (absolute part scaled by the
    largest entry); one count per call."""
    g, w, q, a = _dx_operands(cuda, m, k, n, r, dtype, a_dtype, m + k + n)
    n0 = tl_ops.LAUNCHES["tri_lora_dx"]
    got = tl_ops.tri_lora_dx(g, w, q, a)
    torch.cuda.synchronize()
    assert tl_ops.LAUNCHES["tri_lora_dx"] == n0 + 1
    assert got.dtype == dtype and got.shape == (m, k)
    want = _dx_plain(g, w, q, a)
    tol = TOL[dtype]["rtol"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol * max(1.0, float(want.float().abs()
                                                         .max())))


@pytest.mark.parametrize("offset", [0, 1])    # 16-byte copies; scalar
def test_tri_lora_dx_reads_views_in_place(cuda, offset):
    """g as a row slice of a wider buffer and W as one layer of a stacked
    (layers, K, N) tensor give bitwise the contiguous copies' dx, on either
    copy route (the accumulation order does not depend on it)."""
    gen = torch.Generator(device=cuda).manual_seed(21 + offset)
    m, k, n, r = 200, 192, 100, 8
    wide = torch.randn((m, n + 12), generator=gen, device=cuda)
    g = wide[:, offset:offset + n]
    w = (0.1 * torch.randn((3, k, n + 4 * offset), generator=gen,
                           device=cuda))[1, :, offset:offset + n]
    q = torch.randn((m, r), generator=gen, device=cuda)
    a = torch.randn((k, r), generator=gen, device=cuda)
    assert g.stride(0) == n + 12 and w.stride(0) == n + 4 * offset
    got = tl_ops.tri_lora_dx(g, w, q, a)
    want = tl_ops.tri_lora_dx(g.contiguous(), w.contiguous(), q, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(got, _dx_plain(g, w, q, a), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tri_lora_dx_is_bitwise_repeatable(cuda, dtype):
    """Two calls on the same inputs give the same bits."""
    g, w, q, a = _dx_operands(cuda, 2048, 768, 256, 8, dtype, torch.float32,
                              4)
    first = tl_ops.tri_lora_dx(g, w, q, a)
    second = tl_ops.tri_lora_dx(g, w, q, a)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------------------------------------------
# wkv6
# ---------------------------------------------------------------------------

def _wkv_inputs(cuda, b, t, h, hd, dtype, seed, w_dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    r, k, v = (rn(b, t, h, hd).to(dtype) for _ in range(3))
    w = torch.sigmoid(2 * rn(b, t, h, hd)).to(w_dtype)
    return r, k, v, w, (0.5 * rn(h, hd)).to(dtype), 0.1 * rn(b, h, hd, hd)


def _wkv_close(got, want):
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b.float(), rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("b,t,h,hd,dtype", [
    (2, 64, 2, 16, torch.float32), (2, 80, 2, 16, torch.float32),
    (2, 33, 1, 8, torch.float32), (2, 128, 4, 32, torch.float32),
    (2, 1, 2, 64, torch.float32), (2, 77, 3, 64, torch.float32),
    (8, 512, 32, 64, torch.bfloat16), (2, 40, 4, 64, torch.bfloat16),
])
def test_wkv6_kernel_matches_plain(cuda, b, t, h, hd, dtype):
    """The JAX kernel-test shapes, T = 1, a T that is no multiple of the
    32-step chunk, and the rwkv6-1.6b prefill shape with the model's types
    (bf16 r/k/v/u, f32 w and state); one launch per call, on the 16-byte
    route."""
    ins = _wkv_inputs(cuda, b, t, h, hd, dtype, b * t + h)
    wkv_ops.reset_launches()
    got = wkv_ops.wkv6(*ins)
    torch.cuda.synchronize()
    assert wkv_ops.LAUNCHES == {"wkv6": 1}
    assert wkv_ops.ROUTES == {"wkv6_vec": 1, "wkv6_scalar": 0}
    assert all(x.dtype == torch.float32 for x in got)
    assert got[0].shape == (b, t, h, hd) and got[1].shape == (b, h, hd, hd)
    _wkv_close(got, wkv_ref.wkv6_ref(*ins))


@pytest.mark.parametrize("hd", [17, 48, 64])
@pytest.mark.parametrize("t", [1, 15, 17, 513])
def test_wkv6_kernel_head_dims_and_ragged_lengths(cuda, hd, t):
    """Head dims that leave part of the kernel's 64 columns and keys empty
    (17: the scalar staging route; 48: 16-byte copies) or none (64), at T
    of one step, within one 32-step chunk and one past a multiple of it;
    y and the final state are bitwise the same on a second call."""
    ins = _wkv_inputs(cuda, 2, t, 3, hd, torch.bfloat16, hd * 1000 + t)
    wkv_ops.reset_launches()
    first = wkv_ops.wkv6(*ins)
    second = wkv_ops.wkv6(*ins)
    torch.cuda.synchronize()
    route = "wkv6_scalar" if hd == 17 else "wkv6_vec"
    assert wkv_ops.ROUTES[route] == 2
    _wkv_close(first, wkv_ref.wkv6_ref(*ins))
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0], second[0])
    f32 = [a.float() for a in ins]
    _wkv_close(wkv_ops.wkv6(*f32), wkv_ref.wkv6_ref(*f32))


def test_wkv6_kernel_extreme_decay_and_mixed_types(cuda):
    """w = 1e-6 forgets almost all of the state every step and stays
    finite; w in bf16 and u in f32 beside bf16 r/k/v take their own
    instantiations."""
    b, t, h, hd = 1, 64, 1, 8
    full = [torch.full((b, t, h, hd), x, device=cuda) for x in (0.5, 0.5, 1.0,
                                                                1e-6)]
    ins = (*full, torch.zeros((h, hd), device=cuda),
           torch.zeros((b, h, hd, hd), device=cuda))
    got = wkv_ops.wkv6(*ins)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _wkv_close(got, wkv_ref.wkv6_ref(*ins))
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, 50, 2, 64, torch.bfloat16, 3,
                                    w_dtype=torch.bfloat16)
    for ins in ((r, k, v, w, u, s0), (r, k, v, w.float(), u.float(), s0)):
        _wkv_close(wkv_ops.wkv6(*ins), wkv_ref.wkv6_ref(*ins))


def test_wkv6_kernel_reads_by_strides(cuda):
    """r, k and v as views of one (B, T, 3·D) buffer, and a state that is a
    slice of a stacked one, give the contiguous copies' answer."""
    b, t, h, hd = 2, 45, 4, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.randn((b, t, 3 * h * hd), generator=g, device=cuda).to(
        torch.bfloat16)
    r, k, v = (wide[..., i * h * hd:(i + 1) * h * hd].view(b, t, h, hd)
               for i in range(3))
    _, _, _, w, u, _ = _wkv_inputs(cuda, b, t, h, hd, torch.bfloat16, 6)
    s0 = torch.randn((3, b, h, hd, hd), generator=g, device=cuda)[1]
    assert not r.is_contiguous()
    want = wkv_ref.wkv6_ref(r.contiguous(), k.contiguous(), v.contiguous(), w,
                            u, s0.contiguous())
    _wkv_close(wkv_ops.wkv6(r, k, v, w, u, s0), want)


def test_wkv6_unaligned_view_takes_the_scalar_route(cuda):
    """w read from 4 bytes into a buffer cannot take the 16-byte copies:
    the call takes the scalar route of the same kernel and matches the
    plain version; the 16-byte entry point refuses it."""
    b, t, h, hd = 2, 40, 3, 64
    r, k, v, w, u, s0 = _wkv_inputs(cuda, b, t, h, hd, torch.bfloat16, 11)
    flat = torch.empty(w.numel() + 1, device=cuda)
    moved = flat[1:].view(w.shape)
    moved.copy_(w)
    wkv_ops.reset_launches()
    got = wkv_ops.wkv6(r, k, v, moved, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.ROUTES == {"wkv6_vec": 0, "wkv6_scalar": 1}
    _wkv_close(got, wkv_ref.wkv6_ref(r, k, v, w, u, s0))
    from repro_torch.kernels import ffi
    fn = ffi.fn("wkv6", "wkv6_launch", wkv_ops._ARGS)
    y = torch.empty((b, t, h, hd), device=cuda)
    s_out = torch.empty((b, h, hd, hd), device=cuda)
    code = fn(1, 0, 1, *(x for a in (r, k, v, moved)
                         for x in (a.data_ptr(), *a.stride()[:3])),
              u.data_ptr(), u.stride(0), s0.data_ptr(), *s0.stride()[:3],
              y.data_ptr(), s_out.data_ptr(), b, t, h, hd, ffi.stream())
    assert code != 0


def test_wkv6_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    ins = list(_wkv_inputs(cuda, 1, 8, 2, 64, torch.float32, 7))
    with pytest.raises(RuntimeError, match="no VJP"):
        wkv_ops.wkv6(ins[0].requires_grad_(True), *ins[1:])
    ins[0] = ins[0].detach()
    big = _wkv_inputs(cuda, 1, 8, 1, 128, torch.float32, 8)
    with pytest.raises(ValueError, match="head dims"):
        wkv_ops.wkv6(*big)
    with pytest.raises(ValueError, match="share one dtype"):
        wkv_ops.wkv6(ins[0].to(torch.bfloat16), *ins[1:])
    with pytest.raises(ValueError, match="float32"):
        wkv_ops.wkv6(*ins[:5], ins[5].to(torch.bfloat16))
    with pytest.raises(ValueError, match="unit"):
        wkv_ops.wkv6(ins[0].transpose(2, 3).contiguous().transpose(2, 3),
                     *ins[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_ops.wkv6(*ins[:4], ins[4].cpu(), ins[5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_forward_on_the_card_matches_plain_and_counts_launches(cuda,
                                                                     dtype):
    """rwkv6-1.6b reduced (4 heads of 64, 3 layers) on the card: with
    ``use_rwkv_kernel=True`` exactly one wkv6 and four tri-LoRA forward
    launches per layer; the logits match ``use_rwkv_kernel=False`` (plain
    recurrence) on the card and the CPU's forward."""
    cfg = get_config("rwkv6-1.6b").reduced(n_layers=3, param_dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(9)
    with torch.inference_mode():
        params = model.init_params(cfg, g)
        tm = params["base"]["groups"]["0"]["tm"]
        for name, scale in (("u", 0.5), ("w_b", 0.1), ("mu", 0.5)):
            tm[name] += scale * torch.randn(tm[name].shape, generator=g,
                                            device=cuda).to(tm[name].dtype)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=g,
                         device=cuda)
    with torch.inference_mode():
        wkv_ops.reset_launches()
        tl_ops.reset_launches()
        got, _ = model.forward(cfg, params["base"], params["adapter"],
                               {"tokens": toks}, use_rwkv_kernel=True)
        torch.cuda.synchronize()
        assert wkv_ops.LAUNCHES == {"wkv6": 3}
        assert tl_ops.LAUNCHES == {"tri_lora_fwd": 12, "tri_lora_dx": 0,
                                   "tri_lora_dw": 0, **NO_GROUPED}
        plain, _ = model.forward(cfg, params["base"], params["adapter"],
                                 {"tokens": toks})
        assert wkv_ops.LAUNCHES == {"wkv6": 3}
        tol = 1e-4 if dtype == "float32" else 2e-2
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) <= tol * scale
        if dtype == "float32":
            cpu = tree_map(lambda a: a.cpu(), params)
            want, _ = model.forward(cfg, cpu["base"], cpu["adapter"],
                                    {"tokens": toks.cpu()},
                                    use_rwkv_kernel=True)
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def test_graphed_fit_is_bitwise_the_eager_fit(cuda):
    """The LM driver's vectorized fit (fed-100m reduced, f32, flash, 2
    clients × 2 steps of 2×64) as a captured CUDA graph: two calls (the
    first captures the graph, each replays it) give bit for bit what the
    eager fit gives under ``disable_jit``, the flash and tri-LoRA launch
    counts are twice the eager fit's, and a capture of a host sync
    raises, leaving the card usable."""
    from repro_torch.core import client_batch, jit_cache
    from repro_torch.launch import train as lm
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    cfg = get_config("fed-100m").reduced().with_overrides(attn_impl="flash")
    g = torch.Generator(device=cuda).manual_seed(0)
    base = model.init_params(cfg, g)["base"]
    stacked = client_batch.stack_states([tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=g, device=cuda),
        model.init_params(cfg, g)["adapter"]) for _ in range(2)])
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 65), generator=g,
                         device=cuda)
    opt = adamw(lr=1e-2, stacked=True)
    args = (cfg, base, opt, stacked, toks[..., :-1], toks[..., 1:])

    def counts():
        return {**fa_ops.LAUNCHES, **tl_ops.LAUNCHES}
    jit_cache.clear_all()
    jit_cache.reset_stats()
    fa_ops.reset_launches()
    tl_ops.reset_launches()
    with jit_cache.disable_jit():
        want = lm.local_fit_stacked(*args)
    eager = counts()
    assert eager["flash_fwd"] > 0 and eager["tri_lora_fwd_grouped"] > 0
    fa_ops.reset_launches()
    tl_ops.reset_launches()
    got = [lm.local_fit_stacked(*args) for _ in range(2)]
    assert jit_cache.STATS["graphs"] == 1 and len(lm._FIT_CACHE) == 1
    assert jit_cache.STATS["replays"] == 2
    assert counts() == {k: 2 * v for k, v in eager.items()}
    for out in got:
        for a, b in zip(tree_leaves(out), tree_leaves(want), strict=True):
            assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        jit_cache.GraphProgram(lambda x: x * x.sum().item(),
                               (torch.ones(4, device=cuda),))
    assert torch.ones(3, device=cuda).sum().item() == 3.0
    jit_cache.clear_all()


@pytest.mark.parametrize("arch", ["fed-100m", "qwen2-vl-72b", "rwkv6-1.6b",
                                  "recurrentgemma-2b"])
def test_graphed_generate_is_bitwise_the_eager_generate(cuda, arch):
    """``serve.generate`` at reduced size (bf16 where the config is) through
    its captured decode program, the cache donated (M-RoPE, the RWKV-6 and
    RG-LRU states copied back into it): twice, the same tokens as under
    ``disable_jit``, one capture, one replay a step, the same launches,
    and the second call runs on the cache the program holds, zeroed (no
    leaf copied in)."""
    from repro_torch.core import jit_cache
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator(device=cuda).manual_seed(3))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 6))

    def counts():
        return {**ops.LAUNCHES, **tl_ops.LAUNCHES, **wkv_ops.LAUNCHES}
    jit_cache.clear_all()
    ops.reset_launches()
    tl_ops.reset_launches()
    wkv_ops.reset_launches()
    with jit_cache.disable_jit():
        want = serve.generate(cfg, params, prompts, 5, device=cuda)
    eager = counts()
    jit_cache.reset_stats()
    ops.reset_launches()
    tl_ops.reset_launches()
    wkv_ops.reset_launches()
    got = [serve.generate(cfg, params, prompts, 5, device=cuda)
           for _ in range(2)]
    steps = 6 + 5 - 1
    assert jit_cache.STATS["graphs"] == 1
    assert jit_cache.STATS["replays"] == 2 * steps
    assert jit_cache.STATS["donated_in"] == 0
    assert counts() == {k: 2 * v for k, v in eager.items()}
    for out in got:
        assert torch.equal(out, want)
    jit_cache.clear_all()


def test_graphed_engine_and_scan_are_bitwise_eager(cuda):
    """``ServeEngine`` (fed-100m reduced, a random bank) and a
    ``run_federated`` scan run (tiny, int8, the norm gate, chunks of 2 over
    3 rounds, the carry donated) through their captured programs against
    their runs under ``disable_jit``: the same tokens, history and states,
    one replay a step or chunk, and the donated carry's buffers survive
    the chunks' releases.  The engine runs twice: the second run replays
    its one graph on the K/V it holds, zeroed (no capture, no copy)."""
    from repro_torch.core import federated, jit_cache
    from repro_torch.core.fed_model import FedTask
    from repro_torch.data import synthetic
    from repro_torch.tree import tree_leaves
    cfg = get_config("fed-100m").reduced()
    g = torch.Generator(device=cuda).manual_seed(4)
    base = model.init_params(cfg, g)["base"]
    bank = random_bank(cfg, 3, g)
    reqs = serve.make_requests(bank, 5, prompt_len=4, gen=3,
                               vocab=cfg.vocab_size, seed=4)
    jit_cache.clear_all()
    with jit_cache.disable_jit():
        eng = serve.ServeEngine(cfg, base, bank, slots=2, max_len=7,
                                device=cuda)
        want = eng.run(reqs)
    jit_cache.reset_stats()
    eng2 = serve.ServeEngine(cfg, base, bank, slots=2, max_len=7,
                             device=cuda)
    got = [eng2.run(reqs) for _ in range(2)]
    assert eng2.steps == 2 * eng.steps
    assert jit_cache.STATS["replays"] == eng2.steps
    assert jit_cache.STATS["graphs"] == 1
    assert jit_cache.STATS["donated_in"] == 0
    for done in got:
        for r in reqs:
            assert np.array_equal(done[r.rid], want[r.rid])

    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=256, rope_theta=1e4,
                       layer_pattern=("attn",), param_dtype="float32",
                       lora_rank=4)
    data = synthetic.make_federated_classification(0, 4, 24, 8, 16, 256, 2,
                                                   drift=0.8)[:2]
    task = FedTask.create(torch.Generator(device=cuda).manual_seed(0), tiny,
                          2)
    fed = federated.FedConfig(method="celora", n_clients=4, rounds=3,
                              local_steps=1, batch_size=4, lr=1e-2, seed=0,
                              feature_samples=16, cka_probes=8, gmm_iters=3,
                              uplink_codec="int8", admission="norm",
                              engine="scan", chunk_rounds=2)
    jit_cache.reset_stats()
    out = federated.run_federated(task, fed, *data, device=cuda)
    assert jit_cache.STATS["replays"] == 2
    with jit_cache.disable_jit():
        ref = federated.run_federated(task, fed, *data, device=cuda)
    for a, b in zip(out["history"], ref["history"]):
        assert (a.train_loss, a.accs, a.rejected) == \
            (b.train_loss, b.accs, b.rejected)
    for sa, sb in zip(out["states"], ref["states"]):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(sa),
                                                     tree_leaves(sb)))
    jit_cache.clear_all()
