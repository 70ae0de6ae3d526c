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


@pytest.mark.parametrize("k,n,rows", [
    (4096, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
    (11008, 4096, [0, 2, -1, 1, 7, 7, 3, 5]),
    (300, 71, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 2),   # odd N, 20 rows
    (100, 70, [-1]),                                   # only a masked row
    (4096, 4096, [3, -1, 0, 1, 2, 4, 5, 6, 7, 0] * 4),  # 40 rows: 2 groups
    (300, 71, [7, 6, -1, 5, 4, 3, 2, 1, 0, 0] * 7),     # 70 rows: 3 groups
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
    with pytest.raises(ValueError, match="one token per sequence"):
        layers.dense(torch.zeros((2, 3, 16), device=cuda), w,
                     adapter={"A": a, "C": c, "B": b}, adapter_rows=rows)


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
#: are no multiple of the 64-row tile
FLASH_CASES = [
    (2, 256, 12, 4, 64, True, 0),
    (1, 512, 12, 4, 64, True, 64),
    (2, 200, 12, 4, 64, True, 0),
    (2, 256, 32, 32, 128, True, 0),
    (1, 200, 32, 32, 128, True, 64),
    (2, 256, 12, 4, 64, False, 0),
    (2, 77, 8, 2, 128, False, 0),
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
    reference attention; one forward and one dq + dk/dv launch per layer."""
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
    assert out["flash"][2] == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}
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
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    """Two backward calls on the same inputs give bitwise-equal dq, dk and
    dv: the dk/dv cluster sums its heads' partials in rank order and no
    f32 sum uses atomics."""
    q, k, v, do = _flash_inputs(cuda, 2, 200, 12, 4, 64, dtype, 21)
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
    assert fa_ops.ROUTES == {"bwd_vec": 2, "bwd_scalar": 0}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_unaligned_view_takes_scalar_route(cuda, dtype):
    """Operands one element past a 16-byte boundary take the scalar route,
    which gives bitwise the 16-byte route's values; the 16-byte entry point
    itself refuses them."""
    q, k, v, do = _flash_inputs(cuda, 2, 200, 12, 4, 64, dtype, 17)

    def moved(t):
        buf = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                          device=t.device)
        buf[..., 1:] = t
        return buf[..., 1:]
    views = [moved(t) for t in (q, k, v, do)]
    assert fa_ops.bwd_route(*views) == "scalar"
    fa_ops.reset_launches()
    got = _flash_bwd_vs_plain(*views, dtype)
    assert fa_ops.ROUTES == {"bwd_vec": 0, "bwd_scalar": 2}
    out, lse = fa_ops.flash_attention_fwd(q, k, v)
    for a, b in zip(got, fa_ops.flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(a, b)
    delta = fa_ops.softmax_delta(out, do)
    fn = fa_ops._bwd_fn("dq", "vec", 7)
    dq = torch.empty(q.shape, dtype=dtype, device=cuda)
    code = fn(fa_ops.ffi.DTYPE_CODE[dtype], 64, views[0].data_ptr(),
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
                               "tri_lora_dw": 1}
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
                               "tri_lora_dw": 0}
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
                               "tri_lora_dw": 1}


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
    assert routes == {"fwd_wgmma": 1, "fwd_simt": 0}


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
    assert routes == {"fwd_wgmma": 1, "fwd_simt": 0}
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
    assert routes == {"fwd_wgmma": 0, "fwd_simt": 1}


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
    (bf16 r/k/v/u, f32 w and state); one launch per call."""
    ins = _wkv_inputs(cuda, b, t, h, hd, dtype, b * t + h)
    wkv_ops.reset_launches()
    got = wkv_ops.wkv6(*ins)
    torch.cuda.synchronize()
    assert wkv_ops.LAUNCHES == {"wkv6": 1}
    assert all(x.dtype == torch.float32 for x in got)
    assert got[0].shape == (b, t, h, hd) and got[1].shape == (b, h, hd, hd)
    _wkv_close(got, wkv_ref.wkv6_ref(*ins))


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
                                   "tri_lora_dw": 0}
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
