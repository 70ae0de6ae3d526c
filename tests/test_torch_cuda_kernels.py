"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports neither ``jax`` nor the JAX package, so it also runs
on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances are the JAX kernel tolerances, 2e-5 in f32 and 2e-2 in bf16
(tests/test_kernels.py), with TF32 off.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.adapter_bank import random_bank
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig

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
