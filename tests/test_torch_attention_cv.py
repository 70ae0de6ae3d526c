"""The 'blockwise_cv' and 'blockwise_hp' attention backends of the port on
the CPU (``repro_torch.models.attention_cv``, ``attention.self_attention``).

* ``blockwise_sdpa_cv`` mirrors tests/test_attention_cv.py: causal, and
  windowed, f32 forward and q/k/v gradients against the port's ``sdpa``
  under autograd at that test's tolerances (2e-4, 5e-3), and against the
  JAX package's ``blockwise_sdpa_cv`` at 2e-5; in bf16 the dK / dV come out
  in bf16 (summed per KV tile in f32, stored once in bf16: the JAX
  package's rounding points) and match JAX's at the bf16 tolerance 2e-2
  and ``sdpa``'s at that test's 6e-2.  Several KV tiles per row, so the
  per-tile rounding and the skipped tiles (above the diagonal, below the
  window) are on the path.
* Through ``self_attention`` past AUTO_REF_MAX_SEQ (2,304 = 9 x 256
  tokens): 'blockwise_cv' against the JAX package's (out and gradients),
  'blockwise_hp' bit for bit 'blockwise' (one device, no mesh) and equal
  to JAX's; at 2,100 tokens (not a multiple of 256) 'blockwise_cv' is
  'blockwise'.  ``select_impl`` resolves every backend as JAX's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models.attention_cv import blockwise_sdpa_cv as jblockwise_cv
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import attention
from repro_torch.models.attention_cv import blockwise_sdpa_cv
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _qkvc(rng, b, sq, h, kh, hd, dtype=np.float32):
    shapes = ((b, sq, h, hd), (b, sq, kh, hd), (b, sq, kh, hd),
              (b, sq, h, hd))
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _torch_grads(fn, q, k, v, ct, dtype=torch.float32):
    leaves = [torch.from_numpy(t).to(dtype).requires_grad_(True)
              for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(),
                                leaves)
    return out.detach(), grads


def _jax_grads(fn, q, k, v, ct, dtype=jnp.float32):
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(jnp.asarray(ct, dtype))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      t.astype(jnp.float32))


@pytest.mark.parametrize("sq,window", [(128, 0), (128, 48), (64, 0)])
def test_cv_forward_and_grads_match_sdpa_and_jax(sq, window):
    rng = np.random.default_rng(7 + sq + window)
    q, k, v, ct = _qkvc(rng, 2, sq, 4, 2, 16)
    out, grads = _torch_grads(lambda q, k, v: blockwise_sdpa_cv(
        q, k, v, True, window, 32, 32), q, k, v, ct)
    ref, ref_grads = _torch_grads(lambda q, k, v: attention.sdpa(
        q, k, v, causal=True, window=window), q, k, v, ct)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)
    jout, jgrads = _jax_grads(lambda q, k, v: jblockwise_cv(
        q, k, v, True, window, 32, 32), q, k, v, ct)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("window", [0, 40])
def test_cv_bf16_accumulation_matches_jax(window):
    """bf16 q/k/v: dK / dV come out in bf16 and match the JAX package's
    bf16 backward; all within bf16 tolerance of ``sdpa``'s gradients."""
    rng = np.random.default_rng(11 + window)
    q, k, v, ct = _qkvc(rng, 1, 128, 2, 1, 16)
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(t).to(bf).float().numpy() for t in (q, k, v))
    out, grads = _torch_grads(lambda q, k, v: blockwise_sdpa_cv(
        q, k, v, True, window, 32, 32), q, k, v, ct, bf)
    assert out.dtype == bf and all(g.dtype == bf for g in grads)
    jout, jgrads = _jax_grads(lambda q, k, v: jblockwise_cv(
        q, k, v, True, window, 32, 32), q, k, v, ct, jnp.bfloat16)
    assert all(g.dtype == jnp.bfloat16 for g in jgrads)
    np.testing.assert_allclose(_np(out), _np(jout), **BF16)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), **BF16)
    _, ref_grads = _torch_grads(lambda q, k, v: attention.sdpa(
        q, k, v, causal=True, window=window), q, k, v, ct, bf)
    for a, b in zip(grads[1:], ref_grads[1:]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=6e-2, atol=6e-2)


def test_cv_rejects_ragged_tiles():
    q = torch.zeros((1, 100, 2, 16))
    with pytest.raises(ValueError, match="multiples"):
        blockwise_sdpa_cv(q, q[:, :, :1], q[:, :, :1], True, 0, 32, 32)


TINY = dict(name="tiny", family="dense", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
            rope_theta=1e4, param_dtype="float32", lora_rank=4)


@pytest.fixture(scope="module")
def long_attn():
    """One attention block's params (numpy) and 2,304 = 9 x 256 tokens of
    input past AUTO_REF_MAX_SEQ, with a cotangent."""
    rng = np.random.default_rng(21)
    d, hd = TINY["d_model"], TINY["head_dim"]
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, 2 * hd)), ("wk", (d, hd)), ("wv", (d, hd)),
                      ("wo", (2 * hd, d)))}
    x = rng.standard_normal((1, 2304, d)).astype(np.float32)
    ct = rng.standard_normal((1, 2304, d)).astype(np.float32)
    return p, x, ct


def _port_attn(impl, p, x, ct, window=0):
    cfg = ModelConfig(**TINY, attn_impl=impl)
    tp = {k: torch.from_numpy(t).requires_grad_(True) for k, t in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    pos = torch.arange(x.shape[1]).expand(1, -1)
    out = attention.self_attention(cfg, tp, tx, pos, window=window)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [tx, tp["wq"], tp["wk"]])
    return out.detach(), grads


def _jax_attn(impl, p, x, ct, window=0):
    cfg = JConfig(**TINY, attn_impl=impl)
    pos = jnp.arange(x.shape[1])[None]

    def f(x, wq, wk):
        return jattention.self_attention(
            cfg, {**{k: jnp.asarray(t) for k, t in p.items()}, "wq": wq,
                  "wk": wk}, x, pos, window=window)
    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(p["wq"]),
                       jnp.asarray(p["wk"]))
    return out, vjp(jnp.asarray(ct))


def test_self_attention_cv_and_hp_past_the_ref_length(long_attn):
    p, x, ct = long_attn
    cv, cv_grads = _port_attn("blockwise_cv", p, x, ct)
    jcv, jcv_grads = _jax_attn("blockwise_cv", p, x, ct)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), **F32)
    for a, b in zip(cv_grads, jcv_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5 * float(np.abs(b).max()))
    bw, bw_grads = _port_attn("blockwise", p, x, ct)
    hp, hp_grads = _port_attn("blockwise_hp", p, x, ct)
    assert torch.equal(hp, bw)
    assert all(torch.equal(a, b) for a, b in zip(hp_grads, bw_grads))
    jhp, _ = _jax_attn("blockwise_hp", p, x, ct)
    np.testing.assert_allclose(hp.numpy(), np.asarray(jhp), **F32)
    # the custom backward computes the same gradients as autograd of the
    # plain tiles
    np.testing.assert_allclose(cv.numpy(), bw.numpy(), **F32)
    for a, b in zip(cv_grads, bw_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5 * float(b.abs().max()))


def test_cv_off_the_tile_grid_is_blockwise(long_attn):
    p, x, ct = long_attn
    x, ct = x[:, :2100], ct[:, :2100]
    cv, cv_grads = _port_attn("blockwise_cv", p, x, ct, window=700)
    bw, bw_grads = _port_attn("blockwise", p, x, ct, window=700)
    assert torch.equal(cv, bw)
    assert all(torch.equal(a, b) for a, b in zip(cv_grads, bw_grads))


@pytest.mark.parametrize("impl", attention.IMPLS)
def test_select_impl_matches_jax(impl):
    cfg, jcfg = ModelConfig(**TINY), JConfig(**TINY)
    for seq, kv_len, kv_valid in ((128, None, False), (2048, None, False),
                                  (2049, None, False), (4352, None, False),
                                  (4096, 1500, False), (12, 1500, False),
                                  (1, None, True)):
        kw = dict(impl=impl, kv_len=kv_len, kv_valid=kv_valid)
        assert attention.select_impl(cfg, seq, **kw) == \
            jattention.select_impl(jcfg, seq, **kw), (impl, seq, kv_len)
