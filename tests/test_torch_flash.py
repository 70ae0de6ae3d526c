"""The port's flash attention and attention backends against the JAX
package, on the CPU.

On the CPU ``repro_torch...flash_attention`` runs its plain version (the
CUDA kernels are held against that version on the card in
tests/test_torch_cuda_kernels.py).  It is compared with the JAX oracle
``flash_attention_ref`` — forward, and gradients against ``jax.grad`` of
that oracle — at f32 tolerance 2e-5 (tests/test_kernels.py:16-17).  The
Pallas kernel itself never runs in this process (tests/conftest.py keeps
interpret-mode Pallas out of the in-process suite).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_ref as jflash_ref
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)

#: (B, S, H, K, hd, causal, window): causal, window, non-causal, GQA and
#: ragged lengths (no power of two); then h2o-danube-3-4b's head dim 120
#: (no multiple of 32: the kernels compute it at 128) causal with GQA 4:1,
#: windowed, and non-causal with GQA 4:1
CASES = [
    (2, 16, 4, 2, 16, True, 0),
    (1, 37, 4, 4, 8, True, 0),
    (2, 24, 6, 2, 16, True, 5),
    (2, 19, 4, 1, 16, False, 0),
    (1, 33, 8, 2, 32, True, 0),
    (1, 72, 8, 2, 120, True, 0),
    (1, 100, 4, 4, 120, True, 24),
    (2, 45, 8, 2, 120, False, 0),
]


def _inputs(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd),
                       (b, s, h, hd))]


def _jax_fwd_vjp(q, k, v, do, **kw):
    """JAX oracle output and its (dq, dk, dv) for cotangent ``do``, as one
    jitted program (op-by-op dispatch compiles every op separately)."""
    def f(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: jflash_ref(a, b, c, **kw),
                           q_, k_, v_)
        return out, vjp(do_)
    return jax.jit(f)(*map(jnp.asarray, (q, k, v, do)))


@pytest.mark.parametrize("b,s,h,kh,hd,causal,window", CASES)
def test_flash_plain_matches_jax_ref_forward_and_grads(b, s, h, kh, hd,
                                                       causal, window):
    q, k, v, do = _inputs(b, s, h, kh, hd, s + h)

    want, want_grads = _jax_fwd_vjp(q, k, v, do, causal=causal,
                                    window=window)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(*leaves, causal=causal, window=window)
    got.backward(torch.from_numpy(do))
    assert fa_ops.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0,
                               "flash_dkv": 0}      # the CPU takes no kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for leaf, wg in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wg), **TOL)


def test_flash_plain_lse_and_backward_ref():
    """The logsumexp the kernel saves, and the plain backward the card's
    dq/dk/dv are held against, from the same numpy inputs."""
    q, k, v, do = _inputs(2, 21, 4, 2, 16, 3)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa_ref.flash_attention_fwd_ref(qt, kt, vt, causal=True)
    logits = np.einsum("bqkgd,bskd->bkgqs", q.reshape(2, 21, 2, 2, 16),
                       k) / 4.0
    logits = np.where(np.tril(np.ones((21, 21), bool)), logits, -np.inf)
    want_lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(2, 4, 21),
                               **TOL)
    _, want_grads = _jax_fwd_vjp(q, k, v, do, causal=True)
    for got, want in zip(fa_ref.flash_attention_bwd_ref(qt, kt, vt, dot),
                         want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,bq,bk", [(True, 0, 8, 8),
                                                 (True, 6, 8, 4),
                                                 (False, 0, 16, 8)])
def test_blockwise_matches_jax_sdpa(causal, window, bq, bk):
    q, k, v, _ = _inputs(2, 27, 4, 2, 16, 9)
    want = jax.jit(lambda a, b, c: jattn.sdpa(a, b, c, causal=causal,
                                              window=window))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attention.blockwise_sdpa(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window, bq=bq,
                                   bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cfg_impl,impl,seq,kw", [
    ("auto", None, 16, {}), ("auto", None, 4096, {}), ("flash", None, 16, {}),
    ("ref", "blockwise", 16, {}), ("blockwise_cv", None, 64, {}),
    ("blockwise_hp", None, 4096, {}), ("flash", None, 16, {"kv_len": 64}),
    ("auto", None, 4096, {"kv_len": 4096}), ("flash", None, 16,
                                             {"kv_valid": True}),
])
def test_select_impl_matches_jax(cfg_impl, impl, seq, kw):
    shape = dict(name="t", family="dense", n_layers=1, d_model=8, n_heads=1,
                 n_kv_heads=1, d_ff=8, vocab_size=8, attn_impl=cfg_impl)
    got = attention.select_impl(ModelConfig(**shape), seq, impl=impl, **kw)
    assert got == jattn.select_impl(JConfig(**shape), seq, impl=impl, **kw)
    assert attention.IMPLS == jattn.IMPLS
    assert (attention.AUTO_REF_MAX_SEQ, attention.CROSS_TILE_THRESHOLD) == \
        (jattn.AUTO_REF_MAX_SEQ, jattn.CROSS_TILE_THRESHOLD)


def test_select_impl_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown attn_impl"):
        attention.select_impl(None, 16, impl="xla-flash")


def _moved(t, shift):
    """t's values in a view whose rows start ``shift`` elements into a
    buffer one row-width wider."""
    buf = torch.zeros((*t.shape[:-1], t.shape[-1] + shift), dtype=t.dtype)
    buf[..., shift:] = t
    return buf[..., shift:]


@pytest.mark.parametrize("dtype,make,want", [
    (torch.float32, lambda t: t, "vec"),
    (torch.bfloat16, lambda t: t, "vec"),
    (torch.float32, lambda t: _moved(t, 1), "scalar"),      # odd row stride
    (torch.float32, lambda t: _moved(t, 4), "vec"),         # 16-byte shift
    (torch.bfloat16, lambda t: _moved(t, 4), "scalar"),     # 8-byte shift
    (torch.bfloat16, lambda t: _moved(t, 8), "vec"),
    (torch.float32, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "vec"),                                              # heads outermost
], ids=["f32", "bf16", "f32+1", "f32+4", "bf16+4", "bf16+8", "f32-bhsd"])
def test_bwd_route_follows_strides_and_alignment(dtype, make, want):
    """The backward's route is chosen from base addresses and strides alone
    before any launch: 16-byte rows take the 16-byte route, anything else
    the scalar one, and one unaligned operand sends the call to it."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(2, 24, 4, 2, 64, 3))
    ops = [make(t) for t in (q, k, v, do)]
    assert fa_ops.bwd_route(*ops) == want
    assert fa_ops.bwd_route(ops[0], k, v, do) == want
    assert fa_ops.bwd_route(q, k, v, do) == "vec"


@pytest.mark.parametrize("dtype,make,want", [
    (torch.float32, lambda t: t, "vec"),
    (torch.bfloat16, lambda t: t, "vec"),
    (torch.float32, lambda t: _moved(t, 1), "scalar"),      # odd row stride
    (torch.float32, lambda t: _moved(t, 4), "vec"),         # 16-byte shift
    (torch.bfloat16, lambda t: _moved(t, 4), "scalar"),     # 8-byte shift
    (torch.bfloat16, lambda t: _moved(t, 8), "vec"),
    (torch.float32, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "vec"),                                              # heads outermost
    (torch.float32, lambda t: t[:, 1:], "vec"),           # a later row
    (torch.bfloat16, lambda t: t[:, :, 1:], "vec"),       # a later head
], ids=["f32", "bf16", "f32+1", "f32+4", "bf16+4", "bf16+8", "f32-bhsd",
        "f32-row1", "bf16-head1"])
def test_fwd_route_follows_strides_and_alignment(dtype, make, want):
    """The forward's route is chosen from q, k and v alone (base addresses
    and strides) before any launch, by the backward's rule: one unaligned
    operand sends the call to the scalar route."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(2, 24, 4, 2, 64, 5)[:3])
    ops = [make(t) for t in (q, k, v)]
    assert fa_ops.fwd_route(*ops) == want
    assert fa_ops.fwd_route(q, ops[1], v) == want
    assert fa_ops.fwd_route(q, k, ops[2]) == want
    assert fa_ops.fwd_route(q, k, v) == "vec"
    assert fa_ops.fwd_route(*ops) == fa_ops.bwd_route(*ops)


def test_cpu_flash_counts_no_launch_or_route():
    """On CPU tensors flash_attention runs its plain version: no kernel
    launch and no forward or backward route is counted."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_(True)
                   for a in _inputs(1, 16, 4, 2, 16, 4))
    fa_ops.reset_launches()
    fa_ops.flash_attention(q, k, v, causal=True).backward(do.detach())
    assert set(fa_ops.LAUNCHES.values()) == {0}
    assert fa_ops.ROUTES == {"fwd_vec": 0, "fwd_scalar": 0, "bwd_vec": 0,
                             "bwd_scalar": 0}
