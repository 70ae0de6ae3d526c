"""The port's tri-LoRA op on the CPU against the JAX package's plain
versions.

On CPU tensors ``kernels.tri_lora.ops.tri_lora_matmul`` runs its plain
forward and the analytic backward; they are held to
``repro.kernels.tri_lora.tri_lora_matmul_ref``, ``jax.grad`` of it and its
``tri_lora_bwd_ref``, with the JAX kernel tests' tolerances (f32 2e-5,
bf16 2e-2, gradients with the absolute part scaled by their largest entry:
tests/test_kernels.py).  The CUDA kernels themselves are held to these
plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tri_lora import tri_lora_bwd_ref as jbwd_ref
from repro.kernels.tri_lora import tri_lora_matmul_ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels.tri_lora import ops, ref
from repro_torch.models import layers

SHAPES = [(64, 64, 64, 4), (96, 160, 130, 8), (32, 256, 64, 16),
          (128, 64, 192, 2)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(m, k, n, r, lead=None, seed=0):
    """x, W, A, C, B and an f32 cotangent at the JAX kernel tests' scales."""
    rng = np.random.default_rng(seed)
    xs = (lead or (m,)) + (k,)
    return [rng.standard_normal(xs),
            rng.standard_normal((k, n)) * 0.05,
            rng.standard_normal((k, r)) * 0.2,
            rng.standard_normal((r, r)) * 0.2,
            rng.standard_normal((r, n)) * 0.2,
            rng.standard_normal((lead or (m,)) + (n,))]


def _jax(arrs, jdt):
    return [jnp.asarray(a, jdt) for a in arrs[:5]] + \
        [jnp.asarray(arrs[5], jnp.float32)]


def _torch(arrs, tdt):
    return [torch.tensor(np.asarray(a, np.float32)).to(tdt)
            for a in arrs[:5]] + [torch.tensor(arrs[5], dtype=torch.float32)]


def _close(got: torch.Tensor, want, tol: float, scaled: bool = False):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=tol, atol=atol)


@pytest.mark.parametrize("m,k,n,r", SHAPES + [(34, 64, 96, 8)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_op_forward_and_grads_match_jax_ref(m, k, n, r, dt):
    """Forward against the JAX plain forward; all five gradients against
    ``jax.grad`` of it.  The (34, …) case feeds a batched (2, 17, 64)
    input through the leading-dims flatten."""
    jdt, tdt, tol = DTYPES[dt]
    lead = (2, 17) if m == 34 else None
    arrs = _inputs(m, k, n, r, lead)
    jx, jw, ja, jc, jb, jct = _jax(arrs, jdt)
    leaves = [t.requires_grad_(True) for t in _torch(arrs, tdt)[:5]]
    ct = _torch(arrs, tdt)[5]

    y = ops.tri_lora_matmul(*leaves, 2.0)
    want = jref(jx.reshape(-1, k), jw, ja, jc, jb, 2.0)
    assert y.shape == (*(lead or (m,)), n) and y.dtype == tdt
    _close(y.reshape(-1, n), want, tol)

    def loss(*o):
        return jnp.sum(jref(o[0].reshape(-1, k), *o[1:], 2.0).astype(
            jnp.float32) * jct.reshape(-1, n))

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jx, jw, ja, jc, jb)
    grads = torch.autograd.grad((y.float() * ct).sum(), leaves)
    for name, g, jg in zip("xwacb", grads, jgrads):
        assert g.dtype == tdt and g.shape == leaves["xwacb".index(name)].shape
        _close(g, jg, tol, scaled=True)


@pytest.mark.parametrize("m,k,n,r", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_backward_matches_jax_bwd_ref(m, k, n, r, dt):
    """The port's analytic VJP against the JAX package's, the same five
    f32-accumulated chains."""
    jdt, tdt, tol = DTYPES[dt]
    arrs = _inputs(m, k, n, r, seed=1)
    jx, jw, ja, jc, jb, _ = _jax(arrs, jdt)
    g = np.asarray(arrs[5], np.float32)
    want = jbwd_ref((jx, jw, ja, jc, jb), jnp.asarray(g, jdt), 1.5)
    got = ref.tri_lora_bwd_ref(*_torch(arrs, tdt)[:5],
                               torch.tensor(g).to(tdt), 1.5)
    for gt, gj in zip(got, want):
        assert gt.dtype == tdt
        _close(gt, gj, tol, scaled=True)


def test_adapter_grads_flow_with_a_frozen_input_and_weight():
    """A frozen x and W (the federated path's layer 0): the adapter
    factors still get their gradients."""
    x, w, a, c, b, _ = _torch(_inputs(16, 32, 24, 4), torch.float32)
    a, c, b = (t.requires_grad_(True) for t in (a, c, b))
    y = ops.tri_lora_matmul(x, w, a, c, b, 2.0)
    gs = torch.autograd.grad(y.sum(), [a, c, b])
    assert all(g is not None and g.abs().sum() > 0 for g in gs)


def test_dense_with_adapter_is_unchanged_on_the_cpu():
    """``layers.dense`` on CPU tensors keeps its plain path (x·W + bias +
    the rounded delta), equal to the JAX ``dense``, and launches nothing."""
    arrs = _inputs(12, 64, 48, 8)
    bias = np.random.default_rng(3).standard_normal(48)
    x, w, a, c, b, _ = _torch(arrs, torch.float32)
    before = dict(ops.LAUNCHES)
    y = layers.dense(x.reshape(3, 4, 64), w, bias=torch.tensor(bias).float(),
                     adapter={"A": a, "C": c, "B": b}, lora_scaling=2.0)
    jx, jw, ja, jc, jb, _ = _jax(arrs, jnp.float32)
    want = jlayers.dense(jx.reshape(3, 4, 64), jw,
                         bias=jnp.asarray(bias, jnp.float32),
                         adapter={"A": ja, "C": jc, "B": jb},
                         lora_scaling=2.0)
    _close(y, want, 2e-5)
    assert ops.LAUNCHES == before


def test_kernel_wrappers_check_operands_and_device():
    x, w, a, c, b, _ = _torch(_inputs(8, 16, 12, 4), torch.float32)
    p = x @ a
    with pytest.raises(ValueError, match="shape"):
        ops.tri_lora_fwd(x, w.T.contiguous(), p, b)
    with pytest.raises(ValueError, match="rank"):
        ops.tri_lora_fwd(x, w, torch.zeros(8, 65), torch.zeros(65, 12))
    with pytest.raises(ValueError, match="float64"):
        ops.tri_lora_fwd(x, w.double(), p, b)
    with pytest.raises(ValueError, match="unit"):
        ops.tri_lora_dw(x.T.contiguous().T, torch.zeros(8, 12))
    with pytest.raises(ValueError, match="share one dtype"):
        ops.tri_lora_dx(torch.zeros(8, 12), w.bfloat16(), p, a)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tri_lora_fwd(x, w, p, b)
