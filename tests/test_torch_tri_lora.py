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
from torch_threads import one_torch_thread  # noqa: F401

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


def _route_operands(case: str):
    """x (M,K) and w (K,N) laid out as the named case lays them out."""
    bf = torch.bfloat16
    w = torch.zeros((64, 48), dtype=bf)
    if case == "bf16":
        return torch.zeros((8, 64), dtype=bf), w
    if case == "bf16_meta":
        return (torch.empty((4096, 2048), dtype=bf, device="meta"),
                torch.empty((2048, 2048), dtype=bf, device="meta"))
    if case == "bf16_mixed_view":            # mixed[..., i, :], (B,T,5,D)
        return torch.zeros((2, 3, 5, 64), dtype=bf)[..., 2, :].reshape(
            -1, 64), w
    if case == "f32":
        return torch.zeros((8, 64)), torch.zeros((64, 48))
    if case == "bf16_k100":                  # row stride 200 bytes
        return torch.zeros((8, 100), dtype=bf), torch.zeros((100, 48),
                                                            dtype=bf)
    if case == "bf16_base_off_16":           # base 2 bytes past a row
        return torch.zeros((8, 65), dtype=bf)[:, 1:], w
    if case == "bf16_w_stride_52":           # W row stride 104 bytes
        return torch.zeros((8, 64), dtype=bf), torch.zeros(
            (64, 52), dtype=bf)[:, :48]
    if case == "bf16_x_f32_w":
        return torch.zeros((8, 64), dtype=bf), torch.zeros((64, 48))
    raise ValueError(case)


@pytest.mark.parametrize("case,route", [
    ("bf16", "wgmma"), ("bf16_meta", "wgmma"), ("bf16_mixed_view", "wgmma"),
    ("f32", "simt"), ("bf16_k100", "simt"), ("bf16_base_off_16", "simt"),
    ("bf16_w_stride_52", "simt"), ("bf16_x_f32_w", "simt")])
def test_forward_route_follows_dtype_strides_and_alignment(case, route):
    """The forward's route is chosen from dtypes, strides and base
    addresses alone: bf16 operands TMA can read in place (16-byte base and
    row stride) go to the wgmma kernel, the rest to the SIMT kernel."""
    assert ops.fwd_route(*_route_operands(case)) == route


#: dW blocks one H100 80GB HBM3 holds at once by cluster size, as
#: ``ops.dw_capacity`` read it (6 blocks an SM; clusters of 3 or more
#: blocks reach fewer than its 132 SMs)
H100_DW_CAPACITY = {1: 792, 2: 792, 3: 744, 4: 744, 5: 730, 6: 744, 7: 707,
                    8: 736}


@pytest.mark.parametrize("m,k,n,splits,rows", [
    (2048, 768, 768, 5, 416),       # fed-100m wq/wo: 144 tiles x 5 <= 744
    (2048, 768, 256, 8, 256),       # wk/wv: 48 tiles x 8
    (77, 100, 130, 1, 96),          # ragged, below one split
    (1, 4096, 4096, 1, 32),         # one row
    (600, 64, 64, 2, 320),          # ragged last split
    (2000, 768, 512, 7, 288),       # clusters of 7 and 3 blocks
    (800, 768, 768, 3, 288)])
def test_dw_split_plan(m, k, n, splits, rows):
    """dW's M contraction takes the most splits whose tiles x splits blocks
    one H100 holds at once, in ranges of whole slabs that cover M exactly;
    the splits of a tile are one cluster of at most 8 blocks, the portable
    cluster size (any count up to 8, not only powers of two)."""
    assert ops.dw_plan(m, k, n, H100_DW_CAPACITY) == (splits, rows)
    assert (splits - 1) * rows < m <= splits * rows
    assert rows % ops.DW_SLAB == 0
    assert 1 <= splits <= ops.DW_MAX_SPLITS == 8
