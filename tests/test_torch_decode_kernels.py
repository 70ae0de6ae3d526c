"""PyTorch port of the decode kernels (``repro_torch.kernels.decode_attention``).

CPU tests hold the port's plain versions (``ref.py``, and the wrappers in
``ops.py``, which take them for CPU tensors) against the JAX package's
oracles (``repro.kernels.decode_attention.ref``) on the same numpy inputs,
at the JAX kernel tolerances: 2e-5 in f32, 2e-2 in bf16
(tests/test_kernels.py).  The CUDA kernels themselves are held against
the plain versions in tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _both(a, name):
    """One numpy array as (jax array, torch tensor) in dtype ``name``."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(
        np.asarray(a, np.float32)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _bank(rng, m, k, n, r):
    return (rng.standard_normal((m, k, r)) * 0.2,
            rng.standard_normal((m, r, r)) * 0.2,
            rng.standard_normal((m, r, n)) * 0.2)


# ---------------------------------------------------------------------------
# decode attention: plain version vs the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring,h,kh,hd,idx", [
    (64, 4, 2, 32, [5, 10]),           # partially-filled ring, ragged
    (64, 4, 2, 32, [200, 64]),         # wrapped ring (all slots valid)
    (96, 4, 1, 32, [95, -1]),          # MQA, exactly full + masked slot
    (80, 4, 4, 16, [3, 120]),          # MHA, ring not a power of two
    (48, 12, 4, 64, 47),               # GQA 12/4, scalar idx
    (40, 8, 2, 120, [5, 57]),          # h2o-danube's hd 120, wrapped row
    (24, 10, 1, 256, [23, -1]),        # recurrentgemma's hd 256, 10 on 1
    (20, 10, 1, 256, 9),               # hd 256, scalar idx
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_jax(ring, h, kh, hd, idx, dtype):
    rng = np.random.default_rng(ring + h + hd)
    b = 2
    qj, qt = _both(rng.standard_normal((b, 1, h, hd)), dtype)
    kj, kt = _both(rng.standard_normal((b, ring, kh, hd)), dtype)
    vj, vt = _both(rng.standard_normal((b, ring, kh, hd)), dtype)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(idx, jnp.int32))
    idx_t = torch.tensor(idx, dtype=torch.int32)
    got_ref = ref.decode_attention_ref(qt, kt, vt, idx_t)
    got_op = ops.decode_attention(qt, kt, vt, idx_t)     # CPU → plain path
    assert got_op.dtype == qt.dtype and got_op.shape == qt.shape
    np.testing.assert_allclose(_np(got_ref), _np(want), **_tol(dtype))
    np.testing.assert_array_equal(_np(got_op), _np(got_ref))
    for row, i in enumerate(np.broadcast_to(idx, (b,))):
        if i < 0:
            assert np.all(_np(got_op)[row] == 0.0)


# ---------------------------------------------------------------------------
# grouped GEMV: plain version vs the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(128, 128), (100, 70)])
@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemv_ref_matches_jax(k, n, r, dtype):
    rng = np.random.default_rng(k * n + r)
    m = 3
    xj, xt = _both(rng.standard_normal((5, k)), dtype)
    wj, wt = _both(rng.standard_normal((k, n)) * 0.05, dtype)
    a, c, b = _bank(rng, m, k, n, r)
    rows = np.asarray([0, 2, -1, 1, 2], np.int32)   # dup row + masked slot
    want = jref.grouped_gemv_ref(jnp.asarray(rows), xj, wj, jnp.asarray(a),
                                 jnp.asarray(c), jnp.asarray(b), scaling=2.0)
    bank_t = [torch.from_numpy(np.asarray(t, np.float32)) for t in (a, c, b)]
    rows_t = torch.from_numpy(rows)
    got_ref = ref.grouped_gemv_ref(rows_t, xt, wt, *bank_t, scaling=2.0)
    got_op = ops.grouped_dense(rows_t, xt, wt, *bank_t, scaling=2.0)
    assert got_op.dtype == xt.dtype and tuple(got_op.shape) == (5, n)
    np.testing.assert_allclose(_np(got_ref), _np(want), **_tol(dtype))
    np.testing.assert_array_equal(_np(got_op), _np(got_ref))
    assert np.all(_np(got_op)[2] == 0.0)


# ---------------------------------------------------------------------------
# grouped decode composite: port ops (CPU) vs the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kh", [(4, 2), (4, 4), (4, 1)])  # GQA / MHA / MQA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [32, 48])
def test_grouped_decode_matches_jax(h, kh, dtype, ring):
    rng = np.random.default_rng(h * kh + ring)
    m, bsz, d, hd, r = 3, 4, 48, 32, 4
    shapes = {"wq": (d, h * hd), "wk": (d, kh * hd),
              "wv": (d, kh * hd), "wo": (h * hd, d)}
    w_np = {k_: rng.standard_normal(s) * 0.1 for k_, s in shapes.items()}
    bank_np = {k_: dict(zip("ACB", _bank(rng, m, *shapes[k_], r)))
               for k_ in shapes}
    x_np = rng.standard_normal((bsz, d))
    kc_np = rng.standard_normal((bsz, ring, kh, hd))
    vc_np = rng.standard_normal((bsz, ring, kh, hd))
    rows = np.asarray([0, 2, -1, 1], np.int32)
    pos = np.asarray([3, ring + 5, -1, 0], np.int32)

    jd, td = DTYPES[dtype]
    want, kw, vw = jref.grouped_decode_ref(
        jnp.asarray(x_np, jd), {k_: jnp.asarray(v, jd) for k_, v in w_np.items()},
        {k_: {f: jnp.asarray(v, jnp.float32) for f, v in ad.items()}
         for k_, ad in bank_np.items()},
        jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(kc_np, jd),
        jnp.asarray(vc_np, jd), scaling=2.0)

    def t(a, dt=td):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    kc, vc = t(kc_np), t(vc_np)
    kc0, vc0 = kc.clone(), vc.clone()
    got, ko, vo = ops.grouped_decode(
        t(x_np), {k_: t(v) for k_, v in w_np.items()},
        {k_: {f: t(v, torch.float32) for f, v in ad.items()}
         for k_, ad in bank_np.items()},
        torch.from_numpy(rows), torch.from_numpy(pos), kc, vc, scaling=2.0)
    assert ko is kc and vo is vc                  # written in place
    o32, w32 = _np(got), _np(want)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    scale = max(1.0, float(np.abs(w32).max()))
    np.testing.assert_allclose(o32, w32, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(_np(ko), _np(kw), **_tol(dtype))
    np.testing.assert_allclose(_np(vo), _np(vw), **_tol(dtype))
    assert np.all(o32[2] == 0.0)                  # masked row exactly zero
    assert torch.equal(ko[2], kc0[2]) and torch.equal(vo[2], vc0[2])

    # the functional plain composite agrees and leaves its inputs alone
    kc1, vc1 = kc0.clone(), vc0.clone()
    got_r, kr, vr = ref.grouped_decode_ref(
        t(x_np), {k_: t(v) for k_, v in w_np.items()},
        {k_: {f: t(v, torch.float32) for f, v in ad.items()}
         for k_, ad in bank_np.items()},
        torch.from_numpy(rows), torch.from_numpy(pos), kc1, vc1, scaling=2.0)
    assert torch.equal(kc1, kc0) and torch.equal(vc1, vc0)
    np.testing.assert_array_equal(_np(got_r), o32)
    assert torch.equal(kr, ko) and torch.equal(vr, vo)


# ---------------------------------------------------------------------------
# wrappers and build: what the CPU can check
# ---------------------------------------------------------------------------

def test_wrappers_refuse_mixed_devices():
    q = torch.zeros(1, 1, 2, 64)
    k = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, k, torch.tensor(0, dtype=torch.int32))
    x = torch.zeros(2, 16, device="meta")
    w = torch.zeros(16, 8)                       # on the CPU: mixed
    a, c, b = (torch.zeros(s, device="meta") for s in
               ((1, 16, 2), (1, 2, 2), (1, 2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.grouped_dense(torch.zeros(2, dtype=torch.int32), x, w, a, c, b)
    # all on ``meta`` is the plain path traced for shapes (the dry run)
    y = ops.grouped_dense(torch.zeros(2, dtype=torch.int32), x,
                          w.to("meta"), a, c, b)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 8)


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    q = torch.zeros(1, 1, 2, 64)
    k = torch.zeros(1, 8, 2, 64)
    ops.decode_attention(q, k, k, torch.tensor(3, dtype=torch.int32))
    assert ops.LAUNCHES == {"decode_attention": 0, "grouped_gemv": 0}
    assert not any(ops.ROUTES.values())


def test_kernel_sources_are_listed_for_the_build():
    srcs = build.sources()
    launches = {"decode_attention": ["decode_attention"],
                "grouped_gemv": ["grouped_gemv"],
                "flash_attention": ["flash_fwd", "flash_dq", "flash_dkv"],
                "tri_lora": ["tri_lora_fwd", "tri_lora_dx", "tri_lora_dw"],
                "wkv6": ["wkv6"]}
    assert set(srcs) == set(launches)
    for name, path in srcs.items():
        text = path.read_text()
        assert "Replaces:" in text and "bounds it" in text, name
        for fn in launches[name]:
            assert f'extern "C" int {fn}_launch' in text, name
        assert f'extern "C" const char* {name}_error_string' in text, name
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_attention_head_dims_are_the_kernel_instantiations():
    """``ops._ATTN_HEAD_DIMS`` is the ``Instantiated`` list of
    decode_attention.cu, and it holds the head dim (and the group of query
    heads a KV head) of every config the JAX package registers."""
    import re

    import repro.configs  # noqa: F401  (registers the configs)
    from repro.models.config import get_config, list_configs

    text = build.sources()["decode_attention"].read_text()
    found = re.search(r"using Instantiated = HeadDims<([0-9, ]+)>;", text)
    assert found, "decode_attention.cu names no Instantiated head dims"
    dims = tuple(int(d) for d in found.group(1).split(","))
    assert dims == ops._ATTN_HEAD_DIMS
    for name in list_configs():
        cfg = get_config(name)
        assert cfg.hd in ops._ATTN_HEAD_DIMS, name
        assert cfg.n_heads // cfg.n_kv_heads <= ops.ATTN_MAX_GROUP, name


#: blocks an H100 holds at once, two an SM, per cluster size: clusters of
#: 3 or more reach only some of its SMs (the occupancy calculator's answer
#: for the tri-LoRA dW kernel, six an SM, scaled to two)
H100_CAPACITY = {1: 264, 2: 264, 3: 248, 4: 248, 5: 243, 6: 248, 7: 235,
                 8: 245}


@pytest.mark.parametrize("b,kh,group,want", [
    (8, 32, 1, 1),       # the serving shape: LLaMA-7B, 8 slots
    (8, 8, 4, 3),        # h2o-danube-3-4b heads: 64 (row, KV head) pairs
    (8, 1, 10, 8),       # recurrentgemma-2b: 3 head chunks
    (1, 1, 1, 8),
    (64, 8, 8, 1),       # more blocks than one wave: no split
    (4, 4, 3, 8),        # fed-100m heads: 16 pairs
    (3, 2, 64, None),
    (2, 2, 12, None),
])
def test_attn_plan_takes_the_most_splits_of_one_wave(b, kh, group, want):
    """Splits are the most, up to the largest portable cluster, whose
    blocks fit the card's capacity for that cluster size; 1 when none
    does."""
    splits = ops.attn_plan(b, kh, group, H100_CAPACITY)
    blocks = b * kh * -(-group // 4)
    assert 1 <= splits <= ops.ATTN_MAX_SPLITS
    assert blocks * splits <= H100_CAPACITY[splits] or splits == 1
    assert all(blocks * s > H100_CAPACITY[s]
               for s in range(splits + 1, ops.ATTN_MAX_SPLITS + 1))
    if want is not None:
        assert splits == want


@pytest.mark.parametrize("b,k,n", [(8, 4096, 4096), (1, 4096, 4096),
                                   (40, 4096, 4096), (17, 300, 71),
                                   (8, 11008, 4096), (3, 64, 8)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gemv_plan_slices_cover_k_once(b, k, n, itemsize):
    """K slices are stage multiples, at most GEMV_MAX_SPLITS of them, and
    cover K with no empty slice; the serving shape gets 16 slices of
    256."""
    splits, depth = ops.gemv_plan(b, k, n, itemsize, 132)
    assert 1 <= splits <= ops.GEMV_MAX_SPLITS
    assert depth % ops.GEMV_STAGE_K == 0
    assert (splits - 1) * depth < k <= splits * depth
    if (b, k, n, itemsize) == (8, 4096, 4096, 2):
        assert (splits, depth) == (16, 256)


def test_bound_table_names_every_tpu_kernel():
    """Each row of the bound table points at the ``def`` of a Pallas kernel
    function (one that reaches ``pl.pallas_call``), the two serving
    kernels are bound by bytes at their serving shapes, and wkv6 by its
    f32 operations at the RWKV prefill's shape and types."""
    from pathlib import Path

    from repro_torch.kernels import bounds

    root = Path(__file__).resolve().parents[1]
    assert len(bounds.TABLE) == 8
    for name, src, _, bd in bounds.TABLE:
        path, line = src.split(":")
        text = (root / path).read_text()
        assert text.splitlines()[int(line) - 1].startswith(f"def {name}("), src
        assert "pallas_call" in text
        assert bd.ms > 0 and bd.by in ("bytes", "operations")
    attn = bounds.decode_attention(8, 32, 32, 128, 8 * 160, "bfloat16")
    assert attn.by == "bytes" and attn.nbytes == 21_102_624
    gemv = bounds.grouped_gemv(8, 4096, 4096, 8, 8, "bfloat16")
    assert gemv.by == "bytes" and gemv.nbytes > 4096 * 4096 * 2
    # the rwkv6-1.6b prefill: r/k/v/u bf16, w/y/state f32, u read as (H, hd)
    wkv = bounds.TABLE[7][3]
    assert wkv == bounds.wkv6(8, 32, 512, 64, "bfloat16")
    assert wkv.nbytes == 125_833_216 and wkv.flops == 2_684_354_560
    assert wkv.by == "operations" and abs(wkv.ms * 1e3 - 40.06) < 0.01
