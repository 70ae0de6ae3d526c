"""The port's fault injection and admission control (``repro_torch.core.
faults`` / ``admission`` and the robust round of ``run_federated``)
against the JAX package's, on the CPU.

* Unit level: the seeded fault draw, the payload manglers (NaN/Inf fill,
  the bit flip of f32 / bf16 / int8 / int4 wire codes, the divergent
  scale, the zeroing of rejected rows) bit for bit; the payload stats at
  1e-6 and the gate's masks and ring state exactly.
* Run level: the seeded storm of tests/test_faults.py (every event kind
  fires), alone and with the int8 codec and the bit flip, through the JAX
  eager loop path (its draws handed to the port) and the port's loop and
  vmap paths: identical failed / rejected / sampled / participant lists
  and byte ledgers, loss within 1e-4, accuracies within 1e-3, states
  within 5e-4.  The zero-rate config with every knob set explicitly is
  bit for bit the default run on both paths, and the norm gate catches a
  divergent upload.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadmission
from repro.core import compress as jcompress
from repro.core import faults as jfaults
from repro.core import federated as jfed
from repro.core.fed_model import FedTask as JFedTask
from repro.data import partition, synthetic
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.core import admission, compress, faults, federated
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 4
#: the storm of tests/test_faults.py: every event kind fires somewhere in
#: 3 rounds x 4 clients at these rates (seed-pinned)
STORM = dict(fault_crash=0.15, fault_loss=0.2, fault_corrupt=0.25,
             fault_divergent=0.15, admission="norm", seed=11)
RUN = dict(n_clients=M, rounds=3, local_steps=2, batch_size=8, lr=1e-2,
           method="celora", use_data_sim=False, cka_probes=8,
           client_parallelism="loop")
JAX_RUNS = {"storm": STORM,
            "storm_int8_bitflip": dict(STORM, uplink_codec="int8",
                                       fault_corrupt_mode="bitflip")}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(tree):
    """numpy / JAX arrays → torch tensors, bf16 bit for bit."""
    def one(a):
        a = np.array(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return jax.tree.map(one, tree)


def _bits(x):
    """The bytes of an array (bf16 and all) as unsigned integers."""
    a = _np(x.view(torch.int16) if isinstance(x, torch.Tensor)
            and x.dtype == torch.bfloat16 else x)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


# ---------------------------------------------------------------------------
# unit level
# ---------------------------------------------------------------------------

def test_fault_draw_matches_jax_bitwise():
    kw = dict(crash=0.3, loss=0.2, corrupt=0.25, divergent=0.1)
    ours, theirs = faults.FaultModel(**kw), jfaults.FaultModel(**kw)
    for rnd, seed, attempt in ((0, 0, 0), (3, 11, 0), (7, 5, 2)):
        a = ours.draw(23, rnd, seed, attempt)
        b = theirs.draw(23, rnd, seed, attempt)
        for ev in faults.FAULT_EVENTS:
            np.testing.assert_array_equal(getattr(a, ev), getattr(b, ev))
    assert not faults.FaultModel().active
    assert faults.FAULT_EVENTS == jfaults.FAULT_EVENTS
    assert faults.CORRUPT_MODES == jfaults.CORRUPT_MODES


@pytest.mark.parametrize("kw,match", [
    (dict(crash=1.0), "fault_crash"), (dict(loss=-0.1), "fault_loss"),
    (dict(corrupt_mode="zstd"), "corrupt_mode"),
    (dict(divergent_scale=0.5), "divergent_scale")])
def test_fault_model_refuses_what_jax_refuses(kw, match):
    for cls in (faults.FaultModel, jfaults.FaultModel):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def _payload(seed, m=4):
    """A stacked payload tree, keys out of sorted order, f32."""
    rng = np.random.default_rng(seed)
    return {"z": {"C": rng.standard_normal((m, 2, 4, 4)).astype(np.float32)},
            "a": rng.standard_normal((m, 3, 5)).astype(np.float32)}


MASK = np.array([True, False, True, False])


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
def test_manglers_match_jax_bitwise(mode):
    p = _payload(0)
    p["a"][0, 0, :2] = (0.0, -3.5)
    j = jax.tree.map(jnp.asarray, p)
    pairs = [(faults.corrupt_rows(_t(p), MASK, mode),
              jfaults.corrupt_rows(j, jnp.asarray(MASK), mode)),
             (faults.scale_rows(_t(p), MASK, 1e4),
              jfaults.scale_rows(j, jnp.asarray(MASK), 1e4)),
             (faults.zero_rows(faults.corrupt_rows(_t(p), MASK, mode), MASK),
              jfaults.zero_rows(jfaults.corrupt_rows(j, jnp.asarray(MASK),
                                                     mode),
                                jnp.asarray(MASK))),
             (faults.corrupt_one(None, None, _t(p), mode),
              jfaults.corrupt_one(None, None, j, mode))]
    for ours, theirs in pairs:
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, ours)),
                        jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))


def test_bitflip_wire_codes_match_jax_bitwise():
    """int8 codes, int4 packed codes (uint8), bf16 codes and f32 codes:
    one bit of the wire representation, scales untouched."""
    rng = np.random.default_rng(1)
    i8 = rng.integers(-127, 128, (3, 7)).astype(np.int8)
    u8 = rng.integers(0, 256, (3, 5)).astype(np.uint8)
    f32 = rng.standard_normal((3, 6)).astype(np.float32)
    bf = f32.copy()
    scales = rng.standard_normal(3).astype(np.float32)
    ours = faults.bitflip_wire({
        "codes": {"i8": torch.from_numpy(i8), "u8": torch.from_numpy(u8),
                  "bf": torch.from_numpy(bf).to(torch.bfloat16),
                  "f32": torch.from_numpy(f32)},
        "scales": {"s": torch.from_numpy(scales).to(torch.bfloat16)}})
    theirs = jfaults.bitflip_wire({
        "codes": {"i8": jnp.asarray(i8), "u8": jnp.asarray(u8),
                  "bf": jnp.asarray(bf, jnp.bfloat16),
                  "f32": jnp.asarray(f32)},
        "scales": {"s": jnp.asarray(scales, jnp.bfloat16)}})
    for part in ("codes", "scales"):
        for k, b in theirs[part].items():
            a = ours[part][k]
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            b = np.asarray(b)
            b = b.view(np.int16) if b.dtype.itemsize == 2 else b
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


@pytest.mark.parametrize("codec", ["int8", "int4", "bf16"])
def test_corrupt_served_on_the_wire_matches_jax(codec):
    """The bit flip under a codec: the JAX wire tree flipped and decoded
    again by each package, the corrupted rows only."""
    p = _payload(2)
    j = jax.tree.map(jnp.asarray, p)
    jc = jcompress.get_codec(codec)
    enc, dec, _ = jcompress.encode_stacked(
        jc, j, jax.tree.map(jnp.zeros_like, j), jcompress.client_keys(3, 0, 4))
    want = jfaults.corrupt_served(jc, enc, dec, jnp.asarray(MASK), "bitflip")
    got = faults.corrupt_served(compress.get_codec(codec), _t(enc), _t(dec),
                                MASK, "bitflip")
    one = faults.corrupt_one(compress.get_codec(codec), _t(jax.tree.map(
        lambda l: l[1], enc)), _t(jax.tree.map(lambda l: l[1], dec)),
        "bitflip")
    for a, b, c in zip(jax.tree.leaves(jax.tree.map(_np, got)),
                       jax.tree.leaves(want),
                       jax.tree.leaves(jax.tree.map(_np, one))):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert not np.array_equal(c, np.asarray(b)[1])    # row 1 is clean


def test_payload_stats_and_admit_match_jax():
    p = _payload(4, m=6)
    p["a"][2, 1, 1] = np.nan
    p["z"]["C"][4] *= 300.0
    norms, finite = admission.payload_stats(_t(p))
    jn, jf = jadmission.payload_stats(jax.tree.map(jnp.asarray, p))
    np.testing.assert_allclose(_np(norms), np.asarray(jn), rtol=1e-6)
    np.testing.assert_array_equal(_np(finite), np.asarray(jf))
    ctl = admission.AdmissionControl(mode="norm", norm_mult=3.0, window=3)
    jctl = jadmission.AdmissionControl(mode="norm", norm_mult=3.0, window=3)
    st, jst = admission.init_state(3, "cpu"), jadmission.init_state(3)
    rng = np.random.default_rng(5)
    n0 = np.asarray(jn)
    for rnd in range(6):       # past the ring's end; one round all rejected
        nr = (n0 * rng.uniform(0.5, 2.0, 6)).astype(np.float32)
        if rnd == 3:
            nr *= 100.0
        cand = rng.random(6) < 0.8
        acc, st = admission.admit(torch.from_numpy(nr), finite, cand, st,
                                  ctl)
        jacc, jst = jadmission.admit(jnp.asarray(nr), jf, jnp.asarray(cand),
                                     jst, jctl)
        assert acc.dtype == torch.bool
        np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
        np.testing.assert_array_equal(_np(st["meds"]),
                                      np.asarray(jst["meds"]))
        assert int(st["count"]) == int(jst["count"])
    assert int(st["count"]) == 5


# ---------------------------------------------------------------------------
# run level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    seq = 16
    tr = synthetic.make_classification_data(0, 600, seq, TINY["vocab_size"],
                                            CLASSES, class_sep=1.5)
    te = synthetic.make_classification_data(1, 300, seq, TINY["vocab_size"],
                                            CLASSES, class_sep=1.5)
    trs = partition.dirichlet_partition(0, tr.labels, M, 0.5)
    tes = partition.dirichlet_partition(0, te.labels, M, 0.5)
    ctrain = [{"tokens": tr.tokens[s], "labels": tr.labels[s]} for s in trs]
    ctest = [{"tokens": te.tokens[s], "labels": te.labels[s]} for s in tes]
    jcfg = JConfig(**TINY)
    base = jax.jit(lambda k: JFedTask.create(k, jcfg, CLASSES).base)(
        jax.random.key(0))
    jtask = JFedTask(jcfg, base, CLASSES)
    task = convert.fed_task_from_numpy(ModelConfig(**TINY),
                                       jax.tree.map(np.asarray, jtask.base),
                                       CLASSES, "cpu")
    return jtask, task, ctrain, ctest, {}


def _jax_run(setup, name):
    jtask, _, ctrain, ctest, memo = setup
    if name not in memo:
        memo[name] = jfed.run_federated(
            jtask, jfed.FedConfig(**{**RUN, **JAX_RUNS[name]}), ctrain, ctest)
    return memo[name]


def _draws(jtask, kw):
    """The JAX runtime's draws: client init, CKA probes, and the codec's
    uniforms per (round, client) (the port takes them as its inputs)."""
    seed = kw["seed"]
    ckeys = jax.random.split(jax.random.key(seed), M)
    clients = [convert.params_from_numpy(jax.tree.map(
        np.asarray, jtask.init_client(ckeys[i])), "cpu") for i in range(M)]
    probes = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed + 97), (kw["cka_probes"], TINY["lora_rank"]),
        jnp.float32)))
    extra = {}
    if kw.get("uplink_codec", "none") != "none":
        codec = jcompress.get_codec(kw["uplink_codec"])
        like = federated.get_strategy(kw["method"]).uplink(clients[0])
        sizes = [int(np.prod(l.shape)) for l in jax.tree.leaves(
            jax.tree.map(_np, like))]

        def uniforms(rnd, i):
            keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                    len(sizes))
            return [torch.from_numpy(np.array(jax.random.uniform(
                k, (-(-n // jcompress._leaf_tile(n, codec.pack)),
                    jcompress._leaf_tile(n, codec.pack)))))
                for n, k in zip(sizes, keys)]
        extra["sr_uniforms"] = uniforms
    return dict(init_clients=clients, cka_probes=probes, **extra)


def _port_run(setup, kw, draws=None):
    _, task, ctrain, ctest, _ = setup
    return federated.run_federated(task, federated.FedConfig(**kw), ctrain,
                                   ctest, device="cpu", **(draws or {}))


def _paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
    elif tree is not None:
        out[prefix] = tree
    return out


def _assert_history_close(ref, out, other=None):
    """tests/test_faults.py::_assert_history_close's contract: identical
    fault outcomes and byte ledgers, loss within 1e-4, accuracies within
    1e-3, states within 5e-4.  ``other`` is the port's run on its other
    path (loop or vmap), another valid f32 order of the same sums.  An
    element on which the port's two paths themselves part by more than
    1e-4 (every other element parts by under 1e-5) is one whose gradient
    lies near AdamW's eps: a fresh optimizer's first step moves it by
    lr·g/(|g|+eps), so f32 noise in g moves it by up to lr.  At most two
    such elements are allowed, each held to lr·local_steps, one round of
    steps."""
    assert len(ref["history"]) == len(out["history"])
    for a, b in zip(ref["history"], out["history"]):
        assert (a.sampled, a.participants, a.failed, a.rejected) == \
            (b.sampled, b.participants, b.failed, b.rejected)
        assert (a.uplink_bytes, a.downlink_bytes, a.uplink_elems) == \
            (b.uplink_bytes, b.downlink_bytes, b.uplink_elems)
        assert abs(a.train_loss - b.train_loss) < 1e-4
        np.testing.assert_allclose(a.accs, b.accs, atol=1e-3)
    reach = RUN["lr"] * RUN["local_steps"]
    n_loose = 0
    for i, (s_ref, s_out) in enumerate(zip(ref["states"], out["states"])):
        want, got = _paths(jax.tree.map(_np, s_ref)), _paths(s_out)
        alt = _paths(other["states"][i])
        assert want.keys() == got.keys() == alt.keys()
        for k, v in want.items():
            g = _np(got[k])
            loose = np.abs(g - _np(alt[k])) > 1e-4
            n_loose += int(loose.sum())
            err = np.abs(g - v)
            assert (err <= np.where(loose, reach, 5e-4)).all(), \
                f"{k}: {float(err.max())} (loose: {int(loose.sum())})"
    assert n_loose <= 2, f"{n_loose} elements part between loop and vmap"


def _port_storm(setup, name, mode):
    memo = setup[4]
    if (name, mode) not in memo:
        kw = {**RUN, **JAX_RUNS[name], "client_parallelism": mode}
        memo[name, mode] = _port_run(setup, kw, _draws(setup[0], kw))
    return memo[name, mode]


@pytest.mark.parametrize("mode", ["loop", "vmap"])
@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_storm_matches_jax_loop_path(setup, name, mode):
    ref = _jax_run(setup, name)
    hist = ref["history"]
    assert any(r.failed for r in hist) and any(r.rejected for r in hist)
    other = "vmap" if mode == "loop" else "loop"
    _assert_history_close(ref, _port_storm(setup, name, mode),
                          _port_storm(setup, name, other))


@pytest.mark.parametrize("mode", ["loop", "vmap"])
def test_zero_fault_config_is_bitwise_the_default(setup, mode):
    kw = dict(RUN, seed=3, rounds=2, local_steps=1, client_parallelism=mode)
    ref = _port_run(setup, kw)
    out = _port_run(setup, dict(kw, fault_crash=0.0, fault_loss=0.0,
                                fault_corrupt=0.0, fault_divergent=0.0,
                                fault_corrupt_mode="bitflip",
                                admission="none"))
    for a, b in zip(ref["history"], out["history"]):
        assert (a.train_loss, a.accs, a.uplink_bytes, a.rejected,
                a.failed) == (b.train_loss, b.accs, b.uplink_bytes, [], [])
    for s_ref, s_out in zip(ref["states"], out["states"]):
        want, got = _paths(s_ref), _paths(s_out)
        assert want.keys() == got.keys()
        assert all(torch.equal(want[k], got[k]) for k in want)


def test_norm_gate_catches_a_divergent_upload(setup):
    """A divergent fit ships a finite but huge payload, which only the
    norm gate can catch; the history stays finite."""
    out = _port_run(setup, dict(RUN, seed=2, rounds=2, fault_divergent=0.3,
                                admission="norm", client_parallelism="vmap"))
    assert [c for r in out["history"] for c in r.rejected]
    for r in out["history"]:
        assert not r.failed and np.isfinite(r.train_loss)
        assert np.all(np.isfinite(r.accs))
