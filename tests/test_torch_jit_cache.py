"""The port's program cache (``repro_torch.core.jit_cache``) on the CPU.

Its ``JitCache`` against the JAX package's (``repro.core.jit_cache``) on
the same scripted calls; ``run_federated`` and the LM driver getting their
fit and eval through ``JitCache``s anchored on the task's backbone and
config; a run under ``disable_jit`` against the cached run; and the CUDA
graph program's launch accounting, static buffers and clones, and its
donated arguments (the caller's tensors as buffers, copied in only when
another tensor comes, returned aliased, kept by ``client_batch.release``)
and nested programs, driven through a stand-in for ``torch.cuda``'s graph
API (the real capture runs on the card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``'s ``train_graph``, ``decode_graph`` and
``scan_graph``).  On the CPU a program is the function itself, so the
runs are compared bitwise.
"""
import contextlib
import gc

import numpy as np
import pytest
import torch

from repro.core.jit_cache import JitCache as JJitCache
from repro_torch.core import client_batch, federated, jit_cache
from repro_torch.core.fed_model import FedTask
from repro_torch.core.jit_cache import JitCache
from repro_torch.data import synthetic
from repro_torch.kernels.tri_lora import ops as tl_ops
from repro_torch.core.adapter_bank import random_bank
from repro_torch.launch import serve, train
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(method="celora", n_clients=M, rounds=2, local_steps=1,
           batch_size=4, lr=1e-2, seed=0, feature_samples=16, cka_probes=8,
           gmm_iters=3)
LM = dict(arch="fed-100m", reduced=True, clients=2, rounds=2, local_steps=1,
          batch=2, seq=16, method="celora", uplink_codec="int8",
          verbose=False, device="cpu")


@pytest.fixture(scope="module")
def data():
    ctrain, ctest, _ = synthetic.make_federated_classification(
        0, M, 24, 8, 16, TINY["vocab_size"], CLASSES, drift=0.8)
    return ctrain, ctest


def _task(seed: int = 0) -> FedTask:
    return FedTask.create(torch.Generator().manual_seed(seed),
                          ModelConfig(**TINY), CLASSES)


def _run(task, data, **kw):
    return federated.run_federated(task, federated.FedConfig(**{**FED, **kw}),
                                   *data, device="cpu")


def _sizes() -> tuple:
    return len(federated._LOCAL_FIT_CACHE), len(federated._EVAL_CACHE)


# ------------------------------------------------ JitCache against the JAX one

def _script_distinct(cache_cls):
    cache = cache_cls(maxsize=8)
    a, b = {"w": np.zeros(3)}, {"w": np.zeros(3)}
    return [cache.get_or_build((a,), ("k",), lambda: "a"),
            cache.get_or_build((b,), ("k",), lambda: "b"), len(cache),
            cache.get_or_build((a,), ("k",), lambda: "rebuilt"),
            cache.get_or_build((a,), ("other",), lambda: "a2"), len(cache)]


def _script_eviction(cache_cls):
    cache = cache_cls(maxsize=3)
    anchors = [({"i": i},) for i in range(5)]
    out = [cache.get_or_build(anc, (), lambda i=i: i)
           for i, anc in enumerate(anchors)]
    out += [len(cache), cache.get_or_build(anchors[4], (), lambda: "re"),
            cache.get_or_build(anchors[2], (), lambda: "re"),
            cache.get_or_build(anchors[0], (), lambda: "re"),
            # anchors[2] was used last before 0 came back: 3 is the LRU
            cache.get_or_build(anchors[3], (), lambda: "re"), len(cache)]
    cache.clear()
    return out + [len(cache)]


def _script_stale_id(cache_cls):
    """Build for A, drop A, churn new objects until ids recycle: every
    lookup is answered by its own build, never A's; then an entry whose
    kept anchor is not the object with its id (the collision the identity
    re-check guards) is dropped and rebuilt."""
    cache = cache_cls(maxsize=2)
    a = {"w": np.zeros(3)}
    out = [cache.get_or_build((a,), ("k",), lambda: "A's program")]
    del a
    gc.collect()
    for i in range(200):
        obj = {"w": np.zeros(3)}
        out.append(cache.get_or_build((obj,), ("k",), lambda i=i: i))
        del obj             # freed at once: its id is free for the next
    obj, other = {"w": np.zeros(3)}, {"w": np.zeros(3)}
    cache._entries[((id(obj),), ("k",))] = ("stale", (other,))
    out.append(cache.get_or_build((obj,), ("k",), lambda: "rebuilt"))
    return out + [len(cache)]


def _script_maxsize(cache_cls):
    with pytest.raises(ValueError, match="maxsize"):
        cache_cls(maxsize=0)
    return [len(cache_cls(maxsize=1))]


@pytest.mark.parametrize("script", [_script_distinct, _script_eviction,
                                    _script_stale_id, _script_maxsize],
                         ids=["distinct", "eviction", "stale_id", "maxsize"])
def test_jit_cache_behaves_call_for_call_like_jax(script):
    """The counterparts of every case of tests/test_jit_cache.py: the same
    hits, misses, evictions and sizes from the port's cache and the JAX
    package's on one scripted sequence of calls."""
    got, want = script(JitCache), script(JJitCache)
    assert got == want
    if script is _script_stale_id:
        assert got[1:201] == list(range(200)) and got[201] == "rebuilt"


def test_program_caches_are_jit_caches():
    assert isinstance(federated._LOCAL_FIT_CACHE, JitCache)
    assert isinstance(federated._EVAL_CACHE, JitCache)
    assert isinstance(train._FIT_CACHE, JitCache)


def test_clear_all_empties_every_cache():
    cache = JitCache(maxsize=2)
    cache.get_or_build((object(),), (), lambda: 1)
    jit_cache.clear_all()
    assert len(cache) == 0 and _sizes() == (0, 0)


# ------------------------------------------------ run_federated's programs

def test_two_live_tasks_never_share_an_entry(data):
    """Two tasks of one config, with equal shapes and hyperparameters,
    get their own fit and eval programs."""
    jit_cache.clear_all()
    task_a, task_b = _task(0), _task(1)
    _run(task_a, data, rounds=1)
    assert _sizes() == (1, 1)
    _run(task_b, data, rounds=1)
    assert _sizes() == (2, 2)


@pytest.mark.parametrize("kw", [dict(), dict(attn_impl="ref")],
                         ids=["task_impl", "impl_override"])
def test_a_second_run_on_the_task_builds_nothing(data, kw):
    """Also when FedConfig.attn_impl overrides the task's (run_federated
    then makes a new config object each call: the programs are anchored
    on the caller's)."""
    jit_cache.clear_all()
    task = _task()
    first = _run(task, data, **kw)
    built, sizes = jit_cache.STATS["programs"], _sizes()
    second = _run(task, data, **kw)
    assert jit_cache.STATS["programs"] == built and _sizes() == sizes
    assert [r.train_loss for r in first["history"]] == \
        [r.train_loss for r in second["history"]]


@pytest.mark.parametrize("change", [dict(local_steps=2), dict(n_clients=3),
                                    dict(client_parallelism="loop"),
                                    dict(client_parallelism="shard")],
                         ids=["local_steps", "clients", "loop", "shard"])
def test_a_changed_key_builds_a_new_fit(data, change):
    jit_cache.clear_all()
    task = _task()
    _run(task, data, rounds=1)
    fits = len(federated._LOCAL_FIT_CACHE)
    d = data if "n_clients" not in change else tuple(x[:3] for x in data)
    _run(task, d, rounds=1, **change)
    assert len(federated._LOCAL_FIT_CACHE) == fits + 1


def _same_states(a, b) -> bool:
    return all(torch.equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(tree_leaves(sa), tree_leaves(sb)))


@pytest.mark.parametrize("kw", [dict(), dict(engine="scan", chunk_rounds=1),
                                dict(client_parallelism="loop")],
                         ids=["vmap", "scan", "loop"])
def test_disabled_run_equals_the_cached_run(data, kw):
    """Under disable_jit the functions run plain and build nothing; the
    cached run gives the same history and states bit for bit."""
    task = _task()
    cached = _run(task, data, **kw)
    built = jit_cache.STATS["programs"]
    with jit_cache.disable_jit():
        jit_cache.clear_all()
        plain = _run(task, data, **kw)
        assert _sizes() == (0, 0)
    assert jit_cache.STATS["programs"] == built
    assert [(r.train_loss, r.accs) for r in cached["history"]] == \
        [(r.train_loss, r.accs) for r in plain["history"]]
    assert _same_states(cached["states"], plain["states"])


def test_lm_driver_disabled_run_equals_the_cached_run():
    jit_cache.clear_all()
    cached = train.run(**LM)
    assert len(train._FIT_CACHE) == 1
    with jit_cache.disable_jit():
        plain = train.run(**LM)
    assert len(train._FIT_CACHE) == 1
    assert cached["history"][-1]["loss"] == plain["history"][-1]["loss"]
    assert [r["loss"] for r in cached["history"]] == \
        [r["loss"] for r in plain["history"]]
    assert _same_states(cached["adapters"], plain["adapters"])


# ------------------------------------------------ the graph program's plumbing

def test_static_buffers_keep_shape_strides_and_alignment():
    base = torch.arange(64, dtype=torch.float32)
    for view in (base[1:33].view(4, 8), base[3:].as_strided((4, 4), (10, 2)),
                 torch.zeros(2, 3, dtype=torch.bfloat16)[:, 1:]):
        s = jit_cache._static_like(view)
        assert (s.shape, s.stride(), s.dtype) == \
            (view.shape, view.stride(), view.dtype)
        assert s.data_ptr() % 16 == view.data_ptr() % 16
    assert jit_cache.signature((base[1:5],)) != \
        jit_cache.signature((base[4:8],))
    with pytest.raises(ValueError, match="overlaps"):
        jit_cache._static_like(torch.zeros(3)[None].expand(2, 3))
    with pytest.raises(TypeError, match="trees"):
        jit_cache.signature((object(),))


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: a replay changes nothing
    (the outputs keep the capture's values)."""

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(jit_cache, "_SIDE", {})
    tl_ops.reset_launches()
    yield
    tl_ops.reset_launches()


def _counting_fn(calls: list):
    def fn(tr, x):
        calls.append(x.data_ptr())
        tl_ops.LAUNCHES["tri_lora_fwd"] += 3
        tl_ops.ROUTES["fwd_simt"] += 3
        return {"w": tr["w"] + x}, (x * 2).sum()
    return fn


def test_graph_program_counts_replays_not_the_capture(fake_graphs):
    """The warm-up and the capture run the function (on the static
    buffers) and count nothing; each replay adds the capture's counts;
    the results are clones of the static outputs."""
    calls = []
    jit_cache.reset_stats()
    args = ({"w": torch.ones(4)}, torch.arange(4.0))
    prog = jit_cache.GraphProgram(_counting_fn(calls), args)
    assert len(calls) == 2 and args[1].data_ptr() not in calls
    assert tl_ops.LAUNCHES["tri_lora_fwd"] == 0
    assert jit_cache.STATS["graphs"] == 1
    outs = [prog(*args), prog({"w": torch.zeros(4)}, torch.ones(4))]
    assert len(calls) == 2 and jit_cache.STATS["replays"] == 2
    assert tl_ops.LAUNCHES["tri_lora_fwd"] == 6
    assert tl_ops.ROUTES == {**{k: 0 for k in tl_ops.ROUTES},
                             "fwd_simt": 6}
    # the stand-in graph never recomputes: both results are the capture's
    # outputs, each a clone of its own
    for out in outs:
        assert torch.equal(out[0]["w"], torch.tensor([1.0, 2.0, 3.0, 4.0]))
        assert out[0]["w"].data_ptr() != prog._out[0].data_ptr()
    assert outs[0][0]["w"].data_ptr() != outs[1][0]["w"].data_ptr()
    for other in (({"v": torch.ones(4)}, torch.ones(4)),
                  ({"w": torch.ones(4)}, torch.ones(1))):
        with pytest.raises(ValueError, match="signature"):
            prog(*other)


def test_a_failed_capture_raises_and_counts_nothing(fake_graphs):
    calls = []

    def fn(x):
        calls.append(1)
        tl_ops.LAUNCHES["tri_lora_dx"] += 1
        if len(calls) == 2:                   # the capture
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1
    cache = JitCache(maxsize=2)
    with pytest.raises(RuntimeError, match="capturing"):
        cache.get_or_build((cache,), (), lambda: jit_cache.GraphProgram(
            fn, (torch.ones(2),)))
    assert len(cache) == 0 and tl_ops.LAUNCHES["tri_lora_dx"] == 0


# ------------------------------------------------ donated arguments

def _carry_fn(calls: list):
    """A chunk-like program: the carry's ``w`` advances by ``x``, its
    ``frozen`` leaf comes back as it went in, and ``x * 2`` is a plain
    result."""
    def fn(carry, x):
        calls.append(1)
        tl_ops.LAUNCHES["tri_lora_fwd"] += 1
        return ({"frozen": carry["frozen"], "w": carry["w"] + x},
                x * 2)
    return fn


def _carry():
    return {"w": torch.ones(4), "frozen": torch.arange(3.0)}


def test_donated_leaves_are_the_callers_tensors(fake_graphs):
    """The static buffer of a donated leaf is the caller's tensor (a
    non-donated one gets a buffer of its own); the capture ends by copying
    the result for the argument into it (the stand-in graph runs the
    capture's copies once, on the CPU)."""
    carry, x = _carry(), torch.arange(4.0)
    w0 = carry["w"].data_ptr()
    prog = jit_cache.GraphProgram(_carry_fn([]), (carry, x),
                                  donate_argnums=(0,))
    static = {id(t) for t in prog._static}
    assert id(carry["w"]) in static and id(carry["frozen"]) in static
    assert id(x) not in static
    assert carry["w"].data_ptr() == w0
    assert torch.equal(carry["w"], torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert torch.equal(carry["frozen"], torch.arange(3.0))


def test_a_call_with_the_buffer_copies_nothing_and_another_is_copied_in(
        fake_graphs):
    calls = []
    carry, x = _carry(), torch.arange(4.0)
    prog = jit_cache.GraphProgram(_carry_fn(calls), (carry, x),
                                  donate_argnums=(0,))
    jit_cache.reset_stats()
    out, _ = prog(carry, x)
    assert jit_cache.STATS["donated_in"] == 0 and len(calls) == 2
    out, _ = prog(out, x)                     # the returned buffers again
    assert jit_cache.STATS["donated_in"] == 0
    other = {"w": torch.full((4,), 9.0), "frozen": carry["frozen"]}
    out, _ = prog(other, x)
    assert jit_cache.STATS["donated_in"] == 1   # w only: frozen is the same
    assert torch.equal(carry["w"], torch.full((4,), 9.0))
    assert out["w"].data_ptr() == carry["w"].data_ptr() != \
        other["w"].data_ptr()
    assert jit_cache.STATS["replays"] == 3
    assert tl_ops.LAUNCHES["tri_lora_fwd"] == 3


def test_donated_results_are_aliased_and_the_others_cloned(fake_graphs):
    carry, x = _carry(), torch.arange(4.0)
    prog = jit_cache.GraphProgram(_carry_fn([]), (carry, x),
                                  donate_argnums=(0,))
    (a, ya), (b, yb) = prog(carry, x), prog(carry, x)
    for out in (a, b):
        assert list(out) == ["w", "frozen"]          # the argument's tree
        assert out["w"] is carry["w"] and out["frozen"] is carry["frozen"]
    assert ya.data_ptr() != yb.data_ptr()
    assert ya.data_ptr() not in {o.data_ptr() for o in prog._out}
    assert torch.equal(ya, x * 2)


def test_a_donated_argument_needs_one_matching_result(fake_graphs):
    carry, x = _carry(), torch.arange(4.0)
    with pytest.raises(ValueError, match="donated argument 0"):
        jit_cache.GraphProgram(lambda c, y: (y, y), (carry, x),
                               donate_argnums=(0,))
    with pytest.raises(TypeError, match="tuple or a list"):
        jit_cache.GraphProgram(lambda c, y: c, (carry, x),
                               donate_argnums=(0,))
    with pytest.raises(ValueError, match="overlaps"):
        jit_cache.GraphProgram(lambda c: (c,), (torch.zeros(3).expand(2, 3),),
                               donate_argnums=(0,))


def test_a_jit_function_inside_a_capture_runs_plain(fake_graphs):
    """The warm-up and the capture call the inner jit function plain: no
    entry, no program; outside a build it is cached as usual."""
    inner_cache = JitCache(maxsize=2)
    seen = []

    def inner_fn(x):
        seen.append(1)
        return x + 1
    inner = jit_cache.jit(inner_cache, (inner_cache,), "inner", inner_fn)
    jit_cache.reset_stats()
    prog = jit_cache.GraphProgram(lambda x: inner(x) * 2, (torch.ones(3),))
    assert len(seen) == 2 and len(inner_cache) == 0
    assert jit_cache.STATS["programs"] == 0
    prog(torch.ones(3))
    assert len(seen) == 2
    inner(torch.ones(3))
    assert len(inner_cache) == 1 and jit_cache.STATS["programs"] == 1


def test_release_keeps_a_programs_buffers(fake_graphs):
    """A donated carry is the program's static buffer: releasing it as an
    old carry frees nothing and leaves it usable; once the program is gone
    the same release frees it."""
    carry, x = _carry(), torch.arange(4.0)
    prog = jit_cache.GraphProgram(_carry_fn([]), (carry, x),
                                  donate_argnums=(0,))
    new = {"w": torch.zeros(4), "frozen": torch.zeros(3)}
    assert client_batch.release(carry, new) == 0
    assert not isinstance(carry["w"], client_batch.ReleasedTensor)
    assert carry["w"].untyped_storage().nbytes() == 16
    prog(carry, x)
    kept = jit_cache.unshared(carry)
    assert kept["w"].data_ptr() != carry["w"].data_ptr()
    assert torch.equal(kept["w"], carry["w"])
    del prog
    gc.collect()
    assert jit_cache.unshared(carry)["w"] is carry["w"]
    assert client_batch.release(carry, new) == 2
    with pytest.raises(RuntimeError, match="released"):
        carry["w"] + 1


def test_a_second_decode_call_reuses_the_held_cache(fake_graphs,
                                                    monkeypatch):
    """``generate`` and ``ServeEngine.run`` called twice at the same shapes
    through graph programs (the stand-in): the second call zeroes and
    passes back the cache its program holds (``jit_cache.held``), so no
    second cache is allocated (``init_decode_cache`` runs on ``meta``
    only), none is copied in, and nothing is captured again; the engine's
    program is its own, not in ``serve._DECODE_CACHE``."""
    monkeypatch.setattr(jit_cache, "program",
                        lambda fn, args, donate_argnums=():
                        jit_cache.GraphProgram(fn, args, donate_argnums))
    made, init = [], model.init_decode_cache

    def recorded(cfg, batch, seq_len, *, device):
        made.append(str(device))
        return init(cfg, batch, seq_len, device=device)
    monkeypatch.setattr(model, "init_decode_cache", recorded)
    cfg = ModelConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(cfg, gen)
    prompts = np.arange(6, dtype=np.int32).reshape(2, 3)
    jit_cache.clear_all()
    jit_cache.reset_stats()
    serve.generate(cfg, params, prompts, 2, device="cpu")
    held = jit_cache.held(serve._DECODE_CACHE,
                          (params["base"], params["adapter"], cfg),
                          ("generate",), 0,
                          init(cfg, 2, 5, device="meta"))
    assert made == ["meta", "cpu"] and held is not None
    assert jit_cache.STATS["graphs"] == 1
    held_ptrs = [t.data_ptr() for t in tree_leaves(held)]
    with torch.inference_mode():    # the next call must start from zeros
        for t in tree_leaves(held):
            t.fill_(7)
    seen = []
    step = jit_cache.GraphProgram.__call__

    def call(prog, *args):
        seen.append([t.data_ptr() for t in tree_leaves(args[0])])
        assert all(not t.any() for t in tree_leaves(args[0]))
        return step(prog, *args)
    monkeypatch.setattr(jit_cache.GraphProgram, "__call__", call)
    serve.generate(cfg, params, prompts, 2, device="cpu")
    assert made == ["meta", "cpu", "meta"] and seen[0] == held_ptrs
    assert jit_cache.STATS["graphs"] == 1
    assert jit_cache.STATS["donated_in"] == 0
    with jit_cache.disable_jit():
        assert jit_cache.held(serve._DECODE_CACHE,
                              (params["base"], params["adapter"], cfg),
                              ("generate",), 0,
                              init(cfg, 2, 5, device="meta")) is None

    monkeypatch.setattr(jit_cache.GraphProgram, "__call__", step)
    bank = random_bank(cfg, 2, gen)
    reqs = serve.make_requests(bank, 3, prompt_len=2, gen=1,
                               vocab=cfg.vocab_size, seed=0)
    eng = serve.ServeEngine(cfg, params["base"], bank, slots=2, max_len=3,
                            device="cpu")
    made.clear()
    eng.run(reqs)
    eng.run(reqs)
    assert made == ["meta", "cpu", "meta"]
    assert len(eng._programs) == 1 and len(serve._DECODE_CACHE) == 1
    assert jit_cache.STATS["graphs"] == 2
    assert jit_cache.STATS["donated_in"] == 0
    jit_cache.clear_all()
