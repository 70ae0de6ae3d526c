"""PyTorch port of multi-tenant serving (``repro_torch.launch.serve``).

The contract: on the same params, adapter bank and request stream (drawn
by the JAX package and moved across with ``repro_torch.convert``), the
port's ``ServeEngine`` emits token-for-token what the JAX ``ServeEngine``
emits, and what the port's own merged-weights ``serve_naive`` emits.  Also:
the decode programs (``generate``'s and the engine's) emit what the plain
step emits, the request stream is the same numpy stream, and the port
imports neither ``jax`` nor the JAX package.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import adapter_bank as jbank_mod
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.core import jit_cache
from repro_torch.core.adapter_bank import random_bank
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
N_USERS = 4


@pytest.fixture(scope="module")
def both():
    """(JAX cfg, base, bank) and the port's (cfg, base, bank) — the same
    numbers."""
    jcfg = JConfig(**TINY)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jbank = jbank_mod.random_bank(jcfg, N_USERS, jax.random.key(1))
    tcfg = ModelConfig(**TINY)
    tbase = convert.params_from_numpy(jax.tree.map(np.asarray, jp["base"]),
                                      "cpu")
    tbank = convert.bank_from_numpy(jax.tree.map(np.asarray, jbank.tree),
                                    users=jbank.users, device="cpu")
    return (jcfg, jp, jbank), (tcfg, tbase, tbank)


def _same(reqs, got, want, what):
    assert set(got) == set(want) == {r.rid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                      err_msg=f"{what}: rid={r.rid}")


# idle slots / slot reuse / more slots than one 32-row group of the kernel
@pytest.mark.parametrize("n,slots", [(3, 4), (8, 4), (40, 36)])
def test_engine_matches_jax_engine_and_naive(both, n, slots):
    (jcfg, jp, jbank), (tcfg, tbase, tbank) = both
    reqs = jserve.make_requests(jbank, n, prompt_len=3, gen=4,
                                vocab=TINY["vocab_size"], seed=n)
    want = jserve.ServeEngine(jcfg, jp["base"], jbank, slots=slots,
                              max_len=7).run(reqs)
    eng = serve.ServeEngine(tcfg, tbase, tbank, slots=slots, max_len=7,
                            device="cpu")
    got = eng.run(reqs)
    _same(reqs, got, want, "port engine vs JAX engine")
    naive = serve.serve_naive(tcfg, tbase, tbank, reqs, device="cpu")
    _same(reqs, got, naive, "port engine vs port serve_naive")
    assert eng.steps > 0


def test_generate_matches_jax(both):
    (jcfg, jp, _), (tcfg, _, _) = both
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(5).integers(
        0, TINY["vocab_size"], (2, 4)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, jp, jax.numpy.asarray(prompts), 5))
    got = serve.generate(tcfg, tparams, prompts, 5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_programs_equal_the_plain_step(both):
    """``generate`` and ``ServeEngine`` through their cached decode
    programs (on the CPU the step itself) give the tokens of the plain
    step under ``disable_jit``; ``generate`` builds one program for all of
    its steps (the prompt columns and the new tokens share a signature) and
    a second call at the same shapes none; ``ServeEngine.steps`` counts
    every step taken."""
    (jcfg, jp, jbank), (tcfg, tbase, tbank) = both
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(6).integers(
        0, TINY["vocab_size"], (3, 5)).astype(np.int32)
    jit_cache.clear_all()
    got = serve.generate(tcfg, tparams, prompts, 4, device="cpu")
    assert len(serve._DECODE_CACHE) == 1
    built = jit_cache.STATS["programs"]
    again = serve.generate(tcfg, tparams, prompts, 4, device="cpu")
    assert jit_cache.STATS["programs"] == built
    with jit_cache.disable_jit():
        plain = serve.generate(tcfg, tparams, prompts, 4, device="cpu")
    assert torch.equal(got, plain) and torch.equal(again, plain)

    reqs = jserve.make_requests(jbank, 6, prompt_len=3, gen=4,
                                vocab=TINY["vocab_size"], seed=2)
    eng = serve.ServeEngine(tcfg, tbase, tbank, slots=4, max_len=7,
                            device="cpu")
    taken = []
    step = eng._step

    def counted(*args):
        taken.append(1)
        return step(*args)
    eng._step = counted
    done = eng.run(reqs)
    assert eng.steps == len(taken) > 0
    with jit_cache.disable_jit():
        plain = serve.ServeEngine(tcfg, tbase, tbank, slots=4, max_len=7,
                                  device="cpu").run(reqs)
    _same(reqs, done, plain, "engine program vs plain engine step")
    jit_cache.clear_all()


def test_make_requests_is_the_same_stream(both):
    (_, _, jbank), (_, _, tbank) = both
    for seed in (0, 7):
        a = jserve.make_requests(jbank, 9, prompt_len=5, gen=3, vocab=1000,
                                 seed=seed)
        b = serve.make_requests(tbank, 9, prompt_len=5, gen=3, vocab=1000,
                                seed=seed)
        assert [(r.rid, r.user_id, r.gen) for r in a] == \
            [(r.rid, r.user_id, r.gen) for r in b]
        for ra, rb in zip(a, b):
            assert rb.prompt.dtype == np.int32
            np.testing.assert_array_equal(ra.prompt, rb.prompt)


def test_engine_rejects_overlong_request(both):
    _, (tcfg, tbase, tbank) = both
    reqs = serve.make_requests(tbank, 1, prompt_len=6, gen=4,
                               vocab=TINY["vocab_size"], seed=0)
    eng = serve.ServeEngine(tcfg, tbase, tbank, slots=2, max_len=8,
                            device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.run(reqs)


def test_random_bank_draws_distinct_rows():
    cfg = ModelConfig(**TINY)
    bank = random_bank(cfg, 3, torch.Generator().manual_seed(0))
    b = bank.tree["groups"]["0"]["attn"]["wq"]["B"]
    assert tuple(b.shape) == (3, 2, 4, 64) and b.dtype == torch.float32
    assert not torch.equal(b[0], b[1]) and b.abs().max() > 0


# ---------------------------------------------------------------------------
# devices: CUDA by default, and no silent CPU run
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    _, (tcfg, tbase, tbank) = both
    with pytest.raises(RuntimeError, match="cuda"):
        serve.ServeEngine(tcfg, tbase, tbank)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(tcfg, {"base": tbase, "adapter": {}},
                       np.zeros((1, 2), np.int32), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve_naive(tcfg, tbase, tbank, serve.make_requests(
            tbank, 1, prompt_len=2, gen=1, vocab=8))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "fed-100m", "--reduced"])


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {**os.environ, "PYTHONPATH": ""}
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


# ---------------------------------------------------------------------------
# the port stands alone: no jax, no JAX package
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.M)


def test_port_sources_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
