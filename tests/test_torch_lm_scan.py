"""The port's LM driver on the scan engine (``launch.train.run`` with
``engine="scan"``) on the CPU: against the JAX package's LM scan path
(celora, int8, 2 clients, 2 rounds in chunks of 1, its draws handed to the
port) with the JAX package's contract — identical participant and byte
ledgers, loss within 1e-4, adapters within 5e-4 — then kill-and-resume
bitwise against the uninterrupted run, the fingerprint's refusal, the
chunk program bitwise against round-by-round dispatch, and the CLI."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import tri_lora as jtri_lora
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import checkpoint, convert
from repro_torch.core import jit_cache
from repro_torch.launch import train
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

RUN = dict(arch="fed-100m", reduced=True, clients=2, rounds=2,
           local_steps=2, batch=2, seq=32, lr=3e-3, seed=5, method="celora",
           uplink_codec="int8", client_parallelism="vmap", engine="scan",
           chunk_rounds=1)
LEDGER = ("round", "participants", "uplink_bytes", "downlink_bytes",
          "uplink_floats")


def _jax_draws(kw):
    """The JAX driver's draws: backbone, client adapters, CKA probes and
    the codec's uniforms per (round, client)."""
    seed, m = kw["seed"], kw["clients"]
    cfg = jget_config(kw["arch"]).reduced()
    base = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.key(seed))["base"])
    adapters = [jax.tree.map(np.asarray, jmodel.init_params(
        cfg, jax.random.key(seed + i))["adapter"]) for i in range(m)]
    probes = np.array(jax.random.normal(jax.random.key(seed + 99),
                                        (32, cfg.lora_rank), jnp.float32))
    codec = jcompress.get_codec(kw["uplink_codec"])
    sizes = [int(np.prod(np.shape(l))) for l in
             jax.tree.leaves(jtri_lora.tree_payload(adapters[0]))]

    def uniforms(rnd, i):
        keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                len(sizes))
        return [torch.from_numpy(np.array(jax.random.uniform(
            k, (-(-n // jcompress._leaf_tile(n, codec.pack)),
                jcompress._leaf_tile(n, codec.pack)))))
            for n, k in zip(sizes, keys)]
    return dict(base=convert.params_from_numpy(base, "cpu"),
                init_adapters=[convert.params_from_numpy(a, "cpu")
                               for a in adapters],
                cka_probes=torch.from_numpy(probes), sr_uniforms=uniforms)


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


def test_lm_scan_matches_jax_scan(tmp_path):
    ref = jtrain.run(**RUN, verbose=False)
    out = train.run(**RUN, device="cpu", verbose=False,
                    ckpt=str(tmp_path / "lm.npz"), **_jax_draws(RUN))
    assert len(out["history"]) == len(ref["history"]) == RUN["rounds"]
    for a, b in zip(ref["history"], out["history"]):
        assert [a[k] for k in LEDGER] == [b[k] for k in LEDGER]
        assert abs(a["loss"] - b["loss"]) < 1e-4
        assert b["host_s"] >= 0.0 and b["device_s"] > 0.0
    for j, t in zip(ref["adapters"], out["adapters"]):
        want, got = _paths(jax.tree.map(np.asarray, j)), _paths(t)
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=5e-4,
                                       err_msg=k)
    meta = checkpoint.metadata(str(tmp_path / "lm.npz"))
    assert {k: meta[k] for k in ("rounds_done", "engine", "method",
                                 "clients", "seed", "uplink_codec",
                                 "client_store", "attn_impl")} == {
        "rounds_done": 2, "engine": "scan", "method": "celora",
        "clients": 2, "seed": 5, "uplink_codec": "int8",
        "client_store": "device", "attn_impl": "auto"}


#: the port-only jobs: smaller, 3 rounds
PORT = dict(RUN, rounds=3, local_steps=1, seq=16, participation=0.5)


def _strip(hist):
    return [{k: v for k, v in r.items()
             if k not in ("wall_s", "host_s", "device_s")} for r in hist]


def test_lm_kill_and_resume_is_bitwise(tmp_path):
    path = str(tmp_path / "lm.npz")
    full = train.run(**PORT, device="cpu", verbose=False)
    train.run(**dict(PORT, rounds=2), ckpt=path, device="cpu",
              verbose=False)
    resumed = train.run(**PORT, ckpt=path, resume=True, device="cpu",
                        verbose=False)
    assert _strip(full["history"]) == _strip(resumed["history"])
    for a, b in zip(full["adapters"], resumed["adapters"]):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    assert os.listdir(tmp_path) == ["lm.npz"]
    with pytest.raises(ValueError, match="different run configuration"):
        train.run(**dict(PORT, seed=6), ckpt=path, resume=True,
                  device="cpu", verbose=False)


def test_chunk_program_equals_round_by_round_dispatch(monkeypatch):
    """The chunk program (on the CPU the chunk function) against the
    rounds dispatched one by one, plain (chunks of one round under
    ``disable_jit``): bitwise; a run builds one program a chunk length,
    and a program's returned adapters are the run's own."""
    jit_cache.clear_all()
    built, program = [], jit_cache.program

    def counted(fn, args, donate_argnums=()):
        built.append(getattr(fn, "__name__", ""))
        return program(fn, args, donate_argnums)
    monkeypatch.setattr(jit_cache, "program", counted)
    out = train.run(**dict(PORT, chunk_rounds=2), device="cpu",
                    verbose=False)
    assert built.count("chunk_fn") == 2         # chunks of 2 and of 1
    with jit_cache.disable_jit():
        ref = train.run(**dict(PORT, chunk_rounds=1), device="cpu",
                        verbose=False)
    assert _strip(out["history"]) == _strip(ref["history"])
    for a, b in zip(out["adapters"], ref["adapters"]):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    jit_cache.clear_all()


def test_cli_scan_engine_on_the_cpu(capsys, tmp_path):
    argv = ["--arch", "fed-100m", "--reduced", "--clients", "2",
            "--rounds", "2", "--local-steps", "1", "--batch", "2", "--seq",
            "16", "--engine", "scan", "--chunk-rounds", "1",
            "--uplink-codec", "int8", "--ckpt", str(tmp_path / "s.npz"),
            "--device", "cpu"]
    out = train.main(argv)
    assert len(out["history"]) == 2 and out["history"][0]["uplink_bytes"]
    assert checkpoint.metadata(str(tmp_path / "s.npz"))["rounds_done"] == 2
    again = train.main(argv[:6] + ["3"] + argv[7:] + ["--resume",
                                                      "--no-prefetch"])
    assert _strip(again["history"][:2]) == _strip(out["history"])
    assert "over 3 rounds" in capsys.readouterr().out
