"""``repro_torch.core.adapter_bank.export_bank``: the stacked tri-LoRA bank
of a federated checkpoint, on the CPU.

* A checkpoint the JAX package wrote (its ``random_bank`` on the tiny
  config, saved by its ``ckpt.save`` under ``state/adapter`` with
  ``n_clients`` in the metadata) exports the JAX ``export_bank``'s bank,
  leaf for leaf and bit for bit.
* Four doctored checkpoints (no metadata, metadata without
  ``n_clients``, no adapter subtree, a stale ``n_clients``) are refused
  with the JAX package's messages, word for word.
* The port's own scan runs on the device and host client stores export
  the same bank (within the JAX test's 5e-4), trained (B ≠ 0) and with
  distinct rows; for every row, decoding with the row factored and with
  it merged into W (paper eqn. 10) gives the same tokens, and
  ``ServeEngine`` over the bank gives ``serve_naive``'s tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import adapter_bank as jbank
from repro.models.config import ModelConfig as JConfig
from repro_torch.checkpoint import ckpt
from repro_torch.core import adapter_bank, tri_lora
from repro_torch.core.fed_model import FedTask
from repro_torch.core.federated import FedConfig, run_federated
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 4
STORES = ("device", "host")


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


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A bank checkpoint written by the JAX package: 3 layers of a 2-block
    pattern, so the bank has a stacked group and a tail block (wq alone
    adapted, to keep the JAX draw's compile short).  An EF carry of
    another value sits beside it, which the export must not read."""
    jcfg = JConfig(**{**TINY, "n_layers": 3, "lora_targets": ("wq",),
                      "layer_pattern": ("attn", "attn")})
    tree = jax.jit(lambda k: jbank.random_bank(jcfg, M, k).tree)(
        jax.random.key(5))
    path = str(tmp_path_factory.mktemp("jax_bank") / "bank.npz")
    jckpt.save(path, {"state": {"adapter": tree,
                                "ef": jax.tree.map(lambda x: x * 0 + 7,
                                                   tree)}},
               metadata={"n_clients": M, "engine": "scan"})
    return path


def test_exports_a_jax_checkpoint_as_jax_does(jax_ckpt):
    want = jbank.export_bank(jax_ckpt)
    got = adapter_bank.export_bank(jax_ckpt, device="cpu")
    assert (got.n_clients, got.rank, got.users) == \
        (want.n_clients, want.rank, want.users)
    assert got.tree["groups"] is not None and len(got.tree["tail"]) == 1
    w, g = _paths(jax.tree.map(np.asarray, want.tree)), _paths(got.tree)
    assert w.keys() == g.keys() and len(g) > 0
    for k, t in g.items():
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), w[k], err_msg=k)


def _doctored(tmp_path, sub):
    """The four checkpoints the JAX test refuses, written by the port."""
    cases = {
        "no_meta": ({"state": {"adapter": sub}}, None),
        "pre15": ({"state": {"adapter": sub}},
                  {"rounds_done": 2, "engine": "scan"}),
        "empty": ({"state": {"loss": np.zeros(2, np.float32)}},
                  {"n_clients": M}),
        "stale": ({"state": {"adapter": sub}}, {"n_clients": 7}),
    }
    out = {}
    for name, (tree, meta) in cases.items():
        out[name] = str(tmp_path / f"{name}.npz")
        ckpt.save(out[name], tree, metadata=meta)
    return out


@pytest.mark.parametrize("case", ["no_meta", "pre15", "empty", "stale"])
def test_doctored_checkpoints_rejected_as_jax(jax_ckpt, tmp_path, case):
    sub = ckpt.load_subtree(jax_ckpt, "state/adapter")
    path = _doctored(tmp_path, sub)[case]
    with pytest.raises(ValueError) as want:
        jbank.export_bank(path)
    with pytest.raises(ValueError) as got:
        adapter_bank.export_bank(path, device="cpu")
    assert str(got.value) == str(want.value)
    key = {"no_meta": "n_clients", "pre15": "n_clients",
           "empty": "state/adapter", "stale": "n_clients=7"}[case]
    assert key in str(got.value)


def test_user_ids_and_lookup(jax_ckpt):
    bank = adapter_bank.export_bank(jax_ckpt, [f"u{i}" for i in range(M)],
                                    device="cpu")
    assert bank.lookup("u2") == 2
    assert bank.rows(["u1", None, "u0"]).tolist() == [1, -1, 0]
    with pytest.raises(KeyError, match="no adapter bank row"):
        bank.lookup("nobody")
    with pytest.raises(ValueError, match="user_ids"):
        adapter_bank.export_bank(jax_ckpt, ["only-one"], device="cpu")


# ---------------------------------------------------------------------------
# the port's own federated checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fed_ckpts(tmp_path_factory):
    """One short celora run on the scan engine per client store, each
    checkpointed."""
    cfg = ModelConfig(**TINY)
    ctrain, ctest, _ = synthetic.make_federated_classification(
        0, M, 40, 12, 16, cfg.vocab_size, CLASSES, drift=0.5)
    task = FedTask.create(torch.Generator().manual_seed(0), cfg, CLASSES)
    root = tmp_path_factory.mktemp("bank_ckpts")
    paths = {}
    for store in STORES:
        paths[store] = str(root / f"{store}.npz")
        fed = FedConfig(method="celora", n_clients=M, rounds=2,
                        local_steps=2, batch_size=8, lr=1e-2, engine="scan",
                        client_store=store, chunk_rounds=2,
                        use_data_sim=False, cka_probes=8,
                        checkpoint_path=paths[store])
        run_federated(task, fed, ctrain, ctest, device="cpu")
    return task, paths


def test_export_identical_across_stores(fed_ckpts):
    task, paths = fed_ckpts
    banks = {s: adapter_bank.export_bank(p, device="cpu")
             for s, p in paths.items()}
    for b in banks.values():
        assert b.n_clients == M and b.rank == task.cfg.lora_rank
        assert sorted(b.users) == [f"client-{i}" for i in range(M)]
    ref, host = _paths(banks["device"].tree), _paths(banks["host"].tree)
    assert ref.keys() == host.keys()
    for k in ref:
        np.testing.assert_allclose(host[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=5e-4, err_msg=k)


def test_exported_bank_is_trained_and_distinct(fed_ckpts):
    _, paths = fed_ckpts
    bank = adapter_bank.export_bank(paths["device"], device="cpu")
    ads = [a for a in tree_leaves(bank.tree, is_leaf=tri_lora.is_adapter)
           if tri_lora.is_adapter(a)]
    assert ads and all(float(ad["B"].abs().max()) > 0 for ad in ads)
    r0, r1 = tree_leaves(bank.row(0)), tree_leaves(bank.row(1))
    assert any(not torch.allclose(a, b) for a, b in zip(r0, r1))


def test_merged_matches_factored_decode_per_row(fed_ckpts):
    """Eqn. 10 both ways, for every row; then the batched engine over the
    whole bank against the merged-weights baseline."""
    task, paths = fed_ckpts
    cfg = task.cfg
    bank = adapter_bank.export_bank(paths["device"], device="cpu")
    sc = cfg.lora_alpha / cfg.lora_rank
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 3))
    for i in range(M):
        factored = serve.generate(cfg, {"base": task.base,
                                        "adapter": bank.row(i)},
                                  prompts, 4, device="cpu")
        merged = serve.generate(cfg, {"base": bank.merged_base(task.base, i,
                                                               sc),
                                      "adapter": model.no_adapter(cfg)},
                                prompts, 4, device="cpu")
        assert torch.equal(factored, merged), i
    reqs = serve.make_requests(bank, 6, prompt_len=3, gen=3,
                               vocab=cfg.vocab_size, seed=1)
    eng = serve.ServeEngine(cfg, task.base, bank, slots=3, max_len=8,
                            device="cpu")
    got = eng.run(reqs)
    want = serve.serve_naive(cfg, task.base, bank, reqs, device="cpu")
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert len({r.user_id for r in reqs}) > 1
