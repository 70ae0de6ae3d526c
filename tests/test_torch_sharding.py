"""The port's launch layer on one node (``repro_torch.launch.mesh``,
``sharding`` and ``dryrun``) on the CPU.

* The sharding rules against the JAX package's on both production meshes
  (``jax.sharding.AbstractMesh``, as ``tests/test_sharding_specs.py``
  builds them): for every assigned architecture, ``param_specs`` (FSDP on
  and off), ``cache_specs`` of both decode shapes and ``batch_specs`` of
  all four shapes equal JAX's, leaf by leaf, matched by path.
* The meshes: the production layouts, the client mesh's divisor rule on
  emulated devices, ``shard_clients`` / ``join_clients``, and
  ``to_placements``.
* The dry run in-process: the records of ``fed-100m`` at ``train_4k`` on
  the 16×16 mesh and of its federated round step on 2×16×16 (the JAX
  keys, the device counts, the per-device argument bytes against a sum by
  hand), and its FLOP count — traced on ``meta``, extrapolated over depth
  — equal to the count of the same steps on real CPU tensors at a reduced
  config.
"""
import json

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro.configs import ASSIGNED as JASSIGNED
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.mesh import batch_axes as jbatch_axes
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun, mesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.models.config import get_config
from repro_torch.tree import tree_leaves, tree_map_with_path
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


def _jax_mesh(shape, names):
    try:
        return AbstractMesh(shape, names)
    except TypeError:                      # jax 0.4.x
        return AbstractMesh(tuple(zip(names, shape)))


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            tuple(s) for p, s in flat}


def _port_specs(tree, path=()) -> dict:
    if isinstance(tree, mesh.PartitionSpec):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:                                  # None: no leaf, as in JAX
        return {}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, path + (str(k),)))
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_match_jax(arch):
    assert tuple(ASSIGNED) == tuple(JASSIGNED)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams, params = jmodel.abstract_params(jcfg), model.abstract_params(cfg)
    caches = {s: (jsteps.abstract_cache(jsteps.shape_variant(jcfg, s), s),
                  steps.abstract_cache(steps.shape_variant(cfg, s), s))
              for s in ("decode_32k", "long_500k")}
    batches = {s: (jsteps.input_specs(jcfg, s), steps.input_specs(cfg, s))
               for s in steps.SHAPES}
    for shape, names, multi_pod in MESHES.values():
        jmesh = _jax_mesh(shape, names)
        pmesh = mesh.make_production_mesh(multi_pod=multi_pod)
        assert pmesh.shape == dict(jmesh.shape) and pmesh.abstract
        assert mesh.batch_axes(pmesh) == jbatch_axes(jmesh)
        pairs = [(jshd.param_specs(jparams, jmesh, jcfg, fsdp=f),
                  shd.param_specs(params, pmesh, cfg, fsdp=f))
                 for f in (True, False)]
        baxes = mesh.batch_axes(pmesh)
        for s, (jc, pc) in caches.items():
            pairs.append((jshd.cache_specs(jc, jmesh, jcfg, baxes),
                          shd.cache_specs(pc, pmesh, cfg, baxes)))
        for s, (jb, pb) in batches.items():
            pairs.append((jshd.batch_specs(jb, jmesh, baxes),
                          shd.batch_specs(pb, pmesh, baxes)))
        for want, got in pairs:
            assert _port_specs(got) == _jax_specs(want)


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------

def test_meshes_and_placements():
    single = mesh.make_production_mesh()
    assert (single.shape, single.size) == ({"data": 16, "model": 16}, 256)
    multi = mesh.make_production_mesh(multi_pod=True)
    assert (multi.shape["pod"], multi.size) == (2, 512)
    host = mesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and not host.abstract
    cpu = [torch.device("cpu")] * 4
    assert mesh.make_client_mesh(8, cpu).size == 4
    assert mesh.make_client_mesh(6, cpu).size == 3     # largest divisor
    assert mesh.make_client_mesh(7, cpu).size == 1
    assert mesh.make_client_mesh(None, cpu).size == 4
    # shard / join: d row blocks, joined back bitwise
    tree = {"a": torch.arange(24.0).reshape(8, 3), "t": (torch.ones(8, 2),)}
    cm = mesh.make_client_mesh(8, cpu)
    blocks = mesh.shard_clients(cm, tree)
    assert [b["a"].shape[0] for b in blocks] == [2] * 4
    assert torch.equal(mesh.join_clients(blocks, "cpu")["a"], tree["a"])
    one = mesh.shard_clients(mesh.make_client_mesh(8, cpu[:1]), tree)
    assert one[0]["a"] is tree["a"]                 # d = 1: no copy
    specs = mesh.client_axis_sharding(cm, tree)
    assert specs == {"a": ("clients", None), "t": (("clients", None),)}
    # placements per mesh axis
    assert shd.to_placements(mesh.PartitionSpec("data", None), single) == (
        Shard(0), Replicate())
    assert shd.to_placements(mesh.PartitionSpec(None, "model"), single) == (
        Replicate(), Shard(1))
    assert shd.to_placements(mesh.PartitionSpec(("pod", "data"), None),
                             multi) == (Shard(0), Shard(0), Replicate())
    assert shd.shard_factor(mesh.PartitionSpec(("pod", "data"), "model"),
                            multi) == 512


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _hand_bytes(cfg, params, opt_state, batch) -> int:
    """fed-100m's train_4k arguments per device on 16×16, by its shapes:
    every base matrix and the embedding split 256 ways (all its dims
    divide 16), A over ``data``, B and the stacked (layers, D) norm scales
    over ``model`` (16 ways), C and the final norm whole, the optimizer's
    moments as their adapter leaves, the batch over ``data``."""
    def one(path, t):
        name = str(path[-1])
        n = t.numel() * t.element_size()
        if t.dim() <= 1 or name == "C":
            return n
        if name in ("A", "B", "scale"):
            return n // 16
        return n // 256
    total = [0]

    def add(path, t):
        if isinstance(t, torch.Tensor):
            total[0] += one(path, t)
    for tree in (params, opt_state):
        tree_map_with_path(add, tree)
    total[0] += sum(t.numel() * t.element_size() // 16
                    for t in tree_leaves(batch))
    return total[0]


def test_dryrun_records(tmp_path):
    rec = dryrun.lower_combo("fed-100m", "train_4k", multi_pod=False,
                             art_dir=str(tmp_path))
    with open(tmp_path / "16x16" / "fed-100m__train_4k.json") as f:
        assert json.load(f) == rec
    assert {"arch", "variant", "shape", "mesh", "layout", "fed",
            "n_devices", "trace_s"} <= rec.keys()
    assert (rec["mesh"], rec["layout"], rec["fed"], rec["n_devices"],
            rec["attn_impl"]) == ("16x16", "mixed", False, 256, "ref")
    cfg = get_config("fed-100m")
    params = model.abstract_params(cfg)
    opt_state = steps.make_train_step(cfg).optimizer.init(params["adapter"])
    assert rec["memory"]["argument_size_in_bytes"] == _hand_bytes(
        cfg, params, opt_state, steps.input_specs(cfg, "train_4k"))
    assert rec["traced"] == [[1, 1], [2, 1]] and rec["cost"]["flops"] > 0

    fed = dryrun.lower_combo("fed-100m", "train_4k", multi_pod=True,
                             fed=True, art_dir=None)
    assert (fed["mesh"], fed["fed"], fed["n_devices"]) == ("2x16x16", True,
                                                           512)
    # the federated step is the train step with one client per pod (the
    # same matmuls over the same global batch) plus the C-bar einsum,
    # 2 · n_pods² · Σ|C| multiply-adds
    c_numel = sum(a["C"].numel() for a in tree_leaves(
        params["adapter"], is_leaf=lambda x: isinstance(x, dict)
        and "C" in x) if isinstance(a, dict))
    assert fed["cost"]["flops"] == rec["cost"]["flops"] + 2 * 4 * c_numel
    with pytest.raises(ValueError, match="pod axis"):
        dryrun.lower_combo("fed-100m", "train_4k", multi_pod=False,
                           fed=True, art_dir=None)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "fed"])
def test_dryrun_flops_match_real_tensors(kind):
    """``step_flops`` on ``meta`` (a 4-layer stack traced at 1 and 2
    layers, extrapolated) equals ``FlopCounterMode`` on the same step run
    on real CPU tensors at full depth."""
    cfg = get_config("fed-100m").reduced().with_overrides(n_layers=4)
    b, s = 4, 32
    kw = {}
    if kind == "fed":
        kw["mesh"] = mesh.make_production_mesh(multi_pod=True)

    def inputs(c, real: bool):
        if real:
            params = model.init_params(c, torch.Generator().manual_seed(0))
            toks = torch.randint(0, c.vocab_size, (b, s + 1),
                                 generator=torch.Generator().manual_seed(1))
        else:
            params = model.abstract_params(c)
            toks = torch.empty((b, s + 1), dtype=torch.int64, device="meta")
        dev = toks.device
        if kind == "decode":
            return {"params": params,
                    "batch": {"token": toks[:, :1],
                              "positions": torch.zeros((b, 1),
                                                       dtype=torch.int32,
                                                       device=dev)},
                    "cache": model.init_decode_cache(c, b, s, device=dev)}
        batch = {"tokens": toks[:, :-1]}
        if kind != "prefill":
            batch["labels"] = toks[:, 1:]
        return {"params": params, "batch": batch}

    meta, traced = dryrun.step_flops(cfg, kind, lambda c: inputs(c, False),
                                     **kw)
    assert traced == [[1, 1], [2, 1]]
    real = dryrun.trace_flops(cfg, kind, inputs(cfg, True), **kw)
    assert meta == real > 0


def test_dryrun_cli(tmp_path, capsys):
    assert dryrun.main(["--arch", "fed-100m", "--shape", "decode_32k",
                        "--no-hlo", "--out-dir", str(tmp_path)]) == 0
    assert "1/1 combos traced" in capsys.readouterr().out
    rec = json.loads((tmp_path / "16x16" / "fed-100m__decode_32k.json")
                     .read_text())
    assert rec["layout"] == "replicated-data" and rec["cost"]["flops"] > 0
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--out-dir", str(tmp_path)]) == 1
