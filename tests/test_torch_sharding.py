"""The port's LM sharding rules (``sharding/specs.py``) and meshes
(``launch/mesh.py``) against the reference's, on the CPU.

Every leaf of ``param_specs``, ``opt_state_specs``, ``batch_specs`` (every
applicable ``SHAPES`` entry, ``launch.specs_io.input_specs`` of each
package) and ``cache_specs`` equals the reference's on
``repro.compat.make_abstract_mesh``, for every arch of ``list_archs()``
on the production meshes and on small ones, as
``tests/test_sharding_and_roofline.py`` walks them.  ``shardings`` is
held to hand-worked DTensor placements; the DTensor paths themselves run
on gloo ranks in ``tests/test_torch_train_mesh.py``."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as RP
from torch.distributed.tensor import Replicate, Shard

from repro.compat import make_abstract_mesh as ref_mesh
from repro.configs import SHAPES, get_config as ref_config, list_archs, \
    shape_applicable
from repro.launch.specs_io import input_specs as ref_inputs
from repro.models import model as RM
from repro.sharding import specs as RS
from repro.train.optimizer import abstract_opt_state as ref_abstract_opt
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import mesh as TMesh
from repro_torch.launch.specs_io import input_specs
from repro_torch.models import model as TM
from repro_torch.sharding import context as TC
from repro_torch.sharding import specs as TS
from repro_torch.train.optimizer import abstract_opt_state

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model"))]


def _entries(spec):
    """A spec's entries with every tuple entry a plain tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _same(ref_tree, port_tree, label):
    want = jax.tree_util.tree_leaves(
        ref_tree, is_leaf=lambda x: isinstance(x, RP))
    got = tree_leaves(port_tree, is_leaf=lambda x: isinstance(
        x, TS.PartitionSpec))
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, TS.PartitionSpec), (label, i)
        assert _entries(g) == _entries(w), (label, i, g, w)
    return len(got)


@pytest.mark.parametrize("shape, axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_are_the_references(arch, shape, axes):
    """Param, optimizer-state, batch and cache specs leaf for leaf."""
    rm, tm = ref_mesh(shape, axes), TMesh.make_abstract_mesh(shape, axes)
    cr, ct = ref_config(arch), get_config(arch)
    ar, at = RM.abstract_params(cr), TM.abstract_params(ct)
    n = _same(RS.param_specs(cr, rm, ar), TS.param_specs(ct, tm, at),
              "params")
    n += _same(RS.opt_state_specs(cr, rm, ref_abstract_opt(ar)),
               TS.opt_state_specs(ct, tm, abstract_opt_state(at)), "opt")
    for name, sh in SHAPES.items():
        if not shape_applicable(cr, sh)[0]:
            continue
        r, t = ref_inputs(cr, name), input_specs(ct, name)
        n += _same(RS.batch_specs(cr, rm, r["batch"]),
                   TS.batch_specs(ct, tm, t["batch"]), f"{name} batch")
        assert ("cache" in r) == ("cache" in t)
        if "cache" in r:
            n += _same(RS.cache_specs(cr, rm, r["cache"]),
                       TS.cache_specs(ct, tm, t["cache"]), f"{name} cache")
    assert n > 0


def test_spec_rules_read_axis_names_and_sizes():
    """``mesh_shape`` reads an abstract mesh, a cell mesh and anything
    with a jax-style ``shape`` dict alike; ``dp_axes`` and
    ``mesh_axis_size`` on them."""
    m = TMesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert TS.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
    assert TS.dp_axes(m) == ("pod", "data")
    assert TS.mesh_axis_size(m, ("pod", "data")) == 32
    assert TMesh.mesh_devices(m) == 512
    cell = TMesh.make_cell_mesh(devices=["cpu"] * 3)
    assert TS.mesh_shape(cell) == {"cells": 3}
    assert TMesh.mesh_devices(cell) == 3
    with pytest.raises(ValueError):
        TMesh.make_abstract_mesh((2, 2), ("data",))


def test_production_mesh_is_abstract_without_its_ranks():
    """No process group of 256 (512) ranks is up: the production meshes
    are abstract, with the reference's names and sizes."""
    one = TMesh.make_production_mesh()
    two = TMesh.make_production_mesh(multi_pod=True)
    assert isinstance(one, TMesh.AbstractMesh)
    assert one.shape == {"data": 16, "model": 16}
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        TMesh.make_host_mesh((2, 2), ("data", "model"))


class _Mesh:
    """The two attributes of a ``DeviceMesh`` the placements read."""

    def __init__(self, shape, names):
        self.mesh = torch.empty(shape)
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec, want", [
    (("model", None), (Replicate(), Shard(0))),
    ((None, "model"), (Replicate(), Shard(1))),
    ((None, None, ("data",)), (Shard(2), Replicate())),
    (("data", "model", None), (Shard(0), Shard(1))),
    ((("data", "model"), None), (Shard(0), Shard(0))),
    ((), (Replicate(), Replicate())),
])
def test_spec_placements_by_hand(spec, want):
    """For each mesh dim, ``Shard(d)`` where that axis names tensor dim
    ``d``, else ``Replicate()``; a dim over two axes is ``Shard`` on
    both mesh dims (mesh order, major first)."""
    mesh = _Mesh((2, 2), ("data", "model"))
    got = TS.spec_placements(mesh, TS.PartitionSpec(*spec))
    assert got == want


def test_spec_placements_pod_mesh_and_order():
    mesh = _Mesh((2, 2, 2), ("pod", "data", "model"))
    spec = TS.PartitionSpec(("pod", "data"), "model")
    assert TS.spec_placements(mesh, spec) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        TS.spec_placements(mesh, TS.PartitionSpec(("data", "pod")))


def test_shardings_of_olmo_leaves():
    """olmo-1b's specs on a (2, 2) mesh as ``MeshSharding``s: vocab over
    "model" for the embedding, wq's output features, wo's input features,
    and the ZeRO moments' FSDP dim over "data" on top."""
    mesh = _Mesh((2, 2), ("data", "model"))
    cfg = get_config("olmo-1b")
    ap = TM.abstract_params(cfg)
    sh = TS.shardings(mesh, TS.param_specs(cfg, mesh, ap))
    assert sh["embedding"].placements == (Replicate(), Shard(0))
    assert sh["blocks"][0]["attn"]["wq"].placements == (Replicate(),
                                                        Shard(2))
    assert sh["blocks"][0]["attn"]["wo"].placements == (Replicate(),
                                                        Shard(1))
    assert sh["blocks"][0]["attn"]["wq"].spec == (None, None, "model")
    opt = TS.shardings(mesh, TS.opt_state_specs(cfg, mesh,
                                                abstract_opt_state(ap)))
    assert opt.m["blocks"][0]["attn"]["wq"].placements == (Shard(1),
                                                           Shard(2))
    assert opt.step.placements == (Replicate(), Replicate())


def test_activation_constraint_by_the_references_rule():
    """None without a model axis or with ``seq_shard_activations`` off;
    else it shards (B, S, d) as ``(dp, "model", None)``."""
    cfg = get_config("olmo-1b")
    assert TS.activation_constraint(
        cfg, TMesh.make_abstract_mesh((4,), ("data",))) is None
    assert TS.activation_constraint(
        cfg.replace(seq_shard_activations=False),
        TMesh.make_abstract_mesh((2, 2), ("data", "model"))) is None
    assert callable(TS.activation_constraint(
        cfg, TMesh.make_abstract_mesh((2, 2), ("data", "model"))))


def test_constraints_are_the_identity_without_a_mesh():
    """Without an active mesh, and on a plain tensor under one, each
    constraint returns its input; ``use_mesh`` is scoped and
    thread-local."""
    x = torch.randn(4, 2, 3, 8)
    assert TC.active_mesh() is None
    assert TC.constrain_expert_parallel(x) is x
    assert TC.constrain_heads(x, head_dim=2) is x
    mesh = TMesh.make_abstract_mesh((2, 2), ("data", "model"))
    with TC.use_mesh(mesh):
        assert TC.active_mesh() is mesh
        assert TC.constrain_expert_parallel(x) is x
        assert TC.constrain(x, TS.PartitionSpec("model")) is x
        import threading
        seen = []
        t = threading.Thread(target=lambda: seen.append(TC.active_mesh()))
        t.start()
        t.join()
        assert seen == [None]
    assert TC.active_mesh() is None


def test_expert_and_head_specs_are_the_references():
    """The placements the two constraints ask for on a (2, 2) mesh: the
    reference's PartitionSpecs by its own rules (experts / heads over
    "model" when divisible, groups / batch over the dp axes)."""
    mesh = TMesh.make_abstract_mesh((2, 2), ("data", "model"))
    with TC.use_mesh(mesh):
        assert TC._model_spec(torch.empty(8, 2, 4, 16), 0, 1) == \
            ("model", "data", None, None)
        assert TC._model_spec(torch.empty(8, 3, 4, 16), 0, 1) == \
            ("model", None, None, None)
        assert TC._model_spec(torch.empty(7, 2, 4, 16), 0, 1) is None
        assert TC._model_spec(torch.empty(2, 64, 4, 32), 2, 0) == \
            ("data", None, "model", None)
