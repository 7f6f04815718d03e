"""The port's logical-axis sharding against the JAX package's, in one
process and without a process group: ``spec_for`` / ``tree_sharding``
(FSDP on and off) on the parameters of the ten smoke configurations,
``batch_shardings`` and ``decode_state_shardings`` on the six meshes of
the reference's tests and production, ``Model.logical_specs`` against
``M.init``'s spec tree, the DTensor direction of a spec, the rules table,
and ``shard`` without a mesh.

The reference side runs on ``jax.sharding.AbstractMesh``; the port's on
its ``AbstractMesh`` (the dims' names and sizes, which is all ``spec_for``
reads)."""

from __future__ import annotations

import functools
import threading

import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.compat import Replicate, Shard
from repro_torch.distrib import sharding as PS
from repro_torch.launch import steps as port_steps
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import STACKED, Model

ARCHS = sorted(port_configs.REGISTRY)
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
SHAPE = ShapeConfig("t", 64, 32, "train")


def meshes(name):
    """(reference AbstractMesh, port AbstractMesh) of one mesh."""
    from jax.sharding import AbstractMesh

    shape, names = MESHES[name]
    return AbstractMesh(shape, names), PS.AbstractMesh(shape, names)


@functools.cache
def ref_params(arch: str):
    """The reference's (param shapes, spec tree) of the smoke config."""
    from repro import configs as ref_configs
    from repro.launch import steps as RS

    return RS.param_shapes_and_specs(ref_configs.smoke_config(arch))


def by_port_name(cfg, tree) -> dict:
    """A reference parameter tree (specs, shapes or shardings) keyed by the
    port's parameter names: a stacked leaf once for each of its layers."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = t

    for k, v in tree.items():
        if k in STACKED:
            for i in range(cfg.n_layers):
                walk(v, f"{k}.{i}.")
        else:
            walk(v, f"{k}.")
    return out


def spec_tuple(sharding) -> tuple:
    return tuple(sharding.spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_match_reference_init(arch):
    cfg = port_configs.smoke_config(arch)
    _, specs = ref_params(arch)
    assert Model(cfg, device="meta").logical_specs() == by_port_name(cfg, specs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh):
    from repro.distrib import sharding as RSH

    ref_mesh, port_mesh = meshes(mesh)
    cfg = port_configs.smoke_config(arch)
    shapes, specs = ref_params(arch)
    p_shapes, p_specs = port_steps.param_shapes_and_specs(cfg)
    ref_shapes = by_port_name(cfg, shapes)
    assert {k: tuple(s.shape) for k, s in ref_shapes.items()} == \
        {k: tuple(s.shape) for k, s in p_shapes.items()}
    for fsdp in (False, True):
        want = by_port_name(cfg, RSH.tree_sharding(ref_mesh, shapes, specs,
                                                   fsdp=fsdp))
        got = PS.tree_sharding(port_mesh, p_shapes, p_specs, fsdp=fsdp)
        assert {k: spec_tuple(v) for k, v in want.items()} == \
            {k: v.spec for k, v in got.items()}, fsdp
        # the same layouts through param_shardings
        assert port_steps.param_shardings(port_mesh, cfg, fsdp)[2] == got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_state_shardings_match_reference(arch, mesh):
    import jax

    from repro import configs as ref_configs
    from repro.launch import steps as RS

    ref_mesh, port_mesh = meshes(mesh)
    rcfg, cfg = ref_configs.smoke_config(arch), port_configs.smoke_config(arch)
    want = RS.batch_shardings(ref_mesh, rcfg, SHAPE)
    got = port_steps.batch_shardings(port_mesh, cfg, SHAPE)
    assert {k: spec_tuple(v) for k, v in want.items()} == \
        {k: v.spec for k, v in got.items()}
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
            RS.batch_specs(rcfg, SHAPE).items()} == \
        {k: (v.shape, str(v.dtype).replace("torch.", "")) for k, v in
         port_steps.batch_specs(cfg, SHAPE).items()}

    ref_state = RS.decode_state_specs(rcfg, SHAPE)
    want = jax.tree.leaves(RS.decode_state_shardings(ref_mesh, rcfg, SHAPE,
                                                     ref_state))
    state = port_steps.decode_state_specs(cfg, SHAPE)
    got = PS_leaves(port_steps.decode_state_shardings(port_mesh, cfg, SHAPE,
                                                      state))
    assert [spec_tuple(s) for s in want] == [s.spec for s in got]
    assert [tuple(x.shape) for x in jax.tree.leaves(ref_state)] == \
        [s.shape for s in PS_leaves(state, leaf=port_steps.SDS)]


def PS_leaves(tree, leaf=PS.NamedSharding) -> list:
    """Leaves of a port tree in ``jax.tree``'s order (dict keys sorted)."""
    if isinstance(tree, leaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in PS_leaves(tree[k], leaf)]
    return [x for t in tree for x in PS_leaves(t, leaf)]


@pytest.mark.parametrize("mesh", ["4x2", "2x2x2"])
def test_spec_for_and_shard_helpers_match_reference(mesh):
    """Divisibility guards and explicit axis tuples on assorted shapes."""
    from repro.distrib import sharding as RSH

    ref_mesh, port_mesh = meshes(mesh)
    cases = [((8, 32, 4, 16), ("batch", "seq", "heads", None)),
             ((8, 32, 2, 16), ("batch", "seq", "kv_heads", None)),
             ((6, 32, 128), ("batch", "seq", "mlp")),
             ((8, 32, 512), ("batch", "seq", "vocab")),
             ((8, 8), (("data", "model"), None)),
             ((16, 16), ("model", "model")),
             ((3,), ("heads",))]
    for shape, logical in cases:
        assert PS.spec_for(port_mesh, shape, logical) == \
            tuple(RSH.spec_for(ref_mesh, shape, logical)), (shape, logical)


def test_placements_map_tensor_dims_to_mesh_dims():
    mesh = PS.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert PS.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert PS.placements(mesh, ()) == (Replicate(),) * 3
    assert PS.placements(mesh, (None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        PS.placements(mesh, (("data", "pod"),))


def test_axis_rules_nest_and_stay_on_their_thread():
    mesh = PS.AbstractMesh((4, 2), ("data", "model"))
    assert PS.spec_for(mesh, (8, 4), ("batch", "heads")) == ("data", "model")
    seen = {}
    with PS.axis_rules({"heads": None}):
        assert PS.current_rules()["heads"] is None
        with PS.axis_rules({"seq": "model"}) as inner:
            assert inner["heads"] is None and inner["seq"] == "model"
            assert PS.spec_for(mesh, (8, 4, 4), ("batch", "seq", "heads")) == \
                ("data", "model")
            t = threading.Thread(
                target=lambda: seen.update(rules=dict(PS.current_rules())))
            t.start()
            t.join()
        assert PS.current_rules()["seq"] is None
    assert PS.current_rules() == PS.DEFAULT_RULES
    assert seen["rules"] == PS.DEFAULT_RULES  # another thread: the defaults


def test_shard_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8)
    assert PS.shard(x, "batch", "embed") is x
    assert PS.replicate_like(x, x) is x


def test_fsdp_takes_the_largest_divisible_dim_ties_to_the_later():
    mesh = PS.AbstractMesh((4, 2), ("data", "model"))
    shapes = {"a": (8, 8), "b": (6, 8, 12), "c": (3, 5), "d": (8, 16)}
    specs = {"a": (None, None), "b": (None, None, None), "c": (None, None),
             "d": ("batch", None)}
    got = PS.tree_sharding(mesh, shapes, specs, fsdp=True)
    assert got["a"].spec == (None, "data")
    assert got["b"].spec == (None, None, "data")
    assert got["c"].spec == ()
    assert got["d"].spec == ("data",)  # already on an FSDP axis


def test_production_mesh_needs_its_ranks():
    from repro_torch.compat import AxisType, make_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="8 ranks"):
        make_host_mesh(2, 2, pod=2, device_type="cpu")
    with pytest.raises(NotImplementedError):
        make_mesh((1,), ("data",), axis_types=(AxisType.Explicit,),
                  device_type="cpu")
    assert [t.name for t in AxisType] == ["Auto", "Explicit", "Manual"]


def test_layer_dim_fsdp_falls_to_the_layer_tensor():
    """A stacked leaf whose FSDP axes land on the layer dim (the smoke
    hymba's ``ssm.D`` [4, 256] on data = 4): one layer's tensor takes FSDP
    over its own dims where they divide, else stays replicated."""
    mesh = PS.AbstractMesh((4, 2), ("data", "model"))
    cfg = port_configs.smoke_config("hymba-1.5b")
    shapes, _, sh = port_steps.param_shardings(mesh, cfg, fsdp=True)
    name = "layers.0.ssm.D"
    assert sh[name].spec == ("data", "model")
    leaf = port_steps.leaf_sharding(sh[name], shapes[name].shape, 1)
    assert leaf.spec == ("model",)
