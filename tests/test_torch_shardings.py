"""The port's ``launch/shardings.py`` and ``launch/specs.py`` against the
reference's, on abstract meshes (no device, no rank).

For every arch x shape x production mesh, the port's ``build_case``
gives the same spec, leaf by leaf, as the reference's ``build_case``
(the port's ``Spec.dims`` against ``tuple(PartitionSpec)``), the same
case note, and the same per-device argument bytes as the reference's
``NamedSharding.shard_shape``.  ``seq_shard_axes`` is compared over a
grid, and each ``Policy`` flag that changes a spec on its own.
"""

import dataclasses
import math

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import list_archs as jlist_archs
from repro.launch import shardings as jsh
from repro.launch.specs import build_case as jbuild_case
from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch import shardings as tsh
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.roofline import argument_bytes
from repro_torch.launch.specs import build_case
from repro_torch.models.weights import tree_leaves_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): tuple(s.spec)
            for path, s in flat}


def _port_specs(tree):
    return {"/".join(str(k) for k in path): s.dims
            for path, s in tree_leaves_with_path(tree)}


def _ref_arg_bytes(case):
    total = 0
    for args, shs in zip(case.args, case.in_shardings):
        leaves = jax.tree_util.tree_leaves(args)
        shard = jax.tree_util.tree_leaves(shs)
        assert len(leaves) == len(shard)
        for a, s in zip(leaves, shard):
            total += math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
    return total


def _pair(arch, shape, mesh_name, jpolicy=None, tpolicy=None):
    shp, axes = MESHES[mesh_name]
    ref = jbuild_case(arch, shape, JAbstractMesh(shp, axes), policy=jpolicy)
    port = build_case(arch, shape, AbstractMesh(shp, axes), policy=tpolicy)
    return ref, port


def test_the_registry_and_shapes_are_the_reference_s():
    assert list_archs() == jlist_archs()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_case_specs_notes_and_bytes_match_the_reference(arch, shape):
    for mesh_name in MESHES:
        ref, port = _pair(arch, shape, mesh_name)
        what = f"{arch} x {shape} x {mesh_name}"
        assert port.kind == ref.kind and port.tokens == ref.tokens, what
        assert port.note == ref.note, what
        for i, (r, p) in enumerate(zip(ref.in_shardings,
                                       port.in_shardings)):
            rs, ps = _ref_specs(r), _port_specs(p)
            assert rs.keys() == ps.keys(), (what, i)
            bad = {k: (rs[k], ps[k]) for k in rs if rs[k] != ps[k]}
            assert not bad, (what, i, bad)
        assert argument_bytes(port) == _ref_arg_bytes(ref), what


#: one flag at a time, each on cases where it changes a spec
FLAG_CASES = [
    (dict(fsdp=False), "qwen2-72b", "train_4k"),
    (dict(fsdp_threshold=1e9), "qwen3-1.7b", "train_4k"),
    (dict(expert_parallel=True), "phi3.5-moe-42b-a6.6b", "train_4k"),
    (dict(expert_parallel=True), "phi3.5-moe-42b-a6.6b", "decode_32k"),
    (dict(seq_shard_cache=False), "qwen3-1.7b", "long_500k"),
    (dict(seq_shard_cache=False), "gemma3-1b", "decode_32k"),
    (dict(head_aligned=False), "gemma3-1b", "decode_32k"),
    (dict(microbatches=2), "qwen3-1.7b", "train_4k"),
]


@pytest.mark.parametrize("flags,arch,shape", FLAG_CASES)
def test_policy_flags_change_the_specs_as_the_reference_s(flags, arch,
                                                          shape):
    for mesh_name in MESHES:
        ref, port = _pair(arch, shape, mesh_name, jsh.Policy(**flags),
                          tsh.Policy(**flags))
        base, _ = _pair(arch, shape, mesh_name)
        for r, p, b in zip(ref.in_shardings, port.in_shardings,
                           base.in_shardings):
            assert _ref_specs(r) == _port_specs(p), (flags, mesh_name)
        assert port.note == ref.note
        assert argument_bytes(port) == _ref_arg_bytes(ref)
        if "microbatches" not in flags:       # it reaches the step alone
            assert any(_ref_specs(r) != _ref_specs(b) for r, b in zip(
                ref.in_shardings, base.in_shardings)) or \
                ref.note != base.note, f"{flags} changes nothing"


def test_seq_shard_axes_over_a_grid():
    meshes = [((16, 16), ("data", "model")), ((2, 16, 16),
                                             ("pod", "data", "model")),
              ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
              ((4, 1), ("data", "model")), ((8,), ("model",))]
    n = 0
    for shp, axes in meshes:
        jm, tm = JAbstractMesh(shp, axes), AbstractMesh(shp, axes)
        for batch in (1, 2, 4, 32, 128):
            for cache_len in (512, 1024, 2048, 4096, 32768, 524288, 1000):
                for hkv in (1, 2, 4, 8, 16):
                    want = jsh.seq_shard_axes(jm, batch, cache_len, hkv)
                    got = tsh.seq_shard_axes(tm, batch, cache_len, hkv)
                    assert got == (tuple(want[0]), want[1]), (
                        shp, batch, cache_len, hkv)
                    n += 1
    assert n == 6 * 5 * 7 * 5


def test_param_spec_use_time_drops_the_fsdp_axis():
    mesh = make_production_mesh()
    cfg = build_case("qwen2-72b", "train_4k", mesh).cfg
    pol = tsh.Policy()
    jm = JAbstractMesh((16, 16), ("data", "model"))
    for name, shape in (("layers/attn/w_q", (80, 8192, 8192)),
                        ("layers/mlp/w_down", (80, 29568, 8192)),
                        ("embed", (152064, 8192))):
        for use in (False, True):
            got = tsh.param_spec(cfg, name, len(shape), shape, mesh, pol,
                                 use_time=use)
            want = jsh.param_spec(cfg, name, len(shape), shape, jm,
                                  jsh.Policy(), use_time=use)
            assert got.dims == tuple(want), (name, use)
        assert "data" not in tsh.param_spec(cfg, name, len(shape), shape,
                                            mesh, pol, use_time=True).dims
    assert tsh.replicated(mesh).dims == ()


def test_activation_constraint_is_the_rank_s_rows():
    """The reference's constraint pins the batch to ("pod", "data"); the
    port's returns a rank's block of those rows, and is None where the
    reference installs none."""
    import torch
    from repro_torch.launch.mesh import Mesh
    x = torch.arange(8 * 3 * 2.0).reshape(8, 3, 2)
    for rank in range(4):
        mesh = Mesh(("data", "model"), (2, 2), rank, {})
        got = tsh.make_activation_constraint(mesh, batch_size=8)(x)
        d = rank // 2                            # the rank's data index
        assert torch.equal(got, x[4 * d:4 * (d + 1)])
    pod = Mesh(("pod", "data", "model"), (2, 2, 1), 3, {})
    got = tsh.make_activation_constraint(pod, batch_size=8)(x)
    assert torch.equal(got, x[6:8])             # (pod 1, data 1) of 4
    for shp, axes, batch in (((2, 2), ("data", "model"), 3),
                             ((4,), ("model",), 8)):
        assert tsh.make_activation_constraint(
            AbstractMesh(shp, axes), batch_size=batch) is None
