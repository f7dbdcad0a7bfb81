"""Port parity for the sharding rules (``repro_torch.distributed.sharding``
against ``repro.distributed.sharding``).

The reference side lays its abstract trees out on a device-free
``jax.sharding.AbstractMesh`` and reads ``NamedSharding.shard_shape``;
the port's side on a ``DeviceMesh`` of torch's ``fake`` process group
(one process, no collective runs).  For the five LMs on both production
meshes: the per-chip bytes of the parameters and of the ZeRO-1 AdamW
moments equal the reference's, and every parameter leaf's local shape
is the reference's shard shape without its leading layer dim.  ZeRO-1
may shard another dim of a port leaf than the reference's (which takes
the layer dim L where the data axes divide it; a port leaf has no L):
the port-only choice named here, ``ZERO1_OTHER_DIM``, keeps the bytes.
"""
import importlib
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as RNamedSharding
from jax.sharding import PartitionSpec as P

from repro.distributed import sharding as rshr
from repro.models import transformer as rtfm
from repro.models import xdeepfm as rxd
from repro_torch.configs import get_arch
from repro_torch.configs.cells import lm_param_shapes
from repro_torch.distributed import sharding as shr
from repro_torch.launch.mesh import init_fake_world, make_mesh


def ref_get_arch(name: str):
    """The reference's ``ArchSpec`` from its config module (the
    reference's registry loads its archs only while it is empty, so
    another test file's partial registration could hide them)."""
    mod = "sssp_synth" if name == "sssp" else name.replace("-", "_")
    return importlib.import_module("repro.configs." + mod).ARCH


LMS = ["command-r-35b", "command-r-plus-104b", "deepseek-moe-16b",
       "llama4-maverick-400b-a17b", "qwen3-32b"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the reference's ZeRO-1 shards L where the data axes divide it; the
# port's per-layer leaf shards its first divisible dim instead
ZERO1_OTHER_DIM = "zero1: the layer's first divisible dim in place of L"
SUB = ("a", "b", "c", "d")


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    shape, axes = MESHES[request.param]
    with init_fake_world(int(np.prod(shape))):
        yield (request.param, make_mesh(shape, axes, device_type="cpu"),
               AbstractMesh(shape, axes))


def _norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis name (``PartitionSpec``
    writes ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def _ref_bytes(params, shardings) -> int:
    leaves = jax.tree.leaves(params)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, RNamedSharding))
    return sum(_nbytes(sh.shard_shape(p.shape), p.dtype)
               for p, sh in zip(leaves, shs))


def _port_bytes(tree, shardings, itemsize=None) -> int:
    """Bytes a rank holds of ``tree`` laid out by ``shardings``, each leaf
    in its own dtype or ``itemsize`` bytes an element."""
    return sum(
        int(np.prod(sh.shard_shape(tuple(leaf.shape))))
        * (itemsize or leaf.element_size())
        for (_, leaf), (_, sh) in zip(shr.tree_items(tree),
                                      shr.tree_items_sharding(shardings)))


def _ref_layouts(arch, amesh):
    cfg = ref_get_arch(arch).full
    params = jax.eval_shape(partial(rtfm.init_params, cfg),
                            jax.random.PRNGKey(0))
    p_sh = rshr.tree_shardings(params, amesh, rshr.lm_param_spec, cfg)
    o_sh = rshr.opt_state_shardings(p_sh, amesh, params)
    return cfg, params, p_sh, o_sh


def _port_layouts(arch, mesh):
    cfg = get_arch(arch).full
    shapes = lm_param_shapes(cfg)
    p_sh = shr.tree_shardings(shapes, mesh, shr.lm_param_spec, cfg)
    o_sh = shr.opt_state_shardings(p_sh, mesh, shapes)
    return cfg, shapes, p_sh, o_sh


@pytest.mark.parametrize("arch", LMS)
def test_lm_per_chip_bytes_equal_the_reference(arch, meshes):
    name, mesh, amesh = meshes
    _, rparams, rp_sh, ro_sh = _ref_layouts(arch, amesh)
    _, shapes, p_sh, o_sh = _port_layouts(arch, mesh)
    want_p = _ref_bytes(rparams, rp_sh)
    assert _port_bytes(shapes, p_sh) == want_p
    f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32),
                       rparams)
    want_m = _ref_bytes(f32, ro_sh["m"])
    got_m = _port_bytes(shapes, o_sh["m"], itemsize=4)
    assert got_m == want_m
    if arch == "qwen3-32b" and name == "single":
        assert want_p == 4_097_888_256          # the anchor


def _ref_leaf(rtree, cfg, path: str):
    """The reference's leaf of the port's path ``layers/i/...``: its
    super-block tensor and the layer's index in it."""
    parts = path.split("/")
    if parts[0] != "layers":
        node = rtree
        for p in parts:
            node = node[p]
        return node, None
    i = int(parts[1])
    s, sub = divmod(i, cfg.moe_every)
    node = rtree["layers"][SUB[sub]]
    for p in parts[2:]:
        node = node[p]
    return node, s


@pytest.mark.parametrize("arch", LMS)
def test_lm_leaf_shapes_are_the_reference_shards(arch, meshes):
    _, mesh, amesh = meshes
    rcfg, rparams, rp_sh, ro_sh = _ref_layouts(arch, amesh)
    cfg, shapes, p_sh, o_sh = _port_layouts(arch, mesh)
    items = shr.tree_items(shapes)
    p_items = dict(shr.tree_items_sharding(p_sh))
    m_items = dict(shr.tree_items_sharding(o_sh["m"]))
    other = 0
    for path, leaf in items:
        rleaf, s = _ref_leaf(rparams, rcfg, path)
        rsh, _ = _ref_leaf(rp_sh, rcfg, path)
        rm, _ = _ref_leaf(ro_sh["m"], rcfg, path)
        want = rsh.shard_shape(rleaf.shape)
        want_m = rm.shard_shape(rleaf.shape)
        if s is not None:
            assert want[0] == rleaf.shape[0]    # params never shard L
            want = want[1:]
        got = p_items[path].shard_shape(tuple(leaf.shape))
        assert got == tuple(want), path
        got_m = m_items[path].shard_shape(tuple(leaf.shape))
        if s is None:
            assert got_m == tuple(want_m), path
        elif want_m[0] == rleaf.shape[0]:
            assert got_m == tuple(want_m[1:]), path
        else:                                    # ZERO1_OTHER_DIM
            # a rank's bytes of the leaf over all L layers stay equal
            assert np.prod(got_m) * rleaf.shape[0] == np.prod(want_m), path
            other += 1
    print(f"{arch}: {other} leaves take {ZERO1_OTHER_DIM}")


def test_safe_P_drops_axes_at_batch_1(meshes):
    name, mesh, amesh = meshes
    dp = shr.data_axes(mesh)
    rdp = rshr.data_axes(amesh)
    for shape in [(1, 4096), (256, 4096), (3, 8)]:
        got = shr.safe_P(mesh, shape, (dp, None))
        want = rshr.safe_P(amesh, shape, P(rdp, None))
        assert _norm(got) == _norm(want)
    assert shr.safe_P(mesh, (1, 4096), (dp, None)) == (None, None)
    assert shr.safe_P(mesh, (1, 32768, 8, 128),
                      shr.lm_cache_spec(mesh)) == (None, "model", None, None)


@pytest.mark.parametrize("shape,spec", [
    ((64, 5120, 8192), (None, None, "model")),
    ((5120, 8192), (None, "model")),
    ((28, 2048, 1408), (None, None, "model")),
    ((128,), ()),
    ((8, 3), ()),
    ((32, 16), ("model", None)),
])
def test_zero1_spec_matches_the_reference(shape, spec, meshes):
    _, mesh, amesh = meshes
    got = shr.zero1_spec(spec, shape, mesh)
    want = rshr.zero1_spec(P(*spec), shape, amesh)
    assert _norm(got) == _norm(want)


def test_gnn_and_recsys_specs_match_the_reference(meshes):
    _, mesh, amesh = meshes
    for fm in (False, True):
        got = shr.gnn_batch_specs(mesh, fm)
        want = rshr.gnn_batch_specs(amesh, fm)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}
    assert shr.gnn_param_spec("w", torch.empty(3), mesh) == ()
    assert {k: _norm(v) for k, v in shr.recsys_batch_spec(mesh).items()} \
        == {k: _norm(v) for k, v in rshr.recsys_batch_spec(amesh).items()}
    cfg = ref_get_arch("xdeepfm").full
    rparams = jax.eval_shape(partial(rxd.init_params, cfg),
                             jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, leaf in flat:
        want = rshr.recsys_param_spec(path, leaf, amesh)
        got = shr.recsys_param_spec(
            rshr._path_str(path), torch.empty(leaf.shape, device="meta"),
            mesh)
        assert _norm(got) == _norm(want), rshr._path_str(path)


def test_named_sharding_placements(meshes):
    from torch.distributed.tensor import Replicate, Shard
    name, mesh, _ = meshes
    dp = shr.data_axes(mesh)
    sh = shr.NamedSharding(mesh, (dp, None, "model"))
    want = [Shard(0)] * len(dp) + [Shard(2)]
    assert list(sh.placements) == want
    assert shr.NamedSharding(mesh, ()).placements == (Replicate(),) * \
        mesh.ndim
