"""Port parity for the optimizer substrate (``repro_torch.optim``):
AdamW, global-norm clipping, the warmup-cosine schedule and int8
compression against ``repro.optim`` on the same numpy arrays, and
``CompressedAllReduce`` over a world of one and over spawned gloo ranks
against the reference's own all-reduce run under ``jax.vmap`` with a
named axis.  Tolerance: elementwise float32, rtol 1e-6 (the port takes
the reference's elementwise steps in its order; a reduction such as the
global norm sums in another order), int8 values bitwise.  bf16 params
with f32 moments included.  JAX is imported inside the tests: the
spawned ranks import this module."""
import numpy as np
import pytest
import torch

from repro_torch import optim as popt
from repro_torch.checkpoint.store import tree_leaves
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.optim import compress as pcomp

TOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax():
    import jax
    import jax.numpy as jnp

    from repro import optim as ropt
    from repro.optim import compress as rcomp
    return jax, jnp, ropt, rcomp


def _arrays(seed: int, scale: float = 1.0) -> dict:
    """A tree of float32 numpy arrays in the port's shapes of trees:
    dicts, a list of per-layer dicts, a list of (w, b) pairs."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"embed": a(11, 6), "norm": a(6),
            "layers": [{"wq": a(6, 4), "wo": a(4, 6)} for _ in range(2)],
            "dnn": [(a(6, 3), a(3)), (a(3, 1), a(1))]}


BF16 = ("embed", "layers")          # subtrees held in bfloat16


def _port(tree: dict, bf16: bool) -> dict:
    def conv(x, low):
        t = torch.from_numpy(np.array(x))
        return t.to(torch.bfloat16) if low else t
    return {k: _map(v, lambda x, k=k: conv(x, bf16 and k in BF16))
            for k, v in tree.items()}


def _ref(tree: dict, bf16: bool) -> dict:
    _, jnp, _, _ = _jax()
    return {k: _map(v, lambda x, k=k: jnp.asarray(
        x, jnp.bfloat16 if bf16 and k in BF16 else jnp.float32))
        for k, v in tree.items()}


def _map(x, fn):
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, fn) for v in x)
    return fn(x)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _same_trees(port, ref, **tol):
    jax, _, _, _ = _jax()
    a, b = tree_leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_allclose(_np(x), _np(y), **(tol or TOL))


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 37, 99, 100, 150])
def test_warmup_cosine_vs_reference(step):
    _, jnp, ropt, _ = _jax()
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    got = popt.warmup_cosine(step, **kw)
    want = ropt.warmup_cosine(jnp.int32(step), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(
        _np(popt.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)),
        _np(want), **TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_vs_reference(bf16, max_norm):
    _, _, ropt, _ = _jax()
    g = _arrays(1)
    got, gn = popt.clip_by_global_norm(_port(g, bf16), max_norm)
    want, wn = ropt.clip_by_global_norm(_ref(g, bf16), max_norm)
    np.testing.assert_allclose(_np(gn), _np(wn), **TOL)
    np.testing.assert_allclose(_np(popt.global_norm(_port(g, bf16))),
                               _np(ropt.global_norm(_ref(g, bf16))), **TOL)
    assert [t.dtype for t in tree_leaves(got)] == \
        [t.dtype for t in tree_leaves(_port(g, bf16))]
    _same_trees(got, want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("f32_grads", [False, True])
def test_adamw_three_steps_vs_reference(bf16, f32_grads):
    """Three AdamW steps from the same params with three gradient trees:
    params (in their own dtypes), m and v (float32) and the step count
    after each."""
    _, jnp, ropt, _ = _jax()
    p0 = _arrays(0)
    pp, rp = _port(p0, bf16), _ref(p0, bf16)
    ps, rs = popt.adamw_init(pp), ropt.adamw_init(rp)
    assert ps["step"].dtype == torch.int32 and ps["step"].device.type == "cpu"
    for i in range(3):
        g = _arrays(10 + i, scale=0.1)
        pg = _port(g, bf16 and not f32_grads)
        rg = _ref(g, bf16 and not f32_grads)
        lr = popt.warmup_cosine(ps["step"], peak_lr=1e-2, warmup=2, total=5)
        rlr = ropt.warmup_cosine(rs["step"], peak_lr=1e-2, warmup=2, total=5)
        pp, ps = popt.adamw_update(pg, ps, pp, lr=lr, weight_decay=0.1)
        rp, rs = ropt.adamw_update(rg, rs, rp, lr=rlr, weight_decay=0.1)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        _same_trees(ps["m"], rs["m"])
        _same_trees(ps["v"], rs["v"])
        _same_trees(pp, rp)
        assert [t.dtype for t in tree_leaves(pp)] == \
            [t.dtype for t in tree_leaves(_port(p0, bf16))]


def test_adamw_updates_in_place():
    pp = _port(_arrays(0), False)
    leaves = tree_leaves(pp)
    st = popt.adamw_init(pp)
    m = tree_leaves(st["m"])
    out, st2 = popt.adamw_update(_port(_arrays(1), False), st, pp, lr=0.1)
    assert all(a is b for a, b in zip(tree_leaves(out), leaves))
    assert all(a is b for a, b in zip(tree_leaves(st2["m"]), m))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_vs_reference(seed):
    _, jnp, _, rcomp = _jax()
    x = np.random.default_rng(seed).normal(size=(33, 17)).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max() * 127 / 127.0     # a half-way value
    q, s = pcomp.compress_int8(torch.from_numpy(x))
    rq, rs = rcomp.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(_np(s), _np(rs), **TOL)
    np.testing.assert_allclose(_np(pcomp.decompress_int8(q, s)),
                               _np(rcomp.decompress_int8(rq, rs)), **TOL)
    np.testing.assert_allclose(
        _np(pcomp.roundtrip_error(torch.from_numpy(x))),
        _np(rcomp.roundtrip_error(jnp.asarray(x))), **TOL)
    tree = pcomp.compress_tree({"a": torch.from_numpy(x),
                                "b": [torch.from_numpy(x[:3])]})
    np.testing.assert_array_equal(tree["a"][0].numpy(), np.asarray(rq))
    assert tree["b"][0][0].shape == (3, 17)


def _ref_all_reduce(grads: np.ndarray, errs: np.ndarray):
    """The reference's CompressedAllReduce over the leading (rank) axis,
    under jax.vmap with the axis named "data"."""
    jax, jnp, _, rcomp = _jax()
    car = rcomp.CompressedAllReduce(axis="data")
    mean, err = jax.vmap(car, axis_name="data")(jnp.asarray(grads),
                                                jnp.asarray(errs))
    return np.asarray(mean), np.asarray(err)


def _inputs(world: int):
    rng = np.random.default_rng(7)
    grads = rng.normal(size=(world, 4, 9)).astype(np.float32)
    grads *= np.arange(1, world + 1, dtype=np.float32)[:, None, None]
    errs = (rng.normal(size=(world, 4, 9)) * 1e-3).astype(np.float32)
    return grads, errs


def test_compressed_all_reduce_world_of_one():
    grads, errs = _inputs(1)
    mean, err = pcomp.CompressedAllReduce()(torch.from_numpy(grads[0]),
                                            torch.from_numpy(errs[0]))
    want_mean, want_err = _ref_all_reduce(grads, errs)
    np.testing.assert_allclose(mean.numpy(), want_mean[0], **TOL)
    np.testing.assert_allclose(err.numpy(), want_err[0], **TOL)


def car_rank(rank, world):
    """One rank's CompressedAllReduce over the default gloo group."""
    grads, errs = _inputs(world)
    car = pcomp.CompressedAllReduce()
    assert car.world == world
    mean, err = car(torch.from_numpy(grads[rank]),
                    torch.from_numpy(errs[rank]))
    return mean.numpy(), err.numpy()


def test_compressed_all_reduce_two_gloo_ranks(tmp_path):
    out = spawn_ranks(car_rank, 2, init_dir=str(tmp_path), timeout=60,
                      deadline=150)
    want_mean, want_err = _ref_all_reduce(*_inputs(2))
    for rank, (mean, err) in enumerate(out):
        np.testing.assert_allclose(mean, want_mean[rank], **TOL)
        np.testing.assert_allclose(err, want_err[rank], **TOL)
    np.testing.assert_array_equal(out[0][0], out[1][0])
