"""Port parity for the molecular GNNs (``repro_torch.models.gnn.dimenet``,
``nequip``) at smoke widths: the reference's weights carried across by
``convert.gnn_params_from_arrays``, the same molecules through both
packages (padded triplets carry ``t_ji == n_edges``, which the reference's
segment sum drops; one batch also has no padding edge, so the clamped
gathers of padded triplets land on a real edge): forward and loss within
rtol 1e-4 / atol 1e-5, gradients within rtol 1e-3 and 1e-4 of the leaf's
largest magnitude of ``jax.grad``'s (the energies are unnormalized sums
over atoms and blocks, so gradients reach ~1e3 and their small elements
are differences of large terms: 3.4e-6 of the leaf's largest at worst,
where an atol of 1e-5 would need 1e-8).  Leaves that the loss does not
reach (the last NequIP layer's gate, and its self/skip mixes of l > 0)
compare as zeros.  ``build_triplets`` equal array for array, the CG tables
bit for bit, ``real_sh`` allclose, and the port's own rotation checks:
energies invariant, spherical harmonics and CG couplings equivariant
under fitted Wigner-D matrices."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from repro.models.gnn import dimenet as rdn
from repro.models.gnn import nequip as rnq
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models.gnn import dimenet as pdn
from repro_torch.models.gnn import nequip as pnq
from test_torch_gnn_layers import to_np
from test_torch_gnn_models import check_model
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ref_arch

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MOL_SCALED = dict(grad=1e-4)
FIELDS = ("species", "pos", "node_mask", "graph_id", "src", "dst",
          "edge_mask", "t_kj", "t_ji", "t_mask", "y")


def mol_arrays(seed, n_mol=3, n_atom=10, cutoff=2.5):
    """``n_mol`` random molecules (the reference tests' ``mol_batch``):
    atoms uniform in a 3 A box, a directed edge for each pair closer than
    ``cutoff``; ``(n, src, dst, pos, species, y, graph_id)``."""
    rng = np.random.default_rng(seed)
    allsrc, alldst, allpos, allsp, gid = [], [], [], [], []
    off = 0
    for g in range(n_mol):
        pos = rng.uniform(0, 3, (n_atom, 3))
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        s, t = np.where((d < cutoff) & (d > 0))
        allsrc.append(s + off)
        alldst.append(t + off)
        allpos.append(pos)
        allsp.append(rng.integers(1, 5, n_atom))
        gid.extend([g] * n_atom)
        off += n_atom
    y = rng.normal(size=n_mol).astype(np.float32)
    return (off, np.concatenate(allsrc), np.concatenate(alldst),
            np.concatenate(allpos), np.concatenate(allsp), y,
            np.array(gid))


def mol_batches(seed, exact_edges=False):
    """(reference, port) ``TripletBatch`` of ``mol_arrays(seed)``;
    ``exact_edges``: no padding edge (``e_pad == e``)."""
    n, src, dst, pos, sp, y, gid = mol_arrays(seed)
    kw = dict(n_graphs=3, graph_id=gid)
    if exact_edges:
        kw["e_pad_mult"] = len(src)
    return (rdn.build_triplets(n, src, dst, pos, sp, y, **kw),
            pdn.build_triplets(n, src, dst, pos, sp, y, device="cpu", **kw))


@pytest.mark.parametrize("exact_edges", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_triplets_equal(seed, exact_edges):
    ref, port = mol_batches(seed, exact_edges)
    conv = convert.triplet_batch_from_arrays(ref, device="cpu")
    for b in (port, conv):
        assert (b.n_nodes, b.n_edges, b.n_graphs) == (ref.n_nodes,
                                                      ref.n_edges,
                                                      ref.n_graphs)
        for f in FIELDS:
            assert np.array_equal(to_np(getattr(b, f)),
                                  np.asarray(getattr(ref, f))), f
    t_ji, t_mask = to_np(port.t_ji), to_np(port.t_mask)
    assert (~t_mask).any() and np.all(t_ji[~t_mask] == port.n_edges)
    assert bool(to_np(port.edge_mask).all()) == exact_edges


@pytest.mark.parametrize("exact_edges", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dimenet_smoke_matches_reference(seed, exact_edges):
    rcfg = ref_arch("dimenet").smoke
    pcfg = get_arch("dimenet").smoke
    ref_b, port_b = mol_batches(seed, exact_edges)
    n = check_model(rdn, pdn, rcfg, pcfg, ref_b, port_b, seed + 10,
                    MOL_SCALED)
    assert n == 1 + 2 + 2 + 4 + 11 * rcfg.n_blocks


@pytest.mark.parametrize("exact_edges", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_nequip_smoke_matches_reference(seed, exact_edges):
    rcfg = ref_arch("nequip").smoke
    pcfg = get_arch("nequip").smoke
    ref_b, port_b = mol_batches(seed, exact_edges)
    n = check_model(rnq, pnq, rcfg, pcfg, ref_b, port_b, seed + 20,
                    MOL_SCALED)
    assert n == 1 + 4 + rcfg.n_layers * (4 + 2 * (rcfg.l_max + 1) + 2)


def test_cg_tables_bitwise():
    assert pnq.PATHS == rnq.PATHS and len(pnq.PATHS) == 15
    for p in rnq.PATHS:
        want = np.asarray(rnq.CG[p])
        assert pnq.CG[p].dtype == want.dtype == np.float32
        assert np.array_equal(pnq.CG[p], want), p
    cg = pnq.cg_tensors("cpu")
    for p in rnq.PATHS:
        assert np.array_equal(cg[p].numpy(), pnq.CG[p])


def test_real_sh_and_bases_match_reference():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    want = rnq.real_sh(jax.numpy.asarray(pts))
    got = pnq.real_sh(torch.from_numpy(pts))
    assert set(got) == set(want) == {0, 1, 2}
    for l in want:
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]),
                                   **FWD_TOL)
    cfg_r, cfg_p = rdn.DimeNetConfig(), pdn.DimeNetConfig()
    r = rng.uniform(0.0, 6.0, 300).astype(np.float32)
    np.testing.assert_allclose(
        pdn.radial_basis(torch.from_numpy(r), cfg_p).numpy(),
        np.asarray(rdn.radial_basis(jax.numpy.asarray(r), cfg_r)), **FWD_TOL)
    c = rng.uniform(-1.0, 1.0, 300).astype(np.float32)
    c[:2] = (-1.0, 1.0)
    np.testing.assert_allclose(
        pdn.angular_basis(torch.from_numpy(c), cfg_p).numpy(),
        np.asarray(rdn.angular_basis(jax.numpy.asarray(c), cfg_r)),
        **FWD_TOL)


def _moved(batch, rot, shift=0.0):
    pos = batch.pos.numpy() @ rot.T.astype(np.float32) + np.float32(shift)
    return dataclasses.replace(batch, pos=torch.from_numpy(pos))


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_energy_rotation_invariant(arch):
    mod = pdn if arch == "dimenet" else pnq
    cfg = get_arch(arch).smoke
    _, b = mol_batches(4)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rot = Rotation.random(random_state=3).as_matrix()
    with torch.no_grad():
        e0 = mod.forward(params, b, cfg).numpy()
        e1 = mod.forward(params, _moved(b, rot, 1.7), cfg).numpy()
    assert np.isfinite(e0).all() and e0.shape == (3,)
    np.testing.assert_allclose(e0, e1, rtol=1e-4, atol=1e-4)


def _wigner(rot, n=300, seed=7):
    """Wigner-D matrices of ``rot`` fitted from the port's ``real_sh``:
    ``Y_l(R x) = Y_l(x) @ D_l``."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    Y = pnq.real_sh(torch.from_numpy(pts))
    Yr = pnq.real_sh(torch.from_numpy(pts @ rot.T))
    D = {}
    for l in (0, 1, 2):
        A, B = Y[l].numpy(), Yr[l].numpy()
        D[l], *_ = np.linalg.lstsq(A, B, rcond=None)
        np.testing.assert_allclose(A @ D[l], B, atol=1e-5)
        np.testing.assert_allclose(D[l] @ D[l].T, np.eye(2 * l + 1),
                                   atol=1e-4)
    return D


def test_cg_couplings_equivariant():
    """(D1 u) x (D2 v) -> D3 (u x v) for every path, with the port's
    tables and fitted Wigner-Ds."""
    D = _wigner(Rotation.random(random_state=9).as_matrix())
    rng = np.random.default_rng(11)
    for (l1, l2, l3) in pnq.PATHS:
        C = pnq.CG[(l1, l2, l3)].astype(np.float64)
        u = rng.normal(size=(2 * l1 + 1,))
        v = rng.normal(size=(2 * l2 + 1,))
        lhs = np.einsum("abc,a,b->c", C, D[l1].T @ u, D[l2].T @ v)
        rhs = D[l3].T @ np.einsum("abc,a,b->c", C, u, v)
        np.testing.assert_allclose(lhs, rhs, atol=1e-5)
