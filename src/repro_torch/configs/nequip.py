"""nequip [arXiv:2101.03164; paper] (port of ``repro/configs/nequip.py``)
5 layers, d_hidden (mult) = 32, l_max=2, n_rbf=8, cutoff=5,
E(3) tensor-product equivariance (SE(3) here: parity untracked, as in
the reference).

Non-molecular cells: point-cloud treatment (synthetic positions, species
ids), as for dimenet.
"""
import torch

from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES, gnn_cell
from repro_torch.configs.dimenet import to_triplet_batch
from repro_torch.models.gnn import nequip as nq
from repro_torch.models.gnn.nequip import NequIPConfig

FULL = NequIPConfig()
SMOKE = NequIPConfig(n_layers=2, mult=8, n_species=8)


def cell_flops(cfg: NequIPConfig, n_edges: int) -> float:
    """The reference's model FLOPs of a forward over ``n_edges`` edges
    (``build_cell``: all CG paths, ~mult * 15 MACs each, plus the radial
    MLP, per layer; the reference counts them for FULL)."""
    n_paths = len(cfg.paths)
    return cfg.n_layers * 2.0 * (n_paths * cfg.mult * 15
                                 + cfg.n_rbf * cfg.mult
                                 + cfg.mult * n_paths * cfg.mult) * n_edges


def _to_batch(b, n, e, ng):
    dummy = torch.zeros((8,), dtype=torch.int64)
    return to_triplet_batch(b, n, e, ng, t_kj=dummy, t_ji=dummy,
                            t_mask=dummy.bool())


def build_cell(cfg, shape):
    c = FULL
    return gnn_cell(
        "nequip", shape,
        init_fn=lambda gen, dev: nq.init_params(c, gen, dev),
        loss_fn=lambda p, mb: nq.loss_fn(p, mb, c),
        batch_to_model=_to_batch, molecular=True,
        flops_per_edge=cell_flops(c, 1))


ARCH = register(ArchSpec(
    name="nequip", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES, build_cell=build_cell,
    notes="irrep tensor-product (CG) + scatter regime",
))
