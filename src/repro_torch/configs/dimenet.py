"""dimenet [arXiv:2003.03123; unverified] (port of
``repro/configs/dimenet.py``)
6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6.

The reference treats non-molecular cells as point clouds with a triplet
list capped at 2x the edge count; the port has no dry-run cells, so only
the configs are here.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES
from repro_torch.models.gnn.dimenet import DimeNetConfig

FULL = DimeNetConfig()
SMOKE = DimeNetConfig(n_blocks=2, d_hidden=32, n_species=8)


def cell_flops(cfg: DimeNetConfig, n_edges: int) -> float:
    """The reference's model FLOPs of a forward over ``n_edges`` edges
    (``build_cell``: the bilinear nb * d * d a triplet, 2 triplets an
    edge, per block; the reference counts them for FULL)."""
    d = cfg.d_hidden
    return cfg.n_blocks * 2 * (cfg.n_bilinear * d * d) * 2.0 * n_edges


ARCH = register(ArchSpec(
    name="dimenet", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES,
    notes="triplet-gather + bilinear basis contraction regime",
))
