"""dimenet [arXiv:2003.03123; unverified] (port of
``repro/configs/dimenet.py``)
6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6.

Non-molecular cells treat the graph as a point cloud (synthetic 3D
positions, species ids); for mega-graphs the triplet list is CAPPED at
2x the edge count (triplet subsampling), as in the reference.
"""
import torch

from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES, gnn_cell
from repro_torch.models.gnn import dimenet as dn
from repro_torch.models.gnn.dimenet import DimeNetConfig

FULL = DimeNetConfig()
SMOKE = DimeNetConfig(n_blocks=2, d_hidden=32, n_species=8)


def cell_flops(cfg: DimeNetConfig, n_edges: int) -> float:
    """The reference's model FLOPs of a forward over ``n_edges`` edges
    (``build_cell``: the bilinear nb * d * d a triplet, 2 triplets an
    edge, per block; the reference counts them for FULL)."""
    d = cfg.d_hidden
    return cfg.n_blocks * 2 * (cfg.n_bilinear * d * d) * 2.0 * n_edges


def _extra(n, e):
    t = 2 * e  # triplet cap
    return {"t_kj": ((t,), torch.int64), "t_ji": ((t,), torch.int64),
            "t_mask": ((t,), torch.bool)}


def to_triplet_batch(b, n, e, ng, t_kj=None, t_ji=None, t_mask=None):
    """A dry-run cell's batch dict as the model's ``TripletBatch``."""
    return dn.TripletBatch(
        n_nodes=n, n_edges=e, n_graphs=ng, species=b["species"],
        pos=b["pos"], node_mask=b["node_mask"], graph_id=b["graph_id"],
        src=b["src"], dst=b["dst"], edge_mask=b["edge_mask"],
        t_kj=b["t_kj"] if t_kj is None else t_kj,
        t_ji=b["t_ji"] if t_ji is None else t_ji,
        t_mask=b["t_mask"] if t_mask is None else t_mask, y=b["y"])


def build_cell(cfg, shape):
    c = FULL
    return gnn_cell(
        "dimenet", shape,
        init_fn=lambda gen, dev: dn.init_params(c, gen, dev),
        loss_fn=lambda p, mb: dn.loss_fn(p, mb, c),
        batch_to_model=to_triplet_batch, molecular=True,
        flops_per_edge=cell_flops(c, 1), extra_abstract=_extra)


ARCH = register(ArchSpec(
    name="dimenet", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES, build_cell=build_cell,
    notes="triplet-gather + bilinear basis contraction regime",
))
