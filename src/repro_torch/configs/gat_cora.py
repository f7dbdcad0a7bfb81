"""gat-cora [arXiv:1710.10903; paper] (port of ``repro/configs/gat_cora.py``)
2 layers, d_hidden=8, 8 heads, attention aggregator.

in_dim/n_classes track the shape cell: the paper's config (in_dim 1433,
7 classes) is the full_graph_sm/Cora cell; other cells keep the
architecture and adapt the input width.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES, GNN_SHAPES
from repro_torch.models.gnn.gat import GATConfig

_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 47,
            "ogb_products": 47, "molecule": 16}


def cfg_for(shape: str) -> GATConfig:
    """The config of cell ``shape`` (the reference's ``_cfg_for``)."""
    return GATConfig(in_dim=GNN_SHAPES[shape]["d_feat"],
                     n_classes=_CLASSES[shape])


FULL = cfg_for("full_graph_sm")
SMOKE = GATConfig(in_dim=32, n_classes=7)


def cell_flops(cfg: GATConfig, n_edges: int) -> float:
    """The reference's model FLOPs of a forward over ``n_edges`` edges
    (``build_cell``'s ``flops_per_edge``: 2 * 2 * H * d * 4 an edge)."""
    return 2 * 2.0 * cfg.n_heads * cfg.d_hidden * 4 * n_edges


ARCH = register(ArchSpec(
    name="gat-cora", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES,
    notes="SDDMM -> edge-softmax -> SpMM regime",
))
