"""gat-cora [arXiv:1710.10903; paper] (port of ``repro/configs/gat_cora.py``)
2 layers, d_hidden=8, 8 heads, attention aggregator.

in_dim/n_classes track the shape cell: the paper's config (in_dim 1433,
7 classes) is the full_graph_sm/Cora cell; other cells keep the
architecture and adapt the input width.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES, GNN_SHAPES, gnn_cell
from repro_torch.models.gnn import gat
from repro_torch.models.gnn.gat import GATConfig
from repro_torch.models.gnn.layers import GraphBatch

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


def to_graph_batch(b, n, e, ng):
    """A dry-run cell's batch dict as the model's ``GraphBatch``."""
    return GraphBatch(n_nodes=n, n_graphs=ng, x=b["x"], src=b["src"],
                      dst=b["dst"], node_mask=b["node_mask"],
                      graph_id=b["graph_id"], pos=b["pos"], y=b["y"])


def build_cell(cfg, shape):
    c = cfg_for(shape)
    return gnn_cell(
        "gat-cora", shape,
        init_fn=lambda gen, dev: gat.init_params(c, gen, dev),
        loss_fn=lambda p, mb: gat.loss_fn(p, mb, c),
        batch_to_model=to_graph_batch, molecular=False,
        flops_per_edge=cell_flops(c, 1))


ARCH = register(ArchSpec(
    name="gat-cora", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES, build_cell=build_cell,
    notes="SDDMM -> edge-softmax -> SpMM regime",
))
