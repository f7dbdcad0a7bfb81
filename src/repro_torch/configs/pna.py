"""pna [arXiv:2004.05718; paper] (port of ``repro/configs/pna.py``)
4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import GNN_SHAPE_NAMES, GNN_SHAPES, gnn_cell
from repro_torch.configs.gat_cora import to_graph_batch
from repro_torch.models.gnn import pna
from repro_torch.models.gnn.pna import PNAConfig

_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 47,
            "ogb_products": 47, "molecule": 16}


def cfg_for(shape: str) -> PNAConfig:
    """The config of cell ``shape`` (the reference's ``_cfg_for``)."""
    return PNAConfig(in_dim=GNN_SHAPES[shape]["d_feat"],
                     n_classes=_CLASSES[shape])


FULL = cfg_for("ogb_products")
SMOKE = PNAConfig(in_dim=16, d_hidden=24, n_classes=5)


def cell_flops(cfg: PNAConfig, n_edges: int) -> float:
    """The reference's model FLOPs of a forward over ``n_edges`` edges
    (``build_cell``: L * 2 * 2d * d * 2 an edge)."""
    d = cfg.d_hidden
    return cfg.n_layers * 2.0 * (2 * d) * d * 2 * n_edges


def build_cell(cfg, shape):
    c = cfg_for(shape)
    return gnn_cell(
        "pna", shape,
        init_fn=lambda gen, dev: pna.init_params(c, gen, dev),
        loss_fn=lambda p, mb: pna.loss_fn(p, mb, c),
        batch_to_model=to_graph_batch, molecular=False,
        flops_per_edge=cell_flops(c, 1))


ARCH = register(ArchSpec(
    name="pna", kind="gnn", full=FULL, smoke=SMOKE,
    shapes=GNN_SHAPE_NAMES, build_cell=build_cell,
    notes="multi-aggregator (4 reducers x 3 degree scalers)",
))
