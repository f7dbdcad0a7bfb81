"""The reference's GNN shape table (the data of ``GNN_SHAPES`` in
``repro/configs/cells.py``): each cell's node and edge counts (padded
where the note says so), feature width and, for molecules, graph count.
The reference's ``gnn_cell`` (an XLA lowering of a train step) has no
counterpart here."""

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, kind="train"),
    "minibatch_lg": dict(n=169984, e=168960, d_feat=602, kind="train",
                         note="padded 1024-seed fanout-15-10 subgraph"),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, kind="train"),
    "molecule": dict(n=30 * 128, e=64 * 128, d_feat=16, kind="train",
                     n_graphs=128),
}

GNN_SHAPE_NAMES = tuple(GNN_SHAPES)
