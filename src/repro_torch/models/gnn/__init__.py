"""GNNs of the port (``repro/models/gnn``): the segment-op substrate
(``layers``), GAT, PNA, DimeNet, NequIP and the neighbour sampler."""
