"""GNN substrate of the port; so far only the MLP of ``layers``."""
