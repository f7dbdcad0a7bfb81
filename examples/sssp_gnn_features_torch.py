"""The fleet as a distance-feature factory for GNN training, on the
PyTorch/CUDA port: SP4 shortest-path distances from a few landmark
vertices, computed for a whole FLEET of graphs in one batched solve
(``FleetSolver.solve_batch``, [fleet, landmark] lanes), become positional
features for per-graph GAT node classifiers (distance encodings, cf.
position-aware GNNs).

  python examples/sssp_gnn_features_torch.py              # 4 graphs, n=600
  python examples/sssp_gnn_features_torch.py --ci         # 2 graphs, n=200
  python examples/sssp_gnn_features_torch.py --device cpu

Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402


def sizes(ci: bool):
    """(F graphs, n vertices, e edges, d features, L landmarks, SGD
    steps) of the example."""
    return (2, 200, 800, 32, 4, 30) if ci else (4, 600, 2400, 64, 8, 120)


def fleet_distances(ci: bool, device=None, backend: str = "segment"):
    """The example's fleet and its landmark solve: ``(members, solver,
    landmarks int[F, L], result)``, ``result.dist`` float32[F, L, n]."""
    from repro_torch.core.graph import HostGraph
    from repro_torch.data.synthetic import cora_like
    from repro_torch.sssp import FleetSolver, build_fleet
    F, n, e, d, L, _ = sizes(ci)
    # F citation-ish graphs (same n -> one fleet shape), each with its
    # own topology, features and labels
    members = [cora_like(n=n, e=e, d=d, seed=s) for s in range(F)]
    fleet = build_fleet(
        [HostGraph(n, m[1], m[2], np.ones(len(m[1]), np.float32))
         for m in members], device=device)
    rng = np.random.default_rng(0)
    landmarks = np.stack([rng.choice(n, L, replace=False)
                          for _ in range(F)])
    solver = FleetSolver(fleet, backend=backend)
    return members, solver, landmarks, solver.solve_batch(landmarks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ci", action="store_true",
                    help="small config for CI (2 graphs, n=200)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.store import tree_leaves
    from repro_torch.core.graph import resolve_device
    from repro_torch.models.gnn import gat
    from repro_torch.models.gnn.layers import build_batch

    device = resolve_device(args.device)
    F, n, _, _, L, steps = sizes(args.ci)
    members, solver, _, batch = fleet_distances(args.ci, device)
    dist = batch.dist.cpu().numpy()               # [F, L, n]
    dist = np.where(np.isinf(dist), 20.0, dist)   # unreachable -> large
    feats = (dist / 10.0).transpose(0, 2, 1).astype(np.float32)
    print(f"fleet of {F} graphs, n={n} on {device}: {solver.solves} "
          f"landmark solves as the [{F}, {L}] lanes of one solve_batch; "
          f"per-member rounds {[int(r) for r in batch.rounds[:, 0]]}")

    def train(m, features, tag):
        _, src, dst, _, y = members[m]
        gb = build_batch(n, src, dst, features, y, device=device)
        cfg = gat.GATConfig(in_dim=features.shape[1], n_classes=7)
        params = gat.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        for _ in range(steps):                    # plain SGD, lr 0.3
            loss, _ = gat.loss_fn(params, gb, cfg)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p -= 0.3 * g
        with torch.no_grad():
            _, met = gat.loss_fn(params, gb, cfg)
        print(f"  graph {m} {tag:28s} final acc = {float(met['acc']):.3f}")
        return float(met["acc"])

    print("\ntraining per-graph GATs on the fleet's features:")
    acc_base = train(0, members[0][3], "bag-of-words only")
    deltas = []
    for m in range(F):
        x = members[m][3]
        acc = train(m, np.concatenate([x, feats[m]], 1),
                    "+ SP4 landmark distances")
        if m == 0:
            deltas.append(acc - acc_base)
    print(f"\nSP4 positional features delta (graph 0): {deltas[0]:+.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
