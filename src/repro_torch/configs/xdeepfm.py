"""xDeepFM configurations (port of ``repro/configs/xdeepfm.py``).

``FULL`` is the paper's model (arXiv:1803.05170): 39 sparse fields,
embed_dim 10, CIN 200-200-200, MLP 400-400, over a Criteo-scale
vocabulary of 18,916,161 rows (a few huge fields and a long tail).
``SHAPES`` are the reference's cells: scoring runs ``serve_p99``,
``serve_bulk`` and ``retrieval_cand``, training ``train_batch``.  The
arch registers as ``xdeepfm``, kind ``"recsys"``; ``build_cell`` lays a
cell out on a mesh (tables row-sharded over model, the batch over the
data axes).
"""
import torch

from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import (Cell, Step, abstract, host_step,
                                       implicit_replication, placed,
                                       placed_tree, train_run)
from repro_torch.models import xdeepfm as xd
from repro_torch.models.xdeepfm import XDeepFMConfig

_BIG = (10_000_000, 5_000_000, 2_000_000, 1_000_000, 500_000)
_TAIL = tuple(int(100_000 / (1 + i)) + 128 for i in range(34))

FULL = XDeepFMConfig(field_sizes=_BIG + _TAIL)
SMOKE = XDeepFMConfig(
    n_fields=8, embed_dim=6, cin_layers=(16, 16), mlp_dims=(32,),
    field_sizes=(128, 96, 64, 64, 32, 32, 16, 16))

SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_cand=1_000_000, kind="retrieval"),
}
VALUES_PER_FIELD = 3



def build_cell(cfg: XDeepFMConfig, shape: str) -> Cell:
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.mesh import data_axes
    info = SHAPES[shape]
    B = info["batch"]
    kind = info["kind"]

    def build(mesh) -> Step:
        dp = data_axes(mesh)
        shapes = abstract(lambda: xd.init_params(cfg, torch.Generator(),
                                                 device="cpu"))
        p_sh = shr.tree_shardings(shapes, mesh, shr.recsys_param_spec)
        params = placed_tree(shapes, p_sh)
        F, V = cfg.n_fields, VALUES_PER_FIELD

        if kind == "train":
            batch = {"indices": placed(mesh, (B, F, V), torch.int32,
                                       (dp, None, None), fill=0),
                     "labels": placed(mesh, (B,), torch.int32, (dp,),
                                      fill=0)}
            opt = {"m": placed_tree(shapes, p_sh, torch.float32),
                   "v": placed_tree(shapes, p_sh, torch.float32),
                   "step": host_step()}
            run = train_run(xd.loss_fn, params, opt, batch)
            return Step(run, {"params": params, "opt": opt,
                              "batch": batch})

        if kind == "serve":
            idx = placed(mesh, (B, F, V), torch.int32, (dp, None, None),
                         fill=0)

            def run():
                with torch.no_grad(), implicit_replication():
                    return xd.forward(params, {"indices": idx})
            return Step(run, {"params": params, "indices": idx})

        # retrieval: one query vs n_cand candidates
        n_cand = info["n_cand"]
        q = placed(mesh, (1, F, V), torch.int32, (), fill=0)
        cand = placed(mesh, (n_cand, cfg.embed_dim), torch.float32,
                      ((*dp, "model"), None))

        def run():
            with torch.no_grad(), implicit_replication():
                return xd.retrieval_scores(params, q, cand)
        return Step(run, {"params": params, "query": q, "cand": cand})

    flops = (cell_flops(cfg, B) if kind != "retrieval"
             else 2.0 * info["n_cand"] * cfg.embed_dim)
    if kind == "train":
        flops *= 3  # fwd + bwd
    return Cell(arch="xdeepfm", shape=shape, kind=kind, build=build,
                model_flops=flops, tokens=B)


ARCH = register(ArchSpec(
    name="xdeepfm", kind="recsys", full=FULL, smoke=SMOKE,
    shapes=tuple(SHAPES), build_cell=build_cell,
    notes="embedding bag (index_select + sum) + CIN kernel B5",
))


def cell_flops(cfg: XDeepFMConfig, batch: int) -> float:
    """Model FLOPs of a forward over ``batch`` rows: the CIN layers
    (2*K*H*M*D a row each) and the DNN matmuls (the reference's
    ``_cell_flops``)."""
    f = 0.0
    h_prev = cfg.n_fields
    for h in cfg.cin_layers:
        f += 2.0 * h * h_prev * cfg.n_fields * cfg.embed_dim
        h_prev = h
    dims = [cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1]
    f += sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    return f * batch
