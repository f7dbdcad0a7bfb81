"""Dry-run cell builders (port of ``repro/configs/cells.py``): (arch
config x input shape) -> one rank's step on a mesh.

A ``Cell`` bundles what ``launch/dryrun`` needs: ``build(mesh)`` lays the
cell's parameters, optimizer state and batch out on the mesh as DTensors
placed by the sharding rules and returns a ``Step``, whose ``run()`` is
the rank's program (DTensor inserts the collectives) and whose ``inputs``
are those tensors; plus metadata for the roofline (analytic model FLOPs,
token counts).  The tensors are created with ``torch.empty``: under a
``FakeTensorMode`` (the dry-run) they hold no memory, so a full-size cell
runs on any host.

LM shapes (seq_len x global_batch):
  train_4k    : train step (fwd+bwd+AdamW with ZeRO-1 state), [256, 4096+1]
  prefill_32k : forward, last-position logits, tokens [32, 32768]
  decode_32k  : ONE ``decode_step``, KV cache of 32768   [B=128]
  long_500k   : ONE ``decode_step``, cache 524288        [B=1]
                (sub-quadratic archs only; full-attention archs skip)

GNN cells are train steps over a padded batch of the shape table's node
and edge counts, edges sharded over the data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, kind="train"),
    "minibatch_lg": dict(n=169984, e=168960, d_feat=602, kind="train",
                         note="padded 1024-seed fanout-15-10 subgraph"),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, kind="train"),
    "molecule": dict(n=30 * 128, e=64 * 128, d_feat=16, kind="train",
                     n_graphs=128),
}

GNN_SHAPE_NAMES = tuple(GNN_SHAPES)


@dataclasses.dataclass
class Step:
    run: Callable[[], Any]     # one rank's program
    inputs: Any                # the tensors it reads (argument bytes)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                  # train | prefill | decode | serve | ...
    build: Callable[[Any], Step]   # mesh -> Step
    model_flops: float = 0.0   # analytic MODEL_FLOPS for the cell
    tokens: int = 0
    notes: str = ""


def lm_shapes_for(cfg) -> tuple[str, ...]:
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")   # full-attention archs skip
    return tuple(shapes)


# ---------------------------------------------------------------------------
# tensors on a mesh
# ---------------------------------------------------------------------------

def abstract(fn):
    """``fn()`` under a fake-tensor mode (the one active, else a new one):
    its tensors carry shapes and dtypes and hold no memory."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if active_fake_mode() is not None:
        return fn()
    with FakeTensorMode():
        return fn()


def placed(mesh, shape, dtype, spec, fill=None):
    """A DTensor of global ``shape`` laid out by ``safe_P(spec)``: each
    rank's block made by ``torch.empty`` (or ``torch.full`` of ``fill``)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import NamedSharding, safe_P
    sh = NamedSharding(mesh, safe_P(mesh, shape, spec))
    local_shape = sh.shard_shape(shape)
    local = (torch.empty(local_shape, dtype=dtype) if fill is None
             else torch.full(local_shape, fill, dtype=dtype))
    return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def placed_tree(tree, shardings, dtype=None):
    """A DTensor (``placed``) for every leaf of ``tree`` (tensors whose
    shape and dtype are read), laid out by the matching sharding."""
    from repro_torch.checkpoint.store import tree_items, tree_unflatten
    from repro_torch.distributed.sharding import tree_items_sharding
    shs = [sh for _, sh in tree_items_sharding(shardings)]
    return tree_unflatten(tree, [
        placed(sh.mesh, tuple(leaf.shape), dtype or leaf.dtype, sh.spec)
        for (_, leaf), sh in zip(tree_items(tree), shs)])


def host_step() -> torch.Tensor:
    """AdamW's step count: a real host int32 tensor even inside a fake
    trace (``optim.adamw.host_scalars``)."""
    from repro_torch.optim.adamw import host_scalars
    with host_scalars():
        return torch.zeros((), dtype=torch.int32)


def implicit_replication():
    """Plain tensors made inside a step (rope tables, masks, counters)
    act as replicated DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def train_run(loss, params, opt, batch):
    """One ``make_train_step`` step of ``loss`` on the placed tensors, as
    a zero-argument run."""
    from repro_torch.runtime.train_loop import TrainConfig, make_train_step
    step = make_train_step(loss, TrainConfig(total_steps=10_000))

    def run():
        with implicit_replication():
            return step(params, opt, batch)
    return run


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def lm_param_shapes(cfg):
    """The LM's parameter tree as fake tensors (shapes and dtypes)."""
    from repro_torch.models import transformer as tfm
    return abstract(lambda: tfm.init_params(cfg, torch.Generator(),
                                            device="cpu"))


def lm_cell(cfg, shape_name: str, arch: str) -> Cell:
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.mesh import data_axes
    from repro_torch.models import transformer as tfm
    info = LM_SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    n_active = cfg.active_param_count()

    if kind == "train":
        # 6*N_active*D for fwd+bwd
        flops = 6.0 * n_active * batch * seq
        tokens = batch * seq
    elif kind == "prefill":
        flops = 2.0 * n_active * batch * seq
        tokens = batch * seq
    else:
        flops = 2.0 * n_active * batch
        tokens = batch

    def build(mesh) -> Step:
        dp = data_axes(mesh)
        hooks = shr.lm_hooks(mesh, cfg)
        shapes = lm_param_shapes(cfg)
        p_sh = shr.tree_shardings(shapes, mesh, shr.lm_param_spec, cfg)
        params = placed_tree(shapes, p_sh)

        if kind == "train":
            o_sh = shr.opt_state_shardings(p_sh, mesh, shapes)   # ZeRO-1
            opt = {"m": placed_tree(shapes, o_sh["m"], torch.float32),
                   "v": placed_tree(shapes, o_sh["v"], torch.float32),
                   "step": host_step()}
            toks = placed(mesh, (batch, seq + 1), torch.int64, (dp, None),
                          fill=0)
            run = train_run(
                lambda p, b: tfm.loss_fn(p, b, cfg, hooks), params, opt,
                {"tokens": toks})
            return Step(run, {"params": params, "opt": opt,
                              "tokens": toks})

        if kind == "prefill":
            toks = placed(mesh, (batch, seq), torch.int64, (dp, None),
                          fill=0)

            def run():
                with torch.no_grad(), implicit_replication():
                    logits, _ = tfm.forward(params, toks, cfg, hooks)
                    return logits[:, -1]   # next-token logits
            return Step(run, {"params": params, "tokens": toks})

        # decode: one serve step against a seq-long cache
        cache = init_placed_cache(cfg, mesh, batch, seq)
        tok = placed(mesh, (batch,), torch.int64, (dp,), fill=0)
        cache.pos = seq - 1

        def run():
            with torch.no_grad(), implicit_replication():
                return tfm.decode_step(params, cache, tok, cfg, hooks)
        return Step(run, {"params": params, "cache": [cache.k, cache.v],
                          "token": tok})

    return Cell(arch=arch, shape=shape_name, kind=kind, build=build,
                model_flops=flops, tokens=tokens)


def init_placed_cache(cfg, mesh, batch: int, max_seq: int, dtype=None):
    """``transformer.init_cache``'s cache as DTensors laid out by
    ``sharding.lm_cache_spec`` (batch over the data axes, the cache's
    sequence over model), zero-filled."""
    from repro_torch.distributed.sharding import lm_cache_spec
    from repro_torch.models.transformer import KVCache
    dtype = dtype or cfg.dtype
    spec = lm_cache_spec(mesh)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        s = max_seq if cfg.layer_is_global(i) else min(cfg.local_chunk,
                                                       max_seq)
        shape = (batch, s, cfg.n_kv_heads, cfg.hd)
        ks.append(placed(mesh, shape, dtype, spec, fill=0))
        vs.append(placed(mesh, shape, dtype, spec, fill=0))
    return KVCache(k=ks, v=vs, pos=0)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def gnn_abstract_batch(shape_name: str, molecular: bool):
    """The batch of a GNN cell as (shape, dtype) pairs (padded sizes),
    with ``n``, ``e`` and the graph count."""
    info = GNN_SHAPES[shape_name]
    n = -(-info["n"] // 8) * 8
    e = -(-info["e"] // 128) * 128
    ng = info.get("n_graphs", 1)
    i64 = torch.int64
    b = {
        "src": ((e,), i64),
        "dst": ((e,), i64),
        "node_mask": ((n,), torch.bool),
        "graph_id": ((n,), i64),
    }
    if molecular:
        b["species"] = ((n,), i64)
        b["pos"] = ((n, 3), torch.float32)
        b["edge_mask"] = ((e,), torch.bool)
        b["y"] = ((ng,), torch.float32)
    else:
        b["x"] = ((n, info["d_feat"]), torch.float32)
        b["pos"] = ((n, 3), torch.float32)
        b["y"] = ((n,), i64)
    return b, n, e, ng


_EDGE_LIKE = ("src", "dst", "edge_mask", "t_kj", "t_ji", "t_mask")


def gnn_batch_shardings(mesh, batch_abs: dict) -> dict:
    """Specs of a GNN batch: edge and triplet arrays over the data axes,
    node features over model (on the feature dim), the rest replicated."""
    from repro_torch.distributed.mesh import data_axes
    from repro_torch.distributed.sharding import NamedSharding, safe_P
    dp = data_axes(mesh)
    out = {}
    for k, (shape, _) in batch_abs.items():
        if k in _EDGE_LIKE:
            spec = (dp,)
        elif k == "x":
            spec = (None, "model")
        else:
            spec = ()
        out[k] = NamedSharding(mesh, safe_P(mesh, shape, spec))
    return out


def _index_fill(k: str, n: int):
    # index arrays hold the padding sentinel (in range of every gather)
    return n if k in ("src", "dst") else 0 if k in (
        "graph_id", "species", "y", "t_kj", "t_ji") else None


def gnn_cell(arch: str, shape_name: str, *, init_fn, loss_fn,
             batch_to_model, molecular: bool, flops_per_edge: float,
             extra_abstract=None) -> Cell:
    """Generic GNN train-step cell.

    ``init_fn(generator, device)`` -> parameters; ``batch_to_model(batch
    dict, n, e, ng)`` -> the model's batch object; ``extra_abstract(n,
    e)`` -> dict of additional edge-like inputs as (shape, dtype) (e.g.
    DimeNet's triplet indices), sharded over the data axes."""
    info = GNN_SHAPES[shape_name]

    def build(mesh) -> Step:
        from repro_torch.distributed.sharding import tree_shardings
        batch_abs, n, e, ng = gnn_abstract_batch(shape_name, molecular)
        if extra_abstract is not None:
            batch_abs.update(extra_abstract(n, e))
        b_sh = gnn_batch_shardings(mesh, batch_abs)
        batch = {k: placed(mesh, shape, dt, b_sh[k].spec,
                           fill=_index_fill(k, n))
                 for k, (shape, dt) in batch_abs.items()}
        shapes = abstract(lambda: init_fn(torch.Generator(), "cpu"))
        p_sh = tree_shardings(shapes, mesh, lambda *a: ())
        params = placed_tree(shapes, p_sh)
        opt = {"m": placed_tree(shapes, p_sh, torch.float32),
               "v": placed_tree(shapes, p_sh, torch.float32),
               "step": host_step()}

        def loss(p, b):
            return loss_fn(p, batch_to_model(b, n, e, ng))
        run = train_run(loss, params, opt, batch)
        return Step(run, {"params": params, "opt": opt, "batch": batch})

    return Cell(arch=arch, shape=shape_name, kind="train", build=build,
                model_flops=flops_per_edge * info["e"],
                tokens=info["n"], notes=info.get("note", ""))
