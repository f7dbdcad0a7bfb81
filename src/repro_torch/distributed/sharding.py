"""Per-architecture sharding rules, DP/TP/EP/SP (port of
``repro/distributed/sharding.py``).

One function per family maps a parameter tree (by path) and the input
batch to specs on the production mesh; a spec is the reference's
PartitionSpec as a tuple (``distributed/mesh``), ``NamedSharding`` pairs
it with a mesh and gives its DTensor placements.  These rules are what
the dry-run exercises for every (arch x shape) cell.

LM rules (megatron-style).  The port's LM parameters are a list of
per-layer dicts with no leading L dim (``models/transformer``), so each
of the reference's layer rules sits one dim to the left:
  embed [V,d]           -> (model, None)        vocab-sharded
  wq/wk/wv [d,Hhd]      -> (None, model)        column TP
  wo [Hhd,d]            -> (model, None)        row TP
  FFN gate/up | down    -> column | row TP
  MoE expert weights    -> (model, None, None)  EP over experts [E,d,f]
  lm_head [d,V]         -> (None, model)
  batch tokens [B,S]    -> (DATA, None)
  activations [B,S,d]   -> (DATA, None, None)
  MoE dispatch buffer   -> (DATA, model, None, None)
  KV cache [B,S,H,hd]   -> (DATA, model, None, None)  decode: cache-seq
                           sharded over model.

GNN full-graph: edges over DATA (the distributed SSSP layout), node
features replicated, ogb_products' 100-dim features over model.

RecSys: table rows over model (table parallelism), dense MLP
data-parallel, batch over DATA.

ZeRO-1 (``zero1_spec``) shards an optimizer tensor over the data axes
on the first dim they divide.  In the reference that dim is often L
itself; a port leaf has no L, so the rule takes the first divisible dim
of the layer's own shape.  A rank then holds the same number of bytes
wherever the data axes divide a dim of every layer's leaf, which the
tests check for the five LMs on both meshes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.checkpoint.store import tree_items, tree_unflatten
from repro_torch.distributed.layout import constrain, is_dtensor
from repro_torch.distributed.mesh import (data_axes, entry_size, local_shape,
                                          model_size, placements)
from repro_torch.models.transformer import ShardingHooks


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        return local_shape(self.mesh, shape, self.spec)


def safe_P(mesh, shape, spec) -> tuple:
    """Drop spec axes on dims they don't divide (e.g. batch=1 decode)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(e if dim % entry_size(mesh, e) == 0 else None
                 for dim, e in zip(shape, entries))


def _constrain(mesh, *spec):
    """A hook: a DTensor laid out by ``safe_P(spec)`` on ``mesh``, its
    gradient as it came (``layout.constrain``); any other tensor as it
    is (one card keeps its bits)."""
    def f(x):
        if not is_dtensor(x):
            return x
        return constrain(x, mesh, placements(mesh, safe_P(mesh, x.shape,
                                                          spec)))
    return f


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_param_spec(path: str, leaf, mesh, cfg=None) -> tuple:
    mdl = model_size(mesh)

    def div(dim):  # only shard when divisible
        return leaf.shape[dim] % mdl == 0

    s = path
    if s.startswith("embed"):
        return ("model", None) if div(0) else ()
    if s.startswith("lm_head"):
        return (None, "model") if div(1) else ()
    if "wq" in s or "wk" in s or "wv" in s:
        return (None, "model") if div(1) else ()
    if "wo" in s:
        return ("model", None) if div(0) else ()
    if "w_gate" in s or "w_up" in s or "ws_gate" in s or "ws_up" in s:
        return (None, "model") if div(1) else ()
    if "w_down" in s or "ws_down" in s:
        return ("model", None) if div(0) else ()
    if "we_gate" in s or "we_up" in s or "we_down" in s:
        # experts dim 0 of [E, d, f]
        return ("model", None, None) if div(0) else ()
    return ()  # norms, router, scalars replicated


def lm_batch_spec(mesh) -> tuple:
    return (data_axes(mesh), None)


def lm_hooks(mesh, cfg, seq_parallel_attn: bool | None = None
             ) -> ShardingHooks:
    dp = data_axes(mesh)
    mdl = model_size(mesh)
    hooks = ShardingHooks(
        act=_constrain(mesh, dp, None, None),
        moe_buf=_constrain(mesh, dp, "model", None, None),
        logits=_constrain(mesh, dp, None, "model"),
        cache=_constrain(mesh, dp, "model", None, None),
    )
    # Sequence-parallel attention when query heads don't divide the
    # model axis (llama4's 40 heads on 16-way TP): shard S over `model`
    # for q, replicate K/V — one K/V all-gather per layer instead of
    # replicating whole [B,S,d] activations.
    if seq_parallel_attn is None:
        seq_parallel_attn = (cfg.n_heads % mdl != 0)
    if seq_parallel_attn:
        hooks.attn_q = _constrain(mesh, dp, "model", None, None)
        hooks.attn_kv = _constrain(mesh, dp, None, None, None)
        # Megatron-SP: keep the residual stream sequence-sharded too.
        hooks.act = _constrain(mesh, dp, "model", None)
    return hooks


def lm_cache_spec(mesh) -> tuple:
    """KV cache [B, S_cache, Hkv, hd]: batch over DATA, seq over model."""
    return (data_axes(mesh), "model", None, None)


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_batch_specs(mesh, feature_model_shard: bool = False) -> dict:
    dp = data_axes(mesh)
    return {
        "x": (None, "model") if feature_model_shard else (),
        "src": (dp,),
        "dst": (dp,),
        "node_mask": (),
        "graph_id": (),
        "pos": (),
        "y": (),
    }


def gnn_param_spec(path: str, leaf, mesh) -> tuple:
    # small GNN weights: replicate (node/edge data dwarfs them)
    return ()


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def recsys_param_spec(path: str, leaf, mesh) -> tuple:
    mdl = model_size(mesh)
    if path.startswith("table") and leaf.shape[0] % mdl == 0:
        return ("model", None)
    if path.startswith("linear") and leaf.shape[0] % mdl == 0:
        return ("model",)
    return ()


def recsys_batch_spec(mesh) -> dict:
    dp = data_axes(mesh)
    return {"indices": (dp, None, None), "labels": (dp,)}


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def tree_shardings(tree, mesh, spec_fn, *args):
    """``tree`` (of tensors or anything with a ``shape``) mapped to
    ``NamedSharding``s via ``spec_fn(path, leaf, mesh, *args)``."""
    items = tree_items(tree)
    return tree_unflatten(tree, [
        NamedSharding(mesh, spec_fn(path, leaf, mesh, *args))
        for path, leaf in items])


def zero1_spec(spec, shape, mesh) -> tuple:
    """ZeRO-1: additionally shard an optimizer tensor over the DATA axes
    on the first dimension they divide and the param spec leaves free."""
    dp = data_axes(mesh)
    if not dp:
        return tuple(spec)
    size = entry_size(mesh, dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % size == 0 and dim >= size:
            entries[i] = dp
            return tuple(entries)
    return tuple(spec)


def opt_state_shardings(param_shardings, mesh, params=None,
                        zero1: bool = True) -> dict:
    """AdamW's m/v mirror the parameter shardings (+ ZeRO-1 data-axis
    sharding when the parameters, or anything with their shapes, are
    given); step replicated."""
    if zero1 and params is not None:
        shs = [sh for _, sh in tree_items_sharding(param_shardings)]
        leaves = [leaf for _, leaf in tree_items(params)]
        mv = tree_unflatten(params, [
            NamedSharding(mesh, zero1_spec(sh.spec, leaf.shape, mesh))
            for sh, leaf in zip(shs, leaves)])
    else:
        mv = param_shardings
    return {"m": mv, "v": mv, "step": NamedSharding(mesh, ())}


def tree_items_sharding(tree) -> list:
    """``(path, NamedSharding)`` pairs of a tree of shardings, in
    ``tree_items`` order."""
    out = []

    def walk(t, path):
        if isinstance(t, NamedSharding):
            out.append(("/".join(map(str, path)), t))
        elif type(t) is dict:
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
    walk(tree, ())
    return out


def distribute(tree, shardings):
    """``tree`` with every tensor leaf a DTensor placed by its sharding.
    Each rank slices its own block from the full tensor it holds (every
    rank holds the same tree); nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    shs = [sh for _, sh in tree_items_sharding(shardings)]
    leaves = [leaf for _, leaf in tree_items(tree)]
    return tree_unflatten(tree, [
        distribute_tensor(leaf, sh.mesh, sh.placements, src_data_rank=None)
        for leaf, sh in zip(leaves, shs)])
