"""Roofline terms on an NVIDIA H100 (port of ``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, seconds of one step of ONE rank's
program, each term its counted work over the card's peak rate:

  compute    = flops_per_chip / 989e12              dense bf16, tensor cores
  memory     = bytes_per_chip / 3.35e12             HBM3
  collective = sum over collectives of bytes / the slowest link the
               collective's group crosses: 450e9 B/s a direction on
               NVLink inside a node of 8 cards, 50e9 B/s a card (400 Gb/s
               InfiniBand) between nodes.

The counter (``WorkCounter``) takes the place of XLA's ``cost_analysis``
and the reference's HLO parser.  It is a ``TorchDispatchMode`` that sees
the LOCAL tensors below DTensor (an op with a DTensor argument is left
to DTensor, whose local ops come back through the mode), so what it
counts is per rank, as the reference's terms are:

  * flops: ``torch.utils.flop_counter``'s formulas (products, attention,
    the port's custom ops' own; matrix-vector and dot products added
    here), 2 a multiply-add.  Elementwise and reduction ops count no
    FLOPs (they show in the bytes);
  * bytes: each op's tensor inputs read once and outputs written once
    (views and allocations move nothing), the counterpart of XLA's
    "bytes accessed";
  * collective bytes by kind, the reference's convention: the OUTPUT
    size of each all-gather / all-reduce / reduce-scatter / all-to-all /
    collective-permute (broadcast, send and recv count as permutes),
    read from the ``_c10d_functional`` ops DTensor issues and from the
    ``c10d`` ops of explicit ``torch.distributed`` calls;
  * peak bytes: the most bytes of tensor storage alive at once, the
    arguments the caller registers (``track``) included.

The ops DTensor runs on global-shape fake tensors to propagate shapes
are not counted, and DTensor's shard-to-shard all-to-all counts as one
all-to-all (``_patch_dtensor``; it raises if this torch lacks either
function it wraps).
The layer loop of the port's LMs is Python, so every layer is counted;
``launch/calibrate`` still fits depth 2 and 4 to price a deep model
without tracing every layer.  The SSSP cells report ONE round (the round
count is data-dependent).

The analytic least-work functions (``lm_work``, ``train_work``,
``gnn_work``) and a kernel's ``bound`` live here too: ``chip_smoke.py``
holds the card's steps and kernels to them.
"""
from __future__ import annotations

import dataclasses
import weakref

# H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet (dense
# rates, no sparsity, at the 700 W limit)
HBM_BW = 3.35e12          # bytes/s, HBM3
PEAK_FLOPS = 989e12       # dense bf16 on the tensor cores
TF32_FLOPS = 495e12       # dense TF32 on the tensor cores
FP32_FLOPS = 67e12        # f32 outside the tensor cores
HBM_BYTES = 80e9          # device memory a card
NVLINK_BW = 450e9         # bytes/s a direction: NVLink 900 GB/s (same sheet)
# the DGX H100 data sheet: 8 GPUs a node on NVLink, and a ConnectX-7
# 400 Gb/s InfiniBand port a GPU between nodes
NODE_CARDS = 8
INTER_NODE_BW = 50e9      # bytes/s a card
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def link_bw(ranks) -> float:
    """The slowest link a collective over ``ranks`` crosses."""
    nodes = {int(r) // NODE_CARDS for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else INTER_NODE_BW


@dataclasses.dataclass
class RooflineTerms:
    """All *_per_chip quantities are for ONE rank's program."""
    flops: float                 # per-chip
    bytes_accessed: float        # per-chip
    collective_bytes: float      # per-chip
    n_chips: int
    model_flops: float = 0.0     # analytic global 6ND-style
    raw_flops: float = 0.0       # the counted value before calibration
    correction: str = "none"
    peak_bytes: float = 0.0      # per-chip live bytes at the peak
    collective_s: float | None = None   # per-link seconds, when known

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.collective_s is not None:
            return self.collective_s
        return self.collective_bytes / INTER_NODE_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — recompute/redundancy."""
        tot = self.flops * self.n_chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU at the bound: what fraction of fleet peak the
        model's 6ND work achieves if the step runs at t_bound."""
        if not self.t_bound:
            return 0.0
        return (self.model_flops / (self.n_chips * PEAK_FLOPS)) \
            / self.t_bound

    @property
    def fits(self) -> bool:
        """The peak live bytes of a rank within a card's memory."""
        return self.peak_bytes <= HBM_BYTES

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "chips": self.n_chips, "model_flops": self.model_flops,
            "raw_flops": self.raw_flops, "correction": self.correction,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_chip": self.peak_bytes,
            "fits": self.fits,
        }


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

# functional collectives (DTensor's): kind of each op
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
# c10d ops of explicit torch.distributed calls (their first argument
# holds the outputs): kind of each op
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
# allocations move no bytes
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_unsafe_view", "resize_", "set_"}


def _tensors(x) -> list:
    import torch
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(arg):
    """The global ranks of a functional collective's group name or a c10d
    ProcessGroup; None when unknown."""
    import torch.distributed as dist
    try:
        if isinstance(arg, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            arg = _resolve_process_group(arg)
        return dist.get_process_group_ranks(arg)
    except Exception:  # noqa: BLE001 — an unknown group prices as remote
        return None


def _register_vector_products() -> None:
    """FLOP formulas of the products ``flop_counter`` leaves out."""
    import torch
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    aten = torch.ops.aten
    if aten.mv not in flop_registry:
        @register_flop_formula([aten.mv, aten.addmv])
        def _(*args, out_shape=None, **kwargs):
            n, k = [a for a in args if isinstance(a, torch.Size)
                    and len(a) == 2][0]
            return 2 * n * k
    if aten.dot not in flop_registry:
        @register_flop_formula([aten.dot, aten.vdot])
        def _(a, b, *args, out_shape=None, **kwargs):
            return 2 * a[0]


class WorkCounter:
    """Counts one rank's work below DTensor (see the module docstring).

    ``with WorkCounter() as c: step()`` then ``c.flops``, ``c.bytes``,
    ``c.coll`` (bytes by kind, and ``"count"``),
    ``c.coll_s`` (seconds at each group's slowest link), ``c.peak``;
    ``c.track(tree)`` first counts tensors that already exist as live
    (their bytes also in ``c.args_bytes``)."""

    def __init__(self):
        _register_vector_products()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}
        self.coll["count"] = 0
        self.coll_s = 0.0
        self.live = 0
        self.peak = 0
        self.args_bytes = 0       # what ``track`` counted
        self.ops = 0
        self.propagations = 0     # DTensor shape propagations skipped
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self._mode = None
        self._paused = 0
        self._unpatch = None
        self._ranks: dict = {}

    # -- live storage ------------------------------------------------------
    def _add_storage(self, t) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tree) -> None:
        """Count the tensors (DTensors: their local blocks) of ``tree``
        as live from now on."""
        from repro_torch.distributed.layout import is_dtensor
        before = self.live
        for t in _tensors(tree):
            self._add_storage(t.to_local() if is_dtensor(t) else t)
        self.args_bytes += self.live - before

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self._unpatch = _patch_dtensor(self)
        self._mode = _CountingMode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        self._unpatch()
        return False

    def _collective(self, kind: str, nbytes: int, group) -> None:
        self.coll[kind] += nbytes
        self.coll["count"] += 1
        key = group if isinstance(group, str) else id(group)
        if key not in self._ranks:
            self._ranks[key] = _group_ranks(group)
        ranks = self._ranks[key]
        bw = link_bw(ranks) if ranks is not None else INTER_NODE_BW
        self.coll_s += nbytes / bw

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        self.ops += 1
        ns = func.namespace
        name = func._opname
        if ns == "_c10d_functional":
            kind = _FUNCTIONAL.get(name)
            if kind is not None:
                group = args[-1] if isinstance(args[-1], str) else \
                    kwargs.get("group_name")
                self._collective(kind, sum(map(_nbytes, _tensors(out))),
                                 group)
            return
        if ns == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                group = next((a for a in args
                              if type(a).__name__ == "ProcessGroup"), None)
                self._collective(kind, sum(map(_nbytes, _tensors(args[0]))),
                                 group)
            return
        if ns == "prim":
            return
        packet = func._overloadpacket
        f = flop_registry.get(packet)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not (func.is_view or name in _NO_TRAFFIC):
            ins = {id(t): t for t in _tensors((args, kwargs))}
            self.bytes += sum(map(_nbytes, ins.values()))
            self.bytes += sum(map(_nbytes, outs))
        for t in outs:
            self._add_storage(t)


def _patch_dtensor(counter):
    """While ``counter`` is active, skip the ops of DTensor's shape
    propagation (``ShardingPropagator._propagate_tensor_meta_non_cached``
    runs each op on global-shape fake tensors), and count DTensor's
    shard-to-shard all-to-all as one all-to-all of its output (on a CPU
    mesh DTensor emulates it by an all-gather and a chunk, which the
    card's NCCL does not).  A torch without either function raises
    AttributeError here rather than count global work as a rank's.
    Returns the function that restores DTensor."""
    import torch
    if not torch.distributed.is_available():
        return lambda: None
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    propagate = ShardingPropagator._propagate_tensor_meta_non_cached
    a2a = pt.shard_dim_alltoall

    def propagating(self, op_schema):
        counter._paused += 1
        counter.propagations += 1
        try:
            return propagate(self, op_schema)
        finally:
            counter._paused -= 1

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        counter._paused += 1
        try:
            out = a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter._paused -= 1
        counter._collective("all-to-all", _nbytes(out),
                            mesh.get_group(mesh_dim))
        return out
    ShardingPropagator._propagate_tensor_meta_non_cached = propagating
    pt.shard_dim_alltoall = all_to_all

    def restore():
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        pt.shard_dim_alltoall = a2a
    return restore


class _CountingMode:
    """The dispatch mode behind ``WorkCounter`` (built on first use, so
    importing this module imports no dispatch machinery)."""

    def __new__(cls, counter):
        from repro_torch.distributed.layout import is_dtensor
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.utils.flop_counter import flop_registry
                kwargs = kwargs or {}
                ins = _tensors((args, kwargs))
                if any(is_dtensor(t) for t in ins):
                    return NotImplemented
                if (func._overloadpacket not in flop_registry
                        and func.namespace == "aten"):
                    # a composite op (matmul under inference mode) is
                    # counted as the ops it decomposes into
                    with self:
                        r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
                out = func(*args, **kwargs)
                if not counter._paused:
                    counter._count(func, args, kwargs, out)
                return out

        return Mode()


def terms_from_counter(c: WorkCounter, n_chips: int, model_flops: float = 0.0,
                       calibration: dict | None = None,
                       peak_bytes: float | None = None) -> RooflineTerms:
    """``calibration`` (from ``launch/calibrate``): per-chip totals
    {flops, bytes, coll, coll_s} fitted to full depth — overrides the
    counts."""
    peak = float(c.peak if peak_bytes is None else peak_bytes)
    if calibration is not None:
        return RooflineTerms(
            flops=calibration["flops"], bytes_accessed=calibration["bytes"],
            collective_bytes=calibration["coll"], n_chips=n_chips,
            model_flops=model_flops, raw_flops=float(c.flops),
            correction="two-point-depth", peak_bytes=peak,
            collective_s=calibration["coll_s"])
    return RooflineTerms(
        flops=float(c.flops), bytes_accessed=float(c.bytes),
        collective_bytes=float(sum(c.coll[k] for k in COLLECTIVE_KINDS)),
        n_chips=n_chips, model_flops=model_flops, raw_flops=float(c.flops),
        peak_bytes=peak, collective_s=c.coll_s)


# ---------------------------------------------------------------------------
# analytic least work (the card's steps and kernels are held to these)
# ---------------------------------------------------------------------------

def bound(nbytes: float, nops: float, ops_per_s: float = FP32_FLOPS):
    """(ms, "bytes" or "operations"): the least time of moving ``nbytes``
    through HBM and doing ``nops`` at ``ops_per_s``, the larger."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_work(cfg, B: int, S: int):
    """The least bytes and operations of a bf16 prefill of ``B`` prompts
    of ``S`` tokens and of one decode step at position S: each weight
    read once (the embedding table only gathered; of a MoE layer's
    experts, all in the prefill and at most B * top_k in a step), the
    cache written once and read once a step, and 2 operations a
    multiply-add: the products of the tokens' active weights, the causal
    attention, the head at the last position only.  Returns ((bytes,
    ops) of the prefill, (bytes, ops) of a step)."""
    d, hd, H, Hkv, L = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                        cfg.n_layers)
    elt = 2
    attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    act, weights, weights_step = 0, 0, 0
    for i in range(L):
        if cfg.layer_is_moe(i):
            E, f, K = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.moe.top_k
            shared = 3 * d * f * cfg.moe.n_shared
            act += attn + d * E + 3 * d * f * K + shared
            weights += attn + d * E + 3 * d * f * E + shared
            weights_step += attn + d * E + 3 * d * f * min(E, B * K) + shared
        else:
            act += attn + 3 * d * cfg.d_ff
            weights += attn + 3 * d * cfg.d_ff
            weights_step += attn + 3 * d * cfg.d_ff
    head = d * cfg.vocab
    kv = 2 * L * B * Hkv * hd * elt                # bytes a position
    pre_ops = (2.0 * B * S * act + 2.0 * B * H * S * S * hd * L
               + 2.0 * B * head)
    pre_bytes = (elt * (weights + head + B * S * d) + kv * S
                 + 4 * B * cfg.vocab)
    step_ops = 2.0 * B * (act + head) + 4.0 * B * H * (S + 1) * hd * L
    step_bytes = (elt * (weights_step + head + B * d) + kv * (S + 1)
                  + 4 * B * cfg.vocab)
    return (pre_bytes, pre_ops), (step_bytes, step_ops)


def train_work(cfg, B: int, S: int):
    """(operations, AdamW bytes) of one training step of an LM on B
    sequences of S tokens: 6 operations a token for every weight of a
    product the token goes through (the embedding is a gather, not a
    product; of a MoE layer's experts the top-k and the shared), plus
    the causal attention (forward 2 and backward 5 products of S*S*hd
    multiply-adds, half masked, a head and layer); AdamW reads params,
    grads and both f32 moments and writes params and moments once."""
    emb = cfg.vocab * cfg.d_model
    ops = (6.0 * (cfg.active_param_count() - emb) * B * S
           + 7.0 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers)
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    return ops, cfg.param_count() * (3 * elt + 16)


def gnn_work(arch: str, cfg, n_edges: int) -> float:
    """Operations of one training step (3 x the forward) of a GNN over
    ``n_edges`` edges, by the reference's FLOP formulas (its
    ``build_cell``'s ``flops_per_edge``, kept in each config's
    ``cell_flops``)."""
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    return 3.0 * mod.cell_flops(cfg, n_edges)
