"""Op lint: verdict what solver routes execute against their contracts
(the port's counterpart of ``repro/analysis/jaxpr_lint.py``; there is no
jaxpr in eager PyTorch, so the routes are run and their ops recorded).

:class:`Recorder` installs thin wrappers for the length of a lint (a
``with`` block) and restores every one on exit; a solve outside it runs
the unwrapped code.  The wrappers change no result, only note where the
ops run:

  * ``engine._round`` and ``_round_shared`` (and the bidirectional
    module's ``_round``): the **round** scope, one round a call;
  * ``engine._cond`` and ``bidirectional._bidi_go``: the **cond** scope,
    the keep-going predicates (the targeted early exit's ``fixed[target]``
    read lives there);
  * ``engine._loop``, ``_frontier_fixpoint`` and
    ``BidirectionalSolver.solve``: the loops that drive rounds (a round's
    host reads are the counted read that admitted it plus its own);
  * ``engine.SyncCounter._read``: the counted host reads;
  * the entries of ``kernels/ops.py`` and
    ``backends.CollectiveCounter.all_reduce_min``, recorded as
    ``ops.<name>`` and ``dist.all_reduce_min`` sites; the aten ops inside
    a kernel entry are the kernel's (its plain version on the CPU, the
    wrapper's own allocations on the card).

``_loop`` and ``_frontier_fixpoint`` look their callees up as module
globals, and the backends look ``ops.*`` up when they are built, so a
route's solver is built inside the ``with`` block.  While
:meth:`Recorder.record` is active a ``TorchDispatchMode`` records every
aten op: name, input and output shapes, output dtypes, device, scope;
the kernels' launch counts (``kernels/_build.LAUNCHES``) are read around
each round.

:func:`lint_route` verdicts one route's :class:`RouteTrace` against the
``contracts`` registry:

  * required ops present in the rounds (``ops.relax_ell`` on the pallas
    route, ``aten.cumsum`` and ``ops.frontier_relax_b`` on the frontier
    route: a route that quietly fell back to a dense or plain path fails)
    and, on the card, every kernel entry's kernel launched once a call;
  * forbidden ops absent (an uncounted host read anywhere, ``sort`` in a
    round);
  * the value dtypes (no f64/f16/bf16);
  * a dense-pass budget: the most sweep ops over a full edge-layout
    dimension (``e_pad``, the ELL row width) any round makes, as the
    reference counts them: a gather by its output shape, a scatter-class
    op or cumsum by its inputs, a kernel entry by its inputs (B3, B4) or
    its output (B1/B2, which read only the frontier's edges);
  * a host-read budget a round, and, where asked, one op sequence for
    every round (``trace_audit.TraceAudit`` over the rounds' op
    signatures: a dense round is one program a shape).

The reference counts the static equations of a compiled while body; the
port counts the ops a round executes, so a budget is the largest count a
round reaches on the probe routes (``routes.build_routes``): a branch
that runs only on overflow counts only where it ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.contracts import (KERNEL_ENTRIES, REGISTRY,
                                            WIDE_DTYPES, ContractSpec,
                                            Waiver, match_waiver)
from repro_torch.analysis.trace_audit import TraceAudit

#: gather-class ops, judged by their OUTPUT shape: a gather sweeps an
#: edge layout only when it makes an edge-sized result.
GATHER_OPS = frozenset({"aten.gather", "aten.index_select", "aten.index",
                        "aten.take"})
#: scatter-class ops and cumsum, judged by their INPUTS (their dense cost
#: is the operand/update stream, whatever the result's shape).
SCATTER_OPS = frozenset({"aten.scatter", "aten.scatter_add",
                         "aten.scatter_reduce", "aten.index_put",
                         "aten.index_add", "aten.index_reduce",
                         "aten.cumsum"})
#: kernel entries that sweep by their inputs (B3 reads the ELL table, B4
#: its [B, n] operands) or by their output (B1/B2 read only the buffered
#: vertices' out-edges).
ENTRY_BY_INPUT = frozenset({"ops.relax_ell", "ops.masked_min_pair"})
ENTRY_BY_OUTPUT = frozenset({"ops.frontier_relax_b", "ops.frontier_relax"})

#: ``kernels/ops.py`` entries the recorder wraps (the kernel entries of
#: ``contracts.KERNEL_ENTRIES`` and the plain CSR/CSC gathers).
OPS_ENTRIES = ("relax_ell", "masked_min_pair", "frontier_relax",
               "frontier_relax_b", "out_nbrs", "in_min_at")


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One op a route executed."""

    op: str          # "aten.cumsum", "ops.relax_ell", "dist.all_reduce_min"
    scope: str       # "round" | "cond" | "outside"
    kernel: bool     # an aten op inside a kernel entry
    counted: bool    # inside SyncCounter.read
    round: int       # index of the round it ran in (-1 outside)
    in_dims: tuple[tuple[int, ...], ...]
    out_dims: tuple[tuple[int, ...], ...]
    out_dtypes: tuple[str, ...]
    device: str


@dataclasses.dataclass
class RoundStat:
    """What one round (one ``_round``/``_round_shared`` call) did."""

    index: int
    host_reads: int = 0                 # admitting read + its own
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RouteTrace:
    """Everything a recorded run executed."""

    sites: list[OpSite] = dataclasses.field(default_factory=list)
    rounds: list[RoundStat] = dataclasses.field(default_factory=list)
    reads: int = 0                      # counted host reads in all
    launches: dict[str, int] = dataclasses.field(default_factory=dict)

    def round_sites(self, i: int) -> list[OpSite]:
        return [s for s in self.sites
                if s.round == i and s.scope == "round" and not s.kernel]

    def round_signature(self, i: int) -> tuple[str, ...]:
        """Round i's op sequence, one ``"op in_dims -> out_dims dtypes"``
        string an op (strings are keyed by value in a ``TraceAudit``)."""
        return tuple(f"{s.op} {list(s.in_dims)} -> {list(s.out_dims)} "
                     f"{list(s.out_dtypes)}" for s in self.round_sites(i))


def base_name(op: str) -> str:
    """``aten.scatter_reduce.amin`` -> ``aten.scatter_reduce``;
    ``aten.index[bool]`` -> ``aten.index``."""
    return ".".join(op.split("[")[0].split(".")[:2])


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in ``x``: tensors, sequences, dicts, and the tensor
    fields of dataclasses such as ``EllGraph``/``CsrGraph``."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                if isinstance(t := getattr(x, f.name, None), torch.Tensor)]
    return []


def _shapes(ts) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(t.shape) for t in ts)


def _dtypes(ts) -> tuple[str, ...]:
    return tuple(str(t.dtype).replace("torch.", "") for t in ts)


def _aten_name(func, args, kwargs, outs) -> str:
    name = "aten." + func.overloadpacket.__name__.rstrip("_")
    if name == "aten.scatter_reduce":
        reduce = kwargs.get("reduce") or next(
            (a for a in args if isinstance(a, str)), "")
        return f"{name}.{reduce}"
    if name in ("aten.index", "aten.index_put") and len(args) > 1 and any(
            t is not None and t.dtype == torch.bool
            for t in _tensors(list(args[1]))):
        return f"{name}[bool]"
    if name in ("aten._to_copy", "aten.copy"):
        ins = [t.device.type for t in _tensors(list(args))]
        dst = [t.device.type for t in outs]
        if "cuda" in ins and dst and dst[0] == "cpu":
            return "d2h_copy"
    return name


class _Mode(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors(list(args)) + _tensors(list(kwargs.values()))
        dev = (ins or outs or [None])[0]
        self.rec._site(_aten_name(func, args, kwargs, outs), _shapes(ins),
                       _shapes(outs), _dtypes(outs),
                       "cpu" if dev is None else dev.device.type)
        return out


class Recorder:
    """Installs the scope wrappers (``with Recorder() as rec:``) and
    records routes (``with rec.record() as trace: solver.solve(0)``).

    Build the solvers of a route inside the ``with`` block: the backends
    bind the ``ops`` entries when they are made.  ``sync_debug`` (e.g.
    ``"error"``) runs every recorded block under
    ``torch.cuda.set_sync_debug_mode`` when CUDA is available, so an
    uncounted sync on the card raises where it happens
    (``SyncCounter.read`` lifts the mode for its own reads); the set-up
    outside the recorded blocks (layouts and deltas built on the host)
    runs without it.
    """

    def __init__(self, sync_debug: str | None = None):
        self.sync_debug = sync_debug
        self._trace: RouteTrace | None = None
        self._scope = "outside"
        self._kernel = 0
        self._counted = 0
        self._round = -1
        self._in_loop = 0
        self._pending = 0          # counted reads since the last round
        self._round_reads = 0
        self._undo: list = []

    # --- wrappers ------------------------------------------------------
    def __enter__(self) -> "Recorder":
        from repro_torch.core.sssp import backends, bidirectional, engine
        from repro_torch.kernels import ops

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self._undo.append((owner, name, orig))
            setattr(owner, name, functools.wraps(orig)(make(orig)))

        for owner in (engine, bidirectional):
            patch(owner, "_round", self._round_wrapper)
        patch(engine, "_round_shared", self._round_wrapper)
        patch(engine, "_cond", self._cond_wrapper)
        patch(bidirectional, "_bidi_go", self._cond_wrapper)
        patch(engine, "_loop", self._loop_wrapper)
        patch(engine, "_frontier_fixpoint", self._loop_wrapper)
        patch(bidirectional.BidirectionalSolver, "solve", self._loop_wrapper)
        patch(engine.SyncCounter, "_read", self._read_wrapper)
        for name in OPS_ENTRIES:
            patch(ops, name, functools.partial(self._entry_wrapper,
                                               f"ops.{name}"))
        patch(backends.CollectiveCounter, "all_reduce_min",
              functools.partial(self._entry_wrapper, "dist.all_reduce_min"))
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    @contextlib.contextmanager
    def record(self):
        """Record every op run inside the block into a ``RouteTrace``."""
        from repro_torch.kernels import _build
        if not self._undo:
            raise RuntimeError("Recorder.record() outside `with Recorder()`")
        trace = RouteTrace()
        before = dict(_build.LAUNCHES)
        debug = self.sync_debug is not None and torch.cuda.is_available()
        mode = torch.cuda.get_sync_debug_mode() if debug else None
        self._trace = trace
        try:
            if debug:
                torch.cuda.set_sync_debug_mode(self.sync_debug)
            with _Mode(self):
                yield trace
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode(mode)
            self._trace = None
            trace.launches = {k: v - before.get(k, 0)
                              for k, v in _build.LAUNCHES.items()
                              if v != before.get(k, 0)}

    def _site(self, op, in_dims, out_dims, out_dtypes, device) -> None:
        if self._trace is not None:
            self._trace.sites.append(OpSite(
                op, self._scope, self._kernel > 0, self._counted > 0,
                self._round, in_dims, out_dims, out_dtypes, device))

    def _round_wrapper(self, orig):
        def run(*args, **kwargs):
            if self._trace is None or self._scope == "round":
                return orig(*args, **kwargs)
            from repro_torch.kernels import _build
            stat = RoundStat(index=len(self._trace.rounds))
            self._trace.rounds.append(stat)
            before = dict(_build.LAUNCHES)
            self._round, self._scope, self._round_reads = stat.index, \
                "round", 0
            try:
                return orig(*args, **kwargs)
            finally:
                self._round, self._scope = -1, "outside"
                stat.host_reads = self._pending + self._round_reads
                self._pending = 0
                stat.launches = {k: v - before.get(k, 0)
                                 for k, v in _build.LAUNCHES.items()
                                 if v != before.get(k, 0)}
        return run

    def _cond_wrapper(self, orig):
        def run(*args, **kwargs):
            if self._trace is None or self._scope != "outside":
                return orig(*args, **kwargs)
            self._scope = "cond"
            try:
                return orig(*args, **kwargs)
            finally:
                self._scope = "outside"
        return run

    def _loop_wrapper(self, orig):
        def run(*args, **kwargs):
            self._in_loop += 1
            self._pending = 0
            try:
                return orig(*args, **kwargs)
            finally:
                self._in_loop -= 1
        return run

    def _read_wrapper(self, orig):
        def run(*args, **kwargs):
            if self._trace is not None:
                self._trace.reads += 1
                if self._scope == "round":
                    self._round_reads += 1
                elif self._in_loop:
                    self._pending += 1
            self._counted += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._counted -= 1
        return run

    def _entry_wrapper(self, name, orig):
        kernel = name in KERNEL_ENTRIES

        def run(*args, **kwargs):
            if self._trace is None:
                return orig(*args, **kwargs)
            ins = _tensors(list(args))
            self._kernel += kernel
            try:
                out = orig(*args, **kwargs)
            finally:
                self._kernel -= kernel
            outs = _tensors(out)
            self._site(name, _shapes(ins), _shapes(outs), _dtypes(outs),
                       ins[0].device.type if ins else "cpu")
            return out
        return run


def dense_pass_count(sites: list[OpSite],
                     dense_dims: frozenset[int]) -> int:
    """Round-scope sweep ops touching a full edge-layout dimension."""
    def hits(dims) -> bool:
        return any(d in dense_dims for sh in dims for d in sh)

    n = 0
    for s in sites:
        if s.scope != "round" or s.kernel:
            continue
        b = base_name(s.op)
        if b in GATHER_OPS or s.op in ENTRY_BY_OUTPUT:
            n += hits(s.out_dims)
        elif b in SCATTER_OPS or s.op in ENTRY_BY_INPUT:
            n += hits(s.in_dims)
    return n


@dataclasses.dataclass
class Violation:
    rule: str        # "require:aten.cumsum" | "forbid:aten._local_scalar_
    #                  dense" | "dense_budget" | "read_budget" |
    #                  "dtype:float64" | "launch:relax_ell" | ...
    detail: str
    waiver: Waiver | None = None


@dataclasses.dataclass
class RouteVerdict:
    route: str
    verdict: str                 # "PASS" | "FAIL" | "KNOWN_VIOLATION"
    rounds: int
    dense_passes: int            # the most of any round
    dense_budget: int | None
    host_reads: int              # the most of any round
    read_budget: int | None
    round_ops: int               # the most ops of any round
    round_programs: int          # distinct op sequences over the rounds
    launches: dict[str, int]
    ops_hot: dict[str, int]
    violations: list[Violation]
    contracts: list[str]         # spec names that applied

    def to_json(self) -> dict:
        return dict(
            verdict=self.verdict, rounds=self.rounds,
            dense_passes=self.dense_passes, dense_budget=self.dense_budget,
            host_reads=self.host_reads, read_budget=self.read_budget,
            round_ops=self.round_ops, round_programs=self.round_programs,
            launches=self.launches, contracts=self.contracts,
            violations=[
                dict(rule=v.rule, detail=v.detail,
                     waived=v.waiver is not None,
                     waiver=None if v.waiver is None else dict(
                         reason=v.waiver.reason, expires=v.waiver.expires))
                for v in self.violations],
        )


@dataclasses.dataclass
class LintReport:
    """All route verdicts of one gate run."""

    routes: dict[str, RouteVerdict]

    @property
    def failed(self) -> list[RouteVerdict]:
        return [v for v in self.routes.values() if v.verdict == "FAIL"]

    @property
    def waived(self) -> list[RouteVerdict]:
        return [v for v in self.routes.values()
                if v.verdict == "KNOWN_VIOLATION"]

    def to_json(self) -> dict:
        return {name: v.to_json() for name, v in
                sorted(self.routes.items())}


def _present(alternatives: str, names: set[str]) -> bool:
    return any(alt in names for alt in alternatives.split("|"))


def round_stats(trace: RouteTrace, dense_dims: frozenset[int]):
    """Per round: (dense passes, host reads, ops) and the route's
    ``TraceAudit`` over the rounds' op signatures."""
    audit = TraceAudit("rounds")
    stats = []
    for r in trace.rounds:
        sites = trace.round_sites(r.index)
        audit.record(trace.round_signature(r.index))
        stats.append((dense_pass_count(sites, dense_dims), r.host_reads,
                      len(sites)))
    return stats, audit


def lint_route(route: str, trace: RouteTrace, *,
               dense_dims: frozenset[int] = frozenset(),
               specs: dict[str, ContractSpec] | None = None,
               waivers=None) -> RouteVerdict:
    """Verdict one route's recorded run against every applicable
    contract."""
    from repro_torch.analysis.contracts import KNOWN_VIOLATIONS
    specs = REGISTRY if specs is None else specs
    waivers = KNOWN_VIOLATIONS if waivers is None else waivers
    sites = trace.sites
    hot = [s for s in sites if s.scope == "round" and not s.kernel]
    hot_names = {s.op for s in hot}
    cond_names = {s.op for s in sites if s.scope == "cond"}
    # a kernel's plain version stands in for it on the CPU: its own host
    # reads are not the route's; on the card every op is
    loose = {s.op for s in sites if not s.counted
             and (not s.kernel or s.device == "cuda")}
    stats, audit = round_stats(trace, dense_dims)
    passes = max((p for p, _, _ in stats), default=0)
    reads = max((r for _, r, _ in stats), default=0)

    violations: list[Violation] = []
    applied: list[str] = []
    budget = read_budget = None
    uniform = False

    def add(rule: str, detail: str) -> None:
        violations.append(Violation(rule, detail, match_waiver(
            route, rule, waivers)))

    if not trace.rounds:
        add("rounds", "the route ran no round")
    for spec in specs.values():
        if spec.composes or not spec.applies_to(route):
            continue
        applied.append(spec.name)
        for req in spec.require:
            if not _present(req, hot_names):
                add(f"require:{req}",
                    f"[{spec.name}] no round ran {req!r}")
        for req in spec.require_cond:
            if not _present(req, cond_names):
                add(f"require_cond:{req}",
                    f"[{spec.name}] the keep-going predicate lacks {req!r} "
                    "(the early exit is not evaluated)")
        for bad in spec.forbid:
            if bad in loose:
                add(f"forbid:{bad}",
                    f"[{spec.name}] {bad!r} outside SyncCounter.read "
                    "(an uncounted host read)")
        for bad in spec.forbid_hot:
            if bad in hot_names:
                add(f"forbid_hot:{bad}",
                    f"[{spec.name}] {bad!r} inside a round")
        if not spec.allow_wide_dtypes:
            wide = sorted({dt for s in sites for dt in s.out_dtypes
                           if dt in WIDE_DTYPES})
            for dt in wide:
                add(f"dtype:{dt}",
                    f"[{spec.name}] {dt} value in the route: rounds are "
                    "32-bit by contract")
        b = spec.budget_for(route)
        if b is not None:
            budget = b if budget is None else min(budget, b)
        b = spec.reads_for(route)
        if b is not None:
            read_budget = b if read_budget is None else min(read_budget, b)
        uniform = uniform or spec.same_round_ops

    if budget is not None and passes > budget:
        add("dense_budget",
            f"{passes} dense edge sweeps in a round exceed the declared "
            f"budget of {budget} (dims {sorted(dense_dims)})")
    if read_budget is not None and reads > read_budget:
        add("read_budget",
            f"{reads} host reads in a round exceed the declared budget of "
            f"{read_budget}")
    if uniform and audit.trace_count > 1:
        add("same_round_ops",
            f"{audit.trace_count} distinct round op sequences: "
            + audit.explain_last())
    calls = Counter(s.op for s in sites
                    if s.op in KERNEL_ENTRIES and s.device == "cuda")
    for entry, n_calls in sorted(calls.items()):
        key = KERNEL_ENTRIES[entry]
        if trace.launches.get(key, 0) != n_calls:
            add(f"launch:{key}",
                f"{entry} ran {n_calls} times on the card but launched "
                f"{key} {trace.launches.get(key, 0)} times (a plain "
                "fallback)")

    # de-duplicate identical rule ids raised by overlapping specs
    seen: dict[str, Violation] = {}
    for v in violations:
        seen.setdefault(v.rule, v)
    violations = list(seen.values())

    if not violations:
        verdict = "PASS"
    elif all(v.waiver is not None for v in violations):
        verdict = "KNOWN_VIOLATION"
    else:
        verdict = "FAIL"
    return RouteVerdict(
        route=route, verdict=verdict, rounds=len(trace.rounds),
        dense_passes=passes, dense_budget=budget, host_reads=reads,
        read_budget=read_budget,
        round_ops=max((o for _, _, o in stats), default=0),
        round_programs=audit.trace_count, launches=dict(trace.launches),
        ops_hot=dict(sorted(Counter(s.op for s in hot).items())),
        violations=violations, contracts=sorted(applied))
