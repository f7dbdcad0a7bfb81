"""Program contracts: invariants declared next to the code they govern
(port of ``repro/analysis/contracts.py``).

A :class:`ContractSpec` names what must be true of what one or more
solver routes *execute*, round by round: ops that must run inside a
round (the frontier route must actually run its compacted relax through
B2, the pallas route its B3/B4 entries), ops that must never run (an
uncounted host read anywhere, ``sort`` inside a round), a per-round
budget of dense full-edge-layout sweeps and one of host reads, whether
every round issues the same op sequence, and the 32-bit value
discipline.  Specs are attached with the :func:`contract` decorator in
the modules they describe (engine, backends, solver, dynamic,
bidirectional, fleet, service) and collected here in ``REGISTRY``;
``analysis.op_lint`` records each route's ops and verdicts it.

The vocabulary is what an eager round issues, not jaxpr primitives:

  * ``aten.<op>`` names an aten op by its overload packet, a trailing
    in-place ``_`` dropped (``aten.cumsum``, ``aten.index_select``,
    ``aten.gather``, ``aten.amin``); a ``scatter_reduce`` carries its
    reduction (``aten.scatter_reduce.amin``, the segment min);
  * ``ops.<entry>`` names an entry of ``kernels/ops.py`` a round passed
    through (``ops.relax_ell``: B3, ``ops.masked_min_pair``: B4,
    ``ops.frontier_relax_b``: B2 fused with its CSR gather,
    ``ops.frontier_relax``: B1).  On the card every kernel entry must
    also have launched its kernel once a call (``KERNEL_ENTRIES``): the
    reference's ``pallas_call`` requirement;
  * ``dist.all_reduce_min`` is a MIN all-reduce counted by
    ``backends.CollectiveCounter`` (the reference's ``pmin``);
  * ``d2h_copy`` is a device-to-host copy of a card tensor.

Routes are dotted names like ``"segment.cold"``, ``"frontier.batched"``,
``"bidi.pair"``, ``"fleet.warm"``; specs select routes by ``fnmatch``
patterns, so one spec can govern a family (``"*.warm"``).

A violation that is *known and tolerated for now* must match a
:class:`Waiver` in ``KNOWN_VIOLATIONS``, which turns the verdict into
``KNOWN_VIOLATION`` until the waiver expires; a waiver that matches
nothing is stale and fails the gate until it is deleted.  The list is
empty, as the reference's.
"""
from __future__ import annotations

import dataclasses
import datetime
from fnmatch import fnmatch

#: Ops that read a value back to the host.  Outside
#: ``engine.SyncCounter.read`` each one is an uncounted host read
#: (``.item()``, ``bool()``, ``float()`` and ``int()`` of a tensor
#: dispatch ``_local_scalar_dense``; ``nonzero``, ``masked_select`` and a
#: boolean-mask index wait for the device to size their output).  On the
#: card a device-to-host copy is one too.  ``.tolist()`` and ``.numpy()``
#: of a CPU tensor dispatch nothing: ``astlint``'s host-sync rule covers
#: those in the round scopes.
HOST_SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero",
                 "aten.masked_select", "aten.index[bool]", "d2h_copy")

#: Value dtypes a round may not make: the rounds are f32/i32/bool (their
#: bandwidth is the cost).  int64 is allowed, unlike the reference's
#: rule: torch's index ops take int64 indices, and the frontier route's
#: ``edges_relaxed`` counter is int64 on purpose.
WIDE_DTYPES = ("float64", "float16", "bfloat16", "complex128")

#: kernel entries of ``kernels/ops.py`` -> the launch key
#: (``kernels/_build.LAUNCHES``) of the kernel each call launches on the
#: card.  Their plain versions stand in for the kernels on the CPU.
KERNEL_ENTRIES = {
    "ops.relax_ell": "relax_ell",
    "ops.masked_min_pair": "masked_min_pair",
    "ops.frontier_relax_b": "frontier_relax_csr",
    "ops.frontier_relax": "frontier_relax",
}


@dataclasses.dataclass(frozen=True)
class ContractSpec:
    """One declared invariant set over a family of solver routes.

    ``require``/``forbid_hot`` look only inside the rounds
    (``engine._round``, ``_round_shared``); ``forbid`` looks at every op
    of the route outside ``SyncCounter.read``.  A ``require`` entry may
    list alternatives separated by ``|`` (any one satisfies it).
    ``require_cond`` looks only inside the keep-going predicates
    (``engine._cond``, where the targeted early exit reads
    ``fixed[target]``).

    ``dense_budget`` caps the dense edge sweeps of a round (the most any
    round of the route makes); ``read_budget`` caps its host reads (the
    counted read that admitted it plus its own).  Each is one int for
    every matched route or a ``{route-pattern: int}`` dict (most specific
    match wins; a pattern must match or the budget is unconstrained for
    that route).  ``same_round_ops`` asks every round of a route to
    issue the same op sequence with the same shapes (a dense round is
    one program a shape).
    """

    name: str
    routes: tuple[str, ...] = ("*",)
    require: tuple[str, ...] = ()
    require_cond: tuple[str, ...] = ()
    forbid: tuple[str, ...] = ()
    forbid_hot: tuple[str, ...] = ()
    dense_budget: int | dict[str, int] | None = None
    read_budget: int | dict[str, int] | None = None
    same_round_ops: bool = False
    allow_wide_dtypes: bool = False
    composes: tuple[str, ...] = ()  # route patterns this surface rides on
    notes: str = ""

    def applies_to(self, route: str) -> bool:
        return any(fnmatch(route, pat) for pat in self.routes)

    def budget_for(self, route: str) -> int | None:
        return _budget(self.dense_budget, route)

    def reads_for(self, route: str) -> int | None:
        return _budget(self.read_budget, route)


def _budget(budget, route: str) -> int | None:
    if budget is None or isinstance(budget, int):
        return budget
    best, best_len = None, -1
    for pat, cap in budget.items():
        if fnmatch(route, pat) and len(pat) > best_len:
            best, best_len = cap, len(pat)
    return best


#: name -> spec; populated by the ``@contract`` decorators at import of
#: the governed modules (``check`` imports them all before linting).
REGISTRY: dict[str, ContractSpec] = {}


def contract(name: str, **kw):
    """Declare a :class:`ContractSpec` next to the code it governs.

    Usable on functions and classes; the spec lands in ``REGISTRY`` and
    is also attached to the object as ``__contracts__``.  Decorating is
    metadata-only: it never wraps or changes the callable.
    """
    spec = ContractSpec(name=name, **kw)

    def deco(obj):
        REGISTRY[name] = spec
        try:
            obj.__contracts__ = getattr(obj, "__contracts__", ()) + (spec,)
        except (AttributeError, TypeError):
            pass  # frozen/slotted objects keep the registry entry only
        return obj

    return deco


@dataclasses.dataclass(frozen=True)
class Waiver:
    """A known, tolerated contract violation, with an expiry date.

    ``route`` and ``rule`` are fnmatch patterns against the route name
    and the violation's rule id (``"require:aten.cumsum"``,
    ``"dense_budget"``, ``"forbid:aten._local_scalar_dense"`` ...).  An
    expired waiver stops matching and the violation becomes a hard FAIL;
    a waiver that matches nothing is reported stale.
    """

    route: str
    rule: str
    reason: str
    expires: str  # ISO date, e.g. "2027-06-30"

    def expired(self, today: datetime.date | None = None) -> bool:
        today = today or datetime.date.today()
        return today > datetime.date.fromisoformat(self.expires)

    def matches(self, route: str, rule: str,
                today: datetime.date | None = None) -> bool:
        return (not self.expired(today) and fnmatch(route, self.route)
                and fnmatch(rule, self.rule))


#: The port's open, acknowledged gaps: none.
KNOWN_VIOLATIONS: tuple[Waiver, ...] = ()


def match_waiver(route: str, rule: str,
                 waivers: tuple[Waiver, ...] = KNOWN_VIOLATIONS,
                 today: datetime.date | None = None) -> Waiver | None:
    for w in waivers:
        if w.matches(route, rule, today):
            return w
    return None
