"""The scenario combinator IR: small algebraic trees over job-spec
fragments.

A :class:`ScenarioNode` is a frozen tree; the eight constructors are the
whole algebra (genjax-style combinators, specialized to workloads):

    leaf(jobs)                  a fragment: plain job spec dicts
    repeat(node, n[, period_s]) n copies of node, spaced period_s apart
    concat(*nodes[, gap_s])     sequence nodes back-to-back in time
    overlay(*nodes)             union of jobs (same-identity jobs merge)
    shift(node, dt_s)           translate every phase window by dt_s
    scale(node, time=, req=)    stretch time / scale request sizes
    mask(node, start_s=, end_s=) gate phases on a window (clip, drop empty)
    mix(*nodes, seed=, weights=) seeded deterministic choice of one node

Trees stay symbolic until :func:`to_jobs` expands them to ordinary job
spec dicts — the same vocabulary every other construction path uses — so
a tree lowers through the one :func:`repro_torch.scenario.lowering.lower`
pipeline like any hand-written spec.  The algebra's laws (``repeat(n)``
equals n-fold ``concat``, ``overlay`` commutes on disjoint job sets,
``shift(0)``/``mask(full)`` are identities *on the lowered arrays*) are
property-checked on the reference's copy, and the port's trees are held
to the reference's in ``tests/test_torch_scenario.py``.

Time arithmetic note: expansion adds/multiplies phase times as floats, so
two spellings of the same instant can differ by an ulp in the seconds
domain; the laws (and the bit-identity pins) hold on the lowered *tick*
arrays, where ``normalize_phases``'s contiguity snapping and the
seconds->tick rounding absorb ulp slush.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Mapping, Optional, Sequence

from .lowering import OPEN_END_S, normalize_phases

#: The combinator vocabulary (``ScenarioNode.op`` values).
NODE_OPS = ("leaf", "repeat", "concat", "overlay", "shift", "scale",
            "mask", "mix")


@dataclasses.dataclass(frozen=True)
class ScenarioNode:
    """One node of a combinator tree.  Build with the module-level
    constructors (:func:`leaf` .. :func:`mix`), not directly — they
    validate arguments and normalize children."""

    op: str
    children: tuple = ()
    jobs: tuple = ()             # leaf: job spec dicts
    n: int = 1                   # repeat
    period_s: Optional[float] = None   # repeat: copy spacing (default span)
    gap_s: float = 0.0           # concat: idle gap between children
    dt_s: float = 0.0            # shift
    time: float = 1.0            # scale: time stretch factor
    req: float = 1.0             # scale: request-size factor
    start_s: float = 0.0         # mask window
    end_s: float = OPEN_END_S    # mask window
    seed: int = 0                # mix
    weights: Optional[tuple] = None    # mix

    # algebra sugar: node | other == overlay, node >> other == concat
    def __or__(self, other: "ScenarioNode") -> "ScenarioNode":
        return overlay(self, other)

    def __rshift__(self, other: "ScenarioNode") -> "ScenarioNode":
        return concat(self, other)


def _as_nodes(children, op: str) -> tuple:
    if len(children) == 1 and isinstance(children[0], (list, tuple)):
        children = tuple(children[0])
    if not children:
        raise ValueError(f"{op}() needs at least one child node")
    for i, c in enumerate(children):
        if not isinstance(c, ScenarioNode):
            raise TypeError(
                f"{op}() child {i}: expected a ScenarioNode, got "
                f"{type(c).__name__}")
    return tuple(children)


def _one_node(node, op: str) -> ScenarioNode:
    if not isinstance(node, ScenarioNode):
        raise TypeError(
            f"{op}() expected a ScenarioNode, got {type(node).__name__}")
    return node


def leaf(jobs) -> ScenarioNode:
    """A fragment of one or more job spec dicts (validated eagerly)."""
    if isinstance(jobs, Mapping):
        jobs = [jobs]
    jobs = tuple(copy.deepcopy(dict(spec)) for spec in jobs)
    for j, spec in enumerate(jobs):
        normalize_phases(spec, f"leaf job {j}")
    return ScenarioNode(op="leaf", jobs=jobs)


def repeat(node, n: int, *, period_s: Optional[float] = None) -> ScenarioNode:
    """``n`` copies of ``node``, copy ``i`` shifted by ``i * period_s``
    (default: the node's span, i.e. back-to-back).  Same-identity jobs
    across copies merge into one phased job."""
    node = _one_node(node, "repeat")
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"repeat() needs n >= 1, got {n!r}")
    if period_s is not None and not float(period_s) > 0:
        raise ValueError(f"repeat() needs period_s > 0, got {period_s!r}")
    return ScenarioNode(op="repeat", children=(node,), n=n,
                        period_s=None if period_s is None else float(period_s))


def concat(*children, gap_s: float = 0.0) -> ScenarioNode:
    """Sequence children in time: each child starts where the previous
    one's span ends (plus ``gap_s`` of idle)."""
    kids = _as_nodes(children, "concat")
    if float(gap_s) < 0:
        raise ValueError(f"concat() needs gap_s >= 0, got {gap_s!r}")
    return ScenarioNode(op="concat", children=kids, gap_s=float(gap_s))


def overlay(*children) -> ScenarioNode:
    """Union of the children's jobs, run concurrently.  Jobs with the
    same identity (user/group/size/priority/procs/servers/overhead)
    merge their phase lists into one job."""
    return ScenarioNode(op="overlay", children=_as_nodes(children, "overlay"))


def shift(node, dt_s: float) -> ScenarioNode:
    """Translate every phase window of ``node`` by ``dt_s`` seconds."""
    return ScenarioNode(op="shift", children=(_one_node(node, "shift"),),
                        dt_s=float(dt_s))


def scale(node, *, time: float = 1.0, req: float = 1.0) -> ScenarioNode:
    """Stretch time by ``time`` (windows, think times, and arrival
    intervals scale up; Poisson rates scale down) and multiply request
    sizes by ``req``."""
    node = _one_node(node, "scale")
    if not float(time) > 0:
        raise ValueError(f"scale() needs time > 0, got {time!r}")
    if not float(req) > 0:
        raise ValueError(f"scale() needs req > 0, got {req!r}")
    return ScenarioNode(op="scale", children=(node,), time=float(time),
                        req=float(req))


def mask(node, *, start_s: float = 0.0,
         end_s: float = OPEN_END_S) -> ScenarioNode:
    """Gate ``node`` on the window ``[start_s, end_s)``: phases are
    clipped to it; phases (and then jobs) left empty are dropped."""
    node = _one_node(node, "mask")
    if not float(end_s) > float(start_s):
        raise ValueError(
            f"mask() needs end_s > start_s, got [{start_s}, {end_s})")
    return ScenarioNode(op="mask", children=(node,),
                        start_s=float(start_s), end_s=float(end_s))


def mix(*children, seed: int = 0,
        weights: Optional[Sequence[float]] = None) -> ScenarioNode:
    """Pick ONE child, deterministically from ``seed`` (blake2b-hashed —
    stable across platforms and numpy versions), optionally biased by
    ``weights``.  The whole tree stays serializable; re-loading with the
    same seed picks the same child."""
    kids = _as_nodes(children, "mix")
    if weights is not None:
        weights = tuple(float(w) for w in weights)
        if len(weights) != len(kids):
            raise ValueError(
                f"mix() got {len(weights)} weights for {len(kids)} children")
        if any(w < 0 for w in weights) or sum(weights) <= 0:
            raise ValueError(
                f"mix() weights must be >= 0 with a positive sum, "
                f"got {list(weights)}")
    return ScenarioNode(op="mix", children=kids, seed=int(seed),
                        weights=weights)


# -- expansion: tree -> job spec dicts -----------------------------------------
#
# Internal form during expansion: a list of (ident, phases) pairs, where
# ident = (user, group, size, priority, procs, servers, overhead_us) and
# phases are resolved seconds-domain dicts (normalize_phases output).
# Identity is what overlay merges on; phases are what the time operators
# rewrite.

def _ident(spec: Mapping) -> tuple:
    size = int(spec.get("size", 1))
    servers = spec.get("servers")
    return (int(spec.get("user", 0)), int(spec.get("group", 0)), size,
            float(spec.get("priority", 1.0)),
            int(spec.get("procs", size * 56)),
            None if servers is None else tuple(int(s) for s in servers),
            float(spec.get("overhead_us", 0.0)))


def _job_dict(ident: tuple, phases: list) -> dict:
    user, group, size, priority, procs, servers, overhead_us = ident
    d = dict(user=user, size=size, procs=procs,
             phases=[dict(ph) for ph in phases])
    if group:
        d["group"] = group
    if priority != 1.0:
        d["priority"] = priority
    if servers is not None:
        d["servers"] = list(servers)
    if overhead_us:
        d["overhead_us"] = overhead_us
    return d


def _span(pairs) -> float:
    return max([0.0] + [ph["end_s"] for _, phs in pairs for ph in phs])


def _require_bounded(pairs, op: str, which: str) -> float:
    span = _span(pairs)
    if span >= OPEN_END_S:
        raise ValueError(
            f"{op}(): {which} is open-ended (a phase ends at or after "
            f"{OPEN_END_S:g} s); give every job an end_s so its span is "
            f"defined")
    return span


def _shift_pairs(pairs, dt: float):
    return [(ident, [dict(ph, start_s=ph["start_s"] + dt,
                          end_s=ph["end_s"] + dt) for ph in phs])
            for ident, phs in pairs]


def _merge(parts):
    """Overlay semantics: concatenate job lists, merging same-identity
    jobs (first-occurrence order); merged phase lists sort by window."""
    order, by_ident = [], {}
    for pairs in parts:
        for ident, phs in pairs:
            if ident in by_ident:
                by_ident[ident].extend(phs)
            else:
                order.append(ident)
                by_ident[ident] = list(phs)
    out = []
    for ident in order:
        phs = by_ident[ident]
        if any(a["start_s"] > b["start_s"] or
               (a["start_s"] == b["start_s"] and a["end_s"] > b["end_s"])
               for a, b in zip(phs, phs[1:])):
            phs = sorted(phs, key=lambda p: (p["start_s"], p["end_s"]))
        out.append((ident, phs))
    return out


def _mix_uniform(seed: int) -> float:
    """Seed -> uniform [0, 1) via blake2b, not a numpy Generator — the
    choice must be identical across numpy versions and platforms because
    it is part of a scenario's serialized meaning."""
    h = hashlib.blake2b(str(int(seed)).encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def _expand(node: ScenarioNode):
    if node.op == "leaf":
        return [(_ident(spec), normalize_phases(spec, f"leaf job {j}"))
                for j, spec in enumerate(node.jobs)]
    if node.op == "overlay":
        return _merge([_expand(c) for c in node.children])
    if node.op == "shift":
        return _shift_pairs(_expand(node.children[0]), node.dt_s)
    if node.op == "repeat":
        pairs = _expand(node.children[0])
        period = node.period_s
        if period is None:
            period = _require_bounded(pairs, "repeat", "the child")
        return _merge([_shift_pairs(pairs, i * period)
                       for i in range(node.n)])
    if node.op == "concat":
        cursor, parts = 0.0, []
        for i, child in enumerate(node.children):
            pairs = _expand(child)
            parts.append(_shift_pairs(pairs, cursor))
            cursor += _require_bounded(pairs, "concat", f"child {i}")
            cursor += node.gap_s
        return _merge(parts)
    if node.op == "scale":
        k, r = node.time, node.req
        return [(ident,
                 [dict(ph, start_s=ph["start_s"] * k, end_s=ph["end_s"] * k,
                       think_s=ph["think_s"] * k, req_mb=ph["req_mb"] * r,
                       interval_s=ph["interval_s"] * k,
                       rate_hz=ph["rate_hz"] / k) for ph in phs])
                for ident, phs in _expand(node.children[0])]
    if node.op == "mask":
        lo, hi = node.start_s, node.end_s
        out = []
        for ident, phs in _expand(node.children[0]):
            clipped = []
            for ph in phs:
                s, e = max(ph["start_s"], lo), min(ph["end_s"], hi)
                if e > s:
                    clipped.append(dict(ph, start_s=s, end_s=e))
            if clipped:
                out.append((ident, clipped))
        return out
    if node.op == "mix":
        w = node.weights or tuple(1.0 for _ in node.children)
        total, u = sum(w), _mix_uniform(node.seed)
        acc, pick = 0.0, len(node.children) - 1
        for i, wi in enumerate(w):
            acc += wi / total
            if u < acc:
                pick = i
                break
        return _expand(node.children[pick])
    raise ValueError(
        f"unknown combinator op {node.op!r}. Accepted ops: {list(NODE_OPS)}.")


def to_jobs(node: ScenarioNode) -> list[dict]:
    """Expand a combinator tree to ordinary job spec dicts (the input
    vocabulary of :func:`repro_torch.scenario.lowering.lower`)."""
    return [_job_dict(ident, phs)
            for ident, phs in _expand(_one_node(node, "to_jobs"))]


# -- JSON codec ----------------------------------------------------------------

def node_to_doc(node: ScenarioNode) -> dict:
    """A combinator tree as a plain JSON-able document."""
    node = _one_node(node, "node_to_doc")
    d: dict = {"op": node.op}
    if node.op == "leaf":
        d["jobs"] = [copy.deepcopy(spec) for spec in node.jobs]
        return d
    if node.op in ("overlay", "concat", "mix"):
        d["children"] = [node_to_doc(c) for c in node.children]
    else:
        d["child"] = node_to_doc(node.children[0])
    if node.op == "repeat":
        d["n"] = node.n
        if node.period_s is not None:
            d["period_s"] = node.period_s
    elif node.op == "concat":
        if node.gap_s:
            d["gap_s"] = node.gap_s
    elif node.op == "shift":
        d["dt_s"] = node.dt_s
    elif node.op == "scale":
        d["time"] = node.time
        d["req"] = node.req
    elif node.op == "mask":
        d["start_s"] = node.start_s
        d["end_s"] = node.end_s
    elif node.op == "mix":
        d["seed"] = node.seed
        if node.weights is not None:
            d["weights"] = list(node.weights)
    return d


def node_from_doc(doc) -> ScenarioNode:
    """Rebuild a combinator tree from its JSON document (re-validating
    through the public constructors)."""
    if not isinstance(doc, Mapping):
        raise ValueError(
            f"scenario tree node must be an object with an 'op' field, "
            f"got {type(doc).__name__}")
    op = doc.get("op")
    if op not in NODE_OPS:
        raise ValueError(
            f"unknown combinator op {op!r}. Accepted ops: {list(NODE_OPS)}.")
    if op == "leaf":
        return leaf(doc.get("jobs", []))
    if op in ("overlay", "concat", "mix"):
        kids = [node_from_doc(c) for c in doc.get("children", [])]
        if op == "overlay":
            return overlay(*kids)
        if op == "concat":
            return concat(*kids, gap_s=doc.get("gap_s", 0.0))
        return mix(*kids, seed=doc.get("seed", 0),
                   weights=doc.get("weights"))
    child = node_from_doc(doc.get("child"))
    if op == "repeat":
        return repeat(child, doc.get("n", 1), period_s=doc.get("period_s"))
    if op == "shift":
        return shift(child, doc.get("dt_s", 0.0))
    if op == "scale":
        return scale(child, time=doc.get("time", 1.0), req=doc.get("req", 1.0))
    return mask(child, start_s=doc.get("start_s", 0.0),
                end_s=doc.get("end_s", OPEN_END_S))
