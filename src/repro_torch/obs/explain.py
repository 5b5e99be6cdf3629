"""Per-query explain reports: pure renderers over a precomputed context
(port of ``repro.obs.explain``).

The serving side assembles the facts (a traced search, an exact shadow
scan and the per-leaf bound lookups); this module only *renders* them —
as human-readable text (:func:`render_text`) or JSON
(:func:`render_json`) — so it stays importable from anywhere (it depends
on the standard library only).

Context schema (every key optional; renderers skip what is absent)::

    {
      "rid": int, "k": int, "target": float | None, "strategy": str,
      "served":  {"dists": [k floats], "ids": [k ints]},
      "cascade": {"n_leaves": int, "searched": int, "computed": int,
                  "pruned_box": int, "pruned_seed": int,
                  "pruned_filter": int, "probed": int, "overflow": int,
                  "distances": int},
      "leaves":  [{"leaf": int, "d_lb": float, "d_F": float | None,
                   "verdict": "kept" | "box" | "seed" | "filter"}, ...],
                  # closest-first by d_lb; a bounded prefix, not all L
      "shadow":  {"true_dists": [k floats], "true_ids": [k ints],
                  "recall": float,
                  "misses": [{"id": int, "dist": float, "leaf": int,
                              "bound": "box"|"seed"|"filter"|"timing"},
                             ...]},
      "health":  [LeafHealthReport.to_dict(), ...],   # flagged leaves
    }
"""
from __future__ import annotations

import json
from typing import Any, Dict


def _f(v: Any, nd: int = 4) -> str:
    try:
        return f"{float(v):.{nd}f}"
    except (TypeError, ValueError):
        return str(v)


def render_json(ctx: Dict[str, Any], indent: int = 2) -> str:
    """The context as JSON (numpy scalars coerced via ``default=float``)."""
    return json.dumps(ctx, indent=indent, default=float)


def render_text(ctx: Dict[str, Any]) -> str:
    """The context as an aligned human-readable report."""
    lines = []
    head = "explain"
    if "rid" in ctx:
        head += f" rid={ctx['rid']}"
    if ctx.get("k") is not None:
        head += f" k={ctx['k']}"
    if ctx.get("target") is not None:
        head += f" target={_f(ctx['target'], 3)}"
    if ctx.get("strategy"):
        head += f" [{ctx['strategy']}]"
    lines.append(head)

    served = ctx.get("served")
    if served:
        pairs = ", ".join(f"#{i}:{_f(d)}" for i, d in
                          zip(served.get("ids", []),
                              served.get("dists", [])))
        lines.append(f"  served kNN: {pairs}")

    cas = ctx.get("cascade")
    if cas:
        lines.append(
            f"  cascade: {cas.get('searched', '?')} searched of "
            f"{cas.get('n_leaves', '?')} leaves "
            f"(box {cas.get('pruned_box', 0)}, seed "
            f"{cas.get('pruned_seed', 0)}, filter "
            f"{cas.get('pruned_filter', 0)}"
            + (f", probed {cas['probed']}" if cas.get("probed") else "")
            + (", OVERFLOW→scan" if cas.get("overflow") else "") + ")")
        if cas.get("distances") is not None:
            lines.append(f"  distance rows paid: {cas['distances']}")

    leaves = ctx.get("leaves")
    if leaves:
        lines.append("  nearest leaves (by summarization lower bound):")
        lines.append("    leaf   d_lb       d_F        verdict")
        for row in leaves:
            d_f = row.get("d_F")
            lines.append(
                f"    {row.get('leaf', '?'):>4}   "
                f"{_f(row.get('d_lb')):>9}  "
                f"{('-' if d_f is None else _f(d_f)):>9}  "
                f"{row.get('verdict', '?')}")

    sh = ctx.get("shadow")
    if sh:
        lines.append(f"  shadow truth: recall {_f(sh.get('recall'), 3)} "
                     f"vs exact scan")
        misses = sh.get("misses", [])
        if misses:
            for m in misses:
                lines.append(
                    f"    MISSED true neighbor #{m.get('id', '?')} at "
                    f"{_f(m.get('dist'))} — leaf {m.get('leaf', '?')} "
                    f"pruned by {m.get('bound', '?')} bound")
        else:
            lines.append("    no true neighbors lost")

    health = ctx.get("health")
    if health:
        lines.append("  filters needing attention:")
        for r in health:
            lines.append(
                f"    leaf {r.get('leaf', '?')}: "
                f"{','.join(r.get('reasons', []))} "
                f"(violation rate {_f(r.get('violation_rate'), 3)}, "
                f"worst residual {_f(r.get('resid_min'))}, "
                f"shadow misses {r.get('shadow_misses', 0)})")
    return "\n".join(lines)
