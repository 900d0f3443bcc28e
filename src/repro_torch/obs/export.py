"""Trace exporters: Chrome trace_event JSON, JSON-lines, text summary.

Port of ``repro.obs.export``: three serializations of one
:class:`repro_torch.obs.Trace`, in the reference's schema (the same
:data:`SCHEMA_VERSION` and event fields), so ``scripts/trace_report.py
--validate`` reads the port's files:

``to_chrome_trace`` / ``save_chrome_trace``
    The Chrome/Perfetto ``trace_event`` object format: closed spans
    become ``"ph": "X"`` complete events (``ts``/``dur`` in microseconds,
    sorted by ``ts``), instant events ``"ph": "i"``; span attrs ride in
    ``args`` and the counter delta + schema version in ``otherData``.
    Load the file in ``chrome://tracing`` or https://ui.perfetto.dev.

``to_jsonl`` / ``save_jsonl``
    One JSON object per line: a ``{"kind": "header"}`` line (schema
    version, trace name), one ``{"kind": "event"}`` line per event in the
    frozen :data:`repro_torch.obs.EVENT_FIELDS` layout, and a final
    ``{"kind": "counters"}`` line - the grep/pandas-friendly form.

``summary``
    Plain-text per-(cat, name) aggregation; ``scripts/trace_report.py``
    prints it for either on-disk format.
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.obs.trace import SCHEMA_VERSION, Span, Trace


def _sorted_events(tr: Trace) -> List[Span]:
    # spans append at close (children first); exporters order by start
    # time so consumers (and the monotonic-ts validator) see begin order
    return sorted(tr.events, key=lambda e: (e.t_start or 0.0, e.id or 0))


def to_chrome_trace(tr: Trace) -> Dict:
    """Trace -> Chrome ``trace_event`` object (JSON-able dict)."""
    events = []
    for e in _sorted_events(tr):
        d = e.to_dict()
        rec = {"name": e.name, "cat": e.cat, "pid": 0, "tid": 0,
               "ts": round((e.t_start or 0.0) * 1e6, 3),
               "args": dict(d["attrs"], id=e.id, parent=e.parent)}
        if e.t_end is None:
            rec.update(ph="i", s="t")               # thread-scoped instant
        else:
            rec.update(ph="X", dur=round((e.t_end - e.t_start) * 1e6, 3))
        events.append(rec)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"schema_version": SCHEMA_VERSION,
                          "trace_name": tr.name,
                          "counters": dict(tr.counters)}}


def save_chrome_trace(tr: Trace, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tr), f, indent=1)
    return path


def to_jsonl(tr: Trace) -> str:
    """Trace -> JSON-lines text (header, events, counters)."""
    lines = [json.dumps({"kind": "header", "schema_version": SCHEMA_VERSION,
                         "trace_name": tr.name})]
    lines += [json.dumps(dict(e.to_dict(), kind="event"))
              for e in _sorted_events(tr)]
    lines.append(json.dumps({"kind": "counters",
                             "counters": dict(tr.counters)}))
    return "\n".join(lines) + "\n"


def save_jsonl(tr: Trace, path: str) -> str:
    with open(path, "w") as f:
        f.write(to_jsonl(tr))
    return path


def summary(tr: Trace) -> str:
    """Plain-text rollup: per-(cat, name) count/total/mean wall time, the
    mean fraction-of-modeled-peak where spans priced one, and the counter
    delta."""
    groups: Dict = {}
    for e in tr.events:
        key = (e.cat, e.name)
        g = groups.setdefault(key, {"count": 0, "total_s": 0.0,
                                    "fracs": []})
        g["count"] += 1
        if e.t_end is not None and e.t_start is not None:
            g["total_s"] += e.t_end - e.t_start
        frac = e.attrs.get("fraction_of_modeled_peak")
        if isinstance(frac, (int, float)):
            g["fracs"].append(float(frac))
    lines = [f"trace {tr.name!r}: {len(tr.events)} events "
             f"(schema v{SCHEMA_VERSION})",
             f"{'cat':<12} {'name':<28} {'count':>6} {'total_ms':>10} "
             f"{'mean_ms':>9} {'frac_peak':>10}"]
    for (cat, name), g in sorted(groups.items(),
                                 key=lambda kv: -kv[1]["total_s"]):
        mean_ms = 1e3 * g["total_s"] / g["count"] if g["count"] else 0.0
        frac = (sum(g["fracs"]) / len(g["fracs"])) if g["fracs"] else None
        frac_s = f"{frac:.2e}" if frac is not None else "-"
        lines.append(f"{cat:<12} {name:<28} {g['count']:>6} "
                     f"{1e3 * g['total_s']:>10.3f} {mean_ms:>9.3f} "
                     f"{frac_s:>10}")
    if tr.counters:
        lines.append("counters:")
        lines += [f"  {k:<28} {v}" for k, v in sorted(tr.counters.items())]
    return "\n".join(lines)
