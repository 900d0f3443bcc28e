"""repro_torch.obs - context-scoped tracing and counters (port of ``repro.obs``).

    from repro_torch import linalg, obs

    with obs.trace(name="chol") as tr:       # contextvar-scoped capture
        with linalg.use(policy="model"):
            linalg.cholesky(a)               # spans + provenance events
    tr.counters                              # counter delta of the capture

    obs.save_chrome_trace(tr, "chol.json")   # chrome://tracing / Perfetto
    obs.save_jsonl(tr, "chol.jsonl")         # one event per line
    print(obs.summary(tr))                   # per-(cat, name) rollup

The span schema (:data:`EVENT_FIELDS`), the exporters' file formats and
the counter vocabulary (:data:`KNOWN_COUNTERS`) are the reference's.
"""
from repro_torch.obs.counters import (KNOWN_COUNTERS, delta as counters_delta,
                                      inc, reset as reset_counters,
                                      snapshot as counters_snapshot,
                                      value as counter)
from repro_torch.obs.export import (save_chrome_trace, save_jsonl, summary,
                                    to_chrome_trace, to_jsonl)
from repro_torch.obs.trace import (EVENT_FIELDS, NOOP_SPAN, SCHEMA_VERSION,
                                   Span, Trace, annotate, capture,
                                   current_trace, enabled, event, span, trace)

__all__ = [
    "SCHEMA_VERSION", "EVENT_FIELDS",
    "Trace", "Span", "trace", "capture", "span", "event", "annotate",
    "enabled", "current_trace", "NOOP_SPAN",
    "KNOWN_COUNTERS", "inc", "counter", "counters_snapshot",
    "counters_delta", "reset_counters",
    "to_chrome_trace", "save_chrome_trace", "to_jsonl", "save_jsonl",
    "summary",
]
