"""Dtype-flow lint over aten graphs (rules DF001-DF004): the counterpart
of ``repro.analysis.jaxpr_lint``, named like ``core.fx_census``.

Everything here reads the graph :func:`repro_torch.analysis.fake_card.trace`
builds with ``make_fx`` on fake tensors - tracing only, no execution, no
card. An aten node plays a jaxpr equation; the kernels are opaque to the
graph, as a ``pallas_call`` body is to the reference's walk, and their
launches are linted from their records (:mod:`repro_torch.analysis
.kernel_lint`, which owns KL003: a ``c_int`` slot that overflows, the
card's form of a 64-bit index).

Differences from the reference's walk, each deliberate:

- **No x64 mode.** PyTorch always has float64, so DF001 reads the graph as
  traced; there is nothing to switch on and off.
- **DF002's form.** aten refuses an ``mm`` over float64 operands with a
  narrower output (``mm.dtype`` takes fp32 out for fp16 / bf16 only), so a
  float64 accumulation narrowed in the port shows as a contraction whose
  operands were narrowed from float64 by the ``_to_copy`` feeding it; both
  forms are checked.
- **DF004's reads.** A host read (``aten._local_scalar_dense``) leaves no
  node: the trace answers it with a stand-in and records its site, and
  :func:`lint_dtype_flow` reports each recorded read; ``_to_copy`` /
  ``copy_`` from ``cuda`` to ``cpu`` are found in the graph.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.rules import Finding, make_finding

# aten contractions whose accumulation width DF002 checks (operands at
# these argument positions)
CONTRACTIONS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2),
                "baddbmm": (1, 2)}


def iter_nodes(gm) -> Iterator[torch.fx.Node]:
    """Every op node (``call_function``) of a traced graph, in order."""
    graph = getattr(gm, "graph", gm)
    for node in graph.nodes:
        if node.op == "call_function":
            yield node


def op_name(node) -> str:
    """The aten op's name without its overload or in-place suffix."""
    target = node.target
    name = getattr(target, "_opname", None) or getattr(
        target, "__name__", str(target))
    return name.rstrip("_")


def _val(arg):
    return arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None


def _dtype(arg) -> Optional[torch.dtype]:
    v = _val(arg)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _out_dtypes(node) -> List[torch.dtype]:
    v = node.meta.get("val")
    vals = v if isinstance(v, (tuple, list)) else [v]
    return [x.dtype for x in vals if isinstance(x, torch.Tensor)]


def _device(arg) -> Optional[str]:
    v = _val(arg)
    return v.device.type if isinstance(v, torch.Tensor) else None


def location(node) -> Optional[str]:
    """``repro_torch/<file>.py:<line>`` where the node's op was called (the
    trace labels each node), or None."""
    return node.meta.get("site")


def _width(dtype: torch.dtype) -> int:
    return dtype.itemsize


def input_dtypes(gm) -> List[torch.dtype]:
    """The dtypes of the graph's tensor inputs (its placeholders)."""
    graph = getattr(gm, "graph", gm)
    return [n.meta["val"].dtype for n in graph.nodes
            if n.op == "placeholder"
            and isinstance(n.meta.get("val"), torch.Tensor)]


def lint_dtype_flow(gm, routine: Optional[str] = None, accum_dtype=None,
                    host_reads: Sequence[Tuple[Optional[str], str]] = ()
                    ) -> List[Finding]:
    """DF001 / DF002 / DF003 / DF004 over one traced graph.

    ``accum_dtype`` is the active context's accumulation dtype: an explicit
    float64 accumulator legitimizes float64 intermediates over float32
    operands (DF001 stands down). ``host_reads`` are the trace's recorded
    host reads, (site, dtype) each: one DF004 finding per site."""
    findings: List[Finding] = []
    in_dtypes = input_dtypes(gm)
    f64_expected = torch.float64 in in_dtypes or (
        accum_dtype is not None and accum_dtype == torch.float64)
    narrowed_from_f64 = set()        # nodes: a _to_copy of an f64 tensor
    convert_origin = {}              # node -> the dtype it was converted from
    df1 = df3 = 0                    # first-hit reporting
    for node in iter_nodes(gm):
        name = op_name(node)
        outs = _out_dtypes(node)
        if not f64_expected and torch.float64 in outs:
            df1 += 1
            if df1 == 1:
                findings.append(make_finding(
                    "DF001", f"float64 intermediate from {name!r} under a "
                    f"non-f64 context (operands "
                    f"{[str(d).replace('torch.', '') for d in in_dtypes]})",
                    routine=routine, location=location(node)))
        if name in CONTRACTIONS:
            ops = [node.args[i] for i in CONTRACTIONS[name]
                   if i < len(node.args)]
            out = outs[0] if outs else None
            direct = len(ops) == 2 and all(
                _dtype(a) == torch.float64 for a in ops) and \
                out is not None and out != torch.float64
            via = len(ops) == 2 and all(a in narrowed_from_f64 for a in ops)
            if direct or via:
                findings.append(make_finding(
                    "DF002", f"f64 operands accumulate into a {out} "
                    f"{name!r} output (accumulator narrower than "
                    f"operands{'; narrowed on the way in' if via else ''})",
                    routine=routine, location=location(node)))
        if name in ("_to_copy", "copy"):
            src = node.args[1] if name == "copy" else node.args[0]
            if _device(src) == "cuda" and (_device(node) if name != "copy"
                                           else _device(node.args[0])) \
                    == "cpu":
                findings.append(make_finding(
                    "DF004", f"device-to-host transfer {name!r} of a "
                    f"{tuple(_val(src).shape)} tensor in traced body",
                    routine=routine, location=location(node)))
        if name == "_to_copy" and outs:
            src_dt, dst_dt = _dtype(node.args[0]), outs[0]
            if src_dt is not None and src_dt != dst_dt:
                if src_dt == torch.float64 and _width(dst_dt) < 8:
                    narrowed_from_f64.add(node)
                prior = convert_origin.get(node.args[0])
                if (prior is not None and prior == dst_dt
                        and _width(src_dt) < _width(dst_dt)
                        and dst_dt.is_floating_point):
                    df3 += 1
                    if df3 == 1:
                        findings.append(make_finding(
                            "DF003", f"convert round-trip {dst_dt} -> "
                            f"{src_dt} -> {dst_dt} through a narrower dtype",
                            routine=routine, location=location(node)))
                convert_origin[node] = src_dt
    seen = set()
    for where, dtype in host_reads:
        if where in seen:
            continue
        seen.add(where)
        n = sum(1 for w, _ in host_reads if w == where)
        findings.append(make_finding(
            "DF004", f"host read of a {dtype} value "
            f"(aten._local_scalar_dense, {n} time(s); traced with the "
            f"stand-in value) in traced body",
            routine=routine, location=where))
    return findings
