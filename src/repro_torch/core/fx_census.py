"""Op-class census of arbitrary PyTorch functions over their aten graphs -
the paper's section 4, made mechanical (port of ``repro.core.jaxpr_census``).

The paper characterizes ddot/dgemv/dgemm/DGEQRF/DGETRF by hand-counting the
instructions and dependency hazards per floating-point class {mul, add, sqrt,
div}. For the model zoo we cannot hand-count whole model steps, so this
module derives the same parameters from the *aten graph* of any function,
traced by ``torch.fx.experimental.proxy_tensor.make_fx`` under a fake-tensor
mode (meta tensors stand for the reference's ``ShapeDtypeStruct``):

  * ``N_iI``  - elementwise op counts per class (mm/bmm/addmm/baddbmm
    unrolled into their mul+add volumes, reductions into adds),
  * ``N_iH``  - a program-order dependence proxy: elements of an operand
    produced by the *immediately preceding* node stall an in-order pipe
    (back-to-back dependence),
  * ``gamma_i`` - exposure fractions, defaulted per class from the paper's
    section-4 fits (mul 0.5 / add 0.5 / div 0.8 / sqrt 0.9) since graphs
    carry no timing,
  * critical path - longest node chain (unit weight), the DAG depth the
    paper reads off fig. 5.

The census converts to a :class:`repro_torch.core.characterization.
WorkloadProfile` so the whole paper pipeline (eq. 7 depths, codesign knobs)
applies to every architecture in the zoo. Transcendentals (exp/tanh/erf/
log/sigmoid), which BLAS and LAPACK lack but softmax/GeLU introduce, are
counted in an ``exp`` class and mapped onto the paper's divider pipe.

The walk follows the reference's ``_walk`` rule for rule; an aten node
plays a jaxpr equation. Where the two graphs differ, the census differs,
and each difference is deliberate (``tests/test_torch_census.py`` asserts
each one):

  * **Loops.** A Python loop unrolls in the trace: there is no ``scan`` node.
    The reference books a scan's loop-carried dependences as
    ``carry_size * (length - 1)`` adder hazards and walks each body from a
    fresh program order. Here they come from the unrolled chain itself:
    the first node of iteration t+1 consumes the last of iteration t, a
    back-to-back hazard booked in the class of that consuming node (the
    multiplier for ``c * 0.9 + 1.0``, the adder for ``c + 1.0``). The
    critical path lacks the reference's +1 of the scan equation.
  * **Branches.** Python ``if`` traces the branch taken; the reference's
    ``cond`` averages its branches' counts.
  * **Fused aten ops** count as the equations the reference's jaxpr holds
    for them: ``addmm``/``baddbmm`` a product then an add, ``mean`` a sum
    then a divide, ``silu`` a sigmoid then a multiply, each second part
    back-to-back on the first. ``_softmax``, ``_log_softmax`` and ``gelu``
    are decomposed by PyTorch's own decompositions (max, subtract, exp,
    sum, divide): ``jax.nn.softmax`` holds one more add-class op per row
    (its ``max(-inf, .)`` guard) and four equations more on its critical
    path (the guard, two ``broadcast_in_dim``, one ``stop_gradient``).
  * **Nested jit bodies.** jax 0.9 names a nested jit equation ``jit``;
    the reference's walk descends into ``pjit`` only, so it counts nothing
    inside one (``jax.nn.silu``, ``jnp.cumsum``: one equation, no ops).
    Their aten ops are counted here (``silu``: a sigmoid and a multiply per
    element; ``lax.cumsum``, which is not wrapped, agrees).
  * **Shape equations.** Every aten node counts one step of the critical
    path, views included, as every jaxpr equation does; broadcasting that
    jax spells as a ``broadcast_in_dim`` equation is implicit in aten (no
    node), and a keepdim reduction is one aten node where jax adds an
    ``expand_dims``.
  * **The card's kernels are opaque.** A wrapper of
    :mod:`repro_torch.kernels` launches its kernel through ctypes, which no
    dispatch mode sees, as a ``pallas_call`` body is opaque to the
    reference's walk. The fake tensors of the trace lie on the CPU, so
    every wrapper traces its plain version: the census counts the plain
    (CPU) route.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.characterization import T_O, T_P, WorkloadProfile
from repro_torch.core.pipeline_model import PipeParams

CLASSES = ("mul", "add", "div", "sqrt", "exp")
DEFAULT_GAMMA = {"mul": 0.5, "add": 0.5, "div": 0.8, "sqrt": 0.9, "exp": 0.8}

# aten (and prims) op names -> class, the reference's _ELEMWISE by name
_ELEMWISE = {
    "mul": "mul",
    "add": "add", "sub": "add", "rsub": "add", "maximum": "add",
    "minimum": "add", "neg": "add",
    "div": "div", "remainder": "div", "fmod": "div", "reciprocal": "div",
    "sqrt": "sqrt", "rsqrt": "sqrt",
    "exp": "exp", "log": "exp", "tanh": "exp", "sigmoid": "exp",
    "erf": "exp", "exp2": "exp", "log1p": "exp", "expm1": "exp",
    "cos": "exp", "sin": "exp",
}
_REDUCES = {"sum": "add", "amax": "add", "amin": "add", "max": "add",
            "min": "add", "argmax": "add", "argmin": "add", "cumsum": "add",
            "logcumsumexp": "exp", "prod": "mul", "cummax": "add"}
# reductions that are elementwise under one overload (max.other = maximum)
_ELEMWISE_OVERLOADS = {("max", "other"): "add", ("min", "other"): "add"}
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
_CONVS = ("convolution",)
# fused aten ops, each counted as two equations of the reference's jaxpr:
# (first class, second class); the second consumes the first
_FUSED = {"mean": ("add", "div"), "silu": ("exp", "mul")}

_aten = torch.ops.aten
# composite ops traced into their parts by PyTorch's decompositions
DECOMPOSE = (_aten._softmax, _aten._log_softmax, _aten.gelu)


def _size(node) -> float:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    if isinstance(val, (tuple, list)):
        return float(sum(_numel(v) for v in val))
    return _numel(val)


def _numel(val) -> float:
    if isinstance(val, torch.Tensor):
        return float(math.prod(val.shape)) if val.shape else 1.0
    return 1.0


def _shape(node) -> Tuple[int, ...]:
    return tuple(node.meta["val"].shape)


def _dot_muls(name: str, args) -> float:
    """mul count of a product: batch * free(lhs) * free(rhs) * contract."""
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = _shape(args[0]), _shape(args[1])
    if name == "dot":
        return float(a[0])
    if name == "mv":
        return float(a[0] * a[1])
    if name in ("mm", "addmm"):
        return float(a[0] * a[1] * b[1])
    return float(a[0] * a[1] * a[2] * b[2])        # bmm / baddbmm


def _op_name(target) -> Tuple[str, str]:
    """(name, overload) of an aten/prims op, in-place suffix dropped."""
    name = getattr(target, "_opname", None) or getattr(
        target, "__name__", str(target))
    return name.rstrip("_"), getattr(target, "_overloadname", "")


@dataclasses.dataclass
class Census:
    """Accumulated per-class counts for one traced function."""

    name: str
    n_i: Dict[str, float]
    n_h: Dict[str, float]
    critical_path: float
    flops: float
    n_eqns: int

    def hazard_ratios(self) -> Dict[str, float]:
        return {k: (self.n_h[k] / self.n_i[k] if self.n_i[k] else 0.0)
                for k in CLASSES}

    def to_profile(self, gamma: Dict[str, float] | None = None) -> WorkloadProfile:
        """Fold the census into the paper's four-pipe parameter space
        (``exp`` rides the divider pipe: both are long-latency iterative)."""
        g = dict(DEFAULT_GAMMA, **(gamma or {}))
        ni = dict(self.n_i)
        nh = dict(self.n_h)
        ni["div"] = ni["div"] + ni.pop("exp")
        nh["div"] = nh["div"] + nh.pop("exp")
        pipes = {
            k: PipeParams(n_i=ni[k], n_h=nh[k], gamma=g[k], t_p=T_P[k], t_o=T_O)
            for k in ("mul", "add", "div", "sqrt")
        }
        return WorkloadProfile(self.name, pipes, flops=self.flops,
                               critical_path=self.critical_path)


def _equations(node) -> List[Tuple[str | None, float, float]]:
    """The reference's equations for one aten node, in order: (class,
    instruction count, extra hazards) each; class None for an equation
    that counts nothing (views, copies, integer and boolean ops)."""
    if not isinstance(node.target, torch._ops.OpOverload):
        return [(None, 0.0, 0.0)]
    name, overload = _op_name(node.target)
    out_sz = _size(node)
    if name in _DOTS:
        muls = _dot_muls(name, node.args)
        # MXU-style: the k-reduction is a hardware tree; residual hazards
        # are per output element (one chain join each). Count 0: the
        # back-to-back proxy books one hazard, as for the reference's dot
        eqs = [("dot", muls, out_sz)]
        if name in ("addmm", "baddbmm"):
            eqs.append(("add", out_sz, 0.0))
        return eqs
    if name in _CONVS:
        # treat like a dot over the patch volume (weight: out x in x k...)
        patch = math.prod(_shape(node.args[1])[1:])
        return [("conv", out_sz * patch, 0.0)]
    if (name, overload) in _ELEMWISE_OVERLOADS:
        return [(_ELEMWISE_OVERLOADS[name, overload], out_sz, 0.0)]
    if name in _ELEMWISE:
        return [(_ELEMWISE[name], out_sz, 0.0)]
    if name == "pow":
        exponent = node.args[1] if len(node.args) > 1 else None
        if overload == "Tensor_Scalar" and float(exponent).is_integer():
            # the reference's integer_pow: |y| - 1 multiplies per element
            return [("mul", out_sz * max(abs(int(exponent)) - 1, 1), 0.0)]
        return [("exp", out_sz, 0.0)]
    if name in _FUSED:
        first, second = _FUSED[name]
        if name == "mean":
            return [_reduction(first, node, out_sz), (second, out_sz, 0.0)]
        return [(first, out_sz, 0.0), (second, out_sz, 0.0)]
    if name in _REDUCES:
        return [_reduction(_REDUCES[name], node, out_sz)]
    return [(None, 0.0, 0.0)]


def _reduction(cls: str, node, out_sz: float):
    """A reduction: max(in - out, out) ops, and a dependence tree of
    log2(fan-in) serial levels per output (returned as extra hazards)."""
    if _op_name(node.target)[0] in ("max", "min") and \
            isinstance(node.meta.get("val"), (tuple, list)):
        out_sz = _numel(node.meta["val"][0])      # (values, indices)
    in_sz = _size(node.args[0])
    fan = max(in_sz / max(out_sz, 1.0), 2.0)
    return ("reduce:" + cls, max(in_sz - out_sz, out_sz),
            out_sz * math.log2(fan))


def _walk(graph: torch.fx.Graph, acc: Census) -> float:
    """Accumulate counts over one aten graph; returns its DAG depth."""
    depth: Dict[Any, float] = {}
    alias: Dict[Any, Any] = {}
    prev_outs: set = set()
    max_depth = 0.0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            # tuple unpacking of a multi-output op: its output, not an op
            alias[node] = alias.get(node.args[0], node.args[0])
            depth[node] = depth.get(node.args[0], 0.0)
            continue
        inputs = [alias.get(v, v) for v in node.all_input_nodes]
        d = max([depth.get(v, 0.0) for v in inputs], default=0.0)
        operand_prev = any(v in prev_outs for v in inputs)
        for cls, count, extra in _equations(node):
            if cls in ("dot", "conv"):
                acc.n_i["mul"] += count
                acc.n_i["add"] += count     # one accumulate per product
                acc.flops += 2 * count
                acc.n_h["add"] += extra
                cls, count = "mul", 0.0
            elif cls is not None and cls.startswith("reduce:"):
                cls = cls[len("reduce:"):]
                acc.n_i[cls] += count
                acc.flops += count
                acc.n_h[cls] += extra
            elif cls is not None:
                acc.n_i[cls] += count
                acc.flops += count
            # back-to-back dependence proxy: operand produced by the
            # previous equation (a fused op's second part always is)
            if cls is not None and operand_prev:
                acc.n_h[cls] += min(_size(node), 1.0) if count == 0 \
                    else count
            d += 1.0
            acc.n_eqns += 1
            operand_prev = True
        depth[node] = d
        max_depth = max(max_depth, d)
        prev_outs = {node}
    return max_depth


def _trace(fn: Callable, args, kwargs) -> torch.fx.GraphModule:
    """The aten graph of ``fn(*args, **kwargs)`` on fake tensors: meta
    tensors become fake CPU tensors of their shape and dtype, real ones
    fake copies; other arguments are passed as they are."""
    from torch._decomp import get_decompositions
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "meta":
            with mode:
                return torch.empty(x.shape, dtype=x.dtype, device="cpu")
        return mode.from_tensor(x)

    flat, spec = pytree.tree_flatten((args, kwargs))
    is_tensor = [isinstance(x, torch.Tensor) for x in flat]
    tensors = [fake(x) for x, t in zip(flat, is_tensor) if t]

    def flat_fn(*ts):
        it = iter(ts)
        leaves = [next(it) if t else x for x, t in zip(flat, is_tensor)]
        a, kw = pytree.tree_unflatten(leaves, spec)
        return fn(*a, **kw)

    with mode:
        return make_fx(flat_fn, tracing_mode="real",
                       decomposition_table=get_decompositions(
                           list(DECOMPOSE)))(*tensors)


def census_of(fn: Callable, *args, name: str | None = None, **kwargs) -> Census:
    """Trace ``fn`` (abstractly - meta tensors fine) and census it."""
    return census_of_graph(_trace(fn, args, kwargs),
                           name or getattr(fn, "__name__", "fn"))


def census_of_graph(gm: torch.fx.GraphModule, name: str = "fn") -> Census:
    """The census of an aten graph traced elsewhere (with the
    decompositions of :data:`DECOMPOSE` applied, as :func:`census_of`
    traces)."""
    acc = Census(name, {k: 0.0 for k in CLASSES}, {k: 0.0 for k in CLASSES},
                 0.0, 0.0, 0)
    acc.critical_path = _walk(gm.graph, acc)
    # hazards can't exceed instructions in any class
    for k in CLASSES:
        acc.n_h[k] = min(acc.n_h[k], acc.n_i[k])
    return acc


def report(census: Census) -> str:
    prof = census.to_profile()
    lines = [f"census[{census.name}]: eqns={census.n_eqns} flops={census.flops:.3e} "
             f"critical_path={census.critical_path:.0f}"]
    depths = prof.optimal_depths()
    for k in CLASSES:
        if census.n_i[k] <= 0:
            continue
        ratio = census.n_h[k] / census.n_i[k]
        pk = "div" if k == "exp" else k
        lines.append(f"  {k:>4}: N_I={census.n_i[k]:.3e} N_H/N_I={ratio:.4f} "
                     f"p_opt={depths.get(pk, float('nan'))}")
    return "\n".join(lines)
