"""Multi-pod dry run (port of ``repro.launch.dryrun``): one rank's step of
every (arch x shape x mesh) cell, traced on fake tensors in a fake world
of 256 or 512 ranks, priced as a three-term roofline row.

The reference lowers and compiles each cell on 512 placeholder XLA devices
and reads the compiled program. PyTorch compiles no HLO, so for each cell
this module:

1. **joins a fake world**: ``torch.distributed`` with the ``"fake"``
   backend of ``torch.testing._internal.distributed.fake_pg`` (a module
   private to torch, in every release since 2.1; without it the dry run
   raises, naming it, and never carries on without one), as rank 0 of 256
   ranks for ``pod`` and 512 for ``multipod``. The fake backend moves no
   bytes. ``launch.mesh.make_production_mesh`` builds the mesh, which must
   be the whole world, so :func:`main` runs each mesh size in child
   processes of its own (the cells dealt out to one a CPU core: a trace
   is single-threaded Python);
2. **builds the inputs as fake tensors** (``FakeTensorMode``: no storage
   is allocated, whatever the model's size): the model of
   ``model_zoo.build`` on the trace's device, the train state placed by
   ``sharding.place_state`` at ``state_specs`` (DTensors, rank 0 keeping
   its blocks), the batch as DTensors at ``batch_specs``, the decode
   caches at ``cache_specs``;
3. **runs rank 0's step once** under a
   :class:`repro_torch.core.aten_cost.CostMode` (flops, bytes, collective
   bytes and the peak of live memory, at the aten level): train is
   ``make_train_step`` with ``make_shard_fn(mesh, model_axis_residual=)``;
   prefill is ``sharding.prefill(..., use_kernels=False)`` (the
   reference's ``use_pallas=False``) on this rank's rows of the batch;
   decode is ``sharding.decode_step``, flash-decoding on the rank's block
   of each cache whose sequence ``cache_specs`` splits over "model"
   (rank 0 holds the first block; the step's token, at ``seq_len - 1``,
   is the last rank's to write); each runs its products
   tensor-parallel over "model" (``sharding``'s docstring);
4. **prices the counts** as a :class:`repro_torch.core.roofline.Roofline`
   row (:func:`repro_torch.core.roofline.from_trace`, on the ``"h100"``
   machine).

The fake tensors are CUDA tensors where the build of PyTorch has CUDA:
the card route, with ``linalg.context.fake_card()`` and
``kernels.launch_record.record_launches()`` open; the trace asserts that
no kernel launched. A CPU-only build traces fake CPU tensors instead,
since autograd's engine needs a CUDA device guard such a build lacks; the
plain route the dry run takes computes the same ops on either device.
Host reads (``.item()``) get :mod:`repro_torch.analysis.fake_card`'s
stand-ins. The state's values are never read: the model is built without
a generator, its storage never initialized.

A row's ``coll_breakdown`` holds the c10d collectives' operand bytes as
the reference counts them; its ``extra`` holds the port's own counters
(``collective.bytes``, ``shard.redistribute_bytes``,
``shard.tp_all_reduce_bytes``: the bytes that reach the rank), the rank's
state and input bytes and the trace's seconds. The
TP collectives (row-parallel all-reduces, column-parallel input
gradients, the vocab-parallel loss's reductions, the gathers where a
consumer needs whole features) are c10d ops on the fake group like
ZeRO's, priced under the reference's kinds.

Usage::

    python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core import aten_cost
from repro_torch.core import roofline as rl
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models import model_zoo as zoo
from repro_torch.train import train_state as ts
from repro_torch.train.optimizer import AdamWConfig

FAKE_PG = "torch.testing._internal.distributed.fake_pg"
MACHINE = "h100"
WORLD = {"pod": 256, "multipod": 512}
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init_fake_world(world: int) -> None:
    """Join a fake world of ``world`` ranks as rank 0 (module docstring)."""
    try:
        import importlib
        fake_pg = importlib.import_module(FAKE_PG)
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's fake process group ({FAKE_PG}, a "
            f"module private to torch) and this torch {torch.__version__} "
            f"has none") from e
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)


def _require_fake_world() -> None:
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_backend() != "fake":
        raise RuntimeError("the dry run traces inside a fake world: call "
                           "init_fake_world(n) first (it moves no bytes; a "
                           "real process group would)")


def _require_fake_mode() -> None:
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("abstract inputs are built inside a "
                           "FakeTensorMode (they would allocate otherwise)")


def trace_device() -> torch.device:
    """Fake CUDA tensors where the build has CUDA, else fake CPU tensors
    (module docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def _opt_cfg(cfg) -> AdamWConfig:
    return AdamWConfig(eight_bit=cfg.opt_8bit)


def abstract_state(cfg, opt_cfg, device=None) -> dict:
    """The train state of ``cfg`` as fake tensors on ``device`` (default
    :func:`trace_device`); called inside a ``FakeTensorMode``."""
    _require_fake_mode()
    return ts.state_for(zoo.build(cfg, device or trace_device()), opt_cfg)


def abstract_caches(cfg, batch: int, max_len: int, model=None,
                    device=None):
    """The decode caches of ``cfg`` as fake tensors; the encoder-decoder's
    cross K / V are projected from a fake memory by ``model`` (built here
    when not given). Called inside a ``FakeTensorMode``."""
    _require_fake_mode()
    device = device or trace_device()
    model = model if model is not None else zoo.build(cfg, device)
    memory = None
    if cfg.family == "encdec":
        memory = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=device)
    with torch.no_grad():
        return zoo.init_caches(model, cfg, batch, max_len, memory=memory)


def _fake_inputs(specs: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in specs.items()}


def _placed(full: Dict[str, torch.Tensor], specs: Dict, mesh) -> Dict:
    return {k: sh.distribute(t, sh.NamedSharding(mesh, specs[k]))
            for k, t in full.items()}


@dataclasses.dataclass
class DryTrace:
    """What one cell's traced step counted (rank 0's)."""

    cost: aten_cost.Cost
    ops: Dict[str, List[float]]      # per aten op: calls, flops, bytes,
                                     # fused bytes, collective bytes
    input_bytes: int                 # the rank's state (or parameters and
                                     # caches) and batch, before the step
    state_bytes: int                 # the rank's train state or parameters
    peak_extra: int                  # most extra live bytes during the step
    counters: Dict[str, int]         # obs counters the step moved
    transport: List                  # collectives' TransportRecords
    launches: List                   # kernel launch records (must be none)
    host_reads: int
    trace_s: float


def _step(kind, cfg, shape, specs, mesh, shard_fn, accum, fsdp,
          seq_shard_cache, dev):
    """(step thunk, state bytes, input bytes, extra) of one cell, its
    inputs built on fake tensors (the caller holds the fake mode)."""
    if kind == "train":
        opt_cfg = _opt_cfg(cfg)
        state = sh.place_state(abstract_state(cfg, opt_cfg, dev), mesh,
                               fsdp=fsdp)
        full = _fake_inputs(specs, dev)
        batch = _placed(full, sh.batch_specs(full, mesh, accum=max(accum, 1)),
                        mesh)
        del full
        step = ts.make_train_step(cfg, opt_cfg, shard_fn)
        state_b = sh.local_bytes(state)
        return (lambda: step(state, batch)), state_b, \
            state_b + sh.local_bytes(batch), \
            {"spec_bytes": float(sh.spec_bytes(state, mesh, fsdp=fsdp))}
    model = zoo.build(cfg, dev)
    if kind == "prefill":
        sh.shard_model(model, mesh, fsdp=fsdp)
        full = _fake_inputs(specs, dev)
        placed = _placed(full, sh.batch_specs(full, mesh), mesh)
        del full

        def run():
            return sh.prefill(model, placed, cfg, shard_fn=shard_fn,
                              use_kernels=False)
        state_b = sh.local_bytes(model)
        return run, state_b, state_b + sh.local_bytes(placed), {}
    caches = sh.place_caches(abstract_caches(cfg, shape.global_batch,
                                             shape.seq_len, model, dev),
                             mesh, seq_shard=seq_shard_cache)
    sh.shard_model(model, mesh, fsdp=fsdp)
    token = torch.empty(specs["token"][0], dtype=specs["token"][1],
                        device=dev)
    index = shape.seq_len - 1                 # the last slot: a full cache

    def run():
        with torch.no_grad():
            return sh.decode_step(model, token, cfg, caches, index,
                                  shard_fn=shard_fn)
    state_b = sh.local_bytes(model)
    return run, state_b, state_b + sh.local_bytes(caches) + \
        token.numel() * token.element_size(), {}


def lower_cell(arch: str, shape_name: str, mesh, *, accum=None,
               model_axis_residual: bool = False, fsdp: bool = True,
               seq_shard_cache: bool = True, extra_tags=None,
               overrides=None, global_batch: Optional[int] = None,
               seq_len: Optional[int] = None):
    """Trace rank 0's step of one cell on fake tensors; returns
    ``(trace, row)``: a :class:`DryTrace` and its
    :class:`~repro_torch.core.roofline.Roofline`. ``mesh`` is a
    ``DeviceMesh`` of the fake world (:func:`init_fake_world`).

    ``overrides``: ``dataclasses.replace`` kwargs applied to the arch
    config (remat_policy, accum_steps, dtype, ...); ``accum`` sets the
    config's microbatches too, so the step matches its batch;
    ``global_batch`` cuts the shape's batch, ``seq_len`` its sequence
    (a decode cell's cache slots)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.collectives import record_transport
    from repro_torch.kernels.launch_record import record_launches
    from repro_torch.linalg.context import fake_card
    from repro_torch.obs import counters

    _require_fake_world()
    cfg = registry.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if accum is None:
        accum = cfg.accum_steps          # overrides-aware default
    elif accum != cfg.accum_steps:
        cfg = dataclasses.replace(cfg, accum_steps=accum)
    shape = registry.SHAPE_BY_NAME[shape_name]
    if global_batch:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    kind, specs = registry.input_specs(arch, shape_name, accum=accum,
                                       global_batch=global_batch)
    shard_fn = sh.make_shard_fn(mesh, model_axis_residual=model_axis_residual)
    chips = mesh.size()
    n_params = zoo.param_count(cfg)
    n_active = zoo.active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    model_flops = {"train": 6.0 * n_active * tokens,
                   "prefill": 2.0 * n_active * tokens,
                   "decode": 2.0 * n_active * shape.global_batch}[kind]
    dev = trace_device()
    cost = aten_cost.CostMode()
    with contextlib.ExitStack() as st:
        st.enter_context(fake_card())
        launches = st.enter_context(record_launches())
        transport = st.enter_context(record_transport())
        st.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        run, state_b, input_b, cell_extra = _step(
            kind, cfg, shape, specs, mesh, shard_fn, accum, fsdp,
            seq_shard_cache, dev)
        del transport[:]                     # placement's, not the step's
        before = counters.snapshot()
        t0 = time.perf_counter()
        with cost:
            out = run()
        trace_s = time.perf_counter() - t0
        moved = counters.delta(before)
        del out, run
    if launches:
        raise RuntimeError(f"the dry run's trace of {arch} x {shape_name} "
                           f"recorded {len(launches)} kernel launches; it "
                           f"traces the plain route only")
    trace = DryTrace(cost.cost, cost.ops, input_b, state_b, cost.peak,
                     moved, list(transport), list(launches), cost.host_reads,
                     trace_s)
    extra = {"trace_s": trace_s, "n_params": float(n_params),
             "n_active": float(n_active), "kind": kind, "rank": 0,
             "device": dev.type, "state_bytes": float(state_b),
             "input_bytes": float(input_b), "peak_extra_bytes":
                 float(cost.peak), "host_reads": float(cost.host_reads),
             "collective.bytes": float(moved.get("collective.bytes", 0)),
             "shard.redistribute_bytes": float(
                 moved.get("shard.redistribute_bytes", 0)),
             "shard.tp_all_reduce_bytes": float(
                 moved.get("shard.tp_all_reduce_bytes", 0)),
             **{f"product_flops.{dt}": f for dt, f in cost.products.items()},
             **cell_extra, **(extra_tags or {})}
    row = rl.from_trace(arch, shape_name, mesh_name(mesh), chips,
                        cost.cost, model_flops, input_b + cost.peak,
                        extra=extra, machine=MACHINE)
    return trace, row


def _mesh_for(mname: str):
    multi = mname == "multipod"
    return make_production_mesh(multi_pod=multi,
                                device_type=trace_device().type)


def _lower_cells(args, mname: str, cells) -> None:
    """A child's part of :func:`main`: the fake world of ``mname``'s size,
    then each cell, its row (or its traceback) under ``args.out``."""
    init_fake_world(WORLD[mname])
    mesh = _mesh_for(mname)
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{mname}"
        print(f"LOWER  {tag} ...", flush=True)
        try:
            trace, row = lower_cell(
                arch, shape, mesh, accum=args.accum,
                model_axis_residual=args.model_axis_residual,
                seq_shard_cache=not args.no_seq_shard_cache)
            with gzip.open(os.path.join(args.out, tag + ".ops.json.gz"),
                           "wt") as f:
                json.dump(trace.ops, f, indent=0)
            gib = 2 ** 30
            print(f"  trace: {trace.trace_s:.1f} s, peak "
                  f"{row.bytes_per_device / gib:.2f} GiB a rank (inputs "
                  f"{trace.input_bytes / gib:.2f} GiB)")
            print(f"  flops={row.hlo_flops:.3e} bytes={row.hlo_bytes:.3e} "
                  f"bytes_unfused={trace.cost.bytes:.3e}")
            print(f"  collectives: {row.coll_breakdown}")
            print(f"  terms: compute={row.compute_s * 1e3:.2f}ms "
                  f"memory={row.memory_s * 1e3:.2f}ms "
                  f"collective={row.collective_s * 1e3:.2f}ms "
                  f"dominant={row.dominant} "
                  f"roofline_frac={row.roofline_fraction:.3f}", flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(row.to_dict(), f, indent=1)
        except Exception:
            print(f"FAILED {tag}", flush=True)
            traceback.print_exc()
            with open(os.path.join(args.out, tag + ".FAILED"), "w") as f:
                f.write(traceback.format_exc())


def _child(args, mname: str, cells) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
           mname, "--out", args.out, "--child-cells",
           ",".join(f"{a}:{s}" for a, s in cells)]
    if args.accum is not None:
        cmd += ["--accum", str(args.accum)]
    if args.model_axis_residual:
        cmd.append("--model-axis-residual")
    if args.no_seq_shard_cache:
        cmd.append("--no-seq-shard-cache")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_SRC + (os.pathsep + path if path
                                              else ""))
    return subprocess.Popen(cmd, env=env)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCHS)
    ap.add_argument("--shape", choices=[s.name for s in registry.SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--model-axis-residual", action="store_true")
    ap.add_argument("--no-seq-shard-cache", action="store_true")
    ap.add_argument("--child-cells", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child_cells:
        _lower_cells(args, args.mesh, [tuple(c.split(":")) for c in
                                       args.child_cells.split(",")])
        return

    meshes = [m for m in ("pod", "multipod") if args.mesh in (m, "both")]
    if args.all:
        cells, skipped = registry.all_cells()
        for s in skipped:
            print(f"SKIP {s[0]} x {s[1]}: {s[2]}")
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    for mname in meshes:
        todo = []
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{mname}"
            if os.path.exists(os.path.join(args.out, tag + ".json")):
                print(f"CACHED {tag}")
            else:
                todo.append((arch, shape))
        sys.stdout.flush()
        jobs = min(os.cpu_count() or 1, len(todo))
        children = [_child(args, mname, todo[j::jobs]) for j in range(jobs)
                    if todo]
        for c in children:
            if c.wait():
                raise SystemExit(f"dry run of the {mname} mesh failed "
                                 f"(exit code {c.returncode})")


if __name__ == "__main__":
    main()
