"""repro_torch's checkpoints, fault tolerance and training loop.

The reference's own tests of these (``tests/test_ckpt.py``,
``tests/test_fault_tolerance.py``, ``tests/test_train_integration.py``)
run here against the port on the CPU, with the reference's ``ittest``
config. Checkpoints are held to the reference's layout both ways: each
package reads a checkpoint of a flat dict of f32, int8 and int32 arrays
that the other wrote, bitwise. Tolerances: a resumed run's losses equal
the uninterrupted run's within rtol 1e-4, the reference's bound for the
same check (the CPU repeats the same operations, so they agree far
closer); the eval loss matches the reference's within rtol 1e-5 (f32
sums in another order).
"""
import dataclasses
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.models.config import ModelConfig as JConfig
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.ckpt import checkpoint as ck
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import train_loop
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.fault_tolerance import (Heartbeat, SimulatedFailure,
                                                 StragglerDetector,
                                                 run_with_restarts)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as ts
from repro_torch.train.optimizer import AdamWConfig

CFG = ModelConfig("ittest", "dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv=2, d_ff=128, vocab=97, dtype="float32")
OPT = AdamWConfig(lr=5e-3, warmup_steps=5, decay_steps=200)
DATA = DataConfig(vocab=97, global_batch=8, seq_len=32)
RESUME_RTOL = 1e-4
EVAL_RTOL = 1e-5


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": (torch.ones(3), torch.zeros((2, 2)))}}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _flat_arrays(rng):
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "codes": rng.integers(-127, 128, size=(3, 256)).astype(np.int8),
            "step": np.asarray(17, np.int32),
            "ids": rng.integers(0, 1000, size=(11,)).astype(np.int32)}


# -------------------------------- checkpoints -------------------------------

def test_save_restore_roundtrip():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 5, t)
        r, step = ck.restore(d, _tree(1))
        assert step == 5 and _equal(r, t)


def test_train_state_roundtrip_is_bitwise():
    """A model's parameters, the step and 8-bit moments (named tuples)
    after two steps come back bitwise, into an uninitialized model."""
    opt = dataclasses.replace(OPT, eight_bit=True)
    state = ts.init_state(torch.Generator().manual_seed(0), CFG, opt,
                          device="cpu")
    step = ts.make_train_step(CFG, opt)
    for i in range(2):
        state, _ = step(state, make_batch(CFG, DATA, i, device="cpu"))
    from repro_torch.models import model_zoo
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, state)
        with open(os.path.join(d, "step_0000000001", "manifest.json")) as f:
            man = json.load(f)
        assert "params/blocks/0/attn/wq" in man["keys"]
        assert "opt/m/blocks/0/attn/wq/.q" in man["keys"]
        assert man["dtypes"]["opt/v/embed/table/.q"] == "int8"
        assert man["dtypes"]["opt/step"] == "int32"
        like = ts.state_for(model_zoo.build(CFG, "cpu"), opt)
        r, s = ck.restore(d, like)
    assert s == 1 and r["params"] is like["params"]
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              r["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert _equal(r["opt"], state["opt"])
    assert isinstance(r["opt"]["m"]["embed/table"], topt._Moment)


def test_keep_n_gc():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        for s in range(6):
            ck.save(d, s, t, keep=3)
        assert ck.all_steps(d) == [3, 4, 5]


def test_atomic_no_partial_dirs():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, t)
        assert all(not n.startswith(".tmp") for n in os.listdir(d))
        with open(os.path.join(d, "step_0000000001", "manifest.json")) as f:
            man = json.load(f)
        assert man["step"] == 1
        assert man["keys"] == sorted(["a", "nested/b", "nested/c/0",
                                      "nested/c/1"])
        assert man["shapes"]["a"] == [8, 8]


def test_failed_save_leaves_no_partial_dir():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(TypeError, match="bfloat16"):
            ck.save(d, 1, {"x": torch.zeros(2, dtype=torch.bfloat16)})
        assert os.listdir(d) == [] and ck.latest_step(d) is None


def test_restore_missing_key_errors():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 0, _tree())
        with pytest.raises(KeyError, match="missing keys"):
            ck.restore(d, {"zzz": torch.zeros(1)})


def test_restore_corrupt_arrays_errors():
    with tempfile.TemporaryDirectory() as d:
        path = ck.save(d, 2, _tree())
        with open(os.path.join(path, "arrays.npz"), "wb") as f:
            f.write(b"not a zip archive")
        with pytest.raises(ValueError):               # numpy: not an npz
            ck.restore(d, _tree())


def test_restore_missing_file_errors():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            ck.restore(d, _tree())
        path = ck.save(d, 3, _tree())
        os.remove(os.path.join(path, "manifest.json"))
        with pytest.raises(FileNotFoundError):
            ck.restore(d, _tree())


def test_latest_step_empty():
    with tempfile.TemporaryDirectory() as d:
        assert ck.latest_step(d) is None
        state, step = CheckpointManager(d).restore_latest(
            {"x": torch.zeros(1)})
        assert state is None and step == -1


def test_manager_interval():
    mgr = CheckpointManager("unused", save_interval=10)
    assert not mgr.should_save(0)
    assert mgr.should_save(10)
    assert not mgr.should_save(11)


def test_reference_reads_port_checkpoint(rng):
    arrays = _flat_arrays(rng)
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 4, {k: torch.from_numpy(v) for k, v in arrays.items()})
        like = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in arrays.items()}
        got, step = jck.restore(d, like)
    assert step == 4
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_port_reads_reference_checkpoint(rng):
    arrays = _flat_arrays(rng)
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, 9, {k: jnp.asarray(v) for k, v in arrays.items()})
        with open(os.path.join(d, "step_0000000009", "manifest.json")) as f:
            jman = json.load(f)
        got, step = ck.restore(d, {k: torch.zeros(1) for k in arrays})
    assert step == 9
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 9, {k: torch.from_numpy(v) for k, v in arrays.items()})
        with open(os.path.join(d, "step_0000000009", "manifest.json")) as f:
            assert json.load(f) == jman             # the same manifest


# ------------------------------ fault tolerance -----------------------------

def test_heartbeat():
    with tempfile.TemporaryDirectory() as d:
        hb = Heartbeat(os.path.join(d, "hb.json"))
        assert hb.is_stale(0.1)
        hb.beat(3)
        assert not hb.is_stale(5.0)
        assert hb.age() < 5.0


def test_straggler_detection():
    det = StragglerDetector(window=20, threshold=2.0)
    for i in range(20):
        det.observe(i, 0.10)
    assert det.observe(20, 0.50)
    assert not det.observe(21, 0.12)
    rep = det.report()
    assert rep["flagged"] == [20]
    assert abs(rep["median_s"] - 0.10) < 0.02
    det.start()
    time.sleep(0.001)
    det.stop(22)
    assert len(det.durations) == 23


def test_run_with_restarts_gives_up():
    def always_fails(_):
        raise SimulatedFailure("boom")
    rep = run_with_restarts(always_fails, max_restarts=2)
    assert not rep.completed
    assert rep.restarts == 2


def test_run_with_restarts_immediate_success():
    rep = run_with_restarts(lambda _: 1, max_restarts=2)
    assert rep.completed and rep.restarts == 0


# ------------------------------- training loop ------------------------------

def test_loss_decreases():
    state = ts.init_state(torch.Generator().manual_seed(0), CFG, OPT,
                          device="cpu")
    step = ts.make_train_step(CFG, OPT)
    losses = []
    for i in range(40):
        state, m = step(state, make_batch(CFG, DATA, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert all(np.isfinite(losses))


def test_resume_trajectory_consistent():
    """Fail at step 10 with checkpoints every 5, resume: the losses after
    the resume equal the uninterrupted run's."""
    with tempfile.TemporaryDirectory() as d:
        _, ref_hist = train_loop(CFG, OPT, DATA, None, steps=16,
                                 ckpt_dir=os.path.join(d, "a"),
                                 save_interval=1000, device="cpu")
        ckpt = os.path.join(d, "b")
        with pytest.raises(SimulatedFailure):
            train_loop(CFG, OPT, DATA, None, steps=16, ckpt_dir=ckpt,
                       save_interval=5, fail_at_step=10, device="cpu")
        assert ck.latest_step(ckpt) == 5
        _, hist2 = train_loop(CFG, OPT, DATA, None, steps=16,
                              ckpt_dir=ckpt, save_interval=5, device="cpu")
    assert len(hist2) == 10
    np.testing.assert_allclose(hist2, ref_hist[6:], rtol=RESUME_RTOL)


def test_run_with_restarts_recovers():
    with tempfile.TemporaryDirectory() as d:
        calls = {"n": 0}

        def loop(_resume):
            calls["n"] += 1
            fail_at = 7 if calls["n"] == 1 else -1
            train_loop(CFG, OPT, DATA, None, steps=12, ckpt_dir=d,
                       save_interval=3, fail_at_step=fail_at, device="cpu")
            return 12

        report = run_with_restarts(loop, max_restarts=2)
        assert report.completed and report.restarts == 1
        assert CheckpointManager(d).latest_step() == 11
        assert os.path.exists(os.path.join(d, "heartbeat.json"))


def test_eval_step_matches_reference():
    """The eval loss of the reference's parameters on the reference's
    batch, both packages (no grads recorded on the port's side)."""
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, JAdamW())
    model = convert.from_jax_params(jax.tree.map(np.asarray,
                                                 jstate["params"]),
                                    CFG, device="cpu")
    state = ts.state_for(model, OPT)
    batch = make_batch(CFG, DATA, 0, device="cpu")
    out = ts.make_eval_step(CFG)(state, batch)
    want = jax.jit(jts.make_eval_step(jcfg))(
        jstate, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    assert not out["loss"].requires_grad
    np.testing.assert_allclose(out["loss"].item(), float(want["loss"]),
                               rtol=EVAL_RTOL)


def test_mesh_waits_for_distributed():
    """A mesh is made of torch.distributed ranks: without a process group
    ``--mesh debug`` trains on one device, ``--mesh pod`` raises, and so
    does a mesh asked for directly (``tests/test_torch_shard.py`` runs
    ``train_loop(mesh=...)`` on ranks)."""
    from repro_torch.launch.mesh import make_debug_mesh
    assert launch_train.make_mesh("debug") is None
    assert launch_train.make_mesh("none") is None
    with pytest.raises(RuntimeError, match="pod"):
        launch_train.make_mesh("pod")
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(data=2, model=2)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(CFG, OPT, DATA, None, steps=1, ckpt_dir="unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.init_state(None, CFG, OPT)


def test_main_runs_in_process(capsys):
    with tempfile.TemporaryDirectory() as d:
        launch_train.main(["--arch", "hymba-1.5b", "--steps", "6",
                           "--layers", "2", "--d-model", "64", "--heads",
                           "4", "--vocab", "128", "--batch", "2", "--seq",
                           "32", "--device", "cpu", "--ckpt-dir", d])
        saved = ck.all_steps(os.path.join(d, "hymba-1.5b"))
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert np.isfinite(last["first_loss"]) and np.isfinite(last["last_loss"])
    assert saved == [5]
    assert any(line.startswith("[train] step     5") for line in out)
    with pytest.raises(RuntimeError, match="pod"):
        launch_train.main(["--arch", "hymba-1.5b", "--mesh", "pod",
                           "--device", "cpu"])
