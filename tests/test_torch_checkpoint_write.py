"""PyTorch port, checkpoint writer: ``repro_torch.train.checkpoint``
against the JAX package's ``repro.train.checkpoint`` on the CPU.

Checkpoints cross both ways with leaves ``==``: a ``TrainState`` the port
saves restores through JAX's ``CheckpointManager`` into
``init_train_state``'s tree, and one JAX saves restores into the port's.
The keys are JAX's tree-path strings (``".params/['embed']"``,
``".opt/.step"``), so the two sets of keys are compared as well.  The
crash-safety cases of ``tests/test_checkpoint_faults.py`` run against the
port's writer.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config
from repro.train import checkpoint as ref_ckpt
from repro.train import train_step as ref_ts

from repro_torch.configs import get_config
from repro_torch.models.params import init_params, map_tree
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train import optimizer as port_opt
from repro_torch.train import train_step as port_ts
from repro_torch.train.checkpoint import CheckpointManager

NAME = "recurrentgemma-9b"


def _states(layers=3):
    """A JAX TrainState and a port TrainState of the same config, with
    distinct leaves (the port's drawn from a torch generator, its moments
    and step made nonzero)."""
    rcfg = dataclasses.replace(ref_get_config(NAME, tiny=True),
                               num_layers=layers)
    pcfg = dataclasses.replace(get_config(NAME, tiny=True), num_layers=layers)
    rstate = ref_ts.init_train_state(jax.random.key(0), rcfg)
    pstate = port_ts.init_train_state(torch.Generator().manual_seed(1), pcfg,
                                      "cpu")
    for leaf in port_ckpt.flatten_with_keys(pstate.opt.m):
        leaf[1].normal_()
    for leaf in port_ckpt.flatten_with_keys(pstate.opt.v):
        leaf[1].uniform_()
    pstate.opt.step.fill_(7)
    return rstate, pstate


def _jax_flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten_with_paths(tree)}


def _port_flat(tree) -> dict:
    return {k: v.numpy() for k, v in port_ckpt.flatten_with_keys(tree)}


@pytest.mark.parametrize("layers", [3, 6])
def test_keys_are_jax_tree_paths(layers):
    rstate, pstate = _states(layers)
    want = [k for k, _ in ref_ckpt._flatten_with_paths(rstate)]
    got = [k for k, _ in port_ckpt.flatten_with_keys(pstate)]
    assert got == want
    assert ".params/['embed']" in got and ".opt/.step" in got
    if layers == 3:
        assert len(got) == 124
        assert ".params/['segments']/[0]/['block0']/['mixer']/['b_a']" in got


@pytest.mark.parametrize("layers", [3, 6])
def test_torch_save_restores_in_jax(layers):
    rstate, pstate = _states(layers)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(7, pstate, extra={"who": "torch"})
        restored, step, extra = ref_ckpt.CheckpointManager(d).restore(rstate)
    assert step == 7 and extra == {"who": "torch"}
    got, want = _jax_flat(restored), _port_flat(pstate)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert restored.opt.step.dtype == np.int32


@pytest.mark.parametrize("into", [False, True])
def test_jax_save_restores_in_torch(into):
    rstate, pstate = _states(6)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.CheckpointManager(d).save(5, rstate, extra={"a": 1})
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 5
        restored, step, extra = mgr.restore(pstate, into=into)
    assert step == 5 and extra == {"a": 1}
    assert isinstance(restored, port_ts.TrainState)
    assert (restored is pstate) == into
    got, want = _port_flat(restored), _jax_flat(rstate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert restored.opt.step.dtype == torch.int32
    assert int(restored.opt.step) == 0


def test_writer_matches_np_savez():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [np.arange(5, dtype=np.int32), np.float32(2.5)],
            "c": {"d": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}
    with tempfile.TemporaryDirectory() as d:
        port_ckpt._write_npz(os.path.join(d, "p.npz"),
                             port_ckpt.flatten_with_keys(tree))
        np.savez(os.path.join(d, "n.npz"), **{
            k: np.asarray(v) for k, v in ref_ckpt._flatten_with_paths(
                jax.tree.map(np.asarray, tree))})
        with np.load(os.path.join(d, "p.npz")) as p, \
                np.load(os.path.join(d, "n.npz")) as n:
            assert sorted(p.files) == sorted(n.files)
            for k in n.files:
                assert p[k].dtype == n[k].dtype
                np.testing.assert_array_equal(p[k], n[k])


def test_keep_n_and_latest():
    tree = {"a": torch.zeros(2)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            tree["a"].fill_(step)
            mgr.save(step, tree)
        assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000002",
                                         "step_00000003"]
        restored, step, _ = mgr.restore({"a": torch.zeros(2)}, step=2)
        assert step == 2 and torch.equal(restored["a"], torch.full((2,), 2.))
        with pytest.raises(ValueError, match="shape"):
            mgr.restore({"a": torch.zeros(3)})
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            CheckpointManager(d).restore(tree)


# The crash-safety cases of tests/test_checkpoint_faults.py, against the
# port's writer.

def test_resave_swap_failure_keeps_old_step(monkeypatch):
    """Re-saving an existing step never passes through a state where the
    step directory is gone while LATEST names it."""
    v1 = {"a": torch.full((2,), 1.0)}
    v2 = {"a": torch.full((2,), 2.0)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(7, v1)
        final = os.path.join(d, "step_00000007")
        real_rename = os.rename

        def failing_rename(src, dst):
            if dst == final and ".tmp_" in os.path.basename(src):
                raise OSError("injected crash during swap")
            return real_rename(src, dst)

        monkeypatch.setattr(os, "rename", failing_rename)
        with pytest.raises(OSError, match="injected"):
            mgr.save(7, v2)
        monkeypatch.undo()
        restored, step, _ = mgr.restore(v1)
        assert step == 7
        assert torch.equal(restored["a"], torch.full((2,), 1.0))
        assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]


def test_resave_crash_between_renames_recovers_aside():
    """A crash after the old directory was parked but before the new one
    landed leaves only ``.step_<n>.old``; a fresh manager recovers it, and
    so does JAX's."""
    v1 = {"a": torch.arange(3, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(4, v1)
        final = os.path.join(d, "step_00000004")
        os.rename(final, os.path.join(d, ".step_00000004.old"))
        assert not os.path.isdir(final)
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 4
        restored, step, _ = mgr.restore(v1)
        assert step == 4 and torch.equal(restored["a"], v1["a"])
        os.rename(final, os.path.join(d, ".step_00000004.old"))
        ref, _, _ = ref_ckpt.CheckpointManager(d).restore(
            {"a": np.zeros(3, np.float32)})
        np.testing.assert_array_equal(ref["a"], v1["a"].numpy())


def test_resave_success_replaces_and_cleans_aside():
    v1 = {"a": torch.full((2,), 1.0)}
    v2 = {"a": torch.full((2,), 2.0)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, v1)
        mgr.save(3, v2)
        restored, _, _ = mgr.restore(v1)
        assert torch.equal(restored["a"], v2["a"])
        assert not os.path.exists(os.path.join(d, ".step_00000003.old"))
        assert mgr.all_steps() == [3]


def test_spec_tree_reader_reads_port_checkpoint():
    """The reader ``load_forecaster`` uses (by spec tree) reads what the
    writer wrote."""
    from repro_torch.forecast import model as fmodel
    arch = fmodel.forecast_arch()
    specs = fmodel.forecast_specs(arch)
    params = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(9, params)
        tree, step, _ = port_ckpt.restore(d, specs)
    assert step == 9
    for k, v in port_ckpt.flatten_with_keys(params):
        np.testing.assert_array_equal(dict(port_ckpt.flatten_with_keys(tree))
                                      [k], v.numpy())


def test_optimizer_state_round_trip_continues_identically():
    """Saving mid-run and restoring gives the same next AdamW step."""
    pcfg = get_config(NAME, tiny=True)
    state = port_ts.init_train_state(torch.Generator().manual_seed(0), pcfg,
                                     "cpu")
    oc = port_opt.OptimizerConfig(learning_rate=1e-2, warmup_steps=1)
    g = map_tree(lambda _, t: torch.full_like(t, 0.01), state.params)
    port_opt.adamw_update(oc, state.params, g, state.opt)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(1, state)
        other = port_ts.init_train_state(torch.Generator().manual_seed(5),
                                         pcfg, "cpu")
        CheckpointManager(d).restore(other, into=True)
    for s in (state, other):
        gg = map_tree(lambda _, t: t.clone(), g)
        port_opt.adamw_update(oc, s.params, gg, s.opt)
    for (k, a), (_, b) in zip(port_ckpt.flatten_with_keys(state),
                              port_ckpt.flatten_with_keys(other)):
        assert torch.equal(a, b), k
