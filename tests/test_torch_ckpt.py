"""The port's ``CheckpointManager`` (``zoo_tpu_torch/orca/learn/ckpt.py``):
the crash-safety cases of ``tests/test_chaos_ckpt.py`` on it (a worker
SIGKILLed at any instant of a save never poisons restore), and
checkpoints crossing packages: a port checkpoint's params load in the
JAX manager, a JAX pickle-codec checkpoint's params load in the port,
and the port's restricted unpickler refuses a JAX ``aux.pkl`` (optax
NamedTuples) and a file that names ``os.system``.
"""

import os
import pickle
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zoo_tpu.orca.learn.ckpt import CheckpointManager as JaxManager

from zoo_tpu_torch.orca.learn.ckpt import (
    MANIFEST,
    CheckpointCorruptError,
    CheckpointManager,
    CheckpointRefused,
)
from zoo_tpu_torch.util.resilience import default_injector

jax.config.update("jax_platforms", "cpu")

# forked children run pure file I/O (pickle + rename) then os._exit
pytestmark = pytest.mark.filterwarnings(
    "ignore:os.fork\\(\\) was called:RuntimeWarning")

KILL_SITES = ["ckpt.pre_write", "ckpt.pre_manifest", "ckpt.pre_rename"]


def _mgr(tmp_path):
    return CheckpointManager(str(tmp_path / "ck"))


def _state(step):
    return {"step": step,
            "w": np.full((64, 64), float(step), np.float32)}


def _assert_step(state, step):
    assert state["step"] == step
    np.testing.assert_array_equal(
        state["w"], np.full((64, 64), float(step), np.float32))


def _fork_save_and_kill(mgr, step, site):
    """Fork; the child arms a self-SIGKILL at ``site`` and saves ``step``.
    Returns once the child is dead."""
    pid = os.fork()
    if pid == 0:  # child — never touch pytest machinery, never return
        try:
            default_injector.inject(
                site, action=lambda **_: os.kill(os.getpid(),
                                                 signal.SIGKILL))
            mgr.save(step, _state(step))
        finally:
            os._exit(0)  # only reached if the kill site never fired
    _, status = os.waitpid(pid, 0)
    return status


@pytest.mark.parametrize("site", KILL_SITES)
def test_sigkill_mid_save_preserves_previous_step(tmp_path, site):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    status = _fork_save_and_kill(mgr, 2, site)
    assert os.WIFSIGNALED(status) and os.WTERMSIG(status) == signal.SIGKILL
    _assert_step(mgr.restore(), 1)
    assert mgr.latest_verified_step() == 1


def test_sigkill_after_rename_commits_the_step(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    status = _fork_save_and_kill(mgr, 2, "ckpt.post_rename")
    assert os.WIFSIGNALED(status)
    _assert_step(mgr.restore(), 2)
    assert mgr.latest_verified_step() == 2


def test_sigkill_at_random_instants_never_corrupts_resume(tmp_path):
    import time

    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    for delay_ms in (2, 5, 9, 14, 23):
        pid = os.fork()
        if pid == 0:  # child: hammer saves until killed
            try:
                step = 2
                while True:
                    mgr.save(step, _state(step))
                    step += 1
            finally:
                os._exit(0)
        time.sleep(delay_ms / 1000.0)
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        state = mgr.restore()
        _assert_step(state, state["step"])
        assert state["step"] >= 1


def test_stale_staging_dirs_are_garbage_collected(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    _fork_save_and_kill(mgr, 2, "ckpt.pre_rename")
    mgr.save(3, _state(3))
    assert [n for n in os.listdir(mgr.directory)
            if n.startswith(".tmp-")] == []
    _assert_step(mgr.restore(), 3)


def test_bitrot_quarantined_and_older_step_restored(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    with open(os.path.join(mgr.directory, "2", "state.pkl"), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    _assert_step(mgr.restore(), 1)
    names = os.listdir(mgr.directory)
    assert "2.corrupt" in names and "2" not in names
    with pytest.raises((CheckpointCorruptError, FileNotFoundError)):
        mgr.restore(2)


def test_missing_manifest_file_is_incomplete(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    os.remove(os.path.join(mgr.directory, "2", "state.pkl"))
    _assert_step(mgr.restore(), 1)
    assert mgr.latest_verified_step() == 1


def test_truncated_manifest_is_corrupt(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    mpath = os.path.join(mgr.directory, "2", MANIFEST)
    with open(mpath, "r+b") as f:
        f.truncate(os.path.getsize(mpath) // 2)
    _assert_step(mgr.restore(), 1)


def test_legacy_manifestless_checkpoint_still_restores(tmp_path):
    mgr = _mgr(tmp_path)
    legacy = os.path.join(mgr.directory, "7")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "state.pkl"), "wb") as f:
        pickle.dump(_state(7), f)
    _assert_step(mgr.restore(), 7)
    assert mgr.latest_verified_step() == 7


def test_restore_aux_follows_verified_step(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1), aux={"moment": np.ones(3)})
    mgr.save(2, _state(2), aux={"moment": np.full(3, 2.0)})
    with open(os.path.join(mgr.directory, "2", "state.pkl"), "r+b") as f:
        f.write(b"garbage")
    _assert_step(mgr.restore(), 1)
    np.testing.assert_array_equal(mgr.restore_aux()["moment"], np.ones(3))


def test_retention_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in range(5):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]


def _params():
    rs = np.random.RandomState(0)
    return {"000_dense": {"W": rs.randn(4, 3).astype(np.float32),
                          "b": rs.randn(3).astype(np.float32)}}


def _jax_mgr(path):
    mgr = JaxManager(path)
    mgr._ckptr = None   # the pickle codec: the one both packages read
    mgr._ocp = None
    return mgr


def test_port_checkpoint_params_load_in_the_jax_manager(tmp_path):
    params = _params()
    torch_params = {k: {kk: torch.from_numpy(v.copy()) for kk, v in
                        d.items()} for k, d in params.items()}
    aux = {"mu": {"000_dense": {"W": torch.ones(4, 3)}},
           "count": torch.tensor(7, dtype=torch.int32)}
    CheckpointManager(str(tmp_path)).save(
        3, {"params": torch_params, "epoch": 3}, aux=aux)
    state = _jax_mgr(str(tmp_path)).restore(3)
    assert state["epoch"] == 3
    for k, d in params.items():
        for kk, v in d.items():
            np.testing.assert_array_equal(state["params"][k][kk], v)
    assert int(_jax_mgr(str(tmp_path)).restore_aux(3)["count"]) == 7


def test_jax_pickle_checkpoint_params_load_and_its_aux_is_refused(tmp_path):
    params = _params()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = optax.adam(1e-3).init(jparams)
    _jax_mgr(str(tmp_path)).save(2, {"params": jparams, "epoch": 2},
                                 aux=opt_state)
    mgr = CheckpointManager(str(tmp_path))
    state = mgr.restore(2)
    assert int(state["epoch"]) == 2
    for k, d in params.items():
        for kk, v in d.items():
            np.testing.assert_array_equal(state["params"][k][kk], v)
    with pytest.raises(CheckpointRefused, match="optax"):
        mgr.restore_aux(2)


def test_a_file_naming_os_system_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo owned",))

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {}, "epoch": 1}, aux={"x": np.ones(2)})
    path = os.path.join(mgr.directory, "1", "aux.pkl")
    with open(path, "wb") as f:
        pickle.dump({"x": Evil()}, f)
    mgr2 = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointRefused, match="system"):
        mgr2.restore_aux(1)   # the manifest is not consulted for aux
    # a step without a manifest verifies by presence (the legacy rule):
    # its state.pkl is still read through the restricted unpickler
    legacy = os.path.join(mgr.directory, "5")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "state.pkl"), "wb") as f:
        pickle.dump({"params": Evil()}, f)
    with pytest.raises(CheckpointRefused, match="system"):
        CheckpointManager(str(tmp_path)).restore(5)
