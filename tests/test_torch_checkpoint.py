"""Checkpoints of the torch port in the JAX package's on-disk format, both
ways between the packages (macroc_tpu_torch/utils/checkpoint.py).

  - round trip of (u, J2State) and (u, ()) through save/load_latest, the
    ``step_<N>.old`` fallback, the legacy single-file npz, the newest step
    winning, a missing block raising;
  - a checkpoint written under an 8-device JAX mesh (one block per shard,
    as tests/test_checkpoint.py writes it) restored in the port, and a port
    checkpoint restored by the JAX package;
  - the JAX CLI writes at step 2 and the port CLI resumes to step 4, and
    the reverse, on the plastic 5x3x3 golden line: info.dat matches an
    uninterrupted 4-step run's rows.  That line pins roundoff
    (tests/test_torch_golden.py), so across the packages the force and
    f_trial_max columns are held to that test's 1e-5 and the rest
    exactly; a port run resumed by the port equals its uninterrupted run
    as text;
  - a MicroState checkpoint on the FE² golden line, written by the port
    after a plastic step and read back by both packages bit for bit.
Restored leaves are held bit for bit."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from make_goldens import CONFIGS
from macroc_tpu.constitutive.j2 import J2State as JState
from macroc_tpu.constitutive.microfe import MicroState as JMicroState
from macroc_tpu.utils import checkpoint as jckpt
from macroc_tpu_torch.constitutive import J2State
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(seed=0, shape=(8, 4, 8)):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=shape + (3,))
    ep = rng.normal(size=shape + (8, 6))
    al = rng.random(size=shape + (8,))
    return u, ep, al


def _port_tree(u, ep, al):
    return (torch.as_tensor(u), J2State(eps_p=torch.as_tensor(ep), alpha=torch.as_tensor(al)))


def _assert_tree_equal(tree, arrays):
    leaves = ckpt.flatten(tree)
    assert len(leaves) == len(arrays)
    for a, b in zip(leaves, arrays):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


def test_roundtrip_and_leaf_order(tmp_path):
    arrays = _fields()
    tree = _port_tree(*arrays)
    path = ckpt.save(str(tmp_path), 7, tree)
    assert os.path.isdir(path) and path.endswith("step_7")
    assert sorted(os.listdir(path)) == ["proc_0.json", "proc_0.npz"]
    like = _port_tree(*(np.zeros_like(a) for a in arrays))
    step, got = ckpt.load_latest(str(tmp_path), like)
    assert step == 7 and isinstance(got[1], J2State)
    _assert_tree_equal(got, arrays)
    # the elastic engine's () state has no leaves: only u is stored
    ckpt.save(str(tmp_path), 8, (tree[0], ()))
    step, (u, state) = ckpt.load_latest(str(tmp_path), (torch.zeros_like(tree[0]), ()))
    assert step == 8 and state == () and torch.equal(u, tree[0])


def test_old_fallback_legacy_npz_and_latest(tmp_path):
    a1, a2 = _fields(1), _fields(2)
    ck = str(tmp_path)
    like = _port_tree(*(np.zeros_like(a) for a in a1))
    ckpt.save(ck, 1, _port_tree(*a1))
    ckpt.save(ck, 2, _port_tree(*a2))
    assert ckpt.load_latest(ck, like)[0] == 2
    # the crash window of an overwrite: the published copy moved aside
    os.replace(os.path.join(ck, "step_2"), os.path.join(ck, "step_2.old"))
    step, got = ckpt.load_latest(ck, like)
    assert step == 2
    _assert_tree_equal(got, a2)
    ckpt.save(ck, 2, _port_tree(*a1))  # a published dir wins over .old
    step, got = ckpt.load_latest(ck, like)
    _assert_tree_equal(got, a1)
    assert not os.path.exists(os.path.join(ck, "step_2.writing"))
    # legacy round-2 single file
    np.savez(tmp_path / "step_5.npz", **{f"leaf_{i}": a for i, a in enumerate(a2)})
    step, got = ckpt.load_latest(ck, like)
    assert step == 5
    _assert_tree_equal(got, a2)


def test_missing_block_raises(tmp_path):
    arrays = _fields()
    ckpt.save(str(tmp_path), 3, _port_tree(*arrays))
    import json

    idx = tmp_path / "step_3" / "proc_0.json"
    blocks = json.loads(idx.read_text())
    blocks["blocks"] = blocks["blocks"][1:]
    idx.write_text(json.dumps(blocks))
    with pytest.raises(ValueError, match="not fully covered"):
        ckpt.load(str(tmp_path / "step_3"), _port_tree(*arrays))


def test_jax_mesh_checkpoint_restores_in_port_and_back(tmp_path):
    """Written by the JAX package with each leaf sharded over a (2,1,4)
    device mesh (8 blocks per leaf) and restored in the port; then the
    port's own checkpoint of it is restored by the JAX package."""
    arrays = _fields(3)
    devs = np.asarray(jax.devices()[:8]).reshape(2, 1, 4)
    s = NamedSharding(Mesh(devs, ("x", "y", "z")), P("x", "y", "z"))
    jtree = (jax.device_put(jnp.asarray(arrays[0]), s),
             JState(eps_p=jax.device_put(jnp.asarray(arrays[1]), s),
                    alpha=jax.device_put(jnp.asarray(arrays[2]), s)))
    jckpt.save(str(tmp_path / "jax"), 4, jtree)
    import json

    with open(tmp_path / "jax" / "step_4" / "proc_0.json") as f:
        assert sum(b["leaf"] == 0 for b in json.load(f)["blocks"]) == 8
    like = _port_tree(*(np.zeros_like(a) for a in arrays))
    step, got = ckpt.load_latest(str(tmp_path / "jax"), like)
    assert step == 4
    _assert_tree_equal(got, arrays)
    ckpt.save(str(tmp_path / "port"), 4, got)
    jlike = (jnp.zeros_like(jtree[0]), JState(jnp.zeros_like(jtree[1].eps_p),
                                              jnp.zeros_like(jtree[1].alpha)))
    step, back = jckpt.load_latest(str(tmp_path / "port"), jlike)
    assert step == 4 and isinstance(back[1], JState)
    for a, b in zip(jax.tree.leaves(back), arrays):
        assert np.array_equal(np.asarray(a), b)


def test_microstate_roundtrip_on_the_fe2_golden(tmp_path):
    """Two port steps of the FE² golden line (the second plastic) leave a
    MicroState; the port writes it, and both packages read it back."""
    cfg = CONFIGS["hetero_micro_fe2_3x2x2"]
    p = MacroProblem(cfg, "cpu")
    u, state = p.init_fields()
    for ts in range(2):
        u, state, d = p.time_step(u, state, cfg.displacement(ts))
    assert int(d.non_linear.sum()) > 0 and float(state.alpha.abs().max()) > 0
    ckpt.save(str(tmp_path), 2, (u, state))
    arrays = [a.numpy() for a in (u, state.eps_p, state.alpha, state.u)]
    step, got = ckpt.load_latest(str(tmp_path), p.init_fields())
    assert step == 2 and type(got[1]).__name__ == "MicroState"
    _assert_tree_equal(got, arrays)
    jlike = (jnp.zeros(arrays[0].shape), JMicroState(
        eps_p=jnp.zeros(arrays[1].shape), alpha=jnp.zeros(arrays[2].shape),
        u=jnp.zeros(arrays[3].shape)))
    step, back = jckpt.load_latest(str(tmp_path), jlike)
    for a, b in zip(jax.tree.leaves(back), arrays):
        assert np.array_equal(np.asarray(a), b)


# the bending_plastic_5x3x3 golden's line: GPs yield from step 2, so the
# checkpoint carries plastic strain into the resumed steps
PLASTIC = ["-da_grid_x", "5", "-da_grid_y", "3", "-da_grid_z", "3", "-lx", "4",
           "-ly", "2", "-lz", "2", "-bc_type", "0", "-dt", "0.15",
           "-newton_max_its", "10", "-dtype", "float64"]


def _cli(package, out, ck, extra):
    env = dict(os.environ, MACROC_PLATFORM="cpu", XLA_FLAGS="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", package, *PLASTIC, "-output_dir", str(out),
         "-checkpoint_dir", str(ck), *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return r.stdout


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """info.dat rows of an uninterrupted 4-step run, per package."""
    rows = {}
    for package in ("macroc_tpu", "macroc_tpu_torch"):
        out = tmp_path_factory.mktemp(package)
        _cli(package, out, out / "ck", ["-ts", "4"])
        rows[package] = (out / "info.dat").read_text().splitlines()
        assert len(rows[package]) == 4
        assert rows[package][3].split("\t")[-1] != "0"  # step 3 yields
    return rows


def _assert_rows_close(got, want):
    """Step index, time, load and yielded-GP count exactly; force and
    f_trial_max to 1e-5, the bound tests/test_torch_golden.py holds this
    roundoff-pinning line to across the packages."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        assert (g[0], g[1], g[2], g[5]) == (w[0], w[1], w[2], w[5])
        assert np.allclose(np.float64(g[3:5]), np.float64(w[3:5]), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("first,second", [("macroc_tpu", "macroc_tpu_torch"),
                                          ("macroc_tpu_torch", "macroc_tpu"),
                                          ("macroc_tpu_torch", "macroc_tpu_torch")])
def test_cli_resume_across_packages(tmp_path, uninterrupted, first, second):
    """Steps 0-1 by one package, checkpointed at step 2, then steps 2-3 by
    the other.  The rows of the first half equal the writer's own
    uninterrupted run; all four match both packages' uninterrupted runs to
    the roundoff bound; a run resumed in the package that wrote it equals
    its uninterrupted run as text."""
    out, ck = tmp_path / "out", tmp_path / "ck"
    _cli(first, out, ck, ["-ts", "2", "-checkpoint_freq", "2"])
    assert sorted(os.listdir(ck)) == ["step_2"]
    log = _cli(second, out, ck, ["-ts", "4", "-resume"])
    assert "Resumed from checkpoint at step 2" in log
    assert "Time Step = 1\n" not in log and "Time Step = 3\n" in log
    rows = (out / "info.dat").read_text().splitlines()
    assert rows[:2] == uninterrupted[first][:2]
    for want in uninterrupted.values():
        _assert_rows_close(rows, want)
    if first == second:
        assert rows == uninterrupted[first]
