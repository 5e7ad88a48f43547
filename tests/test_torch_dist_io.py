"""Per-rank checkpoints and PVTU pieces of macroc_tpu_torch's N-rank run
(CPU float64, gloo ranks through ``driver.Simulation``):

  - a checkpoint written by 2 ranks (one ``proc_<rank>`` file each, blocks
    at their global start) resumes on 1 process, and one written by 1
    process resumes on 2 ranks where the rank grid divides the node box;
    each resumed run stays within the golden roundoff bounds of the
    uninterrupted one-process run (tests/_torch_dist_common.py);
  - 1 -> 2 on a box the 2 ranks pad raises on both ranks, as the JAX
    reader does: the written blocks do not cover the padding;
  - the JAX package's ``checkpoint.load`` reads the 2 ranks' directory
    into its 2-device sharded fields and gets the ranks' gathered fields;
  - ``-vtu_freq 1`` on 2 ranks (and on 4, where the DMDA pieces drift from
    the padded blocks by a node, so the halo is 2 wide): every piece and
    the one master file byte-identical to the JAX package's
    ``io.write_pvtu`` given the gathered fields on the same grid.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_dist_common as common
from test_torch_halo import launch_ranks

torch.set_num_threads(1)

# the bending_plastic_5x3x3 golden's flags on a 6x3x3 box, which 2 ranks
# (2,1,1) split without padding, and on the golden's 5x3x3, which they pad
PLASTIC = ["-da_grid_y", "3", "-da_grid_z", "3", "-lx", "4", "-ly", "2", "-lz", "2",
           "-bc_type", "0", "-dt", "0.15", "-newton_max_its", "10", "-dtype", "float64"]
GRID_6 = ["-da_grid_x", "6"] + PLASTIC
GRID_5 = ["-da_grid_x", "5"] + PLASTIC


def _rank_cli(argv, out_json, expect=None):
    """One rank (or the one process): driver.Simulation on ``argv``; saves
    its history and the gathered final fields; with ``expect`` the run
    must raise ValueError matching it."""
    torch.set_num_threads(1)
    from macroc_tpu_torch.config import parse_cli
    from macroc_tpu_torch.driver import Simulation
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.problem import fields_to_numpy

    distributed.maybe_initialize()
    sim = Simulation(parse_cli(argv), "cpu")
    if expect is not None:
        with pytest.raises(ValueError, match=expect):
            sim.run()
    else:
        res = sim.run()
        p = sim.problem
        u, eps_p, alpha = fields_to_numpy(res["u"], res["state"], p.mesh)
        d = res["diag"]
        gp = {k: (torch.as_tensor(p.mesh.gather(getattr(d, k))) if p.mesh else getattr(d, k))
              for k in ("stress", "cost", "non_linear")}
        if distributed.is_primary():
            np.savez(out_json + ".npz", u=p.unpad_u(u), eps_p=eps_p, alpha=alpha,
                     **{k: v.numpy() for k, v in gp.items()})
            with open(out_json, "w") as f:
                json.dump(dict(history=[{k: v for k, v in h.items() if k != "seconds"}
                                        for h in res["history"]],
                               node_shape=p.node_shape), f)
    distributed.shutdown()


def _run(n, argv, tmp, tag, expect=None):
    out = str(tmp / f"{tag}.json")
    launch_ranks(n, "import test_torch_dist_io as t; "
                    f"t._rank_cli({argv!r}, {out!r}, {expect!r})")
    if expect is None:
        with open(out) as f:
            return json.load(f), np.load(out + ".npz")


def _steps(history):
    return dict(steps=history)


@pytest.mark.parametrize("write_n,read_n,grid", [(2, 1, GRID_6), (1, 2, GRID_6),
                                                  (2, 1, GRID_5)],
                         ids=["2to1", "1to2", "2to1_padded"])
def test_checkpoint_moves_between_rank_counts(tmp_path, write_n, read_n, grid):
    ck = str(tmp_path / "ck")
    common_flags = grid + ["-output_dir", str(tmp_path / "out"), "-checkpoint_dir", ck]
    whole, _ = _run(1, grid + ["-ts", "4", "-output_dir", str(tmp_path / "whole")],
                    tmp_path, "whole")
    _run(write_n, common_flags + ["-ts", "2", "-checkpoint_freq", "2"], tmp_path, "first")
    assert sorted(os.listdir(os.path.join(ck, "step_2"))) == sorted(
        f"proc_{r}.{e}" for r in range(write_n) for e in ("json", "npz"))
    resumed, _ = _run(read_n, common_flags + ["-ts", "4", "-resume"], tmp_path, "resumed")
    assert [h["ts"] for h in resumed["history"]] == [2, 3]
    assert all(h["nl_gps"] > 0 for h in resumed["history"]), "nothing yielded"
    common.assert_roundoff(_steps(resumed["history"]), _steps(whole["history"][2:]))
    rows = np.loadtxt(tmp_path / "out" / "info.dat", ndmin=2)
    assert rows[:, 0].tolist() == [0, 1, 2, 3]


def test_padded_checkpoint_does_not_resume_on_two_ranks(tmp_path):
    """A 1-process checkpoint of the 5x3x3 box holds no block for the node
    plane x=5 that 2 ranks pad on: both ranks raise, none fills zeros."""
    ck = str(tmp_path / "ck")
    flags = GRID_5 + ["-output_dir", str(tmp_path / "out"), "-checkpoint_dir", ck]
    _run(1, flags + ["-ts", "2", "-checkpoint_freq", "2"], tmp_path, "first")
    _run(2, flags + ["-ts", "4", "-resume"], tmp_path, "resumed",
         expect="not fully covered")


def test_jax_reads_the_ranks_checkpoint(tmp_path):
    """The JAX package's checkpoint.load on the 2 ranks' step directory,
    into its own 2-device sharded (u, J2State) on the padded 5x3x3 box."""
    from macroc_tpu import config as jcfg
    from macroc_tpu.parallel import make_grid_mesh, shard_problem_fields
    from macroc_tpu.problem import MacroProblem
    from macroc_tpu.utils import checkpoint as jck

    ck = str(tmp_path / "ck")
    _, fields = _run(2, GRID_5 + ["-ts", "2", "-checkpoint_freq", "2", "-output_dir",
                                  str(tmp_path / "out"), "-checkpoint_dir", ck],
                     tmp_path, "first")
    p = MacroProblem(jcfg.parse_cli(GRID_5), n_devices=2)
    like = shard_problem_fields(make_grid_mesh(p.grid), *p.init_fields())
    u, state = jck.load(os.path.join(ck, "step_2"), like)
    assert float(np.abs(fields["eps_p"]).max()) > 0
    np.testing.assert_array_equal(np.asarray(p.unpad_u(u)), fields["u"])
    np.testing.assert_array_equal(np.asarray(state.eps_p), fields["eps_p"])
    np.testing.assert_array_equal(np.asarray(state.alpha), fields["alpha"])


VTU_CASES = {
    # 2 ranks (2,1,1) on 7x3x5: DMDA pieces 4+3 nodes, padded blocks 4+4
    "vtu_2": (2, ["-da_grid_x", "7", "-da_grid_y", "3", "-da_grid_z", "5"], (1, 1, 1)),
    # 4 ranks (4,1,1) on 10x3x4: DMDA starts 0,3,6,8 against blocks of 3
    "vtu_4": (4, ["-da_grid_x", "10", "-da_grid_y", "3", "-da_grid_z", "4",
                  "-da_processors_x", "4", "-da_processors_y", "1",
                  "-da_processors_z", "1"], (2, 1, 1)),
}


@pytest.mark.parametrize("case", list(VTU_CASES))
def test_pvtu_pieces_match_jax_writer(tmp_path, case):
    from macroc_tpu import config as jcfg
    from macroc_tpu import grid as jgrid
    from macroc_tpu import io as jio
    from macroc_tpu_torch import config as tcfg
    from macroc_tpu_torch.fem.element import b_for
    from macroc_tpu_torch.fem.kernels import compute_strains
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.io.parallel_vtu import halo_widths
    from macroc_tpu_torch.parallel.mesh import padded_node_shape

    n, grid_flags, halo = VTU_CASES[case]
    flags = grid_flags + ["-lx", "4", "-ly", "1", "-lz", "2", "-bc_type", "0", "-dt", "0.1",
                          "-ts", "2", "-vtu_freq", "1", "-dtype", "float64"]
    out = tmp_path / "ranks"
    _, f = _run(n, flags + ["-output_dir", str(out)], tmp_path, "run")
    cfg = tcfg.parse_cli(flags)
    g = make_grid(cfg, n)
    assert halo_widths(g, padded_node_shape(g)) == halo
    # the gathered fields of the last step, reduced as the driver does
    nx, ny, nz = g.nx, g.ny, g.nz
    el = (slice(0, nx - 1), slice(0, ny - 1), slice(0, nz - 1))
    u = torch.as_tensor(f["u"])
    stress = torch.as_tensor(f["stress"])[el]
    cost = torch.as_tensor(f["cost"])[el]
    nl = torch.as_tensor(f["non_linear"])[el]
    B = torch.as_tensor(b_for(g.spacing, cfg.ref_b_quirk))
    f64 = torch.float64
    assert int(nl.sum()) > 0, "nothing yielded"
    ref = tmp_path / "jax"
    jio.write_pvtu("solution_1", jgrid.make_grid(jcfg.parse_cli(flags), n),
                   u.numpy(), (stress.to(f64).sum(dim=3) * g.wg).numpy(),
                   (compute_strains(u, B).to(f64).sum(dim=3) * g.wg).numpy(),
                   nl.to(torch.int32).sum(dim=3).numpy(),
                   (cost.to(f64).sum(dim=3) / 8.0).numpy(), g.wg,
                   outdir=str(ref), encoding="ascii", reduced=True)
    want = sorted(os.listdir(ref))
    assert want == sorted(["solution_1.pvtu"] + [f"solution_1-subdo-{r}.vtu" for r in range(n)])
    got = sorted(x for x in os.listdir(out) if x.startswith("solution_1"))
    assert got == want
    for name in want:
        assert (out / name).read_bytes() == (ref / name).read_bytes(), name
    assert (out / "solution_0.pvtu").exists()
