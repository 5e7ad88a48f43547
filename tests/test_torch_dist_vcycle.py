"""The distributed MG V-cycle alone (macroc_tpu_torch/solve/mg.py with a
RankMesh) on N gloo ranks, CPU float64: each rank builds its level 0 from
its block of a numpy-seeded tangent field on the padded node box and
applies one V-cycle to its block of a seeded vector; the result must be the
rank's block of the one-process V-cycle on the same padded hierarchy within
1e-12 relative (the restriction's partial sums and the level-1 tangents'
all-reduce add in another order).

Cases, each on rank grids (1,1,2) and (2,1,2): the 17x3x17 pancake (line
smoother; blocks that start at index 9) and a 9x9x9 cube (point smoother),
with -mg_dtype float32 levels on the pancake as well.  The ranks also run a
Newton step of the pancake with ``Comm.gather`` made to raise: no rank
gathers u or the tangent field inside ``time_step``.

Rank grids that split the pancake's line dimension (y) run the pancake
only: (1,2,1) pads y to 4, which coarsens once (to 3); (1,3,1) leaves
every rank a block of one node along the line; (2,2,1) splits x as well.
There every rank holds its rows of the line inverse and gathers each
residual's line over its line group.  A line that fails to invert on one
line group raises on every rank.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_halo import launch_ranks

torch.set_num_threads(1)

CASES = {
    "pancake": dict(nx=17, ny=3, nz=17, lx=10.0, ly=1.0, lz=10.0, bc_type=0, dt=0.001),
    "cube": dict(nx=9, ny=9, nz=9, lx=4.0, ly=4.0, lz=4.0, bc_type=1, rad=1.0, dt=0.01),
}
RANK_GRIDS = [(1, 1, 2), (2, 1, 2)]
# rank grids that split the pancake's line dimension
LINE_SPLIT = [(1, 2, 1), (1, 3, 1), (2, 2, 1)]
MG_DTYPES = {"pancake": [None, torch.float32], "cube": [None]}
TOL = 1e-12


def _elastic_c(E=2.0e7, nu=0.25):
    lam, mu = E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(6), np.arange(6)] += np.array([2 * mu] * 3 + [mu] * 3)
    return C


def _seeded(node_shape, real_elem, seed):
    """A node-shaped tangent field (real elements: the elastic C scaled by
    0.5..1.5 per GP; inactive slots zero) and a residual vector (3, nodes)."""
    rng = np.random.default_rng(seed)
    ctan = np.zeros(tuple(node_shape) + (8, 6, 6))
    scale = rng.uniform(0.5, 1.5, size=tuple(real_elem) + (8, 1, 1))
    ctan[tuple(slice(0, n) for n in real_elem)] = scale * _elastic_c()
    return ctan, rng.standard_normal((3,) + tuple(node_shape))


def _vcycle(levels, mesh, mg_dtype):
    from macroc_tpu_torch.solve.mg import make_mg_preconditioner

    if mg_dtype is not None:
        import dataclasses

        levels = [dataclasses.replace(lv, A_soa=lv.A_soa.to(mg_dtype),
                                      inv_diag=lv.inv_diag.to(mg_dtype)) for lv in levels]
    return make_mg_preconditioner(levels, nu=2, omega=0.6, dtype=torch.float64, mesh=mesh)


def _rank_main(procs, out_dir):
    """One rank: for each case, the distributed V-cycle on its block and the
    one-process V-cycle of the padded hierarchy; the worst deviation and a
    gather-free Newton step go to out_dir."""
    torch.set_num_threads(1)
    from macroc_tpu_torch import bc as bc_mod
    from macroc_tpu_torch.config import MacroConfig
    from macroc_tpu_torch.fem.element import b_for
    from macroc_tpu_torch.ops.assembly import assemble_stencil_slab
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.parallel.halo import assemble_stencil_local
    from macroc_tpu_torch.problem import MacroProblem
    from macroc_tpu_torch.solve.mg import build_hierarchy

    assert distributed.maybe_initialize()
    out = {}
    split = tuple(procs) in LINE_SPLIT
    for name, flags in CASES.items():
        if split and name != "pancake":
            continue
        cfg = MacroConfig(**flags, dtype="float64", procs_x=procs[0], procs_y=procs[1],
                          procs_z=procs[2])
        p = MacroProblem(cfg, "cpu")
        m = p.mesh
        B = torch.as_tensor(b_for(p.grid.spacing, cfg.ref_b_quirk))
        ctan, r = _seeded(p.node_shape, p.real_elem_shape, seed=sum(procs) + len(name))
        ctan_t = torch.as_tensor(ctan)
        # one process, the padded box
        glob = bc_mod.BCData(mask=p.mask_soa.permute(1, 2, 3, 0), val_unit=None)
        crop = ctan_t[:-1, :-1, :-1]
        A = bc_mod.apply_bc_stencil_soa(
            assemble_stencil_slab(crop, B, p.grid.wg, p.node_shape), glob)
        one = build_hierarchy(crop, p.mask_soa, p.grid.spacing, cfg.ref_b_quirk, A0_soa=A)
        # this rank
        ctan_l = torch.as_tensor(np.ascontiguousarray(m.local(ctan)))
        A_l = bc_mod.apply_bc_stencil_soa(
            assemble_stencil_local(ctan_l, B, p.grid.wg, m, assemble_stencil_slab), p.bc)
        mine = build_hierarchy(ctan_l, p.mask_soa, p.grid.spacing, cfg.ref_b_quirk,
                               A0_soa=A_l, mesh=m)
        assert len(mine) == len(one) >= 2
        for mg_dtype in MG_DTYPES[name]:
            z = _vcycle(one, None, mg_dtype)(torch.as_tensor(r))
            z_l = _vcycle(mine, m, mg_dtype)(torch.as_tensor(np.ascontiguousarray(
                r[(slice(None),) + m.slices()])))
            want = z[(slice(None),) + m.slices()]
            err = float((z_l - want).abs().max() / z.abs().max())
            out[f"{name}_{mg_dtype}"] = dict(
                err=err, line_dim=mine[0].line_dim, levels=len(mine), start=list(m.start),
                shapes=[list(lv.A_soa.shape[-3:]) for lv in mine],
                shapes_one=[list(lv.A_soa.shape[-3:]) for lv in one],
                line_inv=list(mine[0].line_inv.shape) if mine[0].line_inv is not None else None)
        if split:
            # one line group's level-0 rows singular: every rank must raise
            bad = A_l * 0 if m.coords[0] == 0 else A_l
            try:
                build_hierarchy(ctan_l, p.mask_soa, p.grid.spacing, cfg.ref_b_quirk,
                                A0_soa=bad, mesh=m)
                out["singular"] = "built"
            except ValueError as e:
                out["singular"] = str(e)
    # a Newton step of the pancake with every gather refused
    cfg = MacroConfig(**CASES["pancake"], dtype="float64", procs_x=procs[0],
                      procs_y=procs[1], procs_z=procs[2])
    p = MacroProblem(cfg, "cpu")

    def refuse(*a, **k):
        raise AssertionError("a rank gathered inside time_step")

    p.comm.gather = refuse
    u, state = p.init_fields()
    u, state, d = p.time_step(u, state, -0.001)
    out["step"] = dict(ksp_its=d.ksp_its[:d.n_solves].tolist(), converged=bool(d.converged))
    with open(os.path.join(out_dir, f"rank{p.comm.rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    got = {}
    for procs in RANK_GRIDS + LINE_SPLIT:
        out = tmp_path_factory.mktemp("vcycle")
        n = int(np.prod(procs))
        launch_ranks(n, f"import test_torch_dist_vcycle as t; t._rank_main({procs!r}, "
                        f"{str(out)!r})")
        got[procs] = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]
    return got


@pytest.mark.parametrize("procs", RANK_GRIDS)
@pytest.mark.parametrize("case", ["pancake_None", "pancake_torch.float32", "cube_None"])
def test_vcycle_ranks_match_the_padded_one_process_vcycle(results, procs, case):
    recs = [r[case] for r in results[procs]]
    assert max(r["err"] for r in recs) <= TOL, [r["err"] for r in recs]
    assert all(r["line_dim"] == (1 if case.startswith("pancake") else -1) for r in recs)
    # some rank's block starts at an odd global index
    assert any(s % 2 for r in recs for s in r["start"])


@pytest.mark.parametrize("procs", LINE_SPLIT, ids=str)
@pytest.mark.parametrize("case", ["pancake_None", "pancake_torch.float32"])
def test_vcycle_on_a_split_line_matches_the_padded_one_process_vcycle(results, procs, case):
    recs = [r[case] for r in results[procs]]
    assert max(r["err"] for r in recs) <= TOL, [r["err"] for r in recs]
    assert all(r["line_dim"] == 1 for r in recs)


@pytest.mark.parametrize("procs", RANK_GRIDS + LINE_SPLIT)
def test_newton_step_gathers_nothing(results, procs):
    steps = [r["step"] for r in results[procs]]
    assert all(s == steps[0] for s in steps) and steps[0]["converged"]
    assert len(steps[0]["ksp_its"]) >= 1


def test_split_line_dimension_raises(results):
    """A pinned rank grid that splits the pancake's line dimension (y) once
    raised; now every rank builds the padded box's line-smoothed hierarchy
    (line_dim 1, the one-process level shapes), holds its rows (na, nb,
    3 b, 3 n) of the level-0 line inverse, and a line that fails to invert
    on one line group raises on every rank (x = 0's rows zeroed)."""
    want_shapes = {(1, 2, 1): [[17, 4, 17], [9, 3, 9], [5, 3, 5], [3, 3, 3]],
                   (1, 3, 1): [[17, 3, 17], [9, 3, 9], [5, 3, 5], [3, 3, 3]],
                   (2, 2, 1): [[18, 4, 17], [10, 3, 9], [6, 3, 5], [4, 3, 3], [3, 3, 3]]}
    for procs in LINE_SPLIT:
        for r in results[procs]:
            rec = r["pancake_None"]
            n = rec["shapes_one"][0][1]
            b = n // procs[1]
            assert rec["line_dim"] == 1 and rec["shapes_one"] == want_shapes[procs]
            assert rec["shapes"] == [[n // p for n, p in zip(want_shapes[procs][0], procs)]] \
                + want_shapes[procs][1:]
            assert rec["line_inv"] == [rec["shapes"][0][0], rec["shapes"][0][2], 3 * b, 3 * n]
            assert "MG line operator along y is singular on" in r["singular"], r["singular"]
