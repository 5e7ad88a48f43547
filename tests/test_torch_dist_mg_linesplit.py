"""MG across ranks whose rank grid splits the line dimension of the
semicoarsened hierarchy (y), CPU float64: N gloo ranks of macroc_tpu_torch
against the JAX package's N-device run and the port's one process
(tests/_torch_dist_common.py).  Each rank holds its rows of the level-0
line inverse and gathers every residual's line over its line group.

  - circle_y2 / circle_xy4: the JAX suite's own sharded MG case
    (tests/test_dist.py:112-116: 9x5x9, circle BC, pc_type mg) on rank
    grids (1,2,1) and (2,2,1); y pads 5 -> 6, split 3 + 3;
  - pancake_y2: ROADMAP's 17x3x17 pancake (pc_type auto) on (1,2,1); y pads
    3 -> 4, which coarsens once (to 3);
  - tall_y2: 9x7x9 on (1,2,1); y pads 7 -> 8, no longer thin, so the padded
    box's hierarchy is point-smoothed, as the JAX package builds it.

Against JAX: the elastic decomposition bounds (same KSP its, |RES|, force
and u within 1e-8).  Against one process: the padded box has another MG
hierarchy, so tests/test_dist.py:129-135's bounds.
"""

import pytest
import torch

import _torch_dist_common as common

torch.set_num_threads(1)

CIRCLE = dict(nx=9, ny=5, nz=9, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=2.0,
              dtype="float64", dt=0.002, newton_max_its=3, pc_type="mg", ts=2)
PANCAKE = dict(nx=17, ny=3, nz=17, lx=10.0, ly=1.0, lz=10.0, bc_type=0, dtype="float64",
               ts=2, dt=0.001)
CONFIGS = {
    "circle_y2": (2, dict(CIRCLE, procs_x=1, procs_y=2, procs_z=1)),
    "circle_xy4": (4, dict(CIRCLE, procs_x=2, procs_y=2, procs_z=1)),
    "pancake_y2": (2, dict(PANCAKE, procs_x=1, procs_y=2, procs_z=1)),
    "tall_y2": (2, dict(CIRCLE, ny=7, procs_x=1, procs_y=2, procs_z=1)),
}
# padded node shape and line dim of each rank grid's hierarchy
PADDED = {"circle_y2": ((9, 6, 9), 1), "circle_xy4": ((10, 6, 9), 1),
          "pancake_y2": ((17, 4, 17), 1), "tall_y2": ((9, 8, 9), -1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mg_line_split_ranks_match(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    assert tuple(rec["node_shape"]) == PADDED[name][0]
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    if against == "jax":
        common.assert_exact(rec, jx[0])
        common.assert_exact_u(u, jx[1])
    else:
        common.assert_padded(rec, u, one[0], one[1])


def test_mg_line_split_hierarchies():
    """MG on the padded box of each rank grid: line-smoothed along the
    split y where the padded y is thin, point-smoothed where padding made
    it 8 > 7 (the JAX package builds on the same padded box: the KSP counts
    of test_mg_line_split_ranks_match hold the two hierarchies equal)."""
    from macroc_tpu_torch.config import MacroConfig
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.parallel.mesh import padded_node_shape
    from macroc_tpu_torch.problem import resolve_solver_plan_torch
    from macroc_tpu_torch.solve.mg import line_dim_for

    for name, (n, flags) in CONFIGS.items():
        cfg = MacroConfig(**flags)
        shape = padded_node_shape(make_grid(cfg, n))
        assert (shape, line_dim_for(shape)) == PADDED[name]
        assert resolve_solver_plan_torch(cfg, shape, "cpu")["pc_type"] == "mg"
