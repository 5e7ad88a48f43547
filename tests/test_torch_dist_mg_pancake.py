"""MG across ranks on ROADMAP's 17x3x17 pancake (pc_type auto -> the
semicoarsened, line-smoothed hierarchy), CPU float64: N gloo ranks of
macroc_tpu_torch against the JAX package's N-device run and the port's one
process (tests/_torch_dist_common.py).

  - pancake_z2: ranks (1,1,2), so the node box pads to 17x3x18 and rank 1's
    block starts at z index 9: its red-black line colouring must follow the
    global parity;
  - pancake_xz4: ranks (2,1,2), blocks starting at 9 in x and z.

Against JAX: the elastic decomposition bounds (same KSP its, |RES|, force
and u within 1e-8).  Against one process: the padded box has another MG
hierarchy, so tests/test_dist.py:129-135's bounds.
"""

import pytest
import torch

import _torch_dist_common as common

torch.set_num_threads(1)

PANCAKE = dict(nx=17, ny=3, nz=17, lx=10.0, ly=1.0, lz=10.0, bc_type=0, dtype="float64",
               ts=2, dt=0.001)
CONFIGS = {
    "pancake_z2": (2, dict(PANCAKE, procs_x=1, procs_y=1, procs_z=2)),
    "pancake_xz4": (4, dict(PANCAKE, procs_x=2, procs_y=1, procs_z=2)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mg_pancake_ranks_match(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    assert rec["node_shape"][2] == 18 and rec["block"][2] == 9
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    if against == "jax":
        common.assert_exact(rec, jx[0])
        common.assert_exact_u(u, jx[1])
    else:
        common.assert_padded(rec, u, one[0], one[1])


def test_mg_pancake_is_the_line_smoothed_hierarchy():
    """pc_type auto resolves MG on the padded pancake, whose hierarchy
    smooths lines along y, the dimension no rank grid here splits."""
    from macroc_tpu_torch.config import MacroConfig
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.parallel.mesh import padded_node_shape
    from macroc_tpu_torch.problem import resolve_solver_plan_torch
    from macroc_tpu_torch.solve.mg import line_dim_for

    for n, flags in CONFIGS.values():
        cfg = MacroConfig(**flags)
        shape = padded_node_shape(make_grid(cfg, n))
        assert resolve_solver_plan_torch(cfg, shape, "cpu")["pc_type"] == "mg"
        assert line_dim_for(shape) == 1
