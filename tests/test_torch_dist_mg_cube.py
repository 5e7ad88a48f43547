"""MG across ranks on a 17^3 cube (point-smoothed hierarchy, pc_type mg),
CPU float64: N gloo ranks of macroc_tpu_torch against the JAX package's
N-device run and the port's one process (tests/_torch_dist_common.py), at
the rank grids the decomposition picks for 2 and 4 ranks ((1,1,2) and
(1,1,4)); the node box pads to 18 and 20 nodes along z.

Against JAX: the elastic decomposition bounds.  Against one process: the
padded box's hierarchy differs, so tests/test_dist.py:129-135's bounds.
"""

import pytest
import torch

import _torch_dist_common as common

torch.set_num_threads(1)

CUBE = dict(nx=17, ny=17, nz=17, lx=4.0, ly=4.0, lz=4.0, bc_type=0, dtype="float64",
            ts=2, dt=0.01, pc_type="mg")
CONFIGS = {"cube_2": (2, CUBE), "cube_4": (4, CUBE)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mg_cube_ranks_match(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    assert rec["procs"] == jx[0]["procs"] and rec["node_shape"] != [17, 17, 17]
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 2, "no solve to compare"
    if against == "jax":
        common.assert_exact(rec, jx[0])
        common.assert_exact_u(u, jx[1])
    else:
        common.assert_padded(rec, u, one[0], one[1])
