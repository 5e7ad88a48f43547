"""The matrix-free operator across ranks (CPU float64): the bending 9x5x5
grid of tests/test_torch_dist.py with -operator matfree and Jacobi PCG as
2 gloo ranks (the node box pads to 10 in x) against the port's one process
and the JAX package's 2-device run, within the elastic decomposition bounds
with Jacobi and the roundoff bounds unpreconditioned
(tests/_torch_dist_common.py).  The rank's operator strains its element
slots from the halo-exchanged x and folds the element forces back, as its
residual does; its Jacobi diagonal is assembled on the slots and folded.
Under matfree, -pc_type mg is the identity on ranks too (R7): the same
iterations as -pc_type none.
"""

import numpy as np
import pytest
import torch

import _torch_dist_common as common

torch.set_num_threads(1)

BENDING = dict(nx=9, ny=5, nz=5, lx=4.0, ly=2.0, lz=2.0, bc_type=0, dtype="float64",
               dt=0.001, u_max=-1.0, newton_max_its=3, ts=2, operator="matfree")
CONFIGS = {
    "matfree_jacobi": (2, dict(BENDING, pc_type="jacobi")),
    "matfree_mg": (2, dict(BENDING, pc_type="mg")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_matfree_ranks_match(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    ref_rec, ref_u, _ = one if against == "one_process" else jx
    assert rec["procs"] == [2, 1, 1] and rec["node_shape"] == [10, 5, 5]
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    if name == "matfree_jacobi":
        common.assert_exact(rec, ref_rec)
        common.assert_exact_u(u, ref_u)
    else:
        # unpreconditioned CG turns the dots' summation order into the
        # last digits of its post-solve |RES|: the roundoff bounds
        common.assert_roundoff(rec, ref_rec)
        assert np.allclose(u, ref_u, rtol=0, atol=1e-6 * np.abs(ref_u).max())


def test_matfree_mg_is_the_identity_on_ranks(runs):
    """R7: Jacobi needs fewer iterations than the unpreconditioned solve
    that matfree makes of -pc_type mg, on ranks as on one process."""
    jac = [k for s in runs("matfree_jacobi")[0][0]["steps"] for k in s["ksp_its"]]
    mg = [k for s in runs("matfree_mg")[0][0]["steps"] for k in s["ksp_its"]]
    assert len(jac) == len(mg) and sum(jac) < sum(mg)
