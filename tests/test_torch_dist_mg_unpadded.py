"""MG across ranks on an 18x3x18 pancake, which ranks (1,1,2) and (2,1,2)
split without padding (CPU float64): the N-rank hierarchy is then the
one-process hierarchy, so the N gloo ranks match the port's one process
and the JAX package's N-device run within the elastic decomposition bounds
(same KSP its, |RES|, force and u within 1e-8; tests/_torch_dist_common.py).
Rank 1's z block starts at index 9, an odd global parity.
"""

import pytest
import torch

import _torch_dist_common as common

torch.set_num_threads(1)

FLAT = dict(nx=18, ny=3, nz=18, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=3.0,
            dtype="float64", ts=2, dt=0.002)
CONFIGS = {
    "flat_z2": (2, dict(FLAT, procs_x=1, procs_y=1, procs_z=2)),
    "flat_xz4": (4, dict(FLAT, procs_x=2, procs_y=1, procs_z=2)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mg_unpadded_ranks_match(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    ref_rec, ref_u, _ = one if against == "one_process" else jx
    assert rec["node_shape"] == [18, 3, 18]
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    common.assert_exact(rec, ref_rec)
    common.assert_exact_u(u, ref_u)
