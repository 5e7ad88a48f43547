"""FE² across ranks (CPU float64): each rank homogenizes its own block of
micro RVEs (micro_n=2, two-phase), its screen, compaction and waves on its
own population, with no traffic, as the JAX package does inside shard_map.
tests/test_microfe_dist.py's 5x3x5 bending line, elastic fast path on and
off, as 2 gloo ranks (the node box pads to 6 in z) against the JAX
package's 2-device run and the port's one process, within
test_microfe_dist.py's bounds (the per-GP micro solves run in other batch
compositions): the same solves, |RES| within 1e-5, u within 1e-6 relative
plus 1e-9, and against JAX the committed micro state of the real elements.
``fields_from_numpy(..., mesh=)`` cuts a MicroState per rank.
"""

import numpy as np
import pytest
import torch

import _torch_dist_common as common
from test_torch_halo import launch_ranks

torch.set_num_threads(1)

FE2 = dict(nx=5, ny=3, nz=5, lx=4.0, ly=1.0, lz=4.0, bc_type=0, dtype="float64", dt=0.001,
           u_max=-1.0, newton_max_its=2, ts=2, constitutive="microfe", micro_n=2,
           micro_mat_2=dict(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7))
CONFIGS = {
    "fe2_fast": (2, dict(FE2, micro_elastic_fastpath=True)),
    "fe2_full": (2, dict(FE2, micro_elastic_fastpath=False)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.runner(__name__, tmp_path_factory)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fe2_ranks_match(runs, name, against):
    (rec, u, eps_p), one, jx = runs(name)
    ref_rec, ref_u, ref_eps_p = one if against == "one_process" else jx
    assert rec["procs"] == [1, 1, 2] and rec["node_shape"] == [5, 3, 6]
    assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    for gs, ws in zip(rec["steps"], ref_rec["steps"], strict=True):
        assert len(gs["ksp_its"]) == len(ws["ksp_its"]) and gs["converged"] == ws["converged"]
        assert gs["nl_gps"] == ws["nl_gps"]
        np.testing.assert_allclose(gs["res_norms"], ws["res_norms"], rtol=1e-5)
    assert np.allclose(u, ref_u, rtol=1e-6, atol=1e-9)
    ne = (4, 2, 4)
    np.testing.assert_allclose(eps_p[:4, :2, :4], ref_eps_p[:ne[0], :ne[1], :ne[2]],
                               rtol=1e-6, atol=1e-10)
    assert eps_p.shape[3:] == (8, 2 ** 3 * 8 * 6)


def _cut_main(out_dir):
    """One rank: a MicroState made of global numpy arrays at the padded
    node shape, cut by fields_from_numpy(mesh=), gathered back."""
    torch.set_num_threads(1)
    from macroc_tpu_torch import config
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.problem import MacroProblem, fields_from_numpy, fields_to_numpy

    assert distributed.maybe_initialize()
    p = MacroProblem(common.make_cfg(config, CONFIGS["fe2_full"][1]), "cpu")
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(p.node_shape + tail)
              for tail in ((3,), (8, 384), (8, 64), (8, 81))]
    u, state = fields_from_numpy(*leaves[:3], "cpu", micro_u=leaves[3], mesh=p.mesh)
    assert type(state).__name__ == "MicroState" and tuple(u.shape[:3]) == p.mesh.block
    back = fields_to_numpy(u, state, p.mesh)
    assert all(np.array_equal(a, b) for a, b in zip(back, leaves))
    distributed.shutdown()


def test_fields_from_numpy_cuts_a_micro_state(tmp_path):
    launch_ranks(2, f"import test_torch_dist_fe2 as t; t._cut_main({str(tmp_path)!r})")
