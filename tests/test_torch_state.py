"""State carried from the JAX package into the torch port.

Two JAX steps of the bending_plastic_5x3x3 golden config leave plastic
strain in every GP; (u, J2State) crosses over as numpy through
fields_from_numpy, and step 3 runs in both packages.  The first |RES| of
the step sees identical inputs (1e-12).  After it, PCG on the plastic
tangent amplifies roundoff (tests/test_torch_golden.py): the Newton
structure must agree exactly, the committed fields to 1e-6 of their
largest magnitude (the spread of the JAX package's own equivalent
assemblers on this config is ~1e-7)."""

import jax.numpy as jnp
import numpy as np
import torch

from make_goldens import CONFIGS
from macroc_tpu.problem import MacroProblem as JaxProblem
from macroc_tpu_torch.problem import MacroProblem, fields_from_numpy, fields_to_numpy

torch.set_num_threads(1)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_jax_state_continues_in_port():
    cfg = CONFIGS["bending_plastic_5x3x3"]
    pj = JaxProblem(cfg, n_devices=1)
    u, state = pj.init_fields()
    for ts in range(2):
        u, state, _ = pj.time_step_jit(u, state, jnp.asarray(cfg.displacement(ts), pj.dtype))
    u_np, ep_np, al_np = (np.asarray(a) for a in (u, state.eps_p, state.alpha))
    assert np.count_nonzero(al_np) > 0  # plastic history to carry

    pt = MacroProblem(cfg, "cpu")
    ut, st = fields_from_numpy(u_np, ep_np, al_np, "cpu")
    assert ut.dtype == pt.dtype and st.eps_p.shape == pt.elem_shape + (8, 6)
    back = fields_to_numpy(ut, st)
    for a, b in zip(back, (u_np, ep_np, al_np)):
        assert np.array_equal(a, b)

    U = cfg.displacement(2)
    uj, sj, dj = pj.time_step_jit(u, state, jnp.asarray(U, pj.dtype))
    ut, st, dt = pt.time_step(ut, st, U)
    assert dt.n_solves == int(dj.n_solves) and dt.n_homogenize == int(dj.n_homogenize)
    assert dt.converged == bool(dj.converged)
    res_j = np.asarray(dj.res_norms)
    assert np.isclose(dt.res_norms[0], res_j[0], rtol=1e-12)
    assert int(dt.non_linear.sum()) == int(np.asarray(dj.non_linear).sum())
    u_t, ep_t, al_t = fields_to_numpy(ut, st)
    assert _rel(u_t, np.asarray(uj)) < 1e-6
    assert _rel(ep_t, np.asarray(sj.eps_p)) < 1e-6
    assert _rel(al_t, np.asarray(sj.alpha)) < 1e-6
    assert np.isclose(dt.force, float(dj.force), rtol=1e-6)
