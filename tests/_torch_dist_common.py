"""Shared machinery of the tests/test_torch_dist_*.py files: one
configuration run as N gloo ranks of macroc_tpu_torch (CPU, float64),
as the port's one process, and as the JAX package's
``MacroProblem(cfg, n_devices=N)`` on N of the conftest's virtual devices,
with test_torch_dist.py's bounds.

A test module holds ``CONFIGS = {name: (n_ranks, flags)}``; flags are
MacroConfig keywords, with a material as a dict (each package builds its
own MaterialParams).  The ranks import no jax: ``launch_ranks`` imports
this module and the test module in each rank, so jax stays inside the
functions that run in the test process.
"""

import importlib
import json
import os

import numpy as np
import torch

from test_torch_halo import launch_ranks

MATERIALS = ("micro_mat_1", "micro_mat_2")


def make_cfg(config_module, flags, one_process=False):
    """A MacroConfig of ``config_module`` (either package's config) from
    ``flags``; ``one_process`` drops the pinned rank grid."""
    kw = {k: v for k, v in flags.items() if not (one_process and k.startswith("procs"))}
    for k in MATERIALS:
        if isinstance(kw.get(k), dict):
            kw[k] = config_module.MaterialParams(**kw[k])
    return config_module.MacroConfig(**kw)


def steps_torch(p, cfg):
    """Run cfg.ts steps of a port MacroProblem; per-step records and the
    final (u, eps_p) as global numpy arrays (a collective on a rank)."""
    from macroc_tpu_torch.problem import fields_to_numpy

    u, state = p.init_fields()
    steps = []
    for ts in range(cfg.ts):
        u, state, d = p.time_step(u, state, cfg.displacement(ts))
        counts = p.nonlinear_counts(d.non_linear)
        steps.append(dict(res_norms=[float(v) for v in d.res_norms[:d.n_homogenize]],
                          ksp_its=[int(v) for v in d.ksp_its[:d.n_solves]],
                          force=d.force, f_trial_max=d.f_trial_max,
                          nl_gps=int(counts.sum()), per_rank=counts.tolist(),
                          converged=bool(d.converged)))
    fields = fields_to_numpy(u, state, p.mesh)
    return steps, p.unpad_u(fields[0]), fields[1]


def rank_main(module, name, out_dir):
    """One rank of the N-rank run of ``module.CONFIGS[name]``; rank 0
    saves it."""
    torch.set_num_threads(1)
    from macroc_tpu_torch import config
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.problem import MacroProblem

    assert distributed.maybe_initialize()
    cfg = make_cfg(config, importlib.import_module(module).CONFIGS[name][1])
    p = MacroProblem(cfg, "cpu")
    steps, u, eps_p = steps_torch(p, cfg)
    if distributed.is_primary():
        np.savez(os.path.join(out_dir, "fields.npz"), u=u, eps_p=eps_p)
        with open(os.path.join(out_dir, "steps.json"), "w") as f:
            json.dump(dict(steps=steps, procs=list(p.grid.procs), node_shape=p.node_shape,
                           block=p.local_shape), f)
    distributed.shutdown()


def steps_jax(n, flags):
    """The JAX package's N-device run (test_dist.py's pattern): per-step
    records, the unpadded u and the padded eps_p."""
    import jax
    import jax.numpy as jnp
    from macroc_tpu import config
    from macroc_tpu.forces import per_rank_nonlinear_counts
    from macroc_tpu.parallel import make_grid_mesh, shard_problem_fields
    from macroc_tpu.problem import MacroProblem

    cfg = make_cfg(config, flags)
    p = MacroProblem(cfg, n_devices=n)
    u, state = shard_problem_fields(make_grid_mesh(p.grid), *p.init_fields())
    step = jax.jit(p.time_step)
    steps = []
    for ts in range(cfg.ts):
        u, state, d = step(u, state, jnp.asarray(cfg.displacement(ts), p.dtype))
        res = np.asarray(d.res_norms)
        nsol = int(d.n_solves)
        counts = per_rank_nonlinear_counts(np.asarray(d.non_linear), p.grid)
        steps.append(dict(res_norms=res[~np.isnan(res)].tolist(),
                          ksp_its=np.asarray(d.ksp_its)[:nsol].tolist(),
                          force=float(d.force), f_trial_max=float(d.f_trial_max),
                          nl_gps=int(counts.sum()), per_rank=counts.tolist(),
                          converged=bool(d.converged)))
    return dict(steps=steps, procs=list(p.grid.procs)), np.asarray(p.unpad_u(u)), \
        np.asarray(state.eps_p)


def runner(module, tmp_path_factory):
    """get(name) -> (ranks, one_process, jax), each a (record, u, eps_p)
    triple, computed on first use."""
    from macroc_tpu_torch import config
    from macroc_tpu_torch.problem import MacroProblem

    configs = importlib.import_module(module).CONFIGS
    cache = {}

    def get(name):
        if name not in cache:
            n, flags = configs[name]
            out = tmp_path_factory.mktemp(name)
            launch_ranks(n, "import _torch_dist_common as c; "
                            f"c.rank_main({module!r}, {name!r}, {str(out)!r})")
            with open(out / "steps.json") as f:
                rec = json.load(f)
            f = np.load(out / "fields.npz")
            cfg1 = make_cfg(config, flags, one_process=True)
            steps1, u1, e1 = steps_torch(MacroProblem(cfg1, "cpu"), cfg1)
            cache[name] = ((rec, f["u"], f["eps_p"]), (dict(steps=steps1), u1, e1),
                           steps_jax(n, flags))
        return cache[name]

    return get


def assert_exact(got, want):
    """Elastic steps: test_multiprocess.py's decomposition bounds (solves
    and KSP its equal, |RES| and force within 1e-8 relative)."""
    assert len(got["steps"]) == len(want["steps"])
    for gs, ws in zip(got["steps"], want["steps"]):
        assert gs["ksp_its"] == ws["ksp_its"]
        assert gs["converged"] == ws["converged"] and gs["nl_gps"] == ws["nl_gps"] == 0
        assert np.allclose(gs["res_norms"], ws["res_norms"], rtol=1e-8, atol=1e-12)
        assert np.isclose(gs["force"], ws["force"], rtol=1e-8, atol=1e-12)


def assert_exact_u(u, ref_u):
    assert np.allclose(u, ref_u, rtol=0, atol=1e-8 * max(np.abs(ref_u).max(), 1e-300))


def assert_roundoff(got, want):
    """Yielding steps: tests/test_torch_golden.py's roundoff bounds."""
    assert len(got["steps"]) == len(want["steps"])
    for gs, ws in zip(got["steps"], want["steps"]):
        assert len(gs["ksp_its"]) == len(ws["ksp_its"])
        assert gs["converged"] == ws["converged"] and gs["nl_gps"] == ws["nl_gps"]
        assert np.isclose(gs["res_norms"][0], ws["res_norms"][0], rtol=1e-7, atol=1e-12)
        assert all(abs(a - b) <= 6 for a, b in zip(gs["ksp_its"], ws["ksp_its"]))
        assert np.isclose(gs["force"], ws["force"], rtol=1e-5, atol=1e-12)
        assert np.isclose(gs["f_trial_max"], ws["f_trial_max"], rtol=1e-5, atol=1e-12)


def assert_padded(got, u, want, ref_u):
    """A padded rank grid against the unpadded one-process run: the MG
    hierarchy of the padded box differs, so both are solves of one system
    to ksp_rtol (tests/test_dist.py:129-135): u within 1e-4, the same
    number of solves, force within 1e-4, MG still effective."""
    assert len(got["steps"]) == len(want["steps"])
    for gs, ws in zip(got["steps"], want["steps"]):
        assert len(gs["ksp_its"]) == len(ws["ksp_its"])
        assert np.isclose(gs["force"], ws["force"], rtol=1e-4)
        assert max(gs["ksp_its"], default=0) <= 25
    assert np.allclose(u, ref_u, rtol=1e-4, atol=1e-5 * np.abs(ref_u).max())
