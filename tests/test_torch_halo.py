"""The port's halo primitives (macroc_tpu_torch/parallel/halo.py) on N gloo
ranks against the JAX package's functions in shard_map on N of the
conftest's 8 virtual devices, at float64, on rank grids (2,1,1), (1,2,2)
and (4,1,1) of an 8x6x6 node box.

Each rank grid is one launch of N processes (``launch_ranks``): every rank
runs ``_rank_main`` on its block of numpy-seeded global inputs and saves its
outputs; the test process assembles the blocks into the shard_map global
layout and compares:

  - exchange_axis (each axis, width 1 and 2) and halo_exchange: bitwise;
  - fold_axis_add, halo_fold_add, fold_high_plane: 1e-15 relative (a fold
    adds two slabs, the same single addition on both sides);
  - assemble_stencil_local against shmap_assemble_stencil, and
    stencil_matvec_local against shmap_stencil_matvec: 1e-12 relative
    (test_halo.py's bound: the per-rank assemblers and products sum in
    another order than the JAX ones);
  - the width > extent ValueError, and RankMesh.gather, bitwise;
  - axis_gather along each axis on rank grids (1,2,1), (1,3,1) and (2,2,1)
    (one launch each): bitwise the global field's line of blocks, and the
    identity on one process and along an unsplit axis.

The ranks import no jax: this module imports it inside the tests only.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

SHAPE = (8, 6, 6)  # nodes; every rank grid below divides it
MESHES = [(2, 1, 1), (1, 2, 2), (4, 1, 1)]
WG = 0.5 ** 3 / 8.0
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(n, code, env=None, timeout=RANK_TIMEOUT_S, cwd=REPO):
    """Run ``python -c code`` as ranks 0..n-1 of one gloo process group on
    the CPU (the MACROC_* environment), in ``cwd`` (one directory, or one
    per rank); returns their outputs after every rank exited 0.  A rank
    still running at ``timeout`` is killed and fails the launch."""
    port = _free_port()
    cwds = cwd if isinstance(cwd, list) else [cwd] * n
    procs = []
    for rank in range(n):
        e = dict(os.environ, MACROC_PLATFORM="cpu", MACROC_COORDINATOR=f"localhost:{port}",
                 MACROC_NUM_PROCESSES=str(n), MACROC_PROCESS_ID=str(rank),
                 PYTHONPATH=os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")]),
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=e, cwd=cwds[rank]))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def _inputs(procs):
    """Global float64 inputs of the primitives for one rank grid; extended
    inputs are in the shard_map global layout (block c at c*(b+k))."""
    rng = np.random.default_rng(sum(p * 10 ** i for i, p in enumerate(procs)))
    block = tuple(n // p for n, p in zip(SHAPE, procs))
    ext = lambda grow: tuple(p * (b + g) for p, b, g in zip(procs, block, grow))
    ctan = np.zeros(SHAPE + (8, 6, 6))
    ctan[:-1, :-1, :-1] = rng.normal(size=tuple(n - 1 for n in SHAPE) + (8, 6, 6))
    return dict(
        u=rng.normal(size=SHAPE + (3,)),
        x=rng.normal(size=(3,) + SHAPE),
        xe=rng.normal(size=(3,) + ext((2, 2, 2))),
        **{f"xh{a}": rng.normal(size=(3,) + ext(tuple(int(a == d) for d in range(3))))
           for a in range(3)},
        A=rng.normal(size=(27, 3, 3) + SHAPE),
        ctan=(ctan + ctan.transpose(0, 1, 2, 3, 5, 4)) / 2,
    )


def _ext_block(a, procs, coords, grow, lead=1):
    """Block ``coords`` of a global array in the shard_map layout whose
    blocks are grown by ``grow`` per spatial dim (spatial dims after
    ``lead`` leading ones)."""
    block = tuple(n // p for n, p in zip(SHAPE, procs))
    sl = tuple(slice(c * (b + g), (c + 1) * (b + g)) for c, b, g in zip(coords, block, grow))
    return a[(slice(None),) * lead + sl]


def _rank_main(procs, out_dir):
    """One rank: every primitive on its block, outputs to out_dir."""
    torch.set_num_threads(1)
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.grid import StructuredGrid3D
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.parallel import halo
    from macroc_tpu_torch.parallel.mesh import RankMesh

    assert distributed.maybe_initialize()
    grid = StructuredGrid3D(*SHAPE, 1.0, 1.0, 1.0, procs=tuple(procs))
    mesh = RankMesh(grid, distributed.Comm("cpu"))
    inp = _inputs(procs)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    soa = lambda a: t(a[(slice(None),) + mesh.slices()])
    x = soa(inp["x"])
    out = {}
    for axis in range(3):
        for width in (1, 2):
            out[f"exchange_axis{axis}_w{width}"] = halo.exchange_axis(x, mesh, axis, axis + 1, width)
        grow = tuple(int(axis == d) for d in range(3))
        xh = t(_ext_block(inp[f"xh{axis}"], procs, mesh.coords, grow))
        out[f"fold_high_plane{axis}"] = halo.fold_high_plane(xh, mesh, axis, axis + 1)
        xe = t(_ext_block(inp["xe"], procs, mesh.coords, (2, 2, 2)))
        out[f"fold_axis_add{axis}"] = halo.fold_axis_add(xe, mesh, axis, axis + 1)
    out["halo_exchange"] = halo.halo_exchange(t(mesh.local(inp["u"])), mesh, dims=(0, 1, 2))
    out["halo_fold_add"] = halo.halo_fold_add(
        t(_ext_block(inp["xe"], procs, mesh.coords, (2, 2, 2))), mesh, dims=(1, 2, 3))
    B = torch.as_tensor(b_matrix((0.5, 0.5, 0.5)))
    out["assemble_stencil_local"] = halo.assemble_stencil_local(
        t(mesh.local(inp["ctan"])), B, WG, mesh, assemble_stencil_soa_kernel)
    A_l = t(inp["A"][(slice(None),) * 3 + mesh.slices()])
    out["stencil_matvec_local"] = halo.stencil_matvec_local(A_l, x, mesh)
    try:
        halo.exchange_axis(x, mesh, 0, 1, width=x.shape[1] + 1)
        out["width_raises"] = np.array(False)
    except ValueError as e:
        out["width_raises"] = np.array("halo width" in str(e))
    out["gather"] = mesh.gather(t(mesh.local(inp["u"])))
    np.savez(os.path.join(out_dir, f"rank{mesh.comm.rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    distributed.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{procs: [per-rank outputs]}, one launch per rank grid on first use."""
    cache = {}

    def get(procs):
        if procs not in cache:
            out_dir = tmp_path_factory.mktemp("halo")
            n = int(np.prod(procs))
            launch_ranks(n, "import test_torch_halo as t; "
                            f"t._rank_main({json.dumps(list(procs))}, {str(out_dir)!r})")
            cache[procs] = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]
        return cache[procs]

    return get


def _stitch(parts, procs, grow, lead=1):
    """Per-rank blocks (x-fastest ranks) into the shard_map global layout."""
    block = tuple(n // p for n, p in zip(SHAPE, procs))
    shape = parts[0].shape[:lead] + tuple(p * (b + g) for p, b, g in zip(procs, block, grow))
    out = np.empty(shape + parts[0].shape[lead + 3:])
    for r, part in enumerate(parts):
        coords = (r % procs[0], (r // procs[0]) % procs[1], r // (procs[0] * procs[1]))
        sl = tuple(slice(c * (b + g), (c + 1) * (b + g)) for c, b, g in zip(coords, block, grow))
        out[(slice(None),) * lead + sl] = part
    return out


def _jax(procs, fn, in_lead, out_lead, *args):
    """fn under shard_map on a (px,py,pz) mesh of the first N devices, the
    spatial dims of every argument and result sharded after their
    ``*_lead`` leading dims."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    devices = np.asarray(jax.devices()[:int(np.prod(procs))]).reshape(procs)
    mesh = Mesh(devices, ("x", "y", "z"))
    spec = lambda lead: P(*((None,) * lead + ("x", "y", "z")))
    f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(spec(n) for n in in_lead),
                      out_specs=spec(out_lead), check_vma=False)
    return np.asarray(f(*args))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("procs", MESHES, ids=str)
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("width", [1, 2])
def test_exchange_axis_bitwise(runs, procs, axis, width):
    from macroc_tpu.parallel import halo as jhalo

    parts = [r[f"exchange_axis{axis}_w{width}"] for r in runs(procs)]
    grow = tuple(2 * width * int(axis == d) for d in range(3))
    got = _stitch(parts, procs, grow)
    name = "xyz"[axis]
    want = _jax(procs, lambda x: jhalo.exchange_axis(x, name, axis + 1, width), (1,), 1,
                _inputs(procs)["x"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("procs", MESHES, ids=str)
def test_halo_exchange_bitwise(runs, procs):
    from macroc_tpu.parallel import halo as jhalo

    got = _stitch([r["halo_exchange"] for r in runs(procs)], procs, (2, 2, 2), lead=0)
    want = _jax(procs, lambda u: jhalo.halo_exchange(u, dims=(0, 1, 2)), (0,), 0,
                _inputs(procs)["u"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("procs", MESHES, ids=str)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fold_axis_add(runs, procs, axis):
    from macroc_tpu.parallel import halo as jhalo

    got = _stitch([r[f"fold_axis_add{axis}"] for r in runs(procs)], procs,
                  tuple(2 * int(d != axis) for d in range(3)))
    want = _jax(procs, lambda xe: jhalo.fold_axis_add(xe, "xyz"[axis], axis + 1), (1,), 1,
                _inputs(procs)["xe"])
    assert _rel(got, want) <= 1e-15


@pytest.mark.parametrize("procs", MESHES, ids=str)
def test_halo_fold_add(runs, procs):
    from macroc_tpu.parallel import halo as jhalo

    got = _stitch([r["halo_fold_add"] for r in runs(procs)], procs, (0, 0, 0))
    want = _jax(procs, lambda xe: jhalo.halo_fold_add(xe, dims=(1, 2, 3)), (1,), 1,
                _inputs(procs)["xe"])
    assert _rel(got, want) <= 1e-15


@pytest.mark.parametrize("procs", MESHES, ids=str)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fold_high_plane(runs, procs, axis):
    from macroc_tpu.parallel import halo as jhalo

    got = _stitch([r[f"fold_high_plane{axis}"] for r in runs(procs)], procs, (0, 0, 0))
    want = _jax(procs, lambda xh: jhalo.fold_high_plane(xh, "xyz"[axis], axis + 1), (1,), 1,
                _inputs(procs)[f"xh{axis}"])
    assert _rel(got, want) <= 1e-15


@pytest.mark.parametrize("procs", MESHES, ids=str)
def test_assemble_stencil_local_matches_shmap(runs, procs):
    """K2's wrapper (its plain version on the CPU) per rank with the
    extra plane folded on, against the JAX slab assembler in
    shmap_assemble_stencil; split and unsplit axes in every grid."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from macroc_tpu.fem.element import b_matrix
    from macroc_tpu.fem.kernels import assemble_stencil_soa
    from macroc_tpu.parallel.halo import shmap_assemble_stencil

    got = _stitch([r["assemble_stencil_local"] for r in runs(procs)], procs, (0, 0, 0), lead=3)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(procs))]).reshape(procs), ("x", "y", "z"))
    B = jnp.asarray(b_matrix((0.5, 0.5, 0.5)))
    want = np.asarray(shmap_assemble_stencil(mesh, jnp.asarray(_inputs(procs)["ctan"]), B, WG,
                                             assemble_stencil_soa))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("procs", MESHES, ids=str)
def test_stencil_matvec_local_matches_shmap(runs, procs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from macroc_tpu.parallel.halo import shmap_stencil_matvec

    got = _stitch([r["stencil_matvec_local"] for r in runs(procs)], procs, (0, 0, 0))
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(procs))]).reshape(procs), ("x", "y", "z"))
    inp = _inputs(procs)
    want = np.asarray(shmap_stencil_matvec(mesh, jnp.asarray(inp["A"]), jnp.asarray(inp["x"])))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("procs", MESHES, ids=str)
def test_width_beyond_the_block_raises_and_gather_is_exact(runs, procs):
    out = runs(procs)
    assert all(bool(r["width_raises"]) for r in out)
    for r in out:
        np.testing.assert_array_equal(r["gather"], _inputs(procs)["u"])


GATHER_MESHES = [(1, 2, 1), (1, 3, 1), (2, 2, 1)]


def _gather_main(procs, out_dir):
    """One rank: axis_gather of its block of a seeded global field along
    each axis (tensor dims 1-3 of a (3, nx, ny, nz) field)."""
    torch.set_num_threads(1)
    from macroc_tpu_torch.grid import StructuredGrid3D
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.parallel.halo import axis_gather
    from macroc_tpu_torch.parallel.mesh import RankMesh

    assert distributed.maybe_initialize()
    mesh = RankMesh(StructuredGrid3D(*SHAPE, 1.0, 1.0, 1.0, procs=tuple(procs)),
                    distributed.Comm("cpu"))
    x = torch.as_tensor(np.ascontiguousarray(_inputs(procs)["x"][(slice(None),) + mesh.slices()]))
    out = {f"axis{a}": axis_gather(x, mesh, a, a + 1).numpy() for a in range(3)}
    out["coords"] = np.array(mesh.coords)
    out["unsplit_is_x"] = np.array([axis_gather(x, mesh, a, a + 1) is x
                                    for a in range(3) if procs[a] == 1])
    np.savez(os.path.join(out_dir, f"rank{mesh.comm.rank}.npz"), **out)
    distributed.shutdown()


@pytest.fixture(scope="module")
def gathers(tmp_path_factory):
    cache = {}

    def get(procs):
        if procs not in cache:
            out_dir = tmp_path_factory.mktemp("gather")
            n = int(np.prod(procs))
            launch_ranks(n, "import test_torch_halo as t; "
                            f"t._gather_main({json.dumps(list(procs))}, {str(out_dir)!r})")
            cache[procs] = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]
        return cache[procs]

    return get


@pytest.mark.parametrize("procs", GATHER_MESHES, ids=str)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_gather_bitwise(gathers, procs, axis):
    """Every rank holds its line group's whole line along ``axis``: the
    global field at its own block along the two other axes, whole along
    ``axis``."""
    x = _inputs(procs)["x"]
    block = tuple(n // p for n, p in zip(SHAPE, procs))
    for r in gathers(procs):
        sl = [slice(c * b, (c + 1) * b) for c, b in zip(r["coords"], block)]
        sl[axis] = slice(None)
        np.testing.assert_array_equal(r[f"axis{axis}"], x[(slice(None),) + tuple(sl)])
        assert r["unsplit_is_x"].all()


def test_axis_gather_is_the_identity_on_one_process():
    from macroc_tpu_torch.grid import StructuredGrid3D
    from macroc_tpu_torch.parallel.distributed import Comm
    from macroc_tpu_torch.parallel.halo import axis_gather
    from macroc_tpu_torch.parallel.mesh import RankMesh

    mesh = RankMesh(StructuredGrid3D(*SHAPE, 1.0, 1.0, 1.0), Comm("cpu"))
    x = torch.as_tensor(_inputs((1, 1, 1))["x"])
    assert all(axis_gather(x, mesh, a, a + 1) is x for a in range(3))
