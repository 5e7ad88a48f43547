"""Typed configuration + PETSc-options-compatible CLI parsing.

Replaces the reference's PETSc options database (reference: src/init.c:47-83)
with an immutable dataclass.  The same flag names are honored so reference
launch lines work unchanged (e.g. ``-da_grid_x 5 -ts 5 -bc_type 0``).

Compiled-in defaults replicate include/macroc.h:36-51 and src/init.c:29-64
exactly (grid 40x3x40, box 50x1x50, dt=1e-3, ts=1, U_MAX=-1, BC_CIRCLE, ...).
Note the reference README documents different defaults (grid 10, lx 10) and
the flags ``-new_its``/``-new_tol`` — the code ignores those; code behavior
wins (see SURVEY.md §5.6), and so does this implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Boundary-condition cases (reference: include/macroc.h:58)
BC_BENDING = 0
BC_CIRCLE = 1

# Micro-structure geometry types (reference: src/init.c:37-45)
MIC_HOMOGENEOUS = -1  # extension: bypass micro geometry, single material
MIC_SPHERE = 0
MIC_LAYER_Y = 1
MIC_CILI_FIB_Z = 3
MIC_CILI_FIB_XZ = 4
MIC_QUAD_FIB_XYZ = 5
MIC_QUAD_FIB_XZ = 6
MIC_QUAD_FIB_XZ_BROKEN_X = 7


@dataclasses.dataclass(frozen=True)
class MaterialParams:
    """One material entry (reference: micropp_C_material_set, src/init.c:196-201).

    Fields map to (E, nu, Sy, Ka) with plasticity enabled, matching the
    hard-coded ``plastic=1`` in the reference call sites.
    """

    E: float = 1.0e7
    nu: float = 0.25
    Sy: float = 1.0e4
    Ka: float = 1.0e7
    plastic: bool = True

    @property
    def lam(self) -> float:
        """First Lamé parameter."""
        return self.E * self.nu / ((1.0 + self.nu) * (1.0 - 2.0 * self.nu))

    @property
    def mu(self) -> float:
        """Shear modulus."""
        return self.E / (2.0 * (1.0 + self.nu))


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    """Immutable run configuration.

    Defaults replicate include/macroc.h:36-51 + src/init.c:29-64,141.
    """

    # Grid (nodes per direction) — reference NX/NY/NZ (macroc.h:44-46)
    nx: int = 40
    ny: int = 3
    nz: int = 40
    # Physical box — reference LX/LY/LZ (macroc.h:47-49)
    lx: float = 50.0
    ly: float = 1.0
    lz: float = 50.0

    # Time stepping — macroc.h:40-43
    dt: float = 0.001
    ts: int = 1
    final_time: float = 1.0
    u_max: float = -1.0

    # Newton — macroc.h:36-38
    newton_max_its: int = 5
    newton_min_tol: float = 1.0e-1
    newton_rel_tol: float = 1.0e-4

    # Linear solver — src/init.c:146-157
    ksp_type: str = "cg"  # {"cg", "gmres"}
    # Preconditioner.  "auto" resolves per grid: geometric-multigrid V-cycle
    # when at least two extents support a deep hierarchy (>= 17, where MG
    # measures a flat ~6-9 CG its vs Jacobi's O(n) growth) — thin dims are
    # SEMICOARSENED (kept fixed), covering the reference's ny=3 pancake
    # shapes — plain Jacobi otherwise (the reference's fixed choice,
    # src/init.c:155).
    pc_type: str = "auto"  # {"auto", "none", "jacobi", "bjacobi", "mg"}
    ksp_rtol: float = 1.0e-5
    ksp_abstol: float = 1.0e-50
    ksp_dtol: float = 1.0e4
    ksp_maxits: int = 10000
    gmres_restart: int = 30
    # Runtime KSP monitors (PETSc -ksp_monitor / -ksp_converged_reason,
    # forwarded by the reference via KSPSetFromOptions, src/init.c:156):
    # per-iteration residual-norm lines and a per-solve convergence-reason
    # line in PETSc's output format.
    ksp_monitor: bool = False
    ksp_converged_reason: bool = False
    # Geometric-MG V-cycle shape (pc_type=mg): pre/post smoothing sweeps,
    # damped-block-Jacobi weight, coarsest-level sweep count.  V(1,1) with
    # 10 coarse sweeps measured fastest end-to-end at 128^3 on v5e
    # (629 ms @ 9 CG its vs 678 ms @ 7 for V(2,2)/20).
    mg_nu: int = 1
    mg_omega: float = 0.6
    mg_coarse_sweeps: int = 10
    # Coarsest-level solve: True = exact dense inverse (default; needed for
    # weakly-constrained BCs like the circle patch), False = Jacobi sweeps.
    mg_coarse_direct: bool = True
    # Storage dtype for the V-cycle level operators ("" = solve dtype).
    # "bfloat16" halves the smoother's A-read traffic; the V-cycle is only
    # a preconditioner, so reduced precision costs at most an extra CG
    # iteration (vectors/transfers stay in solve dtype).
    mg_dtype: str = ""
    # Transfer (P/R) interpolation order: 0 = auto (cubic on semicoarsened
    # pancake hierarchies, linear on cubes), 1 = linear, 3 = cubic.
    mg_transfer_order: int = 0

    # BCs — src/init.c:64,141
    bc_type: int = BC_CIRCLE
    rad: float = 1.0

    # Micro scale — src/init.c:29-32,80-83,210-213
    micro_n: int = 2
    micro_type: int = MIC_LAYER_Y
    micro_mat_1: MaterialParams = dataclasses.field(default_factory=MaterialParams)
    micro_mat_2: MaterialParams = dataclasses.field(default_factory=MaterialParams)
    micro_params: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 0.5)
    # Skip the per-GP RVE Newton + tangent solves for GP chunks whose
    # internal vars are pristine and whose linear elastic trial stays below
    # yield (exact by superposition; disable with
    # -micro_elastic_fastpath 0 to force the full solve everywhere).
    micro_elastic_fastpath: bool = True
    # Full-solve sub-chunk size for the compacted active-GP work lists
    # (constitutive/microfe.py::_solve_chunk; 0 = auto 32): localized
    # plasticity costs ceil(n_active/chunk) full-solve waves instead of
    # every touched 128-GP chunk.
    micro_active_chunk: int = 0
    # Micro CG preconditioner: "auto" = shared dense elastic inverse up to
    # micro_n=10 (production size; ~5x fewer CG its, MXU-batched apply),
    # "jacobi"/"dense_elastic" force one (constitutive/microfe.py).
    micro_precond: str = "auto"
    # Constitutive engine: "auto" routes by physics — "microfe" (batched
    # micro-FE homogenization, the full FE² path) whenever mat_1 != mat_2
    # and the micro geometry is heterogeneous, else "j2" (closed-form J2
    # plasticity, exact for an effectively homogeneous RVE).  "elastic",
    # "j2", "microfe" force a specific engine.
    constitutive: str = "auto"

    # Output — macroc.h:42
    vtu_freq: int = -1
    output_dir: str = "."
    # VTU payload encoding: "ascii" matches the reference byte-for-byte
    # (src/output.c); "binary" is VTK inline base64 (~4x smaller, ~20x
    # faster to write); "appended" is VTK appended-raw (bytes land as one
    # write per array — the production default); "auto" = appended for
    # grids > 100k nodes.
    vtu_encoding: str = "auto"

    # Device decomposition — reference -da_processors_{x,y,z} (README.md:52-54).
    # None = decide from available devices (PETSC_DECIDE equivalent).
    procs_x: Optional[int] = None
    procs_y: Optional[int] = None
    procs_z: Optional[int] = None

    # Numerics knobs (TPU-native additions)
    dtype: str = "float32"  # storage/compute dtype: "float32" | "float64"
    # Replicate the reference's calc_B unit-element quirk (assembly.c:198):
    # shape-function derivatives always use dx=dy=dz=1 while the quadrature
    # weight uses the real spacing.  True = bit-compatible with reference.
    ref_b_quirk: bool = True
    # Operator form for the Krylov solve:
    #   "auto"           — Pallas stencil kernel on TPU for large grids
    #                      (nz >= 128, where it measures ~2x the jnp path),
    #                      fused-jnp stencil otherwise
    #   "stencil"        — assembled 27-point BSR, fused-jnp SpMV (portable)
    #   "stencil_pallas" — assembled BSR, Pallas SpMV kernel (TPU only)
    #   "matfree"        — element-loop operator action, no assembled matrix
    operator: str = "auto"
    # Stencil-assembly formulation:
    #   "auto" — best measured form for the backend
    #   "slab" — x-slab-blocked spatial-minor einsums (assemble_stencil_soa)
    #   "conv" — one MXU 3D convolution with the constant 2x2x2x288x243
    #            kernel (assemble_stencil_soa_conv)
    #   "conv2" — two-stage MXU form: per-element Ke matmul (288->576) +
    #             grouped selector conv (assemble_stencil_soa_conv2)
    assembly: str = "auto"

    # Checkpoint / resume (TPU-native addition; reference has none, SURVEY §5.4)
    checkpoint_freq: int = -1
    checkpoint_dir: str = "checkpoints"
    resume: bool = False

    # Profiling (TPU-native replacement for HPCToolkit/-log_view, SURVEY §5.1)
    profile_dir: str = ""      # jax.profiler trace output dir ("" = off)
    log_phases: bool = False   # print per-phase wall-clock table at the end

    @property
    def nex_global(self) -> int:
        return self.nx - 1

    @property
    def ney_global(self) -> int:
        return self.ny - 1

    @property
    def nez_global(self) -> int:
        return self.nz - 1

    @property
    def dx(self) -> float:
        # reference: src/init.c:137-139
        return self.lx / (self.nx - 1)

    @property
    def dy(self) -> float:
        return self.ly / (self.ny - 1)

    @property
    def dz(self) -> float:
        return self.lz / (self.nz - 1)

    @property
    def wg(self) -> float:
        """Gauss weight = element volume / 8 (reference: src/init.c:140)."""
        return self.dx * self.dy * self.dz / 8.0

    def displacement(self, time_s: int) -> float:
        """Load-ramp U(t) = U_MAX * t/T (reference: src/bcs.c:52-58 intent)."""
        return self.u_max * (time_s * self.dt) / self.final_time


_INT_FLAGS = {
    "-da_grid_x": "nx",
    "-da_grid_y": "ny",
    "-da_grid_z": "nz",
    "-da_processors_x": "procs_x",
    "-da_processors_y": "procs_y",
    "-da_processors_z": "procs_z",
    "-ts": "ts",
    "-vtu_freq": "vtu_freq",
    "-newton_max_its": "newton_max_its",
    "-bc_type": "bc_type",
    "-micro_n": "micro_n",
    "-micro_type": "micro_type",
    "-micro_active_chunk": "micro_active_chunk",
    "-ksp_max_it": "ksp_maxits",
    "-ksp_gmres_restart": "gmres_restart",
    "-mg_nu": "mg_nu",
    "-mg_coarse_sweeps": "mg_coarse_sweeps",
    "-mg_transfer_order": "mg_transfer_order",
    "-checkpoint_freq": "checkpoint_freq",
}

_REAL_FLAGS = {
    "-dt": "dt",
    "-lx": "lx",
    "-ly": "ly",
    "-lz": "lz",
    "-newton_min_tol": "newton_min_tol",
    "-newton_rel_tol": "newton_rel_tol",
    "-ksp_rtol": "ksp_rtol",
    "-ksp_atol": "ksp_abstol",
    "-ksp_divtol": "ksp_dtol",
    "-rad": "rad",
    "-mg_omega": "mg_omega",
}

_STR_FLAGS = {
    "-ksp_type": "ksp_type",
    "-pc_type": "pc_type",
    "-constitutive": "constitutive",
    "-micro_precond": "micro_precond",
    "-dtype": "dtype",
    "-operator": "operator",
    "-assembly": "assembly",
    "-output_dir": "output_dir",
    "-vtu_encoding": "vtu_encoding",
    "-mg_dtype": "mg_dtype",
    "-checkpoint_dir": "checkpoint_dir",
    "-profile_dir": "profile_dir",
}


def _parse_material(tok: str) -> MaterialParams:
    """Parse '-micro_mat_N E,nu,Sy,Ka' array syntax (PetscOptionsGetRealArray)."""
    vals = [float(v) for v in tok.replace(" ", "").split(",") if v]
    fields = ["E", "nu", "Sy", "Ka"]
    return MaterialParams(**dict(zip(fields, vals)))


def parse_cli(argv: Sequence[str], base: Optional[MacroConfig] = None) -> MacroConfig:
    """Parse a PETSc-style flag list into a MacroConfig.

    Unknown flags are ignored, matching the PETSc options database's tolerance
    (which is what makes the reference silently ignore ``-new_its``; see
    SURVEY.md §5.6).
    """
    cfg = dataclasses.asdict(base or MacroConfig())
    # dataclasses.asdict deep-converts nested dataclasses; restore them.
    cfg["micro_mat_1"] = (base or MacroConfig()).micro_mat_1
    cfg["micro_mat_2"] = (base or MacroConfig()).micro_mat_2
    cfg["micro_params"] = tuple(cfg["micro_params"])

    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        nxt = argv[i + 1] if i + 1 < len(argv) else None
        if tok in _INT_FLAGS and nxt is not None:
            cfg[_INT_FLAGS[tok]] = int(nxt)
            i += 2
        elif tok in _REAL_FLAGS and nxt is not None:
            cfg[_REAL_FLAGS[tok]] = float(nxt)
            i += 2
        elif tok in _STR_FLAGS and nxt is not None:
            cfg[_STR_FLAGS[tok]] = str(nxt)
            i += 2
        elif tok == "-micro_mat_1" and nxt is not None:
            cfg["micro_mat_1"] = _parse_material(nxt)
            i += 2
        elif tok == "-micro_mat_2" and nxt is not None:
            cfg["micro_mat_2"] = _parse_material(nxt)
            i += 2
        elif tok == "-micro_params" and nxt is not None:
            cfg["micro_params"] = tuple(
                float(v) for v in nxt.replace(" ", "").split(",") if v
            )
            i += 2
        elif tok == "-micro_elastic_fastpath" and nxt is not None:
            cfg["micro_elastic_fastpath"] = nxt.lower() in (
                "1", "true", "yes"
            )
            i += 2
        elif tok == "-mg_coarse_direct" and nxt is not None:
            cfg["mg_coarse_direct"] = nxt.lower() in ("1", "true", "yes")
            i += 2
        elif tok == "-ref_b_quirk" and nxt is not None:
            cfg["ref_b_quirk"] = nxt.lower() in ("1", "true", "yes")
            i += 2
        elif tok == "-ksp_monitor":
            cfg["ksp_monitor"] = True
            i += 1
        elif tok == "-ksp_converged_reason":
            cfg["ksp_converged_reason"] = True
            i += 1
        elif tok == "-resume":
            cfg["resume"] = True
            i += 1
        elif tok == "-log_phases":
            cfg["log_phases"] = True
            i += 1
        else:
            i += 1  # ignore unknown flags (PETSc behavior)
    return MacroConfig(**cfg)
