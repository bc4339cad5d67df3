"""Problem/optimization/parallelization flags ("Knowledge").

JAX re-design of the reference's reflective flag singleton
(reference: config/Knowledge.scala:26, ~400 vars) as a dataclass.  The
flag *names* are kept compatible so the reference's `.knowledge` files
(e.g. Examples/Poisson/2D_FD_Poisson_fromL4.knowledge) load unchanged;
flags that only make sense for the CPU/CUDA codegen target (SIMD ISA,
OpenMP pragmas, MPI datatypes, ...) are accepted and recorded but have
no effect — XLA owns those decisions.

Constraint propagation follows the reference's
`Knowledge.update()` (config/Knowledge.scala:866-1078): `update()`
validates and auto-fixes dependent flags with a logged warning instead
of failing, mirroring `Constraints.condEnsureValue`.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field

logger = logging.getLogger("exastencils_jax")

# .knowledge-compat flags that are READ but deliberately have no effect
# here, with the design reason (SURVEY.md §7 "XLA owns it" mapping).
# update() logs any non-default setting of these; the flags-honesty test
# (tests/test_flags_honesty.py) requires every other flag to have a real
# consumer.
ACCEPTED_COMPAT_FLAGS = {
    # intra-device parallelism: XLA owns threading and vectorization
    "omp_enabled": "XLA owns intra-device parallelism",
    "omp_numThreads": "XLA owns intra-device parallelism",
    "omp_parallelizeLoopOverFragments": "XLA owns intra-device parallelism",
    "omp_parallelizeLoopOverDimensions": "XLA owns intra-device parallelism",
    "mpi_enabled": "device mesh + collectives replace MPI",
    "mpi_numThreads": "mesh size comes from jax.devices()",
    "cuda_enabled": "XLA's GPU backend generates the device code",
    "cuda_preferredExecution": "every op runs on the JAX device; no host/device split",
    # scalar/loop optimization passes deleted by design: XLA fuses,
    # unrolls, CSEs and schedules (SURVEY.md §7)
    "poly_optLevel_fine": "XLA owns loop scheduling",
    "opt_useAddressPrecalc": "XLA owns address computation",
    "opt_vectorize": "XLA owns vectorization",
    "opt_unroll": "XLA owns unrolling",
    "opt_useColorSplitting": "color masks are computed, not split storage",
    "opt_conventionalCSE": "XLA owns CSE",
    "opt_loopCarriedCSE_skipOuter": "XLA owns CSE",
    "experimental_trimBoundsForReductionLoops": "masked reductions instead",
    "experimental_resolveInverseFunctionCall": "jnp.linalg owns inversion",
    "experimental_useNewMatrixStrategies": "jnp.linalg owns matrix ops",
    "timer_syncMpi": "no MPI; device sync via block_until_ready",
    "benchmark_backend": "bench.py + jax.profiler replace likwid",
    "comm_batchCommunication": "XLA batches collectives during scheduling",
    "data_useFieldNamesAsIdx": "fields are named arrays, not index slots",
    # fragment aggregation: one shard == one fragment on the device mesh
    "domain_fragmentLength_x": "shard == fragment (no aggregation)",
    "domain_fragmentLength_y": "shard == fragment (no aggregation)",
    "domain_fragmentLength_z": "shard == fragment (no aggregation)",
}


# Options that lost a machine-name prefix.  A .knowledge file that still
# sets the prefixed name must fail loudly: recorded as unused, it would
# run silently at another precision or decomposition.
RENAMED_OPTIONS = ("mesh_shape", "compute_dtype", "overlap_halo",
                   "coarse_replicate_threshold", "shard_dsl",
                   "stage_functions")


@dataclass
class Knowledge:
    # --- problem geometry (reference config/Knowledge.scala:38-148) ---
    dimensionality: int = 3

    minLevel: int = 0
    maxLevel: int = 6

    discr_type: str = "FiniteDifferences"  # | FiniteVolumes | FiniteElements

    # grid spacing model (reference config/Knowledge.scala:166)
    grid_isUniform: bool = True
    grid_isStaggered: bool = False
    grid_isAxisAligned: bool = True
    grid_spacingModel: str = "uniform"  # | linearFct | blockstructured
    grid_halveStagBoundaryVolumes: bool = False

    # --- domain decomposition (reference config/Knowledge.scala:96-132) ---
    domain_onlyRectangular: bool = True
    domain_numBlocks: int = 1
    domain_numFragmentsPerBlock: int = 1
    domain_rect_generate: bool = True
    domain_rect_numBlocks_x: int = 1
    domain_rect_numBlocks_y: int = 1
    domain_rect_numBlocks_z: int = 1
    domain_rect_numFragsPerBlock_x: int = 1
    domain_rect_numFragsPerBlock_y: int = 1
    domain_rect_numFragsPerBlock_z: int = 1
    domain_fragmentLength_x: int = 1
    domain_fragmentLength_y: int = 1
    domain_fragmentLength_z: int = 1

    # refinement (reference config/Knowledge.scala:142-148)
    refinement_enabled: bool = False
    refinement_maxFineNeighborsPerDim: int = 2

    # --- data ---
    useDblPrecision: bool = True  # reference config/Knowledge.scala "useDblPrecision"
    data_initAllFieldsWithZero: bool = True
    data_useFieldNamesAsIdx: bool = True

    # --- solver defaults (reference config/Knowledge.scala:200-268) ---
    solver_targetResReduction: float = 1e-5
    solver_maxNumIts: int = 128
    solver_smoother: str = "Jacobi"  # | GaussSeidel | RBGS | Vanka
    solver_smoother_damping: float = 1.0
    solver_smoother_numPre: int = 3
    solver_smoother_numPost: int = 3
    solver_smoother_coloring: str = ""  # "" | "red-black" | "9-way" | ...
    solver_smoother_jacobiType: bool = False
    solver_cgs: str = "CG"  # | BiCGStab | MinRes | ConjugateResidual | Smoother
    solver_cgs_maxNumIts: int = 512
    solver_cgs_targetResReduction: float = 1e-3
    solver_cgs_restart: bool = False
    solver_cgs_restartAfter: int = 64
    solver_useFAS: bool = False
    solver_useFMG: bool = False
    solver_fmg_startLevel: int = 0
    solver_silent: bool = False
    solver_printAllResiduals: bool = True

    mg_cycle: str = "V"  # | W | F

    # --- testing hooks (reference config/Knowledge.scala:293-305) ---
    testing_enabled: bool = False
    testing_printRes: bool = True
    testing_printErr: bool = True
    testing_maxPrecision: int = 4
    testing_zeroThreshold: float = 1e-12

    # --- timing (reference config/Knowledge.scala:311-332) ---
    timer_type: str = "Chrono"
    timer_syncDevice: bool = True
    timer_syncMpi: bool = False
    timer_automaticTiming: bool = False
    timer_automaticCommTiming: bool = False
    timer_automaticBCsTiming: bool = False
    timer_automaticIOTiming: bool = False
    benchmark_backend: str = "None"

    # --- communication (reference config/Knowledge.scala:700-804) ---
    comm_strategyFragment: int = 6  # 6 = axis neighbors, 26 = full
    comm_onlyAxisNeighbors: bool = True
    comm_syncGhostData: bool = True
    comm_batchCommunication: bool = False
    comm_overlapCommunication: bool = False  # interior/boundary split overlap
    comm_ghostWidth: int = -1  # -1: derive from stencils; >=1: explicit
    comm_haloAggregationFactor: int = 1  # exchange width-k halo every k sweeps

    # --- parallelization: accepted for .knowledge compat; the device
    # mesh shape is what matters (see exastencils_jax.parallel.mesh) ---
    omp_enabled: bool = False
    omp_numThreads: int = 1
    omp_parallelizeLoopOverFragments: bool = False
    omp_parallelizeLoopOverDimensions: bool = False
    mpi_enabled: bool = False
    mpi_numThreads: int = 1
    cuda_enabled: bool = False
    cuda_preferredExecution: str = "Performance"

    # --- device-mesh execution (no reference analog: replaces
    # mpi_*/omp_* at runtime; one fragment per device) ---
    mesh_shape: tuple = ()  # e.g. (2, 2); () = single device
    mesh_axis_names: tuple = ("bx", "by", "bz")
    compute_dtype: str = ""  # ""=derive from useDblPrecision; "float32"|"bfloat16"
    overlap_halo: bool = False
    coarse_replicate_threshold: int = 32  # replicate levels with <= N cells/dim/shard
    shard_dsl: bool = True  # place DSL fields on a device mesh (GSPMD)
    stage_functions: bool = True  # jit traceable statement runs (staged DSL exec)

    # --- optimization flags (accepted; mostly delegated to XLA) ---
    poly_optLevel_fine: int = 0
    opt_useAddressPrecalc: bool = False
    opt_vectorize: bool = False
    opt_unroll: int = 1
    opt_useColorSplitting: bool = False
    opt_conventionalCSE: bool = False
    opt_loopCarriedCSE_skipOuter: int = 0

    experimental_trimBoundsForReductionLoops: bool = True

    # matrix-operation execution policy (reference config/Knowledge.scala:809-815)
    experimental_resolveInverseFunctionCall: str = "Compiletime"  # | Runtime
    experimental_resolveLocalMatSys: str = "Runtime"
    experimental_evalMOpRuntimeExe: bool = False
    experimental_MOpRTExeThreshold: int = 4
    experimental_useNewMatrixStrategies: bool = False

    # performance model (reference performance/ir/IR_EvaluatePerformanceEstimates.scala)
    performance_printEstimation: bool = False

    # record of flags we accepted but do not interpret (codegen-target-only)
    _unused: dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    def frags_total(self, dim: int) -> int:
        """Total fragments along `dim` = blocks * fragsPerBlock (reference
        domain/ir/IR_InitGeneratedDomain.scala:40-48)."""
        ax = "xyz"[dim]
        return getattr(self, f"domain_rect_numBlocks_{ax}") * getattr(
            self, f"domain_rect_numFragsPerBlock_{ax}"
        )

    def fragment_length(self, dim: int) -> int:
        return getattr(self, f"domain_fragmentLength_{'xyz'[dim]}")

    def cells_per_dim(self, level: int, dim: int) -> int:
        """Global cell count along `dim` at `level`:
        numBlocks * numFragsPerBlock * fragmentLength * 2^level
        (reference field layout sizing, field/ir/IR_FieldLayout.scala)."""
        return self.frags_total(dim) * self.fragment_length(dim) * (1 << level)

    @property
    def num_levels(self) -> int:
        return self.maxLevel - self.minLevel + 1

    @property
    def real_dtype(self):
        import jax.numpy as jnp

        if self.compute_dtype:
            return jnp.dtype(self.compute_dtype)
        return jnp.float64 if self.useDblPrecision else jnp.float32

    # ------------------------------------------------------------------
    def update(self) -> "Knowledge":
        """Constraint propagation, following the auto-fix-with-warning style of
        the reference's Knowledge.update() (config/Knowledge.scala:866-1078)."""

        def ensure(cond, attr, value, why):
            if not cond:
                logger.warning("Knowledge constraint: setting %s = %r (%s)", attr, value, why)
                setattr(self, attr, value)

        ensure(self.dimensionality in (1, 2, 3), "dimensionality", 3, "dimensionality must be 1, 2 or 3")
        ensure(self.minLevel >= 0, "minLevel", 0, "minLevel must be non-negative")
        ensure(self.maxLevel >= self.minLevel, "maxLevel", self.minLevel, "maxLevel must be >= minLevel")
        if self.comm_strategyFragment not in (6, 26):
            ensure(False, "comm_strategyFragment", 6, "only 6 (axis) or 26 supported")
        self.comm_onlyAxisNeighbors = self.comm_strategyFragment == 6
        ensure(self.comm_haloAggregationFactor >= 1, "comm_haloAggregationFactor", 1, "must be >= 1")
        ensure(
            self.grid_spacingModel in ("uniform", "linearFct"),
            "grid_spacingModel", "uniform",
            "supported spacing models: uniform, linearFct "
            "(core/grid.linearfct_node_positions)",
        )
        # grid consistency: only axis-aligned grids exist on this backend.
        # grid_isUniform WINS over the spacing model, exactly like the
        # reference (config/Knowledge.scala:902: "uniform spacing is
        # required for uniform grids" — the NavierStokes examples set
        # linearFct with grid_isUniform=true and expect uniform)
        ensure(self.grid_isAxisAligned, "grid_isAxisAligned", True,
               "only axis-aligned grids are supported")
        ensure(not (self.grid_isUniform and self.grid_spacingModel != "uniform"),
               "grid_spacingModel", "uniform",
               "uniform spacing is required for uniform grids")
        if self.grid_spacingModel == "uniform" and not self.grid_isUniform:
            ensure(False, "grid_isUniform", True,
                   "grid_isUniform should be true for uniform spacing models")
        ensure(not self.grid_halveStagBoundaryVolumes or self.grid_isStaggered,
               "grid_halveStagBoundaryVolumes", False,
               "needs a staggered grid")
        ensure(self.domain_onlyRectangular, "domain_onlyRectangular", True,
               "only rectangular domains are supported")
        ensure(self.domain_rect_generate, "domain_rect_generate", True,
               "domains are always generated (no from-file meshes)")
        ensure(self.comm_syncGhostData, "comm_syncGhostData", True,
               "ghost layers are always kept in sync")
        # `comm_overlapCommunication` is the reference's name for the
        # interior/boundary split — alias onto the overlap_halo path
        if self.comm_overlapCommunication:
            self.overlap_halo = True
        # automatic category timing: sub-flags require the master switch
        # (reference config/Knowledge.scala:1019-1021 condEnsureValue
        # chain enables it instead of failing)
        if (self.timer_automaticCommTiming or self.timer_automaticBCsTiming
                or self.timer_automaticIOTiming):
            ensure(self.timer_automaticTiming, "timer_automaticTiming", True,
                   "required by timer_automatic{Comm,BCs,IO}Timing")
        # compat flags: accepted so reference .knowledge files load, but
        # deliberately without effect — log any non-default use
        defaults = type(self)()
        for flag, why in ACCEPTED_COMPAT_FLAGS.items():
            if getattr(self, flag) != getattr(defaults, flag):
                logger.info(
                    "Knowledge: %s accepted for .knowledge compat, no "
                    "effect here (%s)", flag, why)
        if self.refinement_enabled:
            # honest rejection instead of a silently-dead flag: 2:1
            # block-structured mesh refinement (reference
            # domain/ir/IR_RefinementCase.scala, C2F/F2C interp packing)
            # is out of scope — uniform rectangular decompositions only
            raise NotImplementedError(
                "refinement_enabled: block-structured 2:1 mesh refinement "
                "is not implemented (uniform rectangular decompositions only)"
            )
        ensure(self.refinement_maxFineNeighborsPerDim == 2,
               "refinement_maxFineNeighborsPerDim", 2, "only 2:1 ratio defined")
        if self.solver_smoother_coloring == "" and self.solver_smoother == "RBGS":
            self.solver_smoother_coloring = "red-black"
        ensure(
            not self.solver_useFMG or self.solver_fmg_startLevel >= self.minLevel,
            "solver_fmg_startLevel", self.minLevel, "FMG start level below minLevel",
        )
        # derived aggregate counts mirroring the reference's domain_numBlocks /
        # domain_numFragmentsPerBlock derivation
        self.domain_numBlocks = (
            self.domain_rect_numBlocks_x * self.domain_rect_numBlocks_y * self.domain_rect_numBlocks_z
        )
        self.domain_numFragmentsPerBlock = (
            self.domain_rect_numFragsPerBlock_x
            * self.domain_rect_numFragsPerBlock_y
            * self.domain_rect_numFragsPerBlock_z
        )
        if self.mesh_shape:
            ensure(
                len(self.mesh_shape) <= self.dimensionality,
                "mesh_shape", (), "mesh rank exceeds problem dimensionality",
            )
        return self

    # ------------------------------------------------------------------
    def set(self, key: str, value):
        """UniversalSetter-style assignment by name (reference
        core/UniversalSetter.scala); unknown keys are recorded, not fatal."""
        if hasattr(self, key) and not key.startswith("_"):
            cur = getattr(self, key)
            if isinstance(cur, bool) and not isinstance(value, bool):
                value = str(value).strip().lower() in ("true", "1", "yes")
            elif isinstance(cur, int) and not isinstance(value, int):
                value = int(value)
            elif isinstance(cur, float) and not isinstance(value, float):
                value = float(value)
            setattr(self, key, value)
        else:
            for new in RENAMED_OPTIONS:
                if key.endswith("_" + new):
                    raise KeyError(
                        f"option {key!r} is retired; it is now {new!r}")
            self._unused[key] = value

    def copy(self) -> "Knowledge":
        return dataclasses.replace(self, _unused=dict(self._unused))
