"""exastencils_jax: a geometric-multigrid stencil framework on JAX/XLA.

A ground-up re-design of the capabilities of ExaStencils (a Scala
source-to-source compiler that emits MPI/OpenMP/CUDA C++ multigrid solvers,
see reference Compiler/src/Main.scala) as a JAX/XLA framework:

* The reference's four-layer ExaSlang DSL (L1 continuous .. L4 imperative)
  becomes a tiered Python API + .exa file frontends that *stage to JAX*
  instead of printing C++ (reference: prettyprinting/PrettyprintingManager.scala).
* Blocks/fragments + MPI halo exchange (reference: communication/ir/)
  become a `jax.sharding.Mesh` with `shard_map`ped stencil steps and
  `ppermute` neighbor shifts between devices.
* CUDA kernel extraction (reference: parallelization/api/cuda/) becomes
  XLA's own GPU code generation for the fused jnp stencil ops.
* The reference's 80-pass IR optimizer pipeline (app/ir/IR_LayerHandler.scala)
  is largely subsumed by XLA; what remains are domain-level transforms
  (solver synthesis, stencil algebra, layout/halo planning).
"""

__version__ = "0.1.0"

from exastencils_jax.config import Knowledge, Settings, Platform  # noqa: F401
