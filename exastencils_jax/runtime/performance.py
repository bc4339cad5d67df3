"""Device table and roofline traffic model.

Reference: performance/ir/IR_EvaluatePerformanceEstimates.scala:43
(per-loop-nest estimate from field-access bytes vs FLOPs against the
Platform hardware model).  Here the same bytes-per-DOF accounting against
the device's published memory bandwidth yields the speed-of-light
estimate that bench.py reports against (`vs_baseline`).

Device facts live in one table keyed by the exact `device_kind` JAX
reports.  A device that is not in the table is an error: no rate is
assumed for it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    hbm_bytes_per_s: float  # published peak memory bandwidth
    source: str


_H100_SHEET = "NVIDIA H100 Tensor Core GPU data sheet"

# keyed by jax.Device.device_kind (the CUDA device name)
DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(3.35e12, _H100_SHEET + ", H100 SXM"),
    "NVIDIA H100 PCIe": DeviceSpec(2.0e12, _H100_SHEET + ", H100 PCIe"),
}


def device_spec(device=None) -> DeviceSpec:
    """Table entry of `device` (default: the first JAX device)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    try:
        return DEVICE_SPECS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no device table entry for {device.device_kind!r} "
            f"(platform {device.platform!r}); known: {sorted(DEVICE_SPECS)}"
        ) from None


@dataclass
class VCycleTrafficModel:
    """Ideal memory bytes per *fine-grid DOF* for one V(pre,post) cycle of
    a (2d+1)-point multigrid solver.

    Per-pass (default): every operation is its own memory pass.  Smoother
    half-sweep (one color): read sol + rhs, write sol = 3 arrays.
    Residual: read sol + rhs, write res = 3.  Restrict: read res, write
    coarse rhs (1/2^d).  Prolong+correct: read coarse sol (1/2^d) + sol,
    write sol.  Convergence check: residual + norm read.

    `fused`: the lower bound of a schedule that runs the whole down leg
    (pre-smooth + residual + restrict) and the whole up leg (prolong +
    correct + post-smooth) as one memory pass each: 3 + 1/2^d arrays per
    leg.
    """

    ndim: int = 3
    n_pre: int = 3
    n_post: int = 3
    colors: int = 2
    dtype_bytes: int = 4
    check_residual: bool = True
    fused: bool = False

    def bytes_per_fine_dof(self) -> float:
        level_sum = 1.0 / (1.0 - 0.5 ** self.ndim)  # sum over levels of (1/2^d)^l
        ratio = 0.5 ** self.ndim
        if self.fused:
            per_level = 2 * (3 + ratio)  # one pass down, one pass up
        else:
            smoother = (self.n_pre + self.n_post) * self.colors * 3
            residual = 3
            restrict = 1 + ratio
            prolong = 2 + ratio
            per_level = smoother + residual + restrict + prolong
        check = (3 + 1) if self.check_residual else 0  # residual + norm read, finest only
        return (per_level * level_sum + check) * self.dtype_bytes

    def roofline_glups(self, bandwidth: float) -> float:
        return bandwidth / self.bytes_per_fine_dof() / 1e9
