"""Post-processing visualization output (VTK / XDMF).

Reference: visualization/ir/postprocessing — IR_PrintVtk.scala (legacy
VTK), xdmf/IR_PrintXdmf.scala:22 (XDMF uniform/non-uniform/meshless),
netCDF/IR_PrintExodus.scala (gated here: netCDF libs are not in the
image).  Writers gather the (possibly sharded) field to host and emit
standard files any ParaView/VisIt install reads."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import jax


def _host(arr) -> np.ndarray:
    return np.asarray(jax.device_get(arr))


def print_vtk(
    path: str,
    fields: Dict[str, object],
    grid,
    localization: str = "Node",
    title: str = "exastencils_jax output",
) -> None:
    """Legacy-VTK structured-points file with one scalar array per field
    (reference IR_PrintVtk quad/hex mesh output)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    nd = grid.ndim
    shape = grid.shape_of(localization)
    origin = list(grid.domain.aabb.lower) + [0.0] * (3 - nd)
    spacing = [grid.grid_width(d) for d in range(nd)] + [1.0] * (3 - nd)
    dims = list(shape) + [1] * (3 - nd)

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(title + "\n")
        f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n")
        n = int(np.prod(dims))
        f.write(f"POINT_DATA {n}\n")
        for name, arr in fields.items():
            host = _host(arr)
            assert host.shape == tuple(shape), (host.shape, shape)
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            # VTK expects x fastest — our arrays are [x][y][z]
            flat = np.transpose(host, axes=tuple(reversed(range(nd)))).ravel()
            np.savetxt(f, flat[:, None], fmt="%.12g")


def print_xdmf(
    basename: str,
    fields: Dict[str, object],
    grid,
    localization: str = "Node",
    time: Optional[float] = None,
) -> None:
    """XDMF (XML + raw binary heavy data) for a uniform axis-aligned grid
    (reference xdmf/IR_PrintXdmf.scala, CoRectMesh topology)."""
    os.makedirs(os.path.dirname(os.path.abspath(basename)) or ".", exist_ok=True)
    nd = grid.ndim
    shape = grid.shape_of(localization)
    dims_zyx = " ".join(str(s) for s in reversed(shape))
    origin = " ".join(str(v) for v in reversed(grid.domain.aabb.lower))
    spacing = " ".join(str(grid.grid_width(d)) for d in reversed(range(nd)))
    topo = "2DCoRectMesh" if nd == 2 else "3DCoRectMesh"
    geom = "ORIGIN_DXDY" if nd == 2 else "ORIGIN_DXDYDZ"

    attrs = []
    for name, arr in fields.items():
        host = _host(arr).astype(np.float64)
        raw = f"{basename}_{name}.bin"
        host.tofile(raw)
        attrs.append(
            f"""      <Attribute Name="{name}" Center="{'Node' if localization == 'Node' else 'Cell'}">
        <DataItem Format="Binary" DataType="Float" Precision="8" Endian="Little"
                  Dimensions="{dims_zyx}">{os.path.basename(raw)}</DataItem>
      </Attribute>"""
        )
    time_el = f'      <Time Value="{time}"/>\n' if time is not None else ""
    xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="grid" GridType="Uniform">
{time_el}      <Topology TopologyType="{topo}" Dimensions="{dims_zyx}"/>
      <Geometry GeometryType="{geom}">
        <DataItem Format="XML" Dimensions="{nd}">{origin}</DataItem>
        <DataItem Format="XML" Dimensions="{nd}">{spacing}</DataItem>
      </Geometry>
{chr(10).join(attrs)}
    </Grid>
  </Domain>
</Xdmf>
"""
    with open(basename + ".xdmf", "w") as f:
        f.write(xml)
