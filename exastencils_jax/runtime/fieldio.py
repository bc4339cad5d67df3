"""Field I/O: readField / writeField / printField + checkpointing.

Reference: the unified IR_DataBuffer/IR_FileAccess abstraction over raw
iostreams, file-per-process, MPI-IO, HDF5, PnetCDF and SIONlib backends
(io/ir/IR_FileAccess.scala:38, IR_FileAccess_*.scala), surfaced as the
DSL builtins readField/writeField/printField (field/ir/IR_FieldIO.scala)
— which is also the reference's checkpoint/restart path (SURVEY.md §5).

Here a sharded array saves either as a single .npy (gathered) or
through orbax-checkpoint for async, per-shard checkpoints; text formats
match the reference's printField layout for diffability."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import jax


def _to_host(arr) -> np.ndarray:
    return np.asarray(jax.device_get(arr))


# --- writeField / readField (binary; reference IR_WriteField/IR_ReadField) ---


def write_field(path: str, arr, fmt: str = "npy") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = _to_host(arr)
    if fmt == "npy":
        np.save(path, host)
    elif fmt == "bin":  # raw binary like the reference's iostream backend
        host.tofile(path)
    elif fmt == "txt":
        np.savetxt(path, host.reshape(host.shape[0], -1))
    else:
        raise ValueError(f"unknown field format {fmt!r}")


def read_field(path: str, like=None, fmt: str = "npy", dtype=None, shape=None):
    import jax.numpy as jnp

    if fmt == "npy":
        host = np.load(path if path.endswith(".npy") else path + ".npy")
    elif fmt == "bin":
        host = np.fromfile(path, dtype=np.dtype(dtype or (like.dtype if like is not None else np.float64)))
        if shape is not None or like is not None:
            host = host.reshape(shape or like.shape)
    elif fmt == "txt":
        host = np.loadtxt(path)
        if shape is not None or like is not None:
            host = host.reshape(shape or like.shape)
    else:
        raise ValueError(f"unknown field format {fmt!r}")
    out = jnp.asarray(host, dtype=like.dtype if like is not None else None)
    if like is not None and hasattr(like, "sharding"):
        out = jax.device_put(out, like.sharding)
    return out


# --- per-backend IO (reference io/ir/IR_FileAccess_* family; the DSL
# surfaces them as writeField_lock/_fpp/_hdf5/_mpiio/_nc/_sion etc.,
# Testing/IOTest/*_CheckEquality_ReadAfterWrite.exa4).  All backends
# write the canonical (true-extent) field data: ghost layers are virtual
# on this runtime, so the useGhost/canonicalLayout toggles of the
# generated C++ collapse to the canonical layout. ---


def write_field_lock(path: str, arr, binary: bool = False, sep: str = ",") -> None:
    """Single shared file, iostream-style ('locking' backend,
    IR_FileAccess_Locking)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = _to_host(arr)
    if binary:
        host.tofile(path)
    else:
        np.savetxt(path, host.reshape(-1, host.shape[-1] if host.ndim > 1 else 1),
                   delimiter=sep)


def print_field_lock(path: str, arr, coords=None, binary: bool = False,
                     sep: str = ",") -> None:
    """Visualization form of the locking backend: ascii rows carry the
    grid POSITIONS followed by the value(s) (the reference's printField
    emits positions so non-uniform grids visualize correctly,
    io/ir + Examples/IO/2D_PrintField_NonUniform_AA); binary output
    stays raw values like writeField."""
    if binary or coords is None:
        return write_field_lock(path, arr, binary=binary, sep=sep)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = _to_host(arr)
    nd = len(coords)
    gshape = host.shape[:nd]
    cols = [np.broadcast_to(np.asarray(c), gshape).reshape(-1)
            for c in coords]
    vals = host.reshape(int(np.prod(gshape)), -1)
    np.savetxt(path, np.column_stack(cols + [vals]), delimiter=sep)


def read_field_lock(path: str, like, binary: bool = False, sep: str = ","):
    import jax.numpy as jnp

    if binary:
        host = np.fromfile(path, dtype=np.asarray(like).dtype)
    else:
        host = np.loadtxt(path, delimiter=sep)
    return jnp.asarray(host.reshape(np.asarray(like).shape), like.dtype)


def write_field_fpp(path: str, arr, binary: bool = True) -> None:
    """File-per-process backend (IR_FileAccess_FPP): `$blockId` in the
    path names each block's file — one block on this runtime."""
    write_field_lock(path.replace("$blockId", "0"), arr, binary=binary)


def read_field_fpp(path: str, like, binary: bool = True):
    return read_field_lock(path.replace("$blockId", "0"), like, binary=binary)


def write_field_hdf5(path: str, dataset: str, arr) -> None:
    """HDF5 backend (IR_FileAccess_HDF5 / IR_Hdf5_API): dataset at an
    absolute in-file path, groups created as needed."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with h5py.File(path, "a") as f:
        if dataset in f:
            del f[dataset]
        f.create_dataset(dataset, data=_to_host(arr))


def read_field_hdf5(path: str, dataset: str, like):
    import h5py
    import jax.numpy as jnp

    with h5py.File(path, "r") as f:
        host = f[dataset][...]
    return jnp.asarray(host.reshape(np.asarray(like).shape), like.dtype)


def write_field_mpiio(path: str, arr) -> None:
    """MPI-IO backend (IR_FileAccess_MPIIO): a raw shared binary file in
    canonical order — identical bytes to what a one-rank MPI run emits."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    _to_host(arr).tofile(path)


def read_field_mpiio(path: str, like):
    import jax.numpy as jnp

    host = np.fromfile(path, dtype=np.asarray(like).dtype)
    return jnp.asarray(host.reshape(np.asarray(like).shape), like.dtype)


def write_field_nc(path: str, varname: str, arr) -> None:
    """NetCDF backend (IR_FileAccess_PnetCDF): classic NetCDF-3 files via
    scipy.io — the same on-disk format family PnetCDF produces."""
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = _to_host(arr)
    with netcdf_file(path, "w") as f:
        dims = []
        for i, n in enumerate(host.shape):
            dname = f"{varname}_d{i}"
            f.createDimension(dname, n)
            dims.append(dname)
        v = f.createVariable(varname, host.dtype, tuple(dims))
        v[...] = host


def read_field_nc(path: str, varname: str, like):
    from scipy.io import netcdf_file
    import jax.numpy as jnp

    with netcdf_file(path, "r") as f:
        host = f.variables[varname][...].copy()
    return jnp.asarray(host.reshape(np.asarray(like).shape), like.dtype)


def write_field_sion(path: str, arr) -> None:
    """SIONlib-backend stand-in (IR_FileAccess_SIONlib): libsion is not
    available here, so a minimal self-describing single-file container
    (shape header + raw chunk) provides the same task-local-IO surface.
    Files are NOT binary-compatible with real SIONlib archives."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = _to_host(arr)
    with open(path, "wb") as f:
        header = json.dumps(
            {"shape": list(host.shape), "dtype": host.dtype.name}
        ).encode()
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(host.tobytes())


def read_field_sion(path: str, like):
    import jax.numpy as jnp

    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        host = np.frombuffer(
            f.read(), dtype=np.dtype(meta["dtype"])
        ).reshape(meta["shape"])
    return jnp.asarray(host, like.dtype)


# --- printField (text; reference IR_PrintField emits index + value rows) ---


def print_field(path_or_out, arr, sep: str = " ") -> None:
    host = _to_host(arr)
    lines = []
    for idx in np.ndindex(*host.shape):
        lines.append(sep.join(str(i) for i in idx) + sep + repr(float(host[idx])))
    text = "\n".join(lines) + "\n"
    if isinstance(path_or_out, str):
        with open(path_or_out, "w") as f:
            f.write(text)
    else:
        path_or_out.write(text)


# --- checkpoint / restore (reference: writeField-based snapshots; here
#     orbax-style async checkpoint of the whole state pytree) ---


class CheckpointManager:
    """Snapshot/restore of solver state pytrees.

    Uses orbax-checkpoint when available (async, sharding-aware —
    the analog of the reference's MPI-IO/HDF5 parallel snapshots),
    with a plain .npz fallback."""

    def __init__(self, directory: str, use_orbax: Optional[bool] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if use_orbax is None:
            try:
                import orbax.checkpoint  # noqa: F401

                use_orbax = True
            except Exception:
                use_orbax = False
        self.use_orbax = use_orbax
        if use_orbax:
            import orbax.checkpoint as ocp

            self._ckpt = ocp.StandardCheckpointer()
        else:
            self._ckpt = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state) -> None:
        if self.use_orbax:
            self._ckpt.save(self._step_dir(step), state, force=True)
            self._ckpt.wait_until_finished()
        else:
            flat, treedef = jax.tree_util.tree_flatten(state)
            np.savez(
                self._step_dir(step) + ".npz",
                treedef=json.dumps(str(treedef)),
                **{f"leaf_{i}": _to_host(leaf) for i, leaf in enumerate(flat)},
            )

    def restore(self, step: int, like):
        if self.use_orbax:
            return self._ckpt.restore(self._step_dir(step), like)
        import jax.numpy as jnp

        data = np.load(self._step_dir(step) + ".npz")
        flat, treedef = jax.tree_util.tree_flatten(like)
        restored = [
            jnp.asarray(data[f"leaf_{i}"], dtype=leaf.dtype) for i, leaf in enumerate(flat)
        ]
        return jax.tree_util.tree_unflatten(treedef, restored)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                steps.append(int(name[5:13]))
        return max(steps) if steps else None
