"""IOTest suite (VERDICT r3 item 5): the reference's read-after-write
equality programs run from their own .exa4/.knowledge over every IO
backend the DSL surfaces — locking text, file-per-process binary, HDF5
(h5py), MPI-IO-style shared binary, NetCDF (scipy classic files, the
PnetCDF on-disk family), and a documented SIONlib stand-in container
(runtime/fieldio backend functions; reference io/ir/IR_FileAccess_*).

The programs self-check: any mismatch exits with a nonzero code before
printing its backend's 'Passed ... test' line."""

import os

import pytest

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4

CASES = [
    "2D_Scalar_CheckEquality_ReadAfterWrite",
    "2D_Vector_CheckEquality_ReadAfterWrite",
    "3D_Scalar_CheckEquality_ReadAfterWrite",
    "3D_Vector_CheckEquality_ReadAfterWrite",
    "3D_Matrix_CheckEquality_ReadAfterWrite",
]

PASS_LINES = {
    "Passed lock test", "Passed fpp test", "Passed hdf5 test",
    "Passed MPI I/O test", "Passed nc test", "Passed sion test",
}


@pytest.mark.parametrize("name", CASES)
def test_read_after_write_equality(name, reference_root, tmp_path, monkeypatch):
    base = os.path.join(reference_root, "Testing", "IOTest", name)
    k = Knowledge()
    parse_config_file(base + ".knowledge", k)
    k.update()
    prog = parse_l4(base + ".exa4")
    monkeypatch.chdir(tmp_path)  # programs write into ./data/
    lines = []
    rc = L4Executable(prog, k, out=lines.append).run("Application")
    assert rc is None or rc == 0, f"program exited with {rc}: {lines[-5:]}"
    passed = {l for l in lines if l in PASS_LINES}
    assert len(passed) >= 6, f"backends passed: {sorted(passed)}\n{lines}"
