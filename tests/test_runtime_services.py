"""Timers, field I/O, checkpoint, VTK/XDMF writers (reference §2.6
generated-runtime services)."""

import io
import os

import numpy as np
import pytest

import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.core.domain import unit_domain
from exastencils_jax.core.grid import NODE, level_grids
from exastencils_jax.runtime.fieldio import (
    CheckpointManager,
    print_field,
    read_field,
    write_field,
)
from exastencils_jax.runtime.timers import TimerRegistry
from exastencils_jax.runtime.vtk import print_vtk, print_xdmf


def test_timers_nested_and_stats(capsys):
    t = TimerRegistry()
    t.start("solve")
    t.start("solve")  # nested entry like the reference's recursive timers
    t.stop("solve")
    t.stop("solve")
    with t("cycle"):
        pass
    assert t.timers["solve"].num_measurements == 1
    assert t.timers["cycle"].total >= 0
    t.print_all()
    out = capsys.readouterr().out
    assert "Timer cycle" in out and "Timer solve" in out
    with pytest.raises(RuntimeError):
        t.stop("nope")


def test_write_read_field_roundtrip(tmp_path):
    arr = jnp.asarray(np.random.default_rng(0).normal(size=(9, 9)))
    for fmt in ("npy", "bin", "txt"):
        p = str(tmp_path / f"f.{fmt}")
        write_field(p, arr, fmt=fmt)
        back = read_field(p, like=arr, fmt=fmt)
        np.testing.assert_allclose(np.asarray(back), np.asarray(arr), rtol=1e-12)


def test_print_field(tmp_path):
    arr = jnp.arange(6.0).reshape(2, 3)
    buf = io.StringIO()
    print_field(buf, arr)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 6
    assert lines[0].split() == ["0", "0", "0.0"]


def test_checkpoint_roundtrip(tmp_path):
    state = {"sol": jnp.ones((5, 5)), "it": jnp.asarray(3)}
    cm = CheckpointManager(str(tmp_path / "ckpt"), use_orbax=False)
    cm.save(7, state)
    assert cm.latest_step() == 7
    restored = cm.restore(7, state)
    np.testing.assert_array_equal(np.asarray(restored["sol"]), np.ones((5, 5)))
    assert int(restored["it"]) == 3


def test_checkpoint_orbax_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    state = {"sol": jnp.ones((4, 4)), "rhs": jnp.zeros((4, 4))}
    cm = CheckpointManager(str(tmp_path / "ckpt"), use_orbax=True)
    cm.save(1, state)
    restored = cm.restore(1, state)
    np.testing.assert_array_equal(np.asarray(restored["sol"]), np.ones((4, 4)))


def test_vtk_and_xdmf_writers(tmp_path):
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=3).update()
    grids = level_grids(unit_domain(2), k)
    g = grids[3]
    field = jnp.ones(g.shape_of(NODE))
    vtk = str(tmp_path / "out.vtk")
    print_vtk(vtk, {"Solution": field}, g)
    text = open(vtk).read()
    assert "DATASET STRUCTURED_POINTS" in text
    assert f"DIMENSIONS {g.cells[0]+1} {g.cells[1]+1} 1" in text
    assert "SCALARS Solution double 1" in text

    base = str(tmp_path / "out")
    print_xdmf(base, {"Solution": field}, g, time=0.5)
    xml = open(base + ".xdmf").read()
    assert "2DCoRectMesh" in xml and "Solution" in xml
    assert os.path.exists(base + "_Solution.bin")


def test_automatic_category_timing():
    """timer_automaticTiming + sub-flags instrument communicate/apply-bc/
    IO occurrences with autoTime_<CATEGORY>[@level] timers (reference
    IR_AutomaticFunctionTiming; naming IR_RemoteSend.scala:96), printed
    by printAllTimers, without changing solver output."""
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = parse_l4(os.path.join(repo, "examples", "poisson_2d.exa4"))

    def run(**flags):
        k = Knowledge(dimensionality=2, minLevel=1, maxLevel=4, **flags).update()
        lines = []
        ex = L4Executable(prog, k, out=lines.append)
        ex.run()
        return lines, ex.timers

    base_lines, _ = run()
    lines, timers = run(
        timer_automaticCommTiming=True,
        timer_automaticBCsTiming=True,
        timer_automaticIOTiming=True,
    )
    assert lines == base_lines  # observation must not change results
    names = set(timers.timers)
    assert any(n.startswith("autoTime_COMM@") for n in names), names
    assert any(n.startswith("autoTime_APPLYBC@") for n in names), names
    comm = next(n for n in names if n.startswith("autoTime_COMM@"))
    assert timers.timers[comm].num_measurements > 0
    out = []
    timers.print_all(out.append)
    assert any("autoTime_COMM" in l for l in out)


def test_automatic_timing_constraint_chain():
    """Sub-flags force the master switch on (Knowledge.scala:1019-1021)."""
    k = Knowledge(timer_automaticCommTiming=True).update()
    assert k.timer_automaticTiming
