"""exa_native C++ library: build, bind, and verify against the pure
Python mirrors (layout algebra, partitioning, pack intervals, golden
compare).  Reference counterparts cited in native/exa_native.cpp."""

import os

import pytest

from exastencils_jax import native


@pytest.fixture(scope="module")
def lib():
    l = native.get_lib()
    if l is None:
        pytest.skip("g++ unavailable; pure-Python fallback covers API")
    return l


def test_layout_bounds(lib):
    c = native.layout_bounds_1d(1, 2, 1, 30, 1)
    p = native.layout_bounds_1d(1, 2, 1, 30, 1, force_py=True)
    assert c == p
    # [pad 1 | ghost 2 | dup 1 | inner 30 | dup 1 | ghost 2 | pad 1]
    assert c == (0, 1, 3, 4, 34, 35, 37, 38, 38)


def test_fragment_connectivity(lib):
    for fid in range(12):
        c = native.fragment_connectivity((4, 3), fid)
        p = native.fragment_connectivity((4, 3), fid, force_py=True)
        assert c == p
    pos, nb, iob, ioe = native.fragment_connectivity((4, 3), 5)
    assert pos == (1, 1)
    assert nb == (4, 6, 1, 9)
    assert iob == (0, 0) and ioe == (0, 0)
    pos, nb, iob, ioe = native.fragment_connectivity((4, 3), 0)
    assert nb == (-1, 1, -1, 4)
    assert iob == (1, 1) and ioe == (0, 0)


def test_rank_fragments(lib):
    # 2x2 blocks x 2x2 frags (the Testing/Poisson config)
    for rank in range(4):
        c = native.rank_fragments((2, 2), (2, 2), rank)
        p = native.rank_fragments((2, 2), (2, 2), rank, force_py=True)
        assert c == p
    assert native.rank_fragments((2, 2), (2, 2), 0) == [0, 1, 4, 5]
    assert native.rank_fragments((2, 2), (2, 2), 3) == [10, 11, 14, 15]


def test_pack_intervals(lib):
    bounds = [native.layout_bounds_1d(0, 1, 1, 14, 1)] * 2
    for kind in ("ghost", "dup"):
        for send in (True, False):
            for direction in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                c = native.pack_interval(bounds, direction, kind, send)
                p = native.pack_interval(bounds, direction, kind, send,
                                         force_py=True)
                assert c == p, (kind, send, direction)
    # ghost send towards -x reads the first interior-side layer
    beg, end = native.pack_interval(bounds, (-1, 0), "ghost", True)
    assert beg[0] == 1 and end[0] == 2
    # ghost recv from -x writes the ghost layer
    beg, end = native.pack_interval(bounds, (-1, 0), "ghost", False)
    assert beg[0] == 0 and end[0] == 1


def test_check_results(lib, tmp_path, reference_root):
    golden = os.path.join(reference_root,
                          "Testing/Poisson/2D_FD_Poisson_fromL2.results")
    assert native.check_results(golden, golden) == 0
    assert native.check_results(golden, golden, force_py=True) == 0
    # perturb one line beyond eps
    lines = open(golden).read().splitlines()
    lines[3] = "1.0"
    bad = tmp_path / "bad.results"
    bad.write_text("\n".join(lines) + "\n")
    assert native.check_results(str(bad), golden) == 4
    assert native.check_results(str(bad), golden, force_py=True) == 4
    # within-eps numeric difference passes
    lines = open(golden).read().splitlines()
    lines[0] = lines[0] + " "
    ok = tmp_path / "ok.results"
    ok.write_text("\n".join(lines) + "\n")
    assert native.check_results(str(ok), golden) == 0


def test_cli_check_mode(reference_root, capsys):
    """`python -m exastencils_jax ... --check golden.results` — the
    native differ's product role (reference Testing/run_test.py)."""
    import exastencils_jax.__main__ as cli

    base = os.path.join(reference_root, "Testing", "Poisson",
                        "2D_FD_Poisson_fromL4")
    rc = cli.main([base + ".settings", base + ".knowledge",
                   "--cpu", "--f64", "--check", base + ".results"])
    assert rc == 0
    assert "CHECK OK" in capsys.readouterr().out
    # a wrong golden must fail with a line number
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".results",
                                     delete=False) as f:
        f.write("9.999e+99\n")
        bad = f.name
    rc = cli.main([base + ".settings", base + ".knowledge",
                   "--cpu", "--f64", "--check", bad])
    assert rc == 1
    assert "CHECK FAILED" in capsys.readouterr().out
