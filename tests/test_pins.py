"""Cross-platform residual pins (tests/pins.py): the small f64
API and DSL solves must print the lines kept in tests/goldens/pin_*.txt.
`chip_smoke.py` checks the same goldens on the GPU."""

import pytest

import pins


@pytest.mark.parametrize("name", sorted(pins.PINS))
def test_residual_pin_matches_golden(name):
    got = pins.PINS[name]()
    want = pins.read_golden(name)
    bad = pins.first_mismatch(got, want)
    assert bad is None, (
        f"line {bad}: got {got[bad:bad + 1]} want {want[bad:bad + 1]}")


def test_first_mismatch_uses_eps_on_numbers():
    assert pins.first_mismatch(["1.0", "x"], ["1.0000005", "x"]) is None
    assert pins.first_mismatch(["1.0", "x"], ["1.00001", "x"]) == 0
    assert pins.first_mismatch(["1.0"], ["1.0", "2.0"]) == 1
