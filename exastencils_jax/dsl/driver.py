"""Generation driver: settings/knowledge-file driven layer pipeline.

Reference counterpart: Compiler/src/Main.scala:34-135 (parse the three
config files, then ExaLayerHandler.handleAllLayers runs L1->L2->L3->L4->
IR).  Here the pipeline is: parse the deepest declared layer file,
progress L1->L2 (FD discretization), merge L2/L3/L4 files, expand
`generate solver`, and build an executable L4 program
(dsl/interpreter.L4Executable) instead of emitting C++.

Settings keys honored: l1file..l4file, basePathPrefix, configName with
`$configName$` substitution (parsers/config/Settings_Parser.scala).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_value, _strip_comment
from exastencils_jax.dsl import nodes as N
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.l2 import parse_l2_file
from exastencils_jax.dsl.l3 import L3Program, lower_l3, parse_l3_file
from exastencils_jax.dsl.parser import parse_l4

_VAR_RE = re.compile(r"\$(\w+)\$")


def load_settings(path: str) -> Dict[str, object]:
    """Parse a .settings file into a dict with $var$ substitution
    (reference parsers/config/Settings_Parser.scala:41)."""
    out: Dict[str, object] = {}
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw).strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            v = parse_value(val.strip())
            if isinstance(v, str):
                v = _VAR_RE.sub(lambda m: str(out.get(m.group(1), m.group(0))), v)
            out[key] = v
    return out


def _resolve_layer_path(settings_path: str, settings: Dict[str, object],
                        rel: str) -> str:
    base = os.path.dirname(os.path.abspath(settings_path))
    prefix = str(settings.get("basePathPrefix", ""))
    for cand in (
        os.path.join(base, prefix, rel),
        os.path.join(base, rel),
        os.path.join(base, "..", prefix, rel),
    ):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"layer file {rel!r} (from {settings_path})")


def build_program(
    settings_path: str,
    knowledge: Knowledge,
) -> N.Program:
    """Run the layer pipeline for a settings file; returns the final
    executable L4 program (ExaLayerHandler.handleAllLayers analog)."""
    settings = load_settings(settings_path)

    def layer(key: str) -> Optional[str]:
        rel = settings.get(key)
        return _resolve_layer_path(settings_path, settings, str(rel)) if rel else None

    l1p, l2p, l3p, l4p = (layer(k) for k in ("l1file", "l2file", "l3file", "l4file"))

    merged = L3Program()
    if l1p:
        from exastencils_jax.dsl.l1 import parse_l1_file, discretize_l1

        l1 = parse_l1_file(l1p)
        merged.merge(discretize_l1(l1, knowledge))
    if l2p:
        merged.merge(parse_l2_file(l2p))
    if l3p:
        merged.merge(parse_l3_file(l3p))

    user_l4 = parse_l4(l4p) if l4p else None

    # apply inline Knowledge blocks before lowering: level bounds affect
    # level-spec resolution (Main.scala:55 Knowledge.update ordering)
    for k, v in merged.inline_knowledge.items():
        knowledge.set(k, v)
    if user_l4 is not None:
        for k, v in user_l4.inline_knowledge.items():
            knowledge.set(k, v)
    knowledge.update()

    if not (l1p or l2p or l3p):
        return user_l4
    return lower_l3(merged, knowledge, user_l4=user_l4)


def run_config(
    settings_path: str,
    knowledge_path: Optional[str] = None,
    out=print,
    knowledge: Optional[Knowledge] = None,
    function: str = "Application",
) -> L4Executable:
    """generate_code + run_code in one (Utilities/run_exastencils.py:21-62):
    build the program for (settings, knowledge) and execute it."""
    k = knowledge or Knowledge()
    if knowledge_path:
        from exastencils_jax.config.parser import parse_config_file

        parse_config_file(knowledge_path, k)
    prog = build_program(settings_path, k)
    ex = L4Executable(prog, k, out=out)
    ex.run(function)
    return ex
