"""File paths / output configuration ("Settings").

Mirrors the reference's Settings singleton (config/Settings.scala:25) in
name-compatible form so reference `.settings` files load unchanged.  Most
entries are metadata here (no C++ project is emitted); the ones that
matter are the DSL input files and output/debug paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class Settings:
    user: str = "guest"
    basePathPrefix: str = "."

    # DSL inputs (reference config/Settings.scala l1file..l4file)
    l1file: str = ""
    l2file: str = ""
    l3file: str = ""
    l4file: str = ""

    # debug prettyprint dumps per layer (reference config/Settings.scala:48-73)
    debugL1File: str = ""
    debugL2File: str = ""
    debugL3File: str = ""
    debugL4File: str = ""

    outputPath: str = "generated"
    htmlLogFile: str = ""
    produceHtmlLog: bool = False
    timeStrategies: bool = False

    buildfileGenerators: list = field(default_factory=list)

    _unused: dict = field(default_factory=dict, repr=False)

    def set(self, key: str, value):
        if hasattr(self, key) and not key.startswith("_"):
            setattr(self, key, value)
        else:
            self._unused[key] = value

    def copy(self) -> "Settings":
        return dataclasses.replace(
            self, buildfileGenerators=list(self.buildfileGenerators), _unused=dict(self._unused)
        )


@dataclass
class Platform:
    """Hardware description (reference config/Platform.scala:24-218).

    Accepted so reference `.platform` files load; the reference's
    compiler, SIMD and OpenMP knobs have no effect here.  Device facts
    (bandwidth, peaks) live in one table keyed by the device JAX reports,
    exastencils_jax.runtime.performance.DEVICE_SPECS.
    """

    targetHardware: str = "GPU"
    targetName: str = ""

    _unused: dict = dataclasses.field(default_factory=dict, repr=False)

    def set(self, key: str, value):
        if hasattr(self, key) and not key.startswith("_"):
            setattr(self, key, value)
        else:
            self._unused[key] = value

    def copy(self) -> "Platform":
        return dataclasses.replace(self, _unused=dict(self._unused))
