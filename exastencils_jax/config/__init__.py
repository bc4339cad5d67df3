from exastencils_jax.config.knowledge import Knowledge
from exastencils_jax.config.settings import Platform, Settings
from exastencils_jax.config.parser import parse_config_file, parse_config_text, parse_value

__all__ = [
    "Knowledge",
    "Settings",
    "Platform",
    "parse_config_file",
    "parse_config_text",
    "parse_value",
]
