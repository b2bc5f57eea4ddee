from .node import ConfigNode, from_yaml_str, load_yaml_file
from .compose import Composer, compose, parse_overrides, setup_run_dir

__all__ = [
    "ConfigNode",
    "from_yaml_str",
    "load_yaml_file",
    "Composer",
    "compose",
    "parse_overrides",
    "setup_run_dir",
]
