from .config import CfgNode, reroute_config_path
from .defaults import get_default_cfg

__all__ = ["CfgNode", "reroute_config_path", "get_default_cfg"]
