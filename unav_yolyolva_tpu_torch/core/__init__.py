from .config import DEFAULTS, load_config, load_config_dict
from .device import resolve_device

__all__ = ["DEFAULTS", "load_config", "load_config_dict", "resolve_device"]
