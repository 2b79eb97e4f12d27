from .config import DEFAULTS, load_config, load_config_dict
from .device import make_batch_copier, resolve_device

__all__ = ["DEFAULTS", "load_config", "load_config_dict", "make_batch_copier",
           "resolve_device"]
