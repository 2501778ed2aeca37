from .base import ArchConfig, reduced
from .registry_configs import ALL_ARCHS, get_config

__all__ = ["ArchConfig", "reduced", "ALL_ARCHS", "get_config"]
