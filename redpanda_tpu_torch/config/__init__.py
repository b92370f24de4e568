"""Centralized cluster configuration.

Reference: src/v/config/property.h (typed properties with defaults,
validation, live bindings) and src/v/cluster/config_manager.{h,cc}
(values replicated through the controller log so every node converges).
"""

from .properties import ClusterConfig, ConfigError, Property

__all__ = ["ClusterConfig", "ConfigError", "Property"]
