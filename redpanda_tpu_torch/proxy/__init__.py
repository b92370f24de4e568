"""HTTP ecosystem services: REST proxy + schema registry.

Reference: src/v/pandaproxy/ (rest/ and schema_registry/) — both are
HTTP facades over the Kafka surface, sharing the broker's HTTP base.
"""

from .rest import PandaproxyServer
from .schema_registry import SchemaRegistryServer

__all__ = ["PandaproxyServer", "SchemaRegistryServer"]
