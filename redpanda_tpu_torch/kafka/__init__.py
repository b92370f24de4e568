"""Kafka protocol + server + client layer.

Reference: src/v/kafka/ — protocol codegen (schemata/generator.py),
server (net::server subclass + 39 handlers), and the internal client
used by pandaproxy/tests.
"""

from . import protocol  # noqa: F401
