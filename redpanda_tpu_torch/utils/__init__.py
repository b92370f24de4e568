"""Foundation utilities (reference: src/v/utils/, src/v/hashing/, src/v/bytes/)."""

from .crc import Crc32c, crc32, crc32c, crc32c_batch, crc32c_combine
from .iobuf import IOBuf, IOBufParser
from .named_type import NamedInt, named_int
from . import vint

__all__ = [
    "Crc32c",
    "crc32",
    "crc32c",
    "crc32c_batch",
    "crc32c_combine",
    "IOBuf",
    "IOBufParser",
    "NamedInt",
    "named_int",
    "vint",
]
