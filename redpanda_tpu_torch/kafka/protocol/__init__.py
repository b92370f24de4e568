"""Kafka wire protocol (reference: src/v/kafka/protocol/)."""

from .apis import (  # noqa: F401
    ALL_APIS,
    API_BY_KEY,
    API_VERSIONS,
    CREATE_TOPICS,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    PRODUCE,
    register,
)
from .headers import (  # noqa: F401
    ErrorCode,
    RequestHeader,
    decode_request_header,
    encode_request_header,
    encode_response_header,
)
from .schema import Api, Array, F, Msg  # noqa: F401
from .wire import Reader, Writer, WireError  # noqa: F401
from . import tx_apis  # noqa: F401  (registers APIs 24-26, 28)
from . import admin_apis  # noqa: F401  (registers 17,23,29-33,36,37,44)
