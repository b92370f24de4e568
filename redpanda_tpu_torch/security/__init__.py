"""Security layer: SCRAM credentials, ACLs, authorization.

Reference: src/v/security/ — scram_algorithm.h, scram_credential.h,
acl.h, authorizer.h. Credentials and ACL bindings replicate through
controller raft0 (user_management_cmd / acl_management_cmd batches)
so every broker authenticates and authorizes locally.
"""

from .acl import (  # noqa: F401
    AclBinding,
    AclOperation,
    AclPatternType,
    AclPermission,
    AclResourceType,
    AclStore,
    Authorizer,
)
from .scram import (  # noqa: F401
    CredentialStore,
    ScramCredential,
    ScramServerExchange,
    make_credential,
)
