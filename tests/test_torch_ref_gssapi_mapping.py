"""tests/test_gssapi_mapping.py run on the port: all 12 test functions,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


GSSAPI principal-mapping vectors — behavioral parity with the
reference's gssapi_principal_mapper_test.cc (same rules, same inputs,
same expected outputs)."""

import pytest

from redpanda_tpu_torch.security.gssapi import (
    GssapiName,
    GssapiPrincipalMapper,
    parse_rules,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

# (principal, primary, host, realm, expected local name)
NAME_VECTORS = [
    (
        "App.service-name/example.com@REALM.com",
        "App.service-name",
        "example.com",
        "REALM.com",
        "service-name",
    ),
    (
        "App.service-name@REALM.com",
        "App.service-name",
        "",
        "REALM.com",
        "service-name",
    ),
    ("user/host@REALM.com", "user", "host", "REALM.com", "user"),
    (
        "redpanda/example.com@REALM.com",
        "redpanda",
        "example.com",
        "REALM.com",
        "redpandadataexample.com",
    ),
]

RULES = [
    r"RULE:[1:$1](App\..*)s/App\.(.*)/$1/g",
    r"RULE:[2:$1](App\..*)s/App\.(.*)/$1/g",
    r"RULE:[2:$1data$2](redpanda.*)",
    "DEFAULT",
]


@pytest.mark.parametrize(
    "principal,primary,host,realm,expected", NAME_VECTORS
)
def test_gssapi_name_mapping(principal, primary, host, realm, expected):
    mapper = GssapiPrincipalMapper(RULES)
    name = GssapiName.parse(principal)
    assert name is not None
    assert name.primary == primary
    assert name.host_name == host
    assert name.realm == realm
    assert str(name) == principal
    assert mapper.apply("REALM.com", name) == expected


LOWER_VECTORS = [
    ("User@REALM.com", "User", "", "REALM.com", "user"),
    ("TestABC/host@FOO.COM", "TestABC", "host", "FOO.COM", "test"),
    (
        "ABC_User_ABC/host@FOO.COM",
        "ABC_User_ABC",
        "host",
        "FOO.COM",
        "xyz_user_xyz",
    ),
    (
        "App.SERVICE-name/example.com@REALM.COM",
        "App.SERVICE-name",
        "example.com",
        "REALM.COM",
        "service-name",
    ),
    ("User/root@REALM.COM", "User", "root", "REALM.COM", "user"),
]

LOWER_RULES = [
    "RULE:[1:$1]/L",
    "RULE:[2:$1](Test.*)s/ABC///L",
    "RULE:[2:$1](ABC.*)s/ABC/XYZ/g/L",
    r"RULE:[2:$1](App\..*)s/App\.(.*)/$1/g/L",
    "RULE:[2:$1]/L",
    "DEFAULT",
]


@pytest.mark.parametrize("principal,primary,host,realm,expected", LOWER_VECTORS)
def test_gssapi_lower_case(principal, primary, host, realm, expected):
    mapper = GssapiPrincipalMapper(LOWER_RULES)
    name = GssapiName.parse(principal)
    assert name is not None
    assert (name.primary, name.host_name, name.realm) == (
        primary,
        host,
        realm,
    )
    assert mapper.apply("REALM.COM", name) == expected


UPPER_VECTORS = [
    ("User@REALM.com", "USER"),
    ("TestABC/host@FOO.COM", "TEST"),
    ("ABC_User_ABC/host@FOO.COM", "XYZ_USER_XYZ"),
    ("App.SERVICE-name/example.com@REALM.COM", "SERVICE-NAME"),
    ("User/root@REALM.COM", "USER"),
]

UPPER_RULES = [
    "RULE:[1:$1]/U",
    "RULE:[2:$1](Test.*)s/ABC///U",
    "RULE:[2:$1](ABC.*)s/ABC/XYZ/g/U",
    r"RULE:[2:$1](App\..*)s/App\.(.*)/$1/g/U",
    "RULE:[2:$1]/U",
    "DEFAULT",
]


@pytest.mark.parametrize("principal,expected", UPPER_VECTORS)
def test_gssapi_upper_case(principal, expected):
    mapper = GssapiPrincipalMapper(UPPER_RULES)
    assert mapper.apply_principal("REALM.COM", principal) == expected


INVALID_RULES = [
    "default",
    "DEFAUL",
    "DEFAULT/L",
    "DEFAULT/g",
    "rule:[1:$1]",
    "rule:[1:$1]/L/U",
    "rule:[1:$1]/U/L",
    "rule:[1:$1]/LU",
    "RULE:[1:$1/L",
    "RULE:[1:$1]/l",
    "RULE:[2:$1](ABC.*)s/ABC/XYZ/L/g",
]


@pytest.mark.parametrize("rule", INVALID_RULES)
def test_invalid_rules_rejected(rule):
    with pytest.raises(ValueError):
        parse_rules([rule])


def test_invalid_index_produces_no_mapping():
    mapper = GssapiPrincipalMapper(["RULE:[2:$3]"])
    name = GssapiName.parse("test/host@REALM.com")
    assert mapper.apply("REALM.com", name) is None


def test_only_primary_short_circuits():
    # a bare primary (no host, no realm) maps to itself without
    # consulting the rules (mapper.cc apply: early return)
    mapper = GssapiPrincipalMapper(
        ["RULE:[1:$1data](redpanda.*)", "RULE:[2:$3]"]
    )
    name = GssapiName.parse("redpanda")
    assert name is not None
    assert name.host_name == "" and name.realm == ""
    assert mapper.apply("REALM.com", name) == "redpanda"


def test_empty_rules_default_only():
    mapper = GssapiPrincipalMapper([])
    assert mapper.apply_principal("R.com", "alice@R.com") == "alice"
    # non-default realm with DEFAULT rule only: no mapping
    assert mapper.apply_principal("R.com", "alice@OTHER.com") is None


def test_malformed_names():
    assert GssapiName.parse("a@b@c") is None
    assert GssapiName.parse("@REALM.com") is None
    assert GssapiName.parse("") is None


def test_substitution_dollar_zero_is_literal():
    # ECMAScript GetSubstitution: $0 is NOT a backref — it stays
    # literal (and must never become a NUL via Python's \0 escape)
    mapper = GssapiPrincipalMapper(["RULE:[1:$1]s/user/$0x/"])
    out = mapper.apply_principal("R.com", "user@R.com")
    assert out == "$0x"
    assert "\x00" not in out


def test_substitution_double_dollar():
    mapper = GssapiPrincipalMapper(["RULE:[1:$1]s/user/a$$b/"])
    assert mapper.apply_principal("R.com", "user@R.com") == "a$b"


def test_substitution_missing_group_empty():
    # $9 with no such group in the from-pattern → empty (ECMA)
    mapper = GssapiPrincipalMapper(["RULE:[1:$1]s/(us)er/$1-$9x/"])
    assert mapper.apply_principal("R.com", "user@R.com") == "us-x"


def test_non_simple_result_rejected():
    # a rule whose output still contains /or@ must be rejected
    mapper = GssapiPrincipalMapper(["RULE:[2:$1/$2]"])
    assert mapper.apply_principal("R.com", "a/b@R.com") is None
