"""GSSAPI/Kerberos principal mapping — auth_to_local rules.

Maps a Kerberos principal (``primary/host@REALM``) to a local SASL
principal through the same rule language Kafka and the reference use
(reference: src/v/security/gssapi_principal_mapper.{h,cc}; rule
semantics: RULE:[n:format](match)s/from/to/g?/L|U and DEFAULT).

This is pure string logic — no KDC needed — so it is fully testable
against fixed vectors (the reference pins the same vectors in
src/v/security/tests/gssapi_principal_mapper_test.cc; our tests mirror
them for behavioral parity).
"""

from __future__ import annotations

import re
from typing import Optional

__all__ = [
    "GssapiName",
    "GssapiRule",
    "GssapiPrincipalMapper",
    "parse_rules",
]

# principal = primary[/host]@realm  (gssapi_principal_mapper.cc:32)
_NAME_RE = re.compile(r"([^/@]*)(/([^/@]*))?@([^/@]*)")
# a "simple" (local) name must not contain / or @
_NON_SIMPLE_RE = re.compile(r"[/@]")
# the full rule grammar (gssapi_principal_mapper.cc:36). FULLMATCH only:
# trailing garbage ("RULE:[1:$1]/l", ".../L/g") must reject.
_RULE_RE = re.compile(
    r"(?:(DEFAULT)|"
    r"RULE:\[(\d*):([^\]]*)\]"  # [n:format]
    r"(?:\(([^)]*)\))?"  # (match)
    r"(?:s/([^/]*)/([^/]*)/(g)?)?"  # s/from/to/g?
    r"/?"
    r"(L|U)?)"
)


class GssapiName:
    """Parsed Kerberos principal (gssapi_name, mapper.cc:118-158)."""

    __slots__ = ("primary", "host_name", "realm")

    def __init__(self, primary: str, host_name: str, realm: str):
        if not primary:
            raise ValueError("primary must be provided")
        self.primary = primary
        self.host_name = host_name
        self.realm = realm

    @classmethod
    def parse(cls, principal_name: str) -> Optional["GssapiName"]:
        m = _NAME_RE.fullmatch(principal_name)
        if m is not None:
            primary, host, realm = m.group(1), m.group(3) or "", m.group(4)
            if not primary:
                return None
            return cls(primary, host, realm)
        if "@" in principal_name:
            return None  # malformed: multiple @ or /
        if not principal_name:
            return None
        return cls(principal_name, "", "")

    def __str__(self) -> str:
        s = self.primary
        if self.host_name:
            s += "/" + self.host_name
        if self.realm:
            s += "@" + self.realm
        return s

    def __repr__(self) -> str:  # pragma: no cover
        return f"GssapiName({self!s})"


def _replace_parameters(fmt: str, params: list[str]) -> Optional[str]:
    """Expand $0/$1/$2 (realm/primary/host) in a rule's format string
    (mapper.cc replace_parameters). Returns None on a bad index."""
    out: list[str] = []
    i, n = 0, len(fmt)
    while i < n:
        ch = fmt[i]
        if ch != "$":
            out.append(ch)
            i += 1
            continue
        j = i + 1
        while j < n and fmt[j].isdigit():
            j += 1
        if j == i + 1:
            return None  # "$" with no digits: bad format
        index = int(fmt[i + 1 : j])
        if index >= len(params):
            return None  # index outside the parameter range
        out.append(params[index])
        i = j
    return "".join(out)


def _make_replacer(to: str):
    """Build a re.sub replacement *function* implementing ECMAScript
    GetSubstitution semantics for the to-pattern (std::regex_replace's
    format language): ``$$`` → ``$``, ``$N`` (N>=1) → group N (empty if
    unmatched), ``$0`` → literal ``$0`` (not special in ECMA), anything
    else literal. A function, not a template — Python's template
    language treats backslashes specially and maps ``\0`` to NUL."""

    def rep(m: "re.Match") -> str:
        out: list[str] = []
        i, n = 0, len(to)
        while i < n:
            c = to[i]
            if c == "$" and i + 1 < n:
                if to[i + 1] == "$":
                    out.append("$")
                    i += 2
                    continue
                j = i + 1
                while j < n and to[j].isdigit():
                    j += 1
                if j > i + 1:
                    idx = int(to[i + 1 : j])
                    if idx == 0:
                        out.append("$0")
                    else:
                        try:
                            out.append(m.group(idx) or "")
                        except IndexError:
                            pass  # ECMA: nonexistent group → empty
                    i = j
                    continue
            out.append(c)
            i += 1
        return "".join(out)

    return rep


class GssapiRule:
    """One auth_to_local rule (gssapi_rule, mapper.cc:168-305)."""

    __slots__ = (
        "is_default",
        "number_of_components",
        "format",
        "match",
        "from_pattern",
        "to_pattern",
        "repeat",
        "case_change",  # "" | "L" | "U"
    )

    def __init__(
        self,
        number_of_components: int = 0,
        format: str = "",
        match: str = "",
        from_pattern: str = "",
        to_pattern: str = "",
        repeat: bool = False,
        case_change: str = "",
        is_default: bool = True,
    ):
        self.is_default = is_default
        self.number_of_components = number_of_components
        self.format = format
        self.match = match
        self.from_pattern = from_pattern
        self.to_pattern = to_pattern
        self.repeat = repeat
        self.case_change = case_change

    def apply(
        self, default_realm: str, params: list[str]
    ) -> Optional[str]:
        """params = [realm, primary(, host)] — $0/$1/$2."""
        result = ""
        if self.is_default:
            if len(params) >= 2 and default_realm == params[0]:
                result = params[1]
        elif params and len(params) - 1 == self.number_of_components:
            base = _replace_parameters(self.format, params)
            if base is None:
                return None
            try:
                matches = self.match == "" or re.fullmatch(
                    self.match, base
                ) is not None
            except re.error:
                return None
            if matches:
                if not self.from_pattern:
                    result = base
                else:
                    try:
                        result = re.sub(
                            self.from_pattern,
                            _make_replacer(self.to_pattern),
                            base,
                            count=0 if self.repeat else 1,
                        )
                    except re.error:
                        return None
        if result and _NON_SIMPLE_RE.search(result):
            return None  # non-simple name after rewrite: reject
        if result:
            if self.case_change == "L":
                result = result.lower()
            elif self.case_change == "U":
                result = result.upper()
        return result or None

    def __repr__(self) -> str:  # pragma: no cover
        if self.is_default:
            return "GssapiRule(DEFAULT)"
        return (
            f"GssapiRule([{self.number_of_components}:{self.format}]"
            f"({self.match})s/{self.from_pattern}/{self.to_pattern}/"
            f"{'g' if self.repeat else ''}{self.case_change})"
        )


def parse_rules(unparsed_rules: list[str]) -> list[GssapiRule]:
    """Parse the rule list; an empty list means [DEFAULT]
    (mapper.cc parse_rules). Raises ValueError on any invalid rule."""
    if not unparsed_rules:
        return [GssapiRule()]
    out: list[GssapiRule] = []
    for rule in unparsed_rules:
        m = _RULE_RE.fullmatch(rule)
        if m is None:
            raise ValueError(f"GSSAPI: Invalid rule: {rule}")
        default, ncomp, fmt, match, frm, to, rep, case = m.groups()
        if default:
            out.append(GssapiRule())
            continue
        if not ncomp:
            raise ValueError(
                f"Invalid rule - Invalid value for number of components: "
                f"{rule}"
            )
        out.append(
            GssapiRule(
                number_of_components=int(ncomp),
                format=fmt,
                match=match or "",
                from_pattern=frm or "",
                to_pattern=to or "",
                repeat=rep == "g",
                case_change=case or "",
                is_default=False,
            )
        )
    return out


class GssapiPrincipalMapper:
    """Applies the first matching rule (gssapi_principal_mapper)."""

    def __init__(self, rules: list[str]):
        self._rules = parse_rules(rules)

    @property
    def rules(self) -> list[GssapiRule]:
        return self._rules

    def apply(
        self, default_realm: str, name: GssapiName
    ) -> Optional[str]:
        if not name.host_name:
            if not name.realm:
                return name.primary
            params = [name.realm, name.primary]
        else:
            params = [name.realm, name.primary, name.host_name]
        for rule in self._rules:
            result = rule.apply(default_realm, params)
            if result is not None:
                return result
        return None

    def apply_principal(
        self, default_realm: str, principal: str
    ) -> Optional[str]:
        name = GssapiName.parse(principal)
        if name is None:
            return None
        return self.apply(default_realm, name)
