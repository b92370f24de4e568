"""Serde wire-format compatibility corpus.

Reference: src/v/compat/ — per-type random generators + a checked-in
corpus of serialized instances, verified on every build so a wire
format can never change silently. Here the corpus is generated from
each Envelope's SERDE_FIELDS via the SerdeType.spec descriptors,
serialized deterministically (seeded per type), and locked as hex in
tests/corpus/serde_corpus.json. The test fails when:

  - a corpus entry no longer decodes / re-encodes byte-identically
    (wire format changed — a protocol break for rolling upgrades), or
  - a new Envelope type has no corpus entry (coverage gap), or
  - a type's version/compat pair changed without regenerating.

Regenerate intentionally after a DELIBERATE format change:
    python -m redpanda_tpu.utils.compat tests/corpus/serde_corpus.json

This package keys every wire type by the JAX package's qualified name
(`WIRE_ROOT`, e.g. `redpanda_tpu.raft.types.VoteRequest` for this
package's `redpanda_tpu_torch.raft.types.VoteRequest`): the wire type is
the contract, so one corpus locks both packages, and the seeded
instances of a type are the same in both.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import pkgutil
import random
from typing import Any, Iterable

from . import serde

#: module -> exception string for modules that failed to import during
#: discovery. A failed import would silently shrink the corpus key
#: space (its wire types would never be locked) — the compat test
#: asserts this is empty.
discovery_failures: dict[str, str] = {}

#: this package's root, and the root the corpus keys name
PACKAGE = __name__.split(".")[0]
WIRE_ROOT = "redpanda_tpu"


def wire_name(module: str, qualname: str) -> str:
    """The corpus key of a wire type: its qualified name under
    WIRE_ROOT."""
    return f"{WIRE_ROOT}{module[len(PACKAGE):]}.{qualname}"


def _walk_package() -> None:
    pkg = importlib.import_module(PACKAGE)

    discovery_failures.clear()
    for mi in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        if ".ops" in mi.name or ".parallel" in mi.name:
            continue  # device modules: kernel wrappers, no wire types
        try:
            importlib.import_module(mi.name)
        except Exception as e:
            discovery_failures[mi.name] = f"{type(e).__name__}: {e}"


def _subclasses(cls: type) -> Iterable[type]:
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def all_envelope_types() -> dict[str, type]:
    """qualified-name -> Envelope subclass, for every wire type in the
    package (the corpus key space)."""
    _walk_package()
    out = {}
    for cls in _subclasses(serde.Envelope):
        if not cls.SERDE_FIELDS:
            continue
        # only the package's own wire types: tests and embedders may
        # define scratch envelopes that are not wire contracts
        if not cls.__module__.startswith(PACKAGE + "."):
            continue
        out[wire_name(cls.__module__, cls.__qualname__)] = cls
    return out


# ----------------------------------------------------------- generation
def gen_value(spec: Any, rng: random.Random, depth: int = 0) -> Any:
    kind = spec[0]
    if kind == "fixed":
        fmt = spec[1]
        letter = fmt[-1]
        if letter == "d":
            return round(rng.uniform(-1e6, 1e6), 3)
        bits = {"b": 8, "B": 8, "h": 16, "H": 16, "i": 32, "I": 32, "q": 64, "Q": 64}[
            letter
        ]
        signed = letter.islower()
        if signed:
            return rng.randrange(-(1 << (bits - 1)), 1 << (bits - 1))
        return rng.randrange(0, 1 << bits)
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "bytes":
        return rng.randbytes(rng.randrange(0, 24))
    if kind == "string":
        return "".join(
            rng.choice("abcdefghijklmnop-_.0123456789")
            for _ in range(rng.randrange(0, 16))
        )
    if kind == "optional":
        return None if rng.random() < 0.3 else gen_value(spec[1].spec, rng, depth)
    if kind == "vector":
        n = rng.randrange(0, 2 if depth > 2 else 4)
        return [gen_value(spec[1].spec, rng, depth + 1) for _ in range(n)]
    if kind == "mapping":
        n = rng.randrange(0, 2 if depth > 2 else 3)
        return {
            gen_value(spec[1].spec, rng, depth + 1): gen_value(
                spec[2].spec, rng, depth + 1
            )
            for _ in range(n)
        }
    if kind == "envelope":
        return gen_instance(spec[1], rng, depth + 1)
    raise ValueError(f"unknown spec {spec!r}")


def gen_instance(cls: type, rng: random.Random, depth: int = 0):
    kwargs = {}
    for name, t in cls.SERDE_FIELDS:
        if t.spec is None:
            raise ValueError(f"{cls.__name__}.{name}: SerdeType has no spec")
        kwargs[name] = gen_value(t.spec, rng, depth)
    return cls(**kwargs)


def _as_envelope(v: Any) -> Any:
    to_meta = getattr(v, "to_meta", None)
    return to_meta() if to_meta is not None else v


def render(value: Any) -> Any:
    """JSON-able rendering of a decoded value (reference: compat's
    per-type JSON writers). Byte-level re-encoding alone cannot catch
    a pure field REORDER of same-width types — decode+re-encode with a
    consistently wrong schema is byte-identical — so the corpus also
    locks the decoded field VALUES."""
    if isinstance(value, serde.Envelope):
        return {
            "__type__": type(value).__name__,
            **{n: render(getattr(value, n)) for n, _ in value.SERDE_FIELDS},
        }
    if isinstance(value, bytes):
        return {"__bytes__": value.hex()}
    if isinstance(value, dict):
        return {
            "__map__": [[render(k), render(v)] for k, v in value.items()]
        }
    if isinstance(value, (list, tuple)):
        return [render(v) for v in value]
    from collections.abc import Sequence

    if isinstance(value, Sequence) and not isinstance(value, (str, bytes)):
        # columnar stores (cloud.cstore) render like the lists they
        # replace; views render as their envelope form
        return [render(_as_envelope(v)) for v in value]
    if hasattr(value, "__array__"):  # numpy: ndvector fields / scalars
        import numpy as np

        if np.ndim(value) == 0:
            return render(value.item())
        return [render(v.item()) for v in value]
    if isinstance(value, float):
        return round(value, 6)
    return value


def _seed_for(qualname: str) -> int:
    return int.from_bytes(hashlib.sha256(qualname.encode()).digest()[:8], "big")


def corpus_cases(
    qualname: str, cls: type, n: int = 3
) -> tuple[list[str], list[Any]]:
    rng = random.Random(_seed_for(qualname))
    objs = [gen_instance(cls, rng) for _ in range(n)]
    return [o.encode().hex() for o in objs], [render(o) for o in objs]


def generate_corpus() -> dict:
    types = all_envelope_types()
    out = {}
    for q, cls in sorted(types.items()):
        cases, values = corpus_cases(q, cls)
        out[q] = {
            "version": cls.SERDE_VERSION,
            "compat": cls.SERDE_COMPAT_VERSION,
            "cases": cases,
            "values": values,
        }
    return out


def main(path: str) -> None:  # pragma: no cover
    corpus = generate_corpus()
    with open(path, "w") as f:
        json.dump(corpus, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(corpus)} types -> {path}")


if __name__ == "__main__":  # pragma: no cover
    import sys

    main(sys.argv[1])
