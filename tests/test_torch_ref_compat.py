"""tests/test_compat.py run on the port: all 7 test functions, with
imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu". The
port's `utils.compat` walks `redpanda_tpu_torch` and keys each wire type
by the reference's qualified name, so this file reads the same
checked-in corpus and its four stale-corpus cases fail exactly as the
reference's do (32 wire types were added since the corpus was written).
Nothing is left out.


Wire-format compatibility corpus (reference: src/v/compat/run.cc).

Locks every serde Envelope's on-wire encoding against the checked-in
corpus. A failure here means a ROLLING-UPGRADE BREAK: an already-
shipped peer (or an already-written controller log / kvstore entry)
encodes these exact bytes. Regenerate the corpus only for deliberate,
version-gated format changes:

    python -m redpanda_tpu.utils.compat tests/corpus/serde_corpus.json
"""

import json
import os
import random

import pytest

from redpanda_tpu_torch.utils import serde
from redpanda_tpu_torch.utils.compat import (
    all_envelope_types,
    corpus_cases,
    discovery_failures,
    gen_instance,
    render,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

CORPUS_PATH = os.path.join(os.path.dirname(__file__), "corpus", "serde_corpus.json")


def load_corpus():
    with open(CORPUS_PATH) as f:
        return json.load(f)


def test_every_wire_type_has_corpus_coverage():
    corpus = load_corpus()
    types = all_envelope_types()
    # a module that fails to import silently shrinks the key space —
    # its wire types would never be locked
    assert not discovery_failures, discovery_failures
    missing = sorted(set(types) - set(corpus))
    assert not missing, (
        f"wire types without corpus entries (regenerate the corpus): {missing}"
    )


def test_corpus_types_still_exist():
    corpus = load_corpus()
    types = all_envelope_types()
    gone = sorted(set(corpus) - set(types))
    assert not gone, (
        f"corpus types vanished — renaming/deleting a wire type breaks "
        f"peers that still send it: {gone}"
    )


def test_corpus_versions_unchanged():
    corpus = load_corpus()
    types = all_envelope_types()
    for q, entry in corpus.items():
        cls = types[q]
        assert (cls.SERDE_VERSION, cls.SERDE_COMPAT_VERSION) == (
            entry["version"],
            entry["compat"],
        ), f"{q}: serde version changed without corpus regeneration"


def test_corpus_bytes_decode_and_reencode_identically():
    corpus = load_corpus()
    types = all_envelope_types()
    for q, entry in corpus.items():
        cls = types[q]
        assert len(entry["cases"]) == len(entry["values"]) == 3, q
        for case_hex, want_values in zip(
            entry["cases"], entry["values"], strict=True
        ):
            blob = bytes.fromhex(case_hex)
            obj = cls.decode(blob)
            assert obj.encode() == blob, (
                f"{q}: re-encode differs from corpus — wire format changed"
            )
            # semantic lock: a pure field reorder of same-width types
            # re-encodes byte-identically, so values must match too
            assert render(obj) == want_values, (
                f"{q}: decoded values differ from corpus — field "
                f"meaning/order changed"
            )


def test_generator_is_deterministic():
    """The corpus can always be reproduced bit-for-bit from source —
    a regeneration diff shows EXACTLY which types changed."""
    corpus = load_corpus()
    types = all_envelope_types()
    for q in list(corpus)[::7]:  # sample
        cases, values = corpus_cases(q, types[q])
        assert cases == corpus[q]["cases"], q
        assert values == corpus[q]["values"], q


def test_forward_compat_skip_extra_fields():
    """A NEWER peer appending fields inside the envelope body must be
    readable by this build (payload-size-bounded skip)."""
    rng = random.Random(99)
    types = all_envelope_types()
    for q in sorted(types)[::5]:  # sample across the space
        cls = types[q]
        obj = gen_instance(cls, rng)
        blob = bytearray(obj.encode())
        extra = b"\xde\xad\xbe\xef"
        # splice extra bytes into the body and bump the declared size
        size = int.from_bytes(blob[2:6], "little")
        blob[2:6] = (size + len(extra)).to_bytes(4, "little")
        blob += extra
        obj2 = cls.decode(bytes(blob))
        assert obj2 == obj, q


def test_compat_reject_future_compat_version():
    from redpanda_tpu_torch.cluster.commands import DeleteTopicCmd

    blob = bytearray(DeleteTopicCmd(ns="kafka", topic="t").encode())
    blob[1] = 200  # compat_version far beyond this build
    with pytest.raises(serde.SerdeError):
        DeleteTopicCmd.decode(bytes(blob))
