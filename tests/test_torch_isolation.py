"""The port stands alone and never falls back to the CPU quietly.

* redpanda_tpu_torch and chip_smoke.py import neither jax nor anything
  of redpanda_tpu: checked in a fresh interpreter (this process has
  jax loaded by tests/conftest.py) and by an AST scan of the sources.
* Without a CUDA device, the default device path raises instead of
  running the plain versions on the CPU, and chip_smoke.py exits
  non-zero without printing a result.
* Seams whose device programs are not ported yet raise.
"""

import ast
import json
import os
import pathlib
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import redpanda_tpu_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "redpanda_tpu_torch"


def _modules():
    names = [redpanda_tpu_torch.__name__]
    for info in pkgutil.walk_packages(redpanda_tpu_torch.__path__, "redpanda_tpu_torch."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "redpanda_tpu")


def test_every_module_imports_without_jax_or_reference():
    names = _modules()
    assert len(names) > 20
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for n in {names!r} + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'redpanda_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd="/"
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_nothing_forbidden():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad = [a.name for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                bad = [node.module] if _forbidden(node.module or "") else []
            else:
                continue
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-fallback checks need a machine without one")


def test_default_device_tick_raises_without_cuda(monkeypatch):
    _require_no_cuda()
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    monkeypatch.delenv("RP_QUORUM_BACKEND", raising=False)
    arrays = ShardGroupArrays(capacity=64)
    assert arrays._backend() == "device"
    empty = np.empty(0, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        arrays.device_tick(empty, empty, empty, empty, empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        arrays.health_refresh()


def test_default_crc_device_raises_without_cuda(monkeypatch):
    _require_no_cuda()
    from redpanda_tpu_torch.models.record import RecordBatchBuilder, batch_crcs
    from redpanda_tpu_torch.ops.crc32c import crc32c_batch_device

    with pytest.raises(RuntimeError, match="CUDA"):
        crc32c_batch_device(np.zeros((2, 16), np.uint8), np.array([3, 4]))
    batch = RecordBatchBuilder(timestamp_ms=0).add(b"v").build()
    monkeypatch.delenv("RP_CRC_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_crcs([batch])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    _require_no_cuda()
    run = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_unported_seams_raise(monkeypatch):
    from redpanda_tpu_torch import compression
    from redpanda_tpu_torch.compression import CompressionType
    from redpanda_tpu_torch.models.record import RecordBatchBuilder
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    arrays = ShardGroupArrays(capacity=8, device="cpu")
    empty = np.empty(0, np.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        arrays.device_tick(empty, empty, empty, empty, empty)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        arrays.health_refresh()
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compression.compress(b"x" * 64, CompressionType.zstd)
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    batch = RecordBatchBuilder(timestamp_ms=0).add(b"v" * 100).build()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batch.recompressed(CompressionType.lz4)
