"""run.py end to end: it refuses to run without a card or without the
program, it loads nothing of JAX or of the JAX package, and, past its
look for a card, a small run on the CPU comes out correct while each
fault planted underneath turns `correct` false. The same faults on the
card, at each cell's own size, are the card test at the end."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import cell

ROOT = cell.ROOT
BENCH_DIR = cell.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "redpanda_tpu"}
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RP_")}
    env.update(extra)
    return env


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def test_run_refuses_without_a_card():
    if _cuda():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120, env=_env())
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120, env=_env())
    assert p.returncode != 0 and p.stdout.strip() == ""


def _top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(BENCH_DIR) for f in fs if f.endswith(".py")]
    for path in sources:
        assert not _top_level_imports(path) & FORBIDDEN, path
    # the generator imports neither torch nor the program
    for path in [os.path.join(BENCH_DIR, "loadgen.py")] + [
            os.path.join(BENCH_DIR, "harness", f) for f in ("wire.py", "traffic.py", "lz4.py", "crc32c.py")]:
        assert not _top_level_imports(path) & {"torch", "redpanda_tpu_torch"}, path


def test_what_run_loads_holds_no_jax_module():
    """Every module run.py loads, the program's broker among them,
    compared by whole top-level name: `redpanda_tpu_torch` is the port
    and passes, `redpanda_tpu` would not."""
    code = (
        "import sys; sys.path.insert(0, 'benchmark'); import run; from harness import cell, cluster, faults\n"
        "run.setup_program(cell.load(sys.argv[1]), 'cpu'); cluster.port()\n"
        "import redpanda_tpu_torch.compression.tpu_backend, redpanda_tpu_torch.kafka.server\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'redpanda_tpu'}),"
        " 'redpanda_tpu_torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code, CELLS[0]], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=_env(USE_FLAX="0"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-2] == "[] True"


def _cpu_run(name: str, seed: int, *extra) -> dict:
    p = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "tests", "cpu_cell.py"), name, str(seed), *extra],
                       cwd=ROOT, capture_output=True, text=True, timeout=400, env=_env(JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().split("\n")
    line = json.loads(lines[-2])
    counted = json.loads(lines[-1].split(" ", 1)[1])
    assert counted["forbidden"] == [] and counted["acked_batches"] > 0
    return line


def _failing(line) -> set:
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


# on the CPU the card's seams run their plain versions (a fused 64 KiB
# row takes seconds), so only the faults' own seams are switched on, at
# 2 partitions and 2 batches a second
SEAMS = {"corrupt": ("env.RP_CODEC_BACKEND=device", "partitions=2", "batches_per_s=2"),
         "halve": ("env.RP_CODEC_BACKEND=device", "partitions=2", "batches_per_s=2")}


# producers that send LZ4 frames (nothing recompressed), a mix key set
# on a cell; the zstd topic's deployment under the cell's mix
LZ4_FRAMES, ZSTD_TOPIC = 'producer_codec="lz4"', "config=omb-100p-zstd-rf3"


@pytest.mark.parametrize("name,fault,seed,mix", [
    ("lz4-steady", None, 2**31 + 11, ()),
    ("lz4-steady", None, 2**33 + 5, (LZ4_FRAMES,)),
    ("lz4-steady", "rf1", 12, ()),
    ("lz4-steady", "corrupt-fetch", 13, (LZ4_FRAMES,)),
    ("lz4-steady", "corrupt", 14, ()),
    ("lz4-steady", "halve", 15, (ZSTD_TOPIC,)),
])
def test_small_cpu_run_sound_and_faulted(name, fault, seed, mix):
    extra = list(SEAMS.get(fault, ()))
    if ZSTD_TOPIC in mix:
        extra = ["env.RP_ZSTD_BACKEND=tpu", "partitions=2", "batches_per_s=2"]
    line = _cpu_run(name, seed, *([fault] if fault else []), *extra, *mix)
    if fault is None:
        assert line["correct"] is True and line["failed"] == 0, line["checks"]
        assert set(line["metrics"]) == {"produce_mb_s", "setup_s"}
    else:
        assert line["correct"] is False
        assert _failing(line), line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["rf1", "corrupt", "halve", "corrupt-fetch"])
def test_faults_on_the_card_at_the_cells_size(card, name, fault):
    """The control (rf1) and each fault the cell can have, on the card at
    the cell's own size, on three seeds: `correct` false every time."""
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(seed),
                            "--seconds", "5", "--trace", "0", "--fault", fault], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().split("\n")[-1])
        print(f"{name} {fault} seed {seed}: correct {line['correct']}, failing "
              f"{ {k: line['checks'][k]['value'] for k in sorted(_failing(line))} }")
        assert line["correct"] is False and _failing(line), line["checks"]
