"""Run one cell of the port's benchmark once, on the card this machine
holds, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell's configuration, traffic mix and metrics are files found by
the names in BENCHMARK.json (harness/cell.py). This process runs the
brokers (`redpanda_tpu_torch.app.Broker`, `BrokerConfig(device="cuda")`,
data under TMPDIR); loadgen.py runs the producers and consumers in a
process of its own. Set-up is everything up to the window: imports,
the kernels' build check, the brokers, the topic and its leaders, the
generator's batches and its warm-up. With `--trace 1` the window runs
under `torch.profiler` and the line carries the per-layer metrics, the
device's busy seconds and a breakdown; with `--trace 0`, the
end-to-end metrics. The reference check (harness/check.py) runs once
the window has closed and the brokers have stopped.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)

from harness import cell as cells  # noqa: E402
from harness import check, stats, trace, traffic, wire  # noqa: E402

# modules that may not be loaded in this process: the JAX package and
# JAX itself, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "redpanda_tpu")
# the program's kernel caches live at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None, help="plant a fault (the benchmark's own tests; see harness/faults.py)")
    return ap.parse_args(argv)


def require_card(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the port on the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, this machine has {torch.cuda.device_count()}")


async def expect(proc, word: str, timeout: float) -> None:
    line = await asyncio.wait_for(proc.stdout.readline(), timeout)
    if not line.decode().startswith(word):
        raise RuntimeError(f"load generator: expected {word}, got {line.decode().strip()!r}")


async def drive(c, args, torch, pkg, data_dir: str, device: str) -> SimpleNamespace:
    """Set up, warm up, run the window, drain; returns what the program
    and the generator left, read while the brokers still run."""
    from harness.cluster import Cluster

    cfg, mix = c.config, c.mix
    out = SimpleNamespace(prof=None)
    spec = os.path.join(data_dir, "loadgen.json")
    with open(spec, "w") as f:
        json.dump({"mix": mix, "seed": args.seed, "seconds": args.seconds,
                   "out": os.path.join(data_dir, "loadgen-out.json")}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    gen = await asyncio.create_subprocess_exec(sys.executable, os.path.join(BENCH_DIR, "loadgen.py"), spec,
                                               stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
                                               env=env)
    cluster = Cluster(pkg, os.path.join(data_dir, "brokers"), int(cfg["brokers"]), device=device)
    rf = 1 if args.fault == "rf1" else int(cfg["replication_factor"])
    try:
        await cluster.start()
        await cluster.create(cfg["topic"], int(cfg["partitions"]), rf, cfg["topic_configs"])
        await expect(gen, "POOL", 300)
        start = {"bootstrap": cluster.bootstrap(), "topic": cfg["topic"], "partitions": int(cfg["partitions"])}
        gen.stdin.write(f"START {json.dumps(start)}\n".encode())
        await expect(gen, "WARM", 120 + float(mix["warmup_s"]))
        out.h0 = cluster.histograms()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            out.prof = profile(activities=[ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU])
            out.prof.start()
        out.setup_s = time.monotonic() - T_START
        gen.stdin.write(b"GO\n")
        out.w0 = time.monotonic()
        await expect(gen, "END", args.seconds + 60)
        out.w1 = time.monotonic()
        if out.prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            out.prof.stop()
        out.h1 = cluster.histograms()
        await expect(gen, "DONE", 3 * float(mix["drain_s"]) + 60)
        await asyncio.wait_for(gen.wait(), 30)
        out.memory_peak = 0
        if device == "cuda":
            torch.cuda.synchronize()
            out.memory_peak = torch.cuda.max_memory_allocated()
        out.stored = cluster.stored(cfg["topic"], int(cfg["partitions"]))
    finally:
        await cluster.stop()
        if gen.returncode is None:
            gen.kill()
            await gen.wait()
    with open(os.path.join(data_dir, "loadgen-out.json")) as f:
        out.gen = json.load(f)
    return out


def hist_delta(h0: list, h1: list):
    """hist(family, **labels) -> (sum, count) gained over the window,
    summed over every broker and every series whose labels match."""

    def hist(family: str, **labels) -> tuple:
        s = n = 0.0
        for before, after in zip(h0, h1):
            for name, rows in after.items():
                if not name.endswith("_" + family):
                    continue
                old = {tuple(sorted(lab.items())): (s0, n0) for lab, s0, n0 in before.get(name, [])}
                for lab, s1, n1 in rows:
                    if all(lab.get(k) == v for k, v in labels.items()):
                        s0, n0 = old.get(tuple(sorted(lab.items())), (0.0, 0))
                        s, n = s + s1 - s0, n + n1 - n0
        return s, n

    return hist


def window_work(gen: dict, pool: list, stored: dict, mix: dict, config: dict) -> tuple:
    """(recompression, fetch verify) done for the window's batches: what
    the roofline readers count. A batch is recompressed as its produce
    request arrives, a step before its acknowledgement, so the batches
    acknowledged inside the window stand for those recompressed there
    (above capacity many fall due inside and are served after it)."""
    t0, t1 = gen["t0"], gen["t1"]
    codec = wire.CODECS[config["topic_configs"]["compression.type"]]
    recompress = {"codec": codec, "batches": 0, "section_bytes": 0, "stored_bytes": 0}
    if wire.CODECS[mix["producer_codec"]] != codec:
        bodies = {}
        for p, rows in stored.items():
            have = next((r for r in rows if r is not None), [])
            off = 0
            for fields, body in have:
                bodies[(int(p), off)] = len(body)
                off += fields[8]
        for p, k, idx, _, t_ack, base in gen["acks"]:
            if t0 <= t_ack < t1 and (p, base) in bodies:
                recompress["batches"] += 1
                recompress["section_bytes"] += len(pool[idx]["section"])
                recompress["stored_bytes"] += bodies[(p, base)]
    inside = [r for r in gen["receipts"] if t0 <= r[2] < t1]
    verify = {"batches": len(inside), "bytes": sum(r[7] for r in inside)}
    return recompress, verify


def traced(prof, window_s: float) -> SimpleNamespace:
    ops = trace.device_ops(prof)
    results = prof.profiler.kineto_results
    lo = results.trace_start_ns() * 1e-9 if hasattr(results, "trace_start_ns") else (ops[0][1] if ops else 0.0)
    busy_s, gaps = trace.busy(ops, lo, lo + window_s)
    names = trace.by_name(ops)
    return SimpleNamespace(busy_s=busy_s, kernels=names, breakdown={
        "device_ops": [[n, s] for n, s in sorted(names.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[f"after {a} / before {b}", s] for s, a, b in sorted(gaps, key=lambda g: -g[0])[:10]]})


def setup_program(c, device: str) -> None:
    """The cell's switches and the kernel caches, set before the program
    is first imported; then the program's kernels, built where stale."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    for var, value in c.config["env"].items():
        os.environ[var] = str(value)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from redpanda_tpu_torch.ops import _build, default_device
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    default_device.DEVICE = device
    if device == "cuda":
        _build.build_all()


def run_cell(c, args, torch, device: str = "cuda") -> tuple:
    """One run of cell `c` with the brokers on `device`; returns (the
    result's line, [(name, reading, limit)] compared, what was counted)."""
    from harness import cluster, faults

    setup_program(c, device)
    if args.fault:
        faults.install(args.fault)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    data_dir = tempfile.mkdtemp(prefix="omb-", dir=os.environ.get("TMPDIR"))
    try:
        run = asyncio.run(drive(c, args, torch, cluster.port(), data_dir, device))
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    pool = traffic.pool(c.mix, args.seed, wire_batches=False)
    e2e = stats.end_to_end(run.gen, pool)
    e2e["setup_s"] = run.setup_s
    codec = wire.CODECS[c.config["topic_configs"]["compression.type"]]
    rf = int(c.config["replication_factor"])
    stored = {int(p): rows for p, rows in run.stored.items()}
    compared, counted = check.check(run.gen, stored, pool, codec, rf, args.seed, int(c.mix["check_sample"]))
    counted.update(consumers_late=run.gen["consumers_late"], metadata_refreshes=run.gen["refreshes"],
                   attempts=len(run.gen["attempts"]), slot_waits=run.gen["slot_waits"],
                   generator_late_ms=e2e["late_ms"])
    correct = all(v <= limit for _, v, limit in compared)

    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device, "count": c.chips,
                   "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": correct, "attempted": e2e["attempted"], "failed": e2e["failed"]}
    if args.trace:
        window_s = run.w1 - run.w0
        t = traced(run.prof, window_s)
        recompress, verify = window_work(run.gen, pool, stored, c.mix, c.config)
        ctx = SimpleNamespace(client=e2e, hist=hist_delta(run.h0, run.h1), window_s=window_s, busy_s=t.busy_s,
                              kernels=t.kernels, recompress=recompress, verify=verify, config=c.config, mix=c.mix)
        metrics = {}
        for m in c.per_layer:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=t.busy_s, window_s=window_s)
        line.update(metrics=metrics, device=device_info, breakdown=t.breakdown)
    else:
        line.update(metrics={m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in c.end_to_end},
                    device=device_info)
    line["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in compared}
    return line, compared, counted


def main(argv=None) -> None:
    args = parse(argv)
    c = cells.load(args.workload)
    import torch

    require_card(torch, c.chips)
    line, compared, counted = run_cell(c, args, torch)
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package were loaded: {found}", 3)
    print(f"counted: {json.dumps(counted)}", file=sys.stderr)
    for name, v, limit in compared:
        print(f"check {name}: {v} (limit {limit})", file=sys.stderr)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
