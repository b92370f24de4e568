"""One run of a cell on the CPU at a small size, past the harness's look
for a card: the brokers on the port's plain versions, a few partitions,
a short window. For the benchmark's own tests of its check.

    python3 benchmark/tests/cpu_cell.py CELL SEED [FAULT] [KEY=VALUE ...]

KEY=VALUE set a configuration key (partitions) or a run parameter (as
JSON values); `env.NAME=VALUE` sets one of the configuration's
switches; `config=NAME` runs the cell's mix on configs/NAME.json.
Prints the result's line, then `counted {...}`.
"""

from __future__ import annotations

import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH_DIR)

import run  # noqa: E402
from harness import cell, traffic  # noqa: E402

SMALL_CONFIG = {"partitions": 4}
SMALL_MIX = {"pool_batches": 16, "batches_per_s": 40, "warmup_s": 1.0, "drain_s": 20, "producers": 2, "consumers": 2,
             "check_sample": 50}


def main(argv) -> None:
    import torch

    name, seed = argv[0], int(argv[1])
    fault = argv[2] if len(argv) > 2 and "=" not in argv[2] else None
    c = cell.load(name)
    rest = argv[2 + (fault is not None):]
    for kv in [kv for kv in rest if kv.startswith("config=")]:
        c.config = cell.load_json(os.path.join(BENCH_DIR, "configs", kv.split("=", 1)[1] + ".json"))
        c.mix = traffic.plan(c.config, cell.load_json(os.path.join(BENCH_DIR, "traffic", c.mix["name"] + ".json")))
    c.config, c.mix = {**c.config, **SMALL_CONFIG}, {**c.mix, **SMALL_MIX}
    c.config["env"] = {"RP_FETCH_VERIFY": "0"}
    for kv in rest:
        k, v = kv.split("=", 1)
        if k == "config":
            continue
        if k.startswith("env."):
            c.config["env"][k[4:]] = v
        elif k in c.config:
            c.config[k] = json.loads(v)
        else:
            c.mix[k] = json.loads(v)
    args = run.parse(["--workload", name, "--seed", str(seed), "--seconds", os.environ.get("BENCH_CPU_SECONDS", "2"),
                      "--trace", "0"] + (["--fault", fault] if fault else []))
    line, compared, counted = run.run_cell(c, args, torch, device="cpu")
    print(json.dumps(line))
    print("counted " + json.dumps({**counted, "forbidden": run.forbidden_modules()}))


if __name__ == "__main__":
    main(sys.argv[1:])
