"""redpanda_tpu_torch — the PyTorch/CUDA port of redpanda_tpu.

The same Kafka-compatible, Raft-replicated streaming broker design as
`redpanda_tpu`, with the device plane rebuilt for an NVIDIA H100: the
per-shard consensus state is still struct-of-arrays over raft groups,
but it is stepped by CUDA kernels written by hand (`csrc/`, bound with
ctypes by `ops/_build.py`) instead of jitted XLA programs.

The package mirrors `redpanda_tpu`'s layout and names, one module per
counterpart, and imports neither `jax` nor anything of `redpanda_tpu`.
Modules that carry no device code are copies of their counterparts.
Every kernel wrapper runs its plain PyTorch version for tensors on the
CPU (the tests) and launches its CUDA kernel, or raises, for tensors
on the card.

Ported so far:
  utils/        iobuf, crc32c (host), vint, named types, native loader,
                tasks, serde, locks, compileguard (nvcc builds as its
                compile events)
  metrics.py    the metrics registry (prefix "redpanda_tpu", as the
                reference's, so a scraper sees the same names)
  observability/ trace, load_ledger, health, fleet, flightdata, alerts
                and the armed devplane (RP_DEVPLANE=1: dispatch->ready
                probes on every kernel wrapper of the live path)
  compression/  codec registry with the device LZ4 / snappy / zstd legs
  models/       record/record_batch + consensus-state tensors (torch)
  ops/          quorum fold/commit/heartbeat and follower rules, health,
                crc32c, cell parse, LZ4 / snappy / zstd kernels
  raft/         ShardGroupArrays + TickFrame (device and mesh legs)
  parallel/     the mesh frame and the RF=3 ring cluster step over chip
                blocks on one card
  entry.py      entry() and dryrun_multichip(n), as __graft_entry__.py
"""

__version__ = "0.1.0"
