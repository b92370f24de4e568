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

Ported so far (the replication tick and record-batch CRC):
  utils/        iobuf, crc32c (host), vint, named types, native loader
  compression/  host codec registry (device codecs raise: not ported)
  models/       record/record_batch + consensus-state tensors (torch)
  ops/          quorum fold/commit/heartbeat, health, crc32c kernels
  raft/         ShardGroupArrays + TickFrame (device leg on the card)
"""

__version__ = "0.1.0"
