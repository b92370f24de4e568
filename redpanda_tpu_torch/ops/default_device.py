"""The device of the kernel entries whose caller names none.

The record, fetch and archive paths call the codec and CRC entries
(crc32c, lz4, snappy, zstd, fused) without a device argument; each
resolves it here, so one value decides where all of them run. It is the
card unless the process asked otherwise: `python -m redpanda_tpu_torch
--device cpu` calls `use("cpu")`, and the CPU tests set `DEVICE`.
"""

from __future__ import annotations

from ..models.consensus_state import check_device

DEVICE = "cuda"


def use(device: str) -> None:
    """Run every entry without a device argument on `device`. A CUDA
    device that is not there raises here, before anything runs."""
    global DEVICE
    check_device(device)
    DEVICE = device


def resolve(device=None):
    """`device` if the caller named one, else DEVICE, as a
    torch.device (check_device: CUDA without a card raises)."""
    return check_device(device or DEVICE)
