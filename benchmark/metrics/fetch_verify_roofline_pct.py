"""The fetch verify's share of its memory roofline in the traced
window: the least time the card could take to read, once, the CRC-32C
payload (attributes onward) of every batch the consumers received in
the window and write its 4-byte CRC, at the H100's 3.35 TB/s, over the
summed device time of the CRC kernel (csrc/crc32c.cu, reached from
kafka/server.py's fetch verify)."""

from harness.peaks import H100_HBM_BYTES_S

KERNELS = ("crc32c_kernel",)


def read(ctx):
    v = ctx.verify
    device_s = sum(t for n, t in ctx.kernels.items() if any(k in n for k in KERNELS))
    if not v["batches"] or device_s <= 0:
        return None
    return 100.0 * (v["bytes"] + 4 * v["batches"]) / H100_HBM_BYTES_S / device_s
