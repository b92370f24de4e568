"""The recompression kernels' share of their memory roofline in the
traced window: the least time the card could take for the window's
recompressed batches (each records section read once, its stored body
and, where the kernel computes the batch CRC, 4 CRC bytes written once,
at the H100's 3.35 TB/s) over the summed device time of the kernels
that do that work, by topic codec. The byte count is the work, whatever
kernel does it; the names below are the kernels of the program as it
is, and a later kernel that replaces them needs its name added here."""

from harness.peaks import H100_HBM_BYTES_S

# topic codec (Kafka's attribute value) -> (kernel name parts, CRC bytes a batch)
KERNELS = {3: (("fused_kernel<",), 4), 4: (("zstd_encode_kernel",), 0)}


def read(ctx):
    r = ctx.recompress
    if r["codec"] not in KERNELS or not r["batches"]:
        return None
    names, crc = KERNELS[r["codec"]]
    device_s = sum(t for n, t in ctx.kernels.items() if any(k in n for k in names))
    if device_s <= 0:
        return None
    least_s = (r["section_bytes"] + r["stored_bytes"] + crc * r["batches"]) / H100_HBM_BYTES_S
    return 100.0 * least_s / device_s
