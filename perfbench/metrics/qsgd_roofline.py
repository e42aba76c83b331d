"""The QSGD kernels' share of their roofline, in %: the least time their
launches could take (the bytes each must move, from its shapes, at the
H100's 3.35 TB/s) over the device time they took.  A launch counts when it
lies in a ``bench.kernel.<wrapper>:<rows>:<n>:<level bytes>`` range and its
kernel's name is the one that wrapper launches (K1 ``sumsq_kernel``, K2
``quantize_kernel``, K3 ``dequant_apply_kernel``)."""
from perfbench.roofline import H100, QSGD_KERNELS, qsgd_bytes


def read(ctx):
    bound = measured = 0.0
    for (s, e, name, _), r in ctx["trace"].by_range("bench.kernel."):
        parts = (r or "").split(":")
        wrapper = parts[0][len("bench.kernel."):]
        if len(parts) != 4 or wrapper not in QSGD_KERNELS \
                or QSGD_KERNELS[wrapper] not in name:
            continue
        rows, n, level_bytes = (int(p) for p in parts[1:])
        bound += qsgd_bytes(wrapper, rows, n, level_bytes) / H100["hbm_bytes"]
        measured += e - s
    if measured == 0.0:
        return None
    return 100.0 * bound / measured
