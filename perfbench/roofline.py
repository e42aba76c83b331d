"""The chip's published peaks and the bytes each QSGD kernel must move.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s in bf16, 67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s
of HBM3.  A kernel's bound counts each input read once and each output
written once, from the shapes of its launch."""
from __future__ import annotations

H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}

#: the QSGD launch wrappers of the port and the kernel each launches
QSGD_KERNELS = {"qsgd_sumsq": "sumsq_kernel",
                "qsgd_quantize": "quantize_kernel",
                "qsgd_dequant_apply": "dequant_apply_kernel"}


def qsgd_bytes(wrapper: str, rows: int, n: int, level_bytes: int) -> int:
    """Bytes a launch of ``wrapper`` over ``rows`` rows of ``n`` values
    must move.

    K1 ``qsgd_sumsq``: reads y (rows, n) f32; writes ss, norm, inv (rows,).
    K2 ``qsgd_quantize``: reads y and u (rows, n) f32 and inv (rows,);
    writes the levels (rows, n).  K3 ``qsgd_dequant_apply``: reads x (n,)
    f32, the levels (n,) and one norm; writes x' (n,) f32."""
    if wrapper == "qsgd_sumsq":
        return 4 * rows * n + 12 * rows
    if wrapper == "qsgd_quantize":
        return 8 * rows * n + 4 * rows + level_bytes * rows * n
    if wrapper == "qsgd_dequant_apply":
        return (8 + level_bytes) * n + 4
    raise KeyError(wrapper)
