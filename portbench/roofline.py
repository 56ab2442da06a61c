"""The least time the card could take for one launch of the fused
evaluate+assemble kernel, from the cell's shapes.

A frozen copy of the program's ``utils/roofline.py::kernel_bound`` and
``slot_flops``, with the shapes as arguments: every input read once and
every output written once at the memory rate, against the valid slots'
operations at the float32 rate.  Peaks: one NVIDIA H100 SXM by its data
sheet, 3.35 TB/s of device memory and 67 TFLOP/s in float32 outside the
tensor cores, at a 700 W power limit.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12


def slot_flops(rolling_shutter: bool, interp: str, distortion: bool,
               robust: bool) -> int:
    """Operations one valid slot needs (an FMA counts 2), as counted off
    the kernel's arithmetic: the rotation chain on duals with 6 tangents
    (3 without rolling shutter), the projection side as 2×3 products."""
    if not rolling_shutter:
        pose, rotate, sums = 0, 165, 112
    else:
        pose = {"slerp": 21 + 186 + 388, "nlerp": 290,
                "lerp_aa": 63 + 186}[interp]
        rotate, sums = 300, 364
    project = 80 if distortion else 40
    jac = 135 if rolling_shutter else 105
    triggs = 185 if robust else 0
    point_side = 27 + 4 * (36 if rolling_shutter else 18)
    return pose + rotate + project + jac + triggs + point_side + sums


def kernel_bound(NR: int, W: int, L: int, G: int, itemsize: int,
                 n_valid: int, flops_per_slot: int) -> dict:
    """Bytes, operations and the bound (seconds) of one launch on an
    (NR rows, W poses a window, L slots, G point columns) grid."""
    floats_in = (NR * W * 8 + NR * 3 * G + NR * G + NR * 2 * L * G
                 + 3 * NR * L * G + 9)
    bytes_in = itemsize * floats_in + 4 * NR * L * G      # offs: int32
    bytes_out = itemsize * (NR + NR * W * (6 + 36 + 36) + NR * G * (3 + 6)
                            + NR * W * 18 * G)
    flops = n_valid * flops_per_slot
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS
    return {"bytes_in": bytes_in, "bytes_out": bytes_out, "flops": flops,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
