"""``decay_scan``'s share of its roofline in the profiled ``serve``: the
least time its calls need at their shapes, the larger of their bytes at
3.35 TB/s (each input read once, each output written once) and their
FLOPs at 67 TFLOP/s (float32; ``yardstick``), over the device time of
the kernels whose name holds ``decay_scan`` (not its backward).  The
bytes bound it.  Nothing when the call ran none.  Layer: kernels."""
from perfbench import yardstick as Y


def read(ctx):
    t, scans = ctx.get("trace"), ctx.get("scans")
    if not t or not scans:
        return None
    secs = sum(v for k, v in t["by_kernel"].items()
               if "decay_scan" in k and "bwd" not in k)
    if not secs:
        return None
    need = max(sum(Y.decay_scan_bytes(*s) for s in scans) / Y.HBM_BYTES_PER_S,
               sum(Y.decay_scan_flops(*s[:3]) for s in scans) / Y.FP32_FLOPS)
    return 100.0 * need / secs
