"""The quantization stage's share of its memory roofline in the profiled
frame: the bytes the stage's calls need (``roofline.quant_stage_bytes``
of each call's shapes) at the card's 3.35 TB/s, over the device time of
the kernels launched inside those calls."""

from benchmark.roofline import HBM_BYTES_PER_S


def read(run):
    prof = run.profile
    if not prof.get("quant_device_s") or not prof.get("quant_bytes"):
        return None
    return 100.0 * prof["quant_bytes"] / HBM_BYTES_PER_S \
        / prof["quant_device_s"]
