"""Kernels (``kernels/stencil.py``, ``residual.py``, ``deep_cycle.py`` →
``csrc/*.cu``): the summed least times of every kernel wrapper call in the
profiled episode (``roofline.py``) over the device time of the kernels
those calls launched, in percent.  Nothing when no call's kernels reached
the profile."""


def read(trace):
    r = trace["roofline"]
    if not r["calls"] or r["device_s"] <= 0.0:
        return None
    return 100.0 * r["least_s"] / r["device_s"]
