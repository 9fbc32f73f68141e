"""Device (H100): the share of the profiled window in which no operation
ran on the device — one less the union of the device's operation
intervals (``torch.profiler``, device activity only) over the window's
wall — in percent.  Nothing when the profile saw no device operation."""


def read(trace):
    d = trace["device"]
    if d["busy_s"] <= 0.0 or d["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
