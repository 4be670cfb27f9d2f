"""Share of the traced stretch in which no kernel ran on the device:
100 − the union of the device kernels' intervals (torch.profiler)."""


def read(trace, driver):
    if trace.window_us <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
