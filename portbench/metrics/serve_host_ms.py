"""Host time per request in the serving stretch: the mean wall ms of a
request (host clock, issue to result on the host) minus the device's
busy ms per request (the union of its kernels' intervals, profiler)."""


def read(trace, driver):
    if trace.units <= 0 or not trace.kernels:
        return None
    wall_ms = sum(driver.latencies) / len(driver.latencies)
    return wall_ms - trace.busy_us / 1e3 / trace.units
