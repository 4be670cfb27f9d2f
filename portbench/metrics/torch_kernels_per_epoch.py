"""Device operations a training epoch runs besides the port's own
kernels (``half_step``, ``chain``, ``philox_fill``): the plain torch and
cuBLAS work of the epoch bodies, counted in the profiler's trace of the
stretch and divided by its epochs."""


def read(trace, driver):
    if trace.units <= 0 or not trace.kernels:
        return None
    _, n = trace.kernel_us(exclude=("half_step_kernel", "chain_kernel",
                                    "philox_fill_kernel"))
    return n / trace.units
