"""Device operations an epoch of a modality stack runs besides the port's
own kernels (every ``half_step`` body and entry, ``chain``,
``philox_fill``, ``rs_sample``): the plain torch and cuBLAS work of the
epoch bodies, counted in the profiler's trace of the stretch and divided
by its epochs, two a step (MOD1's and MOD2's)."""

OWN = ("half_step", "chain_kernel", "philox_fill_kernel", "rs_sample_kernel")


def read(trace, driver):
    if trace.units <= 0 or not trace.kernels:
        return None
    _, n = trace.kernel_us(exclude=OWN)
    return n / (2 * trace.units)
