"""The chain kernel's share of its roofline in a training stretch: the
least time of every launch (``counts.chain_bound_s`` of its shape, from
the phase's schedule of clamped inits) over the kernel's device time by
name. A launch count (the program's ``chain_run`` counter) that disagrees
with the schedule gives no reading."""

from portbench import counts


def read(trace, driver):
    shapes = driver.phase.chain_launches(trace.units)
    if not shapes or trace.launches.get("chain_run") != len(shapes):
        return None
    us, n = trace.kernel_us("chain_kernel")
    if n != len(shapes) or us <= 0:
        return None
    bound = sum(counts.chain_bound_s(*s)[0] for s in shapes)
    return 100.0 * bound / (us / 1e6)
