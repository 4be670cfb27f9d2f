"""The replicated-softmax word sampler's share of its roofline: the least
time of every launch of the stretch (``counts_mdbn.rs_sample_bound_s``,
its bytes counted once) over the kernel's device time by name. The
launches are the program's counter (``rs_sample``); a count that
disagrees with the schedule gives no reading."""

from portbench import counts_mdbn


def read(trace, driver):
    _, words = driver.phase.launch_schedule()
    words = words * trace.units
    if not words or trace.launches.get("rs_sample") != len(words):
        return None
    us, n = trace.kernel_us("rs_sample_kernel")
    if n != len(words) or us <= 0:
        return None
    bound = sum(counts_mdbn.rs_sample_bound_s(*x) for x in words)
    return 100.0 * bound / (us / 1e6)
