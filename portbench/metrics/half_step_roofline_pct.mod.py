"""The sampled half-step kernel's share of its roofline in the modality
cell: the least time of every launch of the stretch (counted once from
its shape, ``counts.half_step_bound_s``) over the kernel's device time by
name. The launches are the program's counter (``half_step_sample``);
their shapes are MOD1's and MOD2's schedules, and a count that disagrees
with them gives no reading."""

from portbench import counts


def read(trace, driver):
    shapes = driver.phase.half_step_shapes() * trace.units
    if not shapes or trace.launches.get("half_step_sample") != len(shapes):
        return None
    us, n = trace.kernel_us("half_step")
    if n != len(shapes) or us <= 0:
        return None
    bound = sum(counts.half_step_bound_s(*s)[0] for s in shapes)
    return 100.0 * bound / (us / 1e6)
