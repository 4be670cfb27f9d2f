"""A modality cell's whole step against the chip's peak: the operations
of the stretch's steps (an epoch of each stack), counted once from the
shapes (``driver.phase``'s ``flops_per_step``), over the stretch's host
seconds, against the dense TF32 peak (no fp32-accurate implementation
can pass it)."""

from portbench import counts


def read(trace, driver):
    if trace.wall_s <= 0 or trace.units <= 0:
        return None
    flops = driver.phase.flops_per_step() * trace.units
    return 100.0 * flops / trace.wall_s / counts.PEAK_TF32_FLOPS
