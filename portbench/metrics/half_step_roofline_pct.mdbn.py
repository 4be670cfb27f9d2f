"""The half-step kernel's share of its roofline in the multimodal DBN's
cell, every entry and both bodies together: the least time of every launch
of the stretch (``counts_mdbn.half_step_bound_s``: its product or its
bytes, counted once from its shape) over the device time of every kernel
named ``half_step``. The launches are the program's counters of each entry
(``half_step_sample``, ``half_step_gauss``, ``half_step_scaled``,
``half_step_linear``) and of each body (``body:wgmma``,
``body:mma_sync``); a count that disagrees with the schedule gives no
reading."""

from portbench import counts_mdbn


def read(trace, driver):
    half, words = driver.phase.launch_schedule()
    half, words = half * trace.units, words * trace.units
    want = counts_mdbn.expected_launches(half, words)
    want.pop("rs_sample")
    if not half or any(trace.launches.get(k) != n for k, n in want.items()):
        return None
    us, n = trace.kernel_us("half_step")
    if n != len(half) or us <= 0:
        return None
    bound = sum(counts_mdbn.half_step_bound_s(*x) for x in half)
    return 100.0 * bound / (us / 1e6)
