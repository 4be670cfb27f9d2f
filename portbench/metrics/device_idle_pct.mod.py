"""Share of the traced stretch of a modality cell in which no kernel ran
on the device: 100 − the union of the device kernels' intervals
(torch.profiler); the host's key tables, reads and launches between the
stacks' epoch replays show here."""


def read(trace, driver):
    if trace.window_us <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
