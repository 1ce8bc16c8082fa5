"""Share of the traced window in which no kernel, copy or set ran on the
card, in percent; on several cards, each card's share averaged over the
run's cards. Layer: device."""


def read(run):
    window = run.trace.window_us
    if not window or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / window)
