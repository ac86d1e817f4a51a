"""train.step_device_ms: the card's busy time in the traced window over the
steps taken in it, in ms."""


def read(run):
    return (1e3 * run.trace.busy_s / run.counters["steps"]
            if run.trace is not None and run.counters.get("steps") else None)
