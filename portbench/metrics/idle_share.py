"""The device's idle share of the traced window, in percent: one minus
the union of its operations' intervals over the window
(``trace.summarize``)."""


def read(record):
    if record.trace is None or record.trace.busy_s == 0:
        return None
    return 100.0 * record.trace.idle_share
