"""Device operations (kernels, copies, fills) a round in the traced part
of the window: the trace's device operations over the rounds of the
requests that ran while it was on."""


def read(record):
    if record.trace is None or record.trace.device_ops == 0:
        return None
    rounds = sum(r.rounds for r in record.requests if r.traced)
    if rounds == 0:
        return None
    return record.trace.device_ops / rounds
