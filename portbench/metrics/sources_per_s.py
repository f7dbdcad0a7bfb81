"""Sources answered a second: the sources of the window's completed
requests over the time from the window's start to the last completion."""


def read(record):
    if not record.requests:
        return None
    span = record.requests[-1].end - record.window_start
    return sum(r.sources for r in record.requests) / span
