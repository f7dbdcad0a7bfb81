"""Rounds of the round driver a request (the most of its lanes, which
the batched loop runs), averaged over the window's requests."""


def read(record):
    if not record.requests:
        return None
    return sum(r.rounds for r in record.requests) / len(record.requests)
