"""Set-up seconds: from the process's start through generation, the
solver's construction and one warm request (host clock)."""


def read(record):
    return record.setup_s
