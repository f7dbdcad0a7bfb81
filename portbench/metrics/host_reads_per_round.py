"""Device-to-host reads a round: the results' ``host_syncs`` (the
engine's ``SyncCounter``) over their rounds, summed over the window."""


def read(record):
    rounds = sum(r.rounds for r in record.requests)
    if rounds == 0:
        return None
    return sum(r.host_reads for r in record.requests) / rounds
