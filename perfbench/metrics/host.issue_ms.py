"""``host.issue_ms`` (ms): the median, over the measured window's calls,
of the host clock from the entry's call to its return, before the
synchronise: the time the host takes to issue one call's work."""

import statistics


def read(rec):
    if not rec.issue_s:
        return None
    return 1e3 * statistics.median(rec.issue_s)
