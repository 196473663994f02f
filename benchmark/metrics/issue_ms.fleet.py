"""Host ms from a call of the fleet path's step to its return (the copy of
the scans into the graph's inputs, the replay's launch and the clone of its
outputs), the mean over the window's frames: the compiled step layer."""

from benchmark.trace import issue_ms


def read(record):
    return issue_ms(record, "fleet")
