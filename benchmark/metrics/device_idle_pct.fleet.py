"""The device's idle share on the fleet path: 100 x (1 - union busy / wall
time of the traced stretch)."""

from benchmark.trace import idle_pct


def read(record):
    return idle_pct(record, "fleet")
