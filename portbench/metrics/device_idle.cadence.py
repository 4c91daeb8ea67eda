"""Per cent of the profiled stretch in which no device event ran."""
from portbench.trace import idle_share


def read(trace: dict):
    return idle_share(trace)
