"""The device's idle share of the traced window, in %, for every metric
of the ``device_idle`` family: 1 - (the union of the intervals in which
an operation ran on the device) / the window."""

from portbench.readers import idle_percent


def read(run):
    return idle_percent(run)
