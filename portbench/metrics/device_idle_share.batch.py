"""The share of the traced window in which no kernel, copy or fill ran on
the device."""

from portbench.metrics._device import idle_share


def read(ctx):
    return idle_share(ctx)
