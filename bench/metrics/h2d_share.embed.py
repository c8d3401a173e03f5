"""Share of the traced window in which host-to-device copies ran on the
card (the batches' uploads): the device trace's ``Memcpy HtoD`` time
over the window."""
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "job entry", "patches_per_s"


def read(run):
    t = run["trace"]
    return share(t["device_s_by_class"]["memcpy_h2d"], t["window_s"])
