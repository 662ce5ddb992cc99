"""Filter steps (one member or target advanced one time step) completed
in the window, over the window's length; whole requests only."""


def read(rec):
    return rec["steps"] / rec["window_s"]
