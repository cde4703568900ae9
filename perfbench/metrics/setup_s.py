"""``setup_s`` (s): from the process's start to the first timed call:
imports, the inputs made on the device, the program's plans, kernel
builds (the first run of a checkout) and the warm-up calls."""


def read(win):
    return win.setup_s
