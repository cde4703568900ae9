"""``vis_rate`` (Mvis/s): the visibilities of every call completed in the
measured window (the entry's rows × channels × correlations a call),
over the window's length."""


def read(win):
    return len(win.times) * win.vis_per_call / win.window_s / 1e6
