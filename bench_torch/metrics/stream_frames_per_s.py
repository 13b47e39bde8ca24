"""Output frames of the window over the window's time, in millions a
second, for one caller that hands host buffers in and waits for host
buffers back (a closed loop).  A frame is one sample per channel of one
stream; host clock."""


def read(run):
    return run.frames / run.window_s / 1e6
