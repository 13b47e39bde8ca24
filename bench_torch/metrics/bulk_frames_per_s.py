"""Output frames of the window over the window's time, in millions a
second, for engines that keep the audio on the device: the window ends
when the device has finished every call it was given.  A frame is one
sample per channel of one stream; host clock."""


def read(run):
    return run.frames / run.window_s / 1e6
