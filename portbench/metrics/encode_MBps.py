"""encode_MBps: input bytes of every request of the window, in 10^6-byte
units, over the window's whole time, from its start to the completion of its
last request (which may run past the window's length).  Host clock."""


def read(w):
    return w.bytes_in / 1e6 / w.window_s if w.requests else None
