"""setup_s: seconds from the start of the process to the first timed request
(CUDA start, data made from the seed, the program's build lookup, the warm-up
pass).  Host clock."""


def read(w):
    return w.setup_s
