"""setup_s: seconds from the process's start to the window's start
(imports, CUDA start-up, drawing and packing the weights, building the
kernels on a checkout's first run, the warm-up).  Host clock."""


def read(w):
    return w.setup_s
