"""Process start to window open: weights, models, kernels loaded or built,
warm-up."""


def read(r):
    return r["setup_s"]
