"""Process start to the first timed request: imports, the kernel's build
(first run in a checkout only), the matrices, the warm-up request."""


def read(run):
    return run.setup_s
