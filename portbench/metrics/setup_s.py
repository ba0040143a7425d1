"""setup_s: from the start of the process to the opening of the measured
window: imports, the kernel build or its reuse, inputs, warm-up."""


def read(result):
    return result.setup_s
