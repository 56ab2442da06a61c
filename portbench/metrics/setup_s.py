"""setup_s (s): from the start of the process to the first timed
request: imports, CUDA start-up, the kernel library, the inputs, warm-up."""


def read(run):
    return run.setup_s
