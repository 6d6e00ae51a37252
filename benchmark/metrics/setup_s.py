"""Process start to the first timed call, s: loading, the inputs, warm-up and any build."""


def read(run):
    return run.setup_s
