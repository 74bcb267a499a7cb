"""From the start of the process to the first timed frame."""


def read(m):
    return m["setup_s"]
