"""From the process's start to the window's first step, in s."""


def read(rec):
    return rec["setup_s"]
