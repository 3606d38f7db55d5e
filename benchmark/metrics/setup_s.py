"""Set-up: from process start to the first timed step or request, every
build, load, warm-up and the mining of the window's batches included."""


def read(rec):
    return rec["setup_s"]
