"""setup_s: process start to the first timed request (import, CUDA context,
the part, its libraries built or loaded, the warm-up), host clock."""


def read(run, qualifier):
    return run.setup_s
