"""Device kernels launched per profiled call (a training step or a
request)."""


def read(run):
    return run.summary["kernels"] / run.summary["steps"]
