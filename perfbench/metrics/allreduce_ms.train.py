"""Device time of the NCCL kernels (the gradient all-reduce) per traced
step in rank 0's trace, in ms."""


def read(obs):
    ops = obs.ops_named("nccl")
    if not ops:
        return None
    return sum(dur for _, _, dur in ops) / 1e3 / obs.info["steps"]
