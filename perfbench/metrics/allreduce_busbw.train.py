"""Bus bandwidth of the gradient all-reduce on rank 0, in GB/s: the bytes
its program counter ``train.allreduce_bytes`` counted inside the traced
slice per step, times 2 (n - 1) / n for n ranks (a ring all-reduce moves
each byte that often), over the NCCL kernels' device time per step (the
operations ``allreduce_ms.train`` sums)."""


def read(obs):
    n = obs.info.get("ranks")
    ops = obs.ops_named("nccl")
    if obs.slice_s is None or not n or not ops:
        return None
    lo, hi = obs.slice_s
    moved = sum(v for t, v in obs.counters.get("train.allreduce_bytes", [])
                if lo <= t <= hi)
    if not moved:
        return None
    device_s = sum(dur for _, _, dur in ops) / 1e6
    return moved * 2 * (n - 1) / n / device_s / 1e9
