"""The WN-layer kernels' share of their roofline over the traced
batches: the sum of the bounds of every FIRST / STD / FINAL launch of the
batches' vocodes (operations and bytes from their shapes,
``perfbench/roofline.py``) over the device time of the kernels named
``wn_sm90_kernel`` in the trace, in %."""


def read(obs):
    ops = obs.ops_named("wn_sm90_kernel")
    if not ops:
        return None
    device_s = sum(dur for _, _, dur in ops) / 1e6
    bound = obs.info["wn_bound_s_per_batch"] * obs.info["batches"]
    return 100.0 * bound / device_s
