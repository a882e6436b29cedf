"""``nearest_batch``'s share of its roofline over one profiled registration pass, in %.

The bound is :mod:`benchmark.metrics.bound_a` summed over the pass's launches
(counted a batch by ``kernels/cuda/nn.py::launches_by_shape``, with the valid
refs of the fine clouds each batch hands the kernel); the time is the device
time of the trace's ``nearest_kernel`` events.
"""

from benchmark.metrics import bound_a


def read(obs):
    nn, dev = obs.get("nearest"), obs.get("device")
    if not nn or not dev or not nn["launches"]:
        return None
    device_s = sum(s for name, s in dev["device_s_by_name"].items() if nn["kernel_name"] in name)
    if device_s <= 0:
        return None
    return 100.0 * bound_a.total_bound_s(nn["launches"]) / device_s
