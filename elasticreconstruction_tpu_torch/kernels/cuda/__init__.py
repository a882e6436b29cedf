"""Hand-written Hopper (sm_90a) CUDA kernels replacing the reference's Pallas kernels.

- :mod:`.nn`        ``nearest_batch`` (replaces ``kernels/pallas/nn.py``)
- :mod:`.icp_step`  ``normal_eqs_batch`` (replaces ``kernels/pallas/icp_step.py``)
- :mod:`.raycast`   ``raycast_cuda`` (replaces no Pallas kernel: the reference's
  raycast is plain jnp; its plain version is ``kernels/raycast.py::raycast_plain``)

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, kept in the same module, only for CPU tensors. Each
module keeps a plain integer ``launches`` count of its kernel's launches.
"""
