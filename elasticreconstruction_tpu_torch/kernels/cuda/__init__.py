"""Hand-written Hopper (sm_90a) CUDA kernels, one ``csrc/<source>.cu`` each.

- :mod:`.nn`        ``nearest_batch`` (replaces ``kernels/pallas/nn.py``)
- :mod:`.icp_step`  ``normal_eqs_batch`` (replaces ``kernels/pallas/icp_step.py``)
- :mod:`.calib`     ``fma_chain``, ``where_chain``, ``threshold_sum_chain``
  (replace the calibration kernels of ``kernels_bench.py::calibrate``)
- :mod:`.raycast`   ``raycast_cuda`` (replaces the plain ``kernels/raycast.py::raycast_plain``)
- :mod:`.gn_step`   ``gn_level_cuda`` (replaces the plain ``odometry/kinfu.py::_gn_level_plain``)

The seam is :mod:`.build`: each launch function is one ``build.Kernel``,
which builds, binds, launches and counts it (``build.launches``).
The route rule is ``build.on_card(tensor, op)``: CPU tensors run the plain
version, CUDA tensors the kernel, others raise. A kernel standing for a Pallas
kernel keeps its plain twin beside it and routes there (nn, icp_step, calib);
one replacing plain jnp code routes at that code's op
(``kernels/raycast.py::raycast``, ``odometry/kinfu.py::_gn_level``).

Adding a kernel: write ``csrc/<source>.cu``; add its nvcc flags to
``build.SOURCE_FLAGS``; declare its launch function with ``build.Kernel``;
route to it with ``build.on_card`` at the op it stands for; hold it against
its plain version in a card test file (``tests/test_torch_*_kernel.py``).
"""
