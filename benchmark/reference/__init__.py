"""Plain PyTorch reference of what the timed paths produce.

It imports nothing of the port and nothing of JAX: the odometry and
registration paths here are frozen copies of the port's plain versions (the
raycast march vectorised over its steps), and :mod:`.prec` runs them with
matrix products in TF32 for the control.
"""
