"""Entry drivers, one module a program entry, found by the name a workload file gives.

An entry module has ``setup(cell, seed, device, workdir)`` (inputs made and
every shape warmed), ``call(state)`` (one timed unit of work, returns the
units it completed once they are on the host), ``trace(state)`` (the traced
calls, returns what the per-layer readers read) and ``judge(state)`` (the
comparison with the reference, after the window), and ``control(state)``
(the reference in TF32 put in the program's place, for the readings).
"""
