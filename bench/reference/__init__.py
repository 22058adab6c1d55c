"""The plain reference that decides a run's ``correct``.

A frozen copy of the fleet sweep's semantics, independent of the program
under test: range-offset sharding, the Eq. 1 / Eq. 6 stream scores (the
NumPy oracle), the event tapes, and the lane replay (plain torch on the
CPU, float64, or float32 for the control).  It imports nothing of the
program and takes nothing the program made: it works everything out again
from the trace the benchmark generated.
"""
