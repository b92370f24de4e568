"""The benchmark's yardstick: wire format, traffic, reference check,
metric arithmetic. Nothing here imports the program except cluster.py
and faults.py, and those only inside their functions."""
