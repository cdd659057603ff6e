"""The benchmark's CPU tests. A driver added after cellbench/faults.py
registers the faults that apply to it in `faults.FAULTS` under its own
name when it is imported; those drivers are imported here, before any
test module collects its cases from FAULTS by driver name."""

from cellbench.drivers import train_sam  # noqa: F401
