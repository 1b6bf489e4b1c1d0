"""One reader a metric, ``<metric>.py``, found by the metric's name.

A reader has ``read(ctx)``, which returns the metric's value, or None where
the run gave it nothing to read, and may have ``at_open(ctx)``, called
right before the window opens.  ``ctx`` is ``mapbench.drive.Context``."""
