"""The port's fault-injection registry (``faults.CHAOS``)."""
