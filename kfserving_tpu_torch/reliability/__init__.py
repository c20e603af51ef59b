"""Fault injection of the port (``faults``, ``fault_sites``)."""
