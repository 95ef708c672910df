"""The parts of the reference's ``repro.core`` that the port needs so far."""
