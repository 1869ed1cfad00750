"""Plain-data copies of the simulator's job types (``repro.core``)."""
