"""Node templates of the simulated cloud (``repro.cloud``), as data."""
