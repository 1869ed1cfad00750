"""Node templates and the simulated cloud provider (``repro.cloud``)."""
