"""Command-line entry points of the port
(``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.dryrun``,
``python -m repro_torch.launch.costprobe``, ``python -m
repro_torch.launch.orchestrate``)."""
