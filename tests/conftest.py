import os
import sys

# Make `import repro` work without installation (PYTHONPATH=src also works).
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke tests
# and benches must see the real single-device CPU; only launch/dryrun.py
# forces 512 placeholder devices (see the system design brief).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself where none is "
        "present (run on the card with `-m gpu`)")
