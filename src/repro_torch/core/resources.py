"""Two-dimensional resource vectors, paper §3/§6.1.

The paper schedules on (CPU, memory) with an explicit asymmetry:

* **CPU is compressible** — exceeding it gets throttled, never killed.
* **Memory is non-compressible** — exceeding it gets the pod killed; the only
  relief for pressure is eviction.

The TPU-fleet adaptation keeps the same algebra with reinterpreted units
(see DESIGN.md §2): ``cpu_m`` = compressible compute grain (millicores on a
VM worker; chip-milliseconds of schedulable compute share on a TPU host) and
``mem_mb`` = the non-compressible byte resource (RAM MB; HBM MB).  Best-fit
is keyed on the non-compressible axis in both worlds.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Resources:
    """An amount of (compressible, non-compressible) resource.

    Attributes:
      cpu_m:  compressible resource in milli-units (paper: CPU millicores).
      mem_mb: non-compressible resource in MB (paper: RAM; fleet: HBM).
    """

    cpu_m: int = 0
    mem_mb: float = 0.0

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        return Resources(self.cpu_m + other.cpu_m, self.mem_mb + other.mem_mb)

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources(self.cpu_m - other.cpu_m, self.mem_mb - other.mem_mb)

    def __mul__(self, k: float) -> "Resources":
        return Resources(int(self.cpu_m * k), self.mem_mb * k)

    # -- predicates ----------------------------------------------------------
    def fits_in(self, free: "Resources") -> bool:
        """True iff a request of `self` fits inside `free` on both axes."""
        return self.cpu_m <= free.cpu_m and self.mem_mb <= free.mem_mb + 1e-9

    def cpu_fits_in(self, free: "Resources") -> bool:
        """Paper Alg. 3/4 first-stage filter: compressible axis only."""
        return self.cpu_m <= free.cpu_m

    def nonneg(self) -> bool:
        return self.cpu_m >= 0 and self.mem_mb >= -1e-9

    @staticmethod
    def zero() -> "Resources":
        return Resources(0, 0.0)


def gi(x: float) -> float:
    """Gibibytes -> MB (paper requests are written in Gi)."""
    return x * 1024.0


def sum_resources(items) -> Resources:
    total = Resources.zero()
    for r in items:
        total = total + r
    return total
