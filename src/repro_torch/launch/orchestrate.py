"""Orchestration launcher — the paper's system end to end, as
``repro/launch/orchestrate.py``.

``python -m repro_torch.launch.orchestrate --workload slow --rescheduler
non-binding --autoscaler binding`` runs one experiment;
``--compare`` reproduces the Fig. 3 grid + the Fig. 4 K8s baseline for a
workload and prints the cost-reduction headline.  The port's serial
simulator runs on the host: none of these autoscalers reaches the card.
The printed rows are the reference's, character for character.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import (ExperimentSpec, run_all_combos, run_experiment,
                              run_k8s_baseline)
from repro_torch.core.failures import FailureInjector


def _print(r, k8s_cost=None) -> None:
    save = f"  save={100 * (1 - r.cost / k8s_cost):.1f}%" if k8s_cost else ""
    print(f"  {r.combo():10s} cost=${r.cost:8.2f} dur={r.duration_s:7.0f}s "
          f"medpend={r.median_pending_s:6.1f}s ram={r.avg_ram_ratio:.2f} "
          f"cpu={r.avg_cpu_ratio:.2f} pods/node={r.avg_pods_per_node:.2f} "
          f"maxN={r.max_nodes} evic={r.evictions}{save}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``argv`` defaults to the command line (``sys.argv[1:]``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="mixed",
                    choices=["bursty", "slow", "mixed"])
    ap.add_argument("--rescheduler", default="non-binding",
                    choices=["void", "non-binding", "binding"])
    ap.add_argument("--autoscaler", default="binding",
                    choices=["void", "non-binding", "binding"])
    ap.add_argument("--scheduler", default="best-fit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", action="store_true",
                    help="run all 6 combos + the K8s static baseline")
    ap.add_argument("--failures", action="store_true",
                    help="inject node failures (fleet fault-tolerance demo)")
    args = ap.parse_args(argv)

    injector = FailureInjector(mtbf_s=1800.0, seed=args.seed) \
        if args.failures else None

    if args.compare:
        print(f"[orchestrate] workload={args.workload} (Fig. 3 + Fig. 4)")
        k8s = run_k8s_baseline(args.workload, seed=args.seed)
        print(f"  K8S-static n={k8s.max_nodes} cost=${k8s.cost:8.2f} "
              f"dur={k8s.duration_s:7.0f}s")
        for r in run_all_combos(args.workload, seed=args.seed):
            _print(r, k8s.cost)
        return

    spec = ExperimentSpec(workload=args.workload, scheduler=args.scheduler,
                          rescheduler=args.rescheduler,
                          autoscaler=args.autoscaler, seed=args.seed,
                          failure_injector=injector)
    r = run_experiment(spec)
    print(f"[orchestrate] workload={args.workload} completed={r.completed} "
          f"failures={r.failures_injected}")
    _print(r)


if __name__ == "__main__":
    main()
