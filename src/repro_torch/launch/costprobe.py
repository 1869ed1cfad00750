"""The compositional cost probe, as ``repro/launch/costprobe.py``.

The reference extrapolates a full-depth cell's FLOPs and bytes from two
reduced-depth variants, because XLA's ``cost_analysis`` counts a scanned
layer body once:

    F(L_full) = F(La) + (F(Lb) - F(La)) / (Lb - La) x (L_full - La)

with (La, Lb) one and two repetitions of the family's block pattern (the
MoE dense lead and Whisper's encoder scale with the probes).  The port
runs every layer eagerly, so its configs have no ``unroll_layers``: the
probe varies ``num_layers`` (and ``encoder_layers`` for an
encoder-decoder) and counts each variant with the dry run
(``repro_torch.launch.dryrun.run_cell``).  Since the dry run counts
every layer, its direct full-depth count of FLOPs and collective bytes
must equal the extrapolation: that equality shows the accounting is
linear in depth.  Bytes moved are not, in the port: a segment of one
layer holds its parameters and caches unstacked, and autograd writes a
stacked parameter's whole gradient for each of its layers, so a train
step's bytes grow with the square of the depth; the probe reports both.

    python -m repro_torch.launch.costprobe --arch deepseek-7b --shape train_4k

writes ``artifacts/torch/costprobe/<arch>__<shape>.json`` (the probe,
the extrapolation and, with ``--direct``, the full-depth count).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "torch", "costprobe")


def probe_configs(cfg: ArchConfig) -> Tuple[ArchConfig, ArchConfig, int, int]:
    """(cfg_a, cfg_b, La, Lb): the reduced-depth variants."""
    if cfg.family == "ssm":
        k = cfg.slstm_every or 1
        la, lb = k, 2 * k
    elif cfg.family == "hybrid":
        la, lb = cfg.rglru_pattern, 2 * cfg.rglru_pattern
    elif cfg.n_experts > 0 and cfg.first_k_dense:
        la, lb = cfg.first_k_dense + 1, cfg.first_k_dense + 2
    else:
        la, lb = 1, 2

    def mk(n):
        kw = dict(num_layers=n)
        if cfg.is_encoder_decoder:
            kw["encoder_layers"] = n
        return dataclasses.replace(cfg, **kw)
    return mk(la), mk(lb), la, lb


def _cost(arch: str, cfg: ArchConfig, shape, mesh, tiny: bool
          ) -> Dict[str, float]:
    base = get_config(arch, tiny=tiny)
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(base, f.name)}
    r = dryrun.run_cell(arch, shape, False, cfg_overrides=overrides,
                        mesh=mesh, tiny=tiny)
    return {"flops": r["cost"]["flops_per_device"],
            "bytes": r["cost"]["bytes_per_device"],
            "collective_bytes": r["collectives_per_device"]["total"]}


def run_probe(arch: str, shape: Union[str, shp.ShapeSpec],
              out_dir: Optional[str] = None, direct: bool = False,
              mesh: Optional[dryrun.MeshSpec] = None, tiny: bool = False,
              cfg_overrides: Optional[Dict] = None) -> Dict:
    """Probe one cell on the single-pod mesh (or ``mesh``); with
    ``direct`` also count the full depth, for the comparison."""
    cfg = dryrun.cell_config(arch, cfg_overrides, tiny)
    spec = shp.SHAPES[shape] if isinstance(shape, str) else shape
    cfg_a, cfg_b, la, lb = probe_configs(cfg)
    t0 = time.time()
    fa = _cost(arch, cfg_a, spec, mesh, tiny)
    fb = _cost(arch, cfg_b, spec, mesh, tiny)
    n_steps = (cfg.num_layers - la) / (lb - la)
    full = {k: fa[k] + (fb[k] - fa[k]) * n_steps for k in fa}
    mesh_shape = (mesh or dryrun.PRODUCTION[False])[0]
    result = {
        "arch": arch, "shape": spec.name,
        "mesh": "single" if mesh is None else "x".join(map(str, mesh_shape)),
        "devices": math.prod(mesh_shape),
        "probe_layers": [la, lb],
        "flops_per_device_a": fa["flops"], "flops_per_device_b": fb["flops"],
        "bytes_per_device_a": fa["bytes"], "bytes_per_device_b": fb["bytes"],
        "flops_per_device_full": full["flops"],
        "bytes_per_device_full": full["bytes"],
        "collective_bytes_per_device_full": full["collective_bytes"],
    }
    if direct:
        d = _cost(arch, cfg, spec, mesh, tiny)
        result.update({"flops_per_device_direct": d["flops"],
                       "bytes_per_device_direct": d["bytes"],
                       "collective_bytes_per_device_direct":
                           d["collective_bytes"]})
    result["elapsed_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{spec.name}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    print(f"[costprobe] {arch} x {spec.name}: full flops/dev "
          f"{full['flops']:.6e} bytes/dev {full['bytes']:.6e}"
          + (f" (direct {result['flops_per_device_direct']:.6e}, "
             f"{result['bytes_per_device_direct']:.6e})" if direct else "")
          + f" ({result['elapsed_s']}s)")
    return result


def agrees(result: Dict, rel: float = 1e-9) -> bool:
    """Whether a probe's extrapolated FLOPs and collective bytes equal
    its direct count to within ``rel``."""
    return all(abs(result[f"{k}_per_device_full"]
                   - result[f"{k}_per_device_direct"])
               <= rel * abs(result[f"{k}_per_device_direct"])
               for k in ("flops", "collective_bytes"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Compositional cost probe")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--direct", action="store_true",
                    help="also count the full depth and compare")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        names = list(shp.SHAPES) if args.shape == "all" else [args.shape]
        for shape_name in names:
            if not shp.applicable(cfg, shp.SHAPES[shape_name])[0]:
                continue
            try:
                r = run_probe(arch, shape_name, args.out, direct=args.direct)
                if args.direct and not agrees(r):
                    failures.append((arch, shape_name, "the extrapolation "
                                     "differs from the direct count"))
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((arch, shape_name, str(e)))
    print(f"[costprobe] done, {len(failures)} failures")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
