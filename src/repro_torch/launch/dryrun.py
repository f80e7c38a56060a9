"""Dry run of every (architecture x input shape) cell on the production
meshes: the port's ``repro.launch.dryrun``.

Each cell's program — the train step, prefill or decode step that runs on
the card — is traced on meta tensors (``launch/hlo_analysis.py``): nothing
is allocated and nothing launched, so no card is needed.  It computes
nothing, so it is no fallback.  A record holds the per-device dot FLOPs,
the kernels' work and launches, traffic and collective bytes (``hlo``),
memory per device (``memory``: the arguments the port places, the peak
of what the step makes over them, and for a train cell or a prefill or
decode cell on a mesh the arguments under the reference's spec trees,
for the latter beside what the port's f32 leaves add to them) and the
roofline at the H100's peaks (``roofline``: each dtype's FLOPs at its
peak, the traffic at the HBM's rate, the collective bytes over one
NVLink direction).  Where the port
does not run the cell's layout (prefill and decode on a mesh for
parameters under FSDP, among others: ``decode.mesh_serving_gap``),
the record says so under ``skipped`` and holds no number.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.distributed import sharding as shmod
from repro_torch.launch.hlo_analysis import analyze, trace_devices
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.launch.specs import build_cell


def _tensors(tree) -> list:
    """The tensors in a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storage_bytes(tensors) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in tensors}


def run_cell(cfg, shape: InputShape, mesh, rules=shmod.SINGLE_POD_RULES) -> dict:
    """The record of one (config, input shape, mesh) cell."""
    rec: dict = {"arch": cfg.name, "shape": shape.name, "mesh": "x".join(map(str, mesh.shape.values())),
                 "chips": math.prod(mesh.shape.values())}
    with shmod.use_rules(rules):
        spec = build_cell(cfg, shape, mesh)
        if spec.skip:
            rec["skipped"] = spec.skip
            return rec
        t0 = time.perf_counter()
        out, summary, analysis = analyze(spec.fn, *spec.args, known=[t for ts in spec.device_args for t in ts])
        rec["trace_seconds"] = round(time.perf_counter() - t0, 1)
    outs = _storage_bytes(_tensors(out))
    rec["memory"] = {
        "argument_bytes": spec.argument_bytes,
        "output_bytes": analysis.new_storage_bytes(_tensors(out)),
        "temp_bytes": summary.temp_bytes,
        # arguments updated in place and returned (the state, the cache), on the busiest device
        "alias_bytes": max(sum(n for key, n in _storage_bytes(ts).items() if key in outs) for ts in spec.device_args),
        "peak_estimate_bytes": spec.argument_bytes + summary.temp_bytes,
    }
    if spec.reference_argument_bytes is not None:
        rec["memory"]["reference_layout_argument_bytes"] = spec.reference_argument_bytes
    if spec.dtype_surplus_bytes is not None:
        rec["memory"]["dtype_surplus_bytes"] = spec.dtype_surplus_bytes
    rec["hlo"] = summary.to_json()
    rec["roofline"] = summary.roofline()
    return rec


def production_mesh(multi_pod: bool):
    """The production mesh over a trace's logical devices."""
    return make_production_mesh(multi_pod=multi_pod, devices=trace_devices(512 if multi_pod else 256))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in configs.ARCH_NAMES:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        skip = configs.cell_is_skipped(arch, shape)
        if skip:
            print(f"SKIP {arch} x {shape}: {skip}")
            continue
        for multi in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if multi else '16x16'}"
            try:
                rec = run_cell(configs.get_config(arch), SHAPES[shape], production_mesh(multi), rules_for(multi))
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(args.out, f"{arch}__{shape}__{rec['mesh']}.json"), "w") as f:
                        json.dump(rec, f, indent=1)
                if "skipped" in rec:
                    print(f"SKIP {tag}: {rec['skipped']}", flush=True)
                    continue
                r = rec["roofline"]
                print(
                    f"OK {tag}: trace={rec['trace_seconds']}s "
                    f"compute={r['compute_seconds']*1e3:.2f}ms "
                    f"memory={r['memory_seconds']*1e3:.2f}ms "
                    f"collective={r['collective_seconds']*1e3:.2f}ms "
                    f"dominant={r['dominant']} "
                    f"mem/dev={rec['memory']['peak_estimate_bytes']/2**30:.2f}GiB",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
