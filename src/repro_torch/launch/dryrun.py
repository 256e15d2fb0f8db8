"""Multi-pod dry-run driver (counterpart of ``repro.launch.dryrun``).

For every (architecture × input-shape) cell, on the single-pod 16×16
mesh and the multi-pod 2×16×16 mesh:

    cell  = build_cell(arch, shape, mesh)   # fake stand-ins as DTensors
    trace = cell.trace()                    # the step run once on them
    analyze(trace, ...)                     # roofline terms, memory

The reference lowers and compiles each step and reads XLA's cost and
memory analyses; the port runs its own step once on fake tensors over a
fake process group of 256 or 512 ranks (this process is rank 0 and
stands for every rank; no collective runs and no device memory is
taken) and reads the record (``analysis/trace.py``). The terms are
H100 data-sheet predictions (``analysis/roofline.py``). ``lower_s`` is
the time to build and trace a cell; ``compile_s`` is 0 (nothing is
compiled). Results append to a JSON report that ``analysis/report_md``
renders. Failures (a sharding the port cannot run, an unmapped
collective) are bugs: the run exits nonzero listing them.

The fake group is this process's default group, so the dry run takes a
process of its own.

Usage:
  python -m repro_torch.launch.dryrun                 # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k \
      --mesh multi
  python -m repro_torch.launch.dryrun --family lm --mesh single
  python -m repro_torch.launch.dryrun --out reports.json --append
  python -m repro_torch.launch.dryrun --device cpu --arch gemma2-9b
"""
import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.analysis.roofline import H100


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks with
    this process as rank 0 (re-made where its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             hbm_limit_gb=H100["hbm_bytes"] / 2**30, device=None,
             smoke: bool = False):
    from repro_torch.device import resolve_device
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    dev = resolve_device(device)
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, smoke=smoke, device=dev)
    trace = cell.trace()
    return report(cell, trace, mesh, time.time() - t0, hbm_limit_gb)


def report(cell, trace, mesh, seconds: float,
           hbm_limit_gb=H100["hbm_bytes"] / 2**30) -> dict:
    """The report dict of a traced cell: ``analyze``'s fields, the trace
    time, the reference's HBM formula and the fit."""
    from repro_torch.analysis.roofline import analyze
    from repro_torch.launch.mesh import mesh_name

    rep = analyze(
        trace, arch=cell.arch, shape=cell.shape, mesh_name=mesh_name(mesh),
        n_devices=mesh.size(), model_flops=cell.model_flops,
        note=cell.note)
    d = rep.to_json()
    d["lower_s"] = round(seconds, 1)
    d["compile_s"] = 0.0
    ma = d["memory_analysis"]
    per_dev = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)
               + ma.get("output_size_in_bytes", 0)
               - ma.get("alias_size_in_bytes", 0))
    d["hbm_bytes_per_dev"] = int(per_dev)
    d["fits_hbm"] = bool(per_dev <= hbm_limit_gb * 2**30)
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--family", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="dryrun_reports.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--include-sssp", action="store_true",
                    help="also run the paper's SSSP configs")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs and sizes")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells, family_of

    cells = all_cells()
    if not args.include_sssp and args.arch is None and args.family is None:
        cells = [(a, s) for a, s in cells if not a.startswith("sssp-")]
    if args.arch:
        cells = [(a, s) for a, s in all_cells() if a == args.arch]
    if args.family:
        cells = [(a, s) for a, s in cells if family_of(a) == args.family]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    reports = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            reports = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in reports}

    failures = []
    for arch, shape in cells:
        for multi in meshes:
            mesh_label = "2x16x16" if multi else "16x16"
            if (arch, shape, mesh_label) in done:
                print(f"[skip] {arch} {shape} {mesh_label} (cached)")
                continue
            tag = f"{arch} × {shape} × {mesh_label}"
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                d = run_cell(arch, shape, multi, device=args.device,
                             smoke=args.smoke)
                reports.append(d)
                print(f"  ok: compile {d['compile_s']}s, "
                      f"hbm/dev {d['hbm_bytes_per_dev'] / 2**30:.2f} GiB "
                      f"(fits={d['fits_hbm']}), dominant={d['dominant']}, "
                      f"roofline={d['peak_fraction']:.1%}", flush=True)
                print(f"  memory_analysis: {d['memory_analysis']}")
                print(f"  cost: flops/dev={d['flops_per_dev']:.3e} "
                      f"bytes/dev={d['bytes_per_dev']:.3e} "
                      f"wire/dev={d['wire_bytes_per_dev']:.3e}")
                print(f"  traced in {d['lower_s']}s", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                traceback.print_exc()
            with open(args.out, "w") as f:
                json.dump(reports, f, indent=1)

    print(f"\n{len(reports)} cells traced -> {args.out}")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        sys.exit(1)


if __name__ == "__main__":
    main()
