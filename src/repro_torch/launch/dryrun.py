"""Production dry-run driver (the JAX package's `launch/dryrun.py`).

Runs one rank's step of every (architecture × input shape) cell on the
production meshes — (16, 16) single-pod and (2, 16, 16) multi-pod — with
full placements, on fake tensors in a fake process group of 256 or 512
ranks (`launch/dryrun_lib.py`), printing the op statistics and memory and
writing per-cell JSON for the roofline report (render with
`repro_torch.launch.roofline`). No device is needed.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both

A process group is global, so every cell runs in a fresh process of its
own (`--all`, `--mesh both`: one subprocess a cell; resumable: a cell with
a result JSON is skipped unless `--force`). `--route card` (the default)
traces the card's route (fake CUDA tensors, K1/K2 as custom ops; it needs
a CUDA build of torch, not a card); `--route plain` the plain versions on
fake CPU tensors. `--out` defaults to `build/dryrun` (git-ignored). The
JAX driver's `--save-hlo` has nothing to save here and is not taken.
"""
import argparse
import json
import os
import subprocess
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="build/dryrun")
    ap.add_argument("--variant", type=str, default="baseline")
    ap.add_argument("--remat", type=str, default="full")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--mesh-shape", type=str, default=None,
                    help="perf-variant mesh remap, e.g. 64x4")
    ap.add_argument("--sharding-plan", type=str, default="rules",
                    help="rules|search|<plan.json>: plan source for every "
                         "tree of the cell (dist/plan.py)")
    ap.add_argument("--route", choices=["card", "plain"], default="card",
                    help="card: the kernels' route on fake CUDA tensors; "
                         "plain: the plain versions on fake CPU tensors")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have a result JSON")
    return ap.parse_args(argv)


def cell_done(out_dir, arch, shape, mesh, variant):
    from repro_torch.launch.dryrun_lib import cell_tag
    tag = cell_tag(arch, shape, mesh == "multi", variant)
    return os.path.exists(os.path.join(out_dir, tag + ".json"))


def cell_command(args, arch: str, shape: str, mesh: str):
    """The command that runs one cell in a fresh process."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--out", args.out, "--variant", args.variant,
           "--remat", args.remat, "--route", args.route]
    if args.microbatch is not None:
        cmd += ["--microbatch", str(args.microbatch)]
    if args.mesh_shape:
        cmd += ["--mesh-shape", args.mesh_shape]
    if args.sharding_plan != "rules":
        cmd += ["--sharding-plan", args.sharding_plan]
    return cmd


def main(argv=None):
    args = parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    if args.all:
        from repro_torch import configs
        from repro_torch.launch import dryrun_lib
        failures = []
        for mname in meshes:
            for arch in configs.ARCH_IDS:
                cfg = configs.get(arch)
                for shape in configs.SHAPES:
                    if dryrun_lib.long_context_skip(cfg, shape):
                        print(f"SKIP {arch} {shape.name} {mname} "
                              "(full attention)")
                        continue
                    if not args.force and cell_done(args.out, arch,
                                                    shape.name, mname,
                                                    args.variant):
                        print(f"done {arch} {shape.name} {mname} (cached)")
                        continue
                    print(f"RUN  {arch} {shape.name} {mname} ...",
                          flush=True)
                    r = subprocess.run(cell_command(args, arch, shape.name,
                                                    mname))
                    if r.returncode != 0:
                        failures.append((arch, shape.name, mname))
                        print(f"FAIL {arch} {shape.name} {mname}",
                              flush=True)
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all cells traced OK")
        return

    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all)")
    if len(meshes) > 1:
        # one fake process group a process: each mesh in its own
        for mname in meshes:
            r = subprocess.run(cell_command(args, args.arch, args.shape,
                                            mname))
            if r.returncode:
                sys.exit(r.returncode)
        return
    from repro_torch.launch import dryrun_lib
    res = dryrun_lib.run_cell(
        args.arch, args.shape, meshes[0] == "multi", args.out,
        variant=args.variant, remat=args.remat, microbatch=args.microbatch,
        mesh_shape=args.mesh_shape, sharding_plan=args.sharding_plan,
        route=args.route)
    print(json.dumps(
        {k: res[k] for k in ("arch", "shape", "mesh", "route", "terms",
                             "dominant", "roofline_fraction",
                             "useful_flops_ratio")}, indent=1))
    print("memory:", json.dumps(res["memory"], indent=1))
    print("collectives: " + json.dumps(res["collectives"]))
    print("kernels: " + json.dumps(res["kernel_counts"]))
    print("op stats: flops/dev=%.3e bytes/dev=%.3e coll/dev=%.3e"
          % (res["flops_per_device"], res["bytes_per_device"],
             res["collective_bytes_per_device"]))


if __name__ == "__main__":
    main()
