"""The command line: render a scene to EXR, or recover its parameters.

Counterpart of ``phosphorus_mk2_tpu/cli.py``, with the same flags, the
same defaults and the same printed lines:

    python -m phosphorus_mk2_tpu_torch.cli scene.yaml -o out.exr -s 16 -d 4
    python -m phosphorus_mk2_tpu_torch.cli builtin:cornell_box -c ...   # on the CPU

Flags of the reference CLI (reference src/core.cpp:37-90):
  -o/--output, -s/--samples, -d/--depth, -p/--paths-per-sample,
  -1/--single (one device), -c/--host-only (CPU), --progressive,
  --normals, -v/--verbose
plus the JAX package's additions (--spp-per-pass, --no-bvh, --pallas,
--seed, --checkpoint-dir, --width/--height overrides, --png preview,
--optimize). The render runs on the cards; ``-c`` is the only way to the
CPU, and without it a host with no card raises before anything is read
or written. Every flag reaches ``Options``: ``--spp-batch`` folds
samples into one wavefront and ``--remat`` checkpoints each bounce under
autograd (a render has none, so it changes nothing there), as in the JAX
package; ``--pallas`` (the CUDA brute tracer always runs its hand
kernels), ``--depth-unroll`` and ``--sample-unroll`` (scan unrolls: the
port's loops are eager) are ignored.

Pipeline mirrors the reference main() (src/core.cpp:125-187): import
scene -> build device scene (+BVH) -> devices -> render passes -> write
EXR, with wall-clock timing printed like the reference's "Rendering
time" (src/core.cpp:173-177).
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phosphorus_mk2_tpu_torch",
        description="CUDA differentiable path tracer (the PyTorch port of "
        "phosphorus_mk2_tpu)",
    )
    p.add_argument("scene", help="YAML scene file (or builtin: scene name)")
    p.add_argument("-o", "--output", default="out.exr")
    p.add_argument("-s", "--samples", type=int, default=16)
    p.add_argument("-d", "--depth", type=int, default=9)
    p.add_argument("-p", "--paths-per-sample", type=int, default=1)
    p.add_argument("-1", "--single", action="store_true", help="use one device")
    p.add_argument("-c", "--host-only", action="store_true", help="force CPU")
    p.add_argument("--progressive", action="store_true")
    p.add_argument("--normals", action="store_true", help="write normals AOV")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--spp-per-pass", type=int, default=4)
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--pallas", action="store_true")
    p.add_argument(
        "--mis",
        action="store_true",
        help="NEE/BSDF multiple importance sampling (deviation from the "
        "reference, which has none; drops its (e*4) NEE factor)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--spp-batch", type=int, default=1,
        help="samples folded into one wavefront (bigger waves amortize "
        "the per-launch floor; costs HBM)",
    )
    p.add_argument(
        "--depth-unroll", type=int, default=0,
        help="bounce-scan unroll; 0 = auto (full unroll for depth <= 8)",
    )
    p.add_argument(
        "--sample-unroll", type=int, default=0,
        help="sample-scan unroll; 0 = auto",
    )
    p.add_argument("--remat", action="store_true",
                   help="checkpoint the bounce body (memory vs recompute)")
    p.add_argument(
        "--aniso-taps", type=int, default=0,
        help="anisotropic texture filtering: probes along the footprint "
        "major axis (0 = isotropic trilinear mips)",
    )
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--png", default=None, help="also write a tonemapped PNG")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    # --- inverse rendering (BASELINE config 5 as a product feature) ---
    p.add_argument(
        "--optimize", default=None, metavar="TARGET",
        help="inverse-rendering mode: recover scene parameters by "
        "gradient descent against this target image (EXR or PNG) "
        "instead of rendering",
    )
    p.add_argument(
        "--train", default="emission,lobe_weight",
        help="comma-separated trainable fields for --optimize "
        "(emission,lobe_weight,lobe_param,vertices,normals)",
    )
    p.add_argument("--steps", type=int, default=100,
                   help="gradient steps for --optimize")
    p.add_argument("--lr", type=float, default=5e-2,
                   help="Adam learning rate for --optimize")
    p.add_argument(
        "--recovered-out", default=None,
        help="npz path for the recovered parameters (--optimize); "
        "default <output>.params.npz",
    )
    return p


BUILTIN_SCENES = ("sphere_in_box", "cornell_box", "multi_bsdf_scene")


def load_scene(name: str):
    if name.startswith("builtin:"):
        import phosphorus_mk2_tpu_torch.scenes as scenes

        builder = name.split(":", 1)[1]
        if builder not in BUILTIN_SCENES:
            raise SystemExit(f"unknown builtin scene {builder!r}; have {BUILTIN_SCENES}")
        return getattr(scenes, builder)()
    from phosphorus_mk2_tpu_torch.io.yaml_scene import import_scene

    return import_scene(name)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.device import resolve_device
    from phosphorus_mk2_tpu_torch.io.exr import write_film, write_png
    from phosphorus_mk2_tpu_torch.renderer import Renderer

    # the cards, or the CPU when asked; no card raises here, before any
    # file is read or written
    device = resolve_device("cpu" if args.host_only else "cuda")

    t_import = time.time()
    scene = load_scene(args.scene)
    if args.width:
        scene.camera.width = args.width
    if args.height:
        scene.camera.height = args.height
    if args.verbose:
        print(f"Imported scene in {time.time() - t_import:.2f}s "
              f"({len(scene.meshes)} meshes, {len(scene.materials)} materials)")

    options = Options(
        output=args.output,
        samples_per_pixel=args.samples,
        paths_per_sample=args.paths_per_sample,
        path_depth=args.depth,
        progressive=args.progressive,
        render_normals=args.normals,
        verbose=args.verbose,
        samples_per_pass=args.spp_per_pass,
        use_bvh=not args.no_bvh,
        use_pallas=args.pallas,
        mis=args.mis,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        spp_batch=args.spp_batch,
        depth_unroll=args.depth_unroll,
        sample_unroll=args.sample_unroll,
        remat=args.remat,
        aniso_taps=args.aniso_taps,
    )

    n_devices = 1 if args.single else None
    if args.optimize:
        return run_optimize(args, scene, options, n_devices, device)
    renderer = Renderer(scene, options, n_devices=n_devices, device=device)
    if args.verbose:
        print(f"Devices: {renderer.mesh.size} x {device.type}")

    t0 = time.time()
    if args.progressive and args.png:
        # stream tonemapped previews per pass (the reference's
        # progressive flag is parsed but unused, src/options.hpp:18-20 —
        # here it works)
        film = None
        for film, done in renderer.passes():
            write_png(args.png, film["color"])
            if args.verbose:
                print(f"  progressive preview: {done} spp -> {args.png}")
    else:
        film = renderer.render()
    # every film is on the host: the device work is done
    dt = time.time() - t0
    rays = (
        scene.camera.width * scene.camera.height * args.samples * args.depth * 2
    )
    print(f"Rendering time: {dt:.2f}s ({rays / dt / 1e6:.2f} Mrays/s nominal)")

    write_film(args.output, film if args.normals else {k: film[k] for k in ("color", "alpha")})
    if args.png:
        write_png(args.png, film["color"])
    if args.verbose:
        print(f"Wrote {args.output}")
    return 0


def run_optimize(args, scene, options, n_devices, device) -> int:
    """Inverse rendering from the CLI: BASELINE config 5 with one
    command. Stamped optimizer checkpoints (step + params + Adam state)
    land in --checkpoint-dir every --checkpoint-every steps and resume
    automatically; the file is the JAX package's ``optimizer.npz``."""
    import os

    import numpy as np

    from phosphorus_mk2_tpu_torch.io.exr import read_exr, write_png
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer

    if args.optimize.lower().endswith((".png", ".jpg", ".jpeg")):
        from PIL import Image

        img = np.asarray(
            Image.open(args.optimize).convert("RGB"), np.float32
        ) / 255.0
        target = img ** 2.2  # undo the writer's gamma
    else:
        ch = read_exr(args.optimize)
        target = np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)
    h, w = target.shape[:2]
    if (scene.camera.width, scene.camera.height) != (w, h):
        if args.verbose:
            print(f"resizing camera to target {w}x{h}")
        scene.camera.width, scene.camera.height = w, h

    trainable = tuple(f for f in args.train.split(",") if f)
    inv = InverseRenderer(
        scene,
        target,
        trainable=trainable,
        learning_rate=args.lr,
        spp=max(1, options.samples_per_pass),
        max_depth=options.path_depth,
        use_bvh=options.use_bvh,
        n_devices=n_devices,
        seed=options.seed,
        device=device,
    )
    ck_path = None
    start = 0
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        ck_path = os.path.join(args.checkpoint_dir, "optimizer.npz")
        if os.path.exists(ck_path):
            inv.load_checkpoint(ck_path)
            start = inv._step_count
            if args.verbose:
                print(f"resumed optimizer checkpoint at step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        loss = inv.step()  # a float: the step's device work is done
        if args.verbose and (i + 1) % max(1, args.steps // 20) == 0:
            print(f"step {i + 1}/{args.steps}: loss={loss:.6f}", flush=True)
        if (
            ck_path
            and args.checkpoint_every
            and (i + 1) % args.checkpoint_every == 0
        ):
            inv.save_checkpoint(ck_path)
    if ck_path:
        inv.save_checkpoint(ck_path)
    dt = time.time() - t0
    print(f"Optimization time: {dt:.2f}s ({args.steps - start} steps)")

    out = args.recovered_out or args.output + ".params.npz"
    np.savez(out, **{k: v.detach().cpu().numpy() for k, v in inv.params.items()})
    print(f"Wrote recovered parameters: {out}")
    if args.png:
        film = inv.render_current(spp=options.samples_per_pass)
        write_png(args.png, film)
        print(f"Wrote recovered-scene preview: {args.png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
