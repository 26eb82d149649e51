"""Asset and scene converter CLI of the port (``yhair_tpu/apps/convert.py``).

  # Cem Yuksel .hair -> PLY line strands (with optional decimation)
  python -m yhair_tpu_torch.apps.convert hair2ply wig.hair wig.ply --decimate 2

  # builtin generator -> scene JSON (+ PLY strands next to it)
  python -m yhair_tpu_torch.apps.convert genscene curly_hairball scene.json \\
      --kwargs '{"n_strands": 5000}'

  # PLY -> .hair
  python -m yhair_tpu_torch.apps.convert ply2hair wig.ply wig.hair

  # OBJ mesh <-> PLY mesh
  python -m yhair_tpu_torch.apps.convert obj2ply bunny.obj bunny.ply
  python -m yhair_tpu_torch.apps.convert ply2obj bunny.ply bunny.obj

Every output is byte for byte the reference converter's. Host numpy
only: no tensor and no device is involved.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..io import hairfile, obj, ply, scene_json


def build_parser():
    p = argparse.ArgumentParser(prog="yhair-torch-convert",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    h2p = sub.add_parser("hair2ply")
    h2p.add_argument("input")
    h2p.add_argument("output")
    h2p.add_argument("--decimate", type=int, default=1,
                     help="keep every Nth strand")
    h2p.add_argument("--radius-scale", type=float, default=1.0)

    p2h = sub.add_parser("ply2hair")
    p2h.add_argument("input")
    p2h.add_argument("output")

    gs = sub.add_parser("genscene")
    gs.add_argument("generator")
    gs.add_argument("output")
    gs.add_argument("--kwargs", default="{}")

    for name in ("obj2ply", "ply2obj"):
        c = sub.add_parser(name)
        c.add_argument("input")
        c.add_argument("output")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.cmd == "hair2ply":
        h = hairfile.load(args.input)
        counts = h["segments"]
        if args.decimate > 1:
            keep = np.arange(len(counts)) % args.decimate == 0
            starts = np.concatenate([[0], np.cumsum(counts + 1)])[:-1]
            pts_idx = np.concatenate(
                [np.arange(s, s + c + 1)
                 for s, c, k in zip(starts, counts, keep) if k])
            h = {"points": h["points"][pts_idx],
                 "thickness": h["thickness"][pts_idx],
                 "segments": counts[keep]}
        # vertices stay shared within strands: emit per-strand polylines
        counts = h["segments"]
        starts = np.concatenate([[0], np.cumsum(counts + 1)])[:-1]
        lines = np.concatenate(
            [np.stack([np.arange(s, s + c), np.arange(s + 1, s + c + 1)], -1)
             for s, c in zip(starts, counts)])
        ply.save_strands(args.output, h["points"],
                         h["thickness"] * 0.5 * args.radius_scale, lines)
        print(f"wrote {args.output}: {len(counts)} strands, "
              f"{len(lines)} segments")

    elif args.cmd == "ply2hair":
        pos, rad, lines = ply.load_strands(args.input)
        # detect strand breaks: consecutive lines share a vertex
        breaks = np.where(lines[1:, 0] != lines[:-1, 1])[0]
        counts = np.diff(np.concatenate([[0], breaks + 1, [len(lines)]]))
        hairfile.save(args.output, pos, counts, rad * 2.0)
        print(f"wrote {args.output}: {len(counts)} strands")

    elif args.cmd == "genscene":
        import scenes.generators as gen
        fn = getattr(gen, args.generator)
        scene, cam = fn(**json.loads(args.kwargs))
        scene_json.save(args.output, scene, cam)
        print(f"wrote {args.output} "
              f"({scene['segments'][0].shape[0]} segments)")

    elif args.cmd in ("obj2ply", "ply2obj"):
        load = obj.load_mesh if args.cmd == "obj2ply" else ply.load_mesh
        mesh = load(args.input)
        kw = dict(normals=mesh.get("normals"))
        if args.cmd == "ply2obj":
            save, kw["texcoords"] = obj.save_mesh, mesh.get("texcoords")
        else:
            save = ply.save_mesh
        save(args.output, mesh["positions"], mesh["triangles"], **kw)
        print(f"wrote {args.output}: {len(mesh['positions'])} vertices, "
              f"{len(mesh['triangles'])} triangles")


if __name__ == "__main__":
    main()
