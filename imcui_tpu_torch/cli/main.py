"""Command line. Counterpart of ``imcui_tpu/cli/main.py`` on ``argparse``:
the same group options (``--server-name/-s``, ``--server-port/-p``,
``--config/-c``, ``--example-data-root/-d``, ``--verbose/-v``,
``--version``), the same config resolution order and the ``serve``,
``match`` and ``eval pose`` commands, each with ``--device`` (``cuda`` by
default, which raises without a card; ``cpu`` runs the plain PyTorch
path).

    python -m imcui_tpu_torch.cli.main serve [--host H] [--port P] \\
        [--api-config api.yaml] [--device cuda|cpu]
    python -m imcui_tpu_torch.cli.main match a.png b.png \\
        [--matcher superpoint+lightglue] [-o pred.pkl] [--device cuda|cpu]
    python -m imcui_tpu_torch.cli.main eval pose [--corpus DIR | \\
        --pairs-json pairs.json] [--matcher superpoint+lightglue] \\
        [--subpixel] [--ransac-threshold-px 0.75] [--out runs/pose_eval] \\
        [--device cuda|cpu]

``eval`` without a command prints its help and exits with status 2, as
the JAX package's click group does. ``webui`` and ``train`` are registered
and exit with status 2 naming what they wait for. As in the JAX package,
``match`` and ``eval pose`` resolve their zoo from
``get_default_config_path()`` and ignore the group's ``--config``; from
the repository root that is ``config/app.yaml``, whose zoo is not the
packaged one.
"""

import argparse
import logging
import pickle
import sys
from pathlib import Path

from .. import __version__, logger

PROG = "imcui-tpu-torch"
WAITING = {
    "webui": "the WebUI needs the gradio package, which is not installed "
             "here; it is not ported",
    "train": "training is not ported yet (ROADMAP.md, section A.8)",
}


def get_default_config_path():
    """The first of: ./app.yaml, ./config/app.yaml, this package's
    config/app.yaml."""
    candidates = [
        Path.cwd() / "app.yaml",
        Path.cwd() / "config" / "app.yaml",
        Path(__file__).parent.parent / "config" / "app.yaml",
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        "No app.yaml found in cwd, ./config, or the package defaults."
    )


def _existing_path(value):
    if not Path(value).exists():
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


def build_parser():
    parser = argparse.ArgumentParser(
        prog=PROG, description="imcui-tpu-torch: image matching on the card "
                               "(the PyTorch/CUDA port of imcui-tpu).")
    parser.add_argument("--server-name", "-s", default=None,
                        help="Server bind address (overrides config).")
    parser.add_argument("--server-port", "-p", default=None, type=int,
                        help="Server port (overrides config).")
    parser.add_argument("--config", "-c", dest="config_path", default=None,
                        type=_existing_path,
                        help="Path to an app.yaml config.")
    parser.add_argument("--example-data-root", "-d", default=None,
                        help="Root for example image data.")
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="Verbose logging.")
    parser.add_argument("--version", action="version",
                        version=f"{PROG}, version {__version__}")
    sub = parser.add_subparsers(dest="command")
    for name in WAITING:
        sub.add_parser(name, help=f"not ported: {WAITING[name]}").add_argument(
            "rest", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    serve = sub.add_parser("serve", help="Launch the HTTP matching API.")
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", default=None, type=int)
    serve.add_argument("--api-config", default=None, type=_existing_path)
    match = sub.add_parser("match", help="Match two images.")
    match.add_argument("image0", type=_existing_path)
    match.add_argument("image1", type=_existing_path)
    match.add_argument("--matcher", default="superpoint+lightglue")
    match.add_argument("--output", "-o", default=None)
    ev = sub.add_parser(
        "eval", help="Accuracy evaluations (relative pose AUC).",
        description="Accuracy evaluations (relative pose AUC). Consumes "
                    "real MegaDepth pair lists when available, or "
                    "manufactures calibrated synthetic-pose pairs offline.")
    ev.set_defaults(eval_help=ev.print_help)
    ev_sub = ev.add_subparsers(dest="eval_command", metavar="COMMAND")
    pose = ev_sub.add_parser(
        "pose", help="Relative-pose AUC@5/10/20 through the full on-device "
                     "chain (match -> fundamental RANSAC -> essential -> "
                     "pose recovery).")
    pose.add_argument("--pairs-json", default=None, type=_existing_path,
                      help="Existing pair list (eval/megadepth schema). "
                           "Omitted = synthesise pairs from --corpus.")
    pose.add_argument("--corpus", default="runs/corpus_clean",
                      help="Photo dir for synthetic pairs.")
    pose.add_argument("--n-images", default=10, type=int)
    pose.add_argument("--n-poses", default=3, type=int,
                      help="Pose draws per image.")
    pose.add_argument("--height", default=480, type=int)
    pose.add_argument("--width", default=640, type=int)
    pose.add_argument("--matcher", default="superpoint+lightglue")
    pose.add_argument("--max-pairs", default=None, type=int)
    pose.add_argument("--ransac-threshold-px", default=0.75, type=float)
    pose.add_argument("--subpixel", action="store_true",
                      help="Soft-argmax peak refinement on the sparse "
                           "extractor.")
    pose.add_argument("--out", default="runs/pose_eval")
    pose.add_argument("--seed", default=0, type=int)
    for cmd in (serve, match, pose):
        cmd.add_argument("--device", default="cuda",
                         help="cuda (default) or cpu")
    return parser


def serve(args):
    from ..api.server import main as serve_main

    serve_main(config_path=args.api_config, host=args.host, port=args.port,
               device=args.device)
    return 0


def match(args):
    from ..ui.utils import get_matcher_zoo, load_config, run_matching
    from ..utils.image import read_image

    config = load_config(get_default_config_path())
    zoo = get_matcher_zoo(config["matcher_zoo"])
    pred = run_matching(
        read_image(args.image0), read_image(args.image1), key=args.matcher,
        matcher_zoo=zoo, device=args.device,
    )
    n_raw = len(pred.get("mkeypoints0_orig", []))
    n_ransac = len(pred.get("mmkeypoints0_orig", []))
    print(f"raw matches: {n_raw}, ransac inliers: {n_ransac}")
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump(pred, f)
        print(f"wrote {args.output}")
    return 0


def eval_pose(args):
    import json

    from ..eval import megadepth, synthpose

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.pairs_json:
        with open(args.pairs_json) as f:
            pairs = json.load(f)
        source = args.pairs_json
    else:
        photos = sorted(
            p for p in Path(args.corpus).iterdir()
            if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".ppm",
                                    ".bmp"))[:args.n_images]
        pairs = synthpose.generate_pairs(
            photos, out_dir / "pairs", n_pose_per_image=args.n_poses,
            size=(args.height, args.width), seed=args.seed)
        source = f"synthpose({len(photos)} photos x {args.n_poses} poses)"
    result = megadepth.evaluate_matcher(
        pairs, args.matcher, max_pairs=args.max_pairs,
        ransac_threshold_px=args.ransac_threshold_px,
        feature_opts={"subpixel": True} if args.subpixel else None,
        device=args.device)
    summary = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in result.items() if k != "errors"}
    print(f"pose eval [{args.matcher}] on {source}: {json.dumps(summary)}")
    name = f"pose_{args.matcher.replace('/', '_')}.json"
    rec = {"matcher": args.matcher, "source": source, "n_pairs": len(pairs),
           **result}
    with open(out_dir / name, "w") as f:
        json.dump(rec, f)
    print(f"wrote {out_dir}/{name}")
    return 0


def main(argv=None):
    """Parse ``argv`` and run the command; the exit status."""
    args = build_parser().parse_args(argv)
    if args.verbose:
        logger.setLevel(logging.DEBUG)
    command = args.command or "webui"  # the JAX CLI's default command
    if command in WAITING:
        print(f"{PROG} {command}: {WAITING[command]}", file=sys.stderr)
        return 2
    if command == "eval":
        if args.eval_command is None:
            args.eval_help(sys.stderr)
            return 2
        return eval_pose(args)
    return {"serve": serve, "match": match}[command](args)


def run():
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(130)


if __name__ == "__main__":
    run()
