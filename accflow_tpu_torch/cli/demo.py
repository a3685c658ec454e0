"""Flow inference on raw image frames (demo CLI) of the port, counterpart
of accflow_tpu/cli/demo.py: point it at a directory of frames (or an
explicit file list) and get .flo flows plus Middlebury-colour PNGs.

    # consecutive-pair flows f_{i->i+1}, warm-started between pairs
    python -m accflow_tpu_torch.cli.demo --frames demo/ --ofe raft \\
        --ofe_ckpt checkpoints/raft-things.pth --out out/ --warm_start

    # long-range flows F_{i->0} by backward accumulation over the clip
    python -m accflow_tpu_torch.cli.demo --frames demo/ --mode long \\
        --ofe gma --acc_ckpt checkpoints/acc+gma-things.pth --out out/

    # the same from an exported artifact (cli.export_serving; a clip or a
    # streaming one, told apart by the streaming artifact's magic)
    python -m accflow_tpu_torch.cli.demo --frames demo/ \\
        --artifact acc_raft_512.pt2 --out out/

Frames are sorted lexicographically (.png/.jpg/.ppm read with PIL, .bin
with numpy.load); any size is accepted (replicate-padded to /8 and unpadded
on output). Images are normalized 2*(x/255)-1 exactly like the protocol
preprocess (test_cvo.py:32-50). --video extracts frames from a video file
first (OpenCV). --device picks the card (cuda, the default) or the CPU.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


IMG_EXTS = (".png", ".jpg", ".jpeg", ".ppm")  # in a directory; explicit files any read_gen takes


def extract_video_frames(video: str, out_dir: str, stride: int, limit: int):
    """Decode every `stride`-th frame of a video to PNGs (up to `limit`);
    returns the sorted file list."""
    import cv2

    if stride < 1:
        raise SystemExit(f"--video_stride must be >= 1, got {stride}")
    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video: {video}")
    os.makedirs(out_dir, exist_ok=True)
    files, idx = [], 0
    while len(files) < limit:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            path = osp.join(out_dir, f"frame_{idx:06d}.png")
            cv2.imwrite(path, frame)  # BGR on disk; read back as RGB below
            files.append(path)
        idx += 1
    cap.release()
    if len(files) < 2:
        raise SystemExit(f"extracted only {len(files)} frames from {video}")
    return files


def collect_frames(paths):
    """Expand dir-or-file arguments into a sorted list of image paths."""
    files = []
    for p in paths:
        if osp.isdir(p):
            files.extend(
                osp.join(p, f)
                for f in sorted(os.listdir(p))
                if f.lower().endswith(IMG_EXTS)
            )
        else:
            files.append(p)
    if len(files) < 2:
        raise SystemExit(f"need at least 2 frames, found {len(files)}: {paths}")
    return files


def load_frames(files):
    """Read frames -> (T, 1, H, W, 3) float32 normalized to [-1, 1]."""
    import numpy as np

    from accflow_tpu_torch.utils.frame_io import read_gen

    imgs = []
    for f in files:
        a = np.asarray(read_gen(f)).astype(np.float32)
        if a.ndim == 2:  # grayscale
            a = np.stack([a] * 3, axis=-1)
        a = a[..., :3]  # drop alpha
        imgs.append(2.0 * (a / 255.0) - 1.0)
    shapes = {a.shape for a in imgs}
    if len(shapes) != 1:
        raise SystemExit(f"frames disagree in size: {sorted(shapes)}")
    return np.stack(imgs, axis=0)[:, None]


def save_flow(out_dir, name, flow, viz: bool):
    import numpy as np

    from accflow_tpu_torch.utils.frame_io import write_flow

    flow = np.asarray(flow, dtype=np.float32)
    write_flow(osp.join(out_dir, name + ".flo"), flow)
    if viz:
        from PIL import Image

        from accflow_tpu_torch.utils.flow_viz import flow_to_image

        Image.fromarray(flow_to_image(flow)).save(
            osp.join(out_dir, name + ".png")
        )


def run_streaming_artifact(args):
    """Unbounded long-range inference through a STREAMING artifact
    (export_serving --streaming): frames are fed one at a time; the
    padded frame size must match the export."""
    from accflow_tpu_torch.api import FlowPipeline

    stream = FlowPipeline.from_streaming_artifact(args.artifact, normalized=True,
                                                  device=args.device)
    files = collect_frames(args.frames)
    frames = load_frames(files)
    os.makedirs(args.out, exist_ok=True)
    stem = lambda i: osp.splitext(osp.basename(files[i]))[0]
    n_out = 0
    for i in range(frames.shape[0]):
        out = stream.send(frames[i])
        if out is None:
            continue
        save_flow(args.out, f"{stem(i)}_to_{stem(0)}", out[0],
                  viz=not args.no_viz)
        n_out += 1
    print(f"[demo] wrote {n_out} streamed long-range flows to {args.out} "
          f"(streaming artifact {args.artifact})")


def run_artifact(args):
    """Long-range inference through a serialized serving artifact
    (api.ArtifactPipeline: exactly T frames are consumed — extras are
    reported and dropped — and the frame size must match the export).
    Streaming artifacts (export_serving --streaming) are detected by
    magic and routed to the per-frame surface."""
    from accflow_tpu_torch.api import ArtifactPipeline
    from accflow_tpu_torch.streaming import _MAGIC

    with open(args.artifact, "rb") as f:
        if f.read(len(_MAGIC)) == _MAGIC:
            return run_streaming_artifact(args)

    pipe = ArtifactPipeline(args.artifact, device=args.device)
    t = pipe.clip_shape[0]

    files = collect_frames(args.frames)
    if len(files) < t:
        raise SystemExit(
            f"artifact expects a {t}-frame clip, found {len(files)} frames"
        )
    if len(files) > t:
        print(f"[demo] artifact clip length is {t}; using the first {t} "
              f"of {len(files)} frames")
        files = files[:t]
    frames = load_frames(files)

    try:
        outs = pipe.long_range(frames, normalized=True)
    except ValueError as e:
        raise SystemExit(str(e))

    os.makedirs(args.out, exist_ok=True)
    stem = lambda i: osp.splitext(osp.basename(files[i]))[0]
    for i in range(t - 2):
        save_flow(args.out, f"{stem(i + 2)}_to_{stem(0)}", outs[i, 0],
                  viz=not args.no_viz)
    print(f"[demo] wrote {t - 2} accumulated flows to {args.out} "
          f"(artifact {args.artifact})")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=str, nargs="+", default=None,
                        help="frame directory or explicit image files "
                        "(sorted lexicographically)")
    parser.add_argument("--video", type=str, default=None,
                        help="video file to extract frames from instead "
                        "of --frames (OpenCV decode)")
    parser.add_argument("--video_stride", type=int, default=1,
                        help="keep every Nth video frame")
    parser.add_argument("--video_max", type=int, default=7,
                        help="max frames to extract from --video "
                        "(default 7, one reference clip)")
    parser.add_argument("--out", type=str, default="./demo_out")
    parser.add_argument("--mode", type=str,
                        choices=["pairs", "long", "stream"],
                        default="pairs",
                        help="pairs: consecutive-pair flows f_{i->i+1}; "
                        "long: accumulated long-range flows F_{i->0} "
                        "(needs --acc_ckpt weights and >= 3 frames); "
                        "stream: the same long-range flows through the "
                        "STATEFUL per-frame surface (FlowPipeline.stream "
                        "— warm-started, state on device, unbounded "
                        "stream length)")
    parser.add_argument("--stream_iters", type=int, default=6,
                        help="stream mode: OFE iterations per step "
                        "(default 6 — the warm-start serving count)")
    parser.add_argument("--ofe", type=str, choices=["raft", "gma"],
                        default="raft")
    parser.add_argument("--ofe_ckpt", type=str, default=None)
    parser.add_argument("--acc_ckpt", type=str, default=None)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--compute-dtype", type=str, default="bfloat16")
    parser.add_argument("--warm_start", action="store_true",
                        help="pairs mode: initialize each solve from the "
                        "previous flow advected along itself (streaming)")
    parser.add_argument("--no_viz", action="store_true",
                        help="skip the flow-colour PNGs, write .flo only")
    parser.add_argument("--occ", action="store_true",
                        help="pairs mode: also estimate backward flows "
                        "and write bidirectional occlusion masks "
                        "(*_occ.png; doubles the solves, ignores "
                        "--warm_start)")
    parser.add_argument("--corr_lookup", type=str, default="auto",
                        help="correlation lookup (ops/corr.py). Default "
                        "'auto': the stored volume while it fits its "
                        "budget, the volume-free 'ondemand' mode past "
                        "that, so any frame size runs; or force fused, "
                        "ondemand[:chunk] or an experimental: spelling")
    parser.add_argument("--attn_chunk", type=int, default=-1,
                        help="gma only: >0 recomputes attention per query "
                        "chunk instead of storing the (HW)^2 matrix; "
                        "-1 (default) switches automatically past the "
                        "memory budget; 0 forces the dense matrix")
    parser.add_argument("--artifact", type=str, default=None,
                        help="exported serving artifact (cli.export_serving, "
                        "clip or --streaming); implies long-range mode with "
                        "the clip shape baked into the artifact")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if (args.video is None) == (args.frames is None):
        raise SystemExit("exactly one of --frames / --video is required")
    if args.video:
        args.frames = extract_video_frames(
            args.video, osp.join(args.out, "_video_frames"),
            args.video_stride, args.video_max,
        )

    if args.artifact:
        return run_artifact(args)

    files = collect_frames(args.frames)
    frames = load_frames(files)
    t = frames.shape[0]
    print(f"[demo] {t} frames {frames.shape[2]}x{frames.shape[3]} "
          f"from {args.frames}")

    from accflow_tpu_torch.api import FlowPipeline

    long_like = args.mode in ("long", "stream")
    if long_like and not args.acc_ckpt:
        print("[demo] WARNING: no --acc_ckpt; using random weights")
    if args.mode == "pairs" and not args.ofe_ckpt:
        print("[demo] WARNING: no --ofe_ckpt; using random weights")
    pipe = FlowPipeline.from_checkpoint(
        f"acc+{args.ofe}" if long_like else args.ofe,
        ofe_ckpt=args.ofe_ckpt, acc_ckpt=args.acc_ckpt,
        compute_dtype=args.compute_dtype, iters=args.iters,
        corr_lookup=args.corr_lookup, attn_chunk=args.attn_chunk,
        device=args.device,
    )

    os.makedirs(args.out, exist_ok=True)
    stem = lambda i: osp.splitext(osp.basename(files[i]))[0]

    if args.mode == "stream":
        if t < 3:
            raise SystemExit("stream mode needs >= 3 frames (got "
                             f"{t}; accumulation starts at F_{{2->0}})")
        stream = pipe.stream(iters=args.stream_iters, normalized=True)
        n_out = 0
        for i in range(t):
            out = stream.send(frames[i])
            if out is None:
                continue
            save_flow(args.out, f"{stem(i)}_to_{stem(0)}", out[0],
                      viz=not args.no_viz)
            n_out += 1
        print(f"[demo] wrote {n_out} streamed long-range flows to "
              f"{args.out} ({args.stream_iters} iters/step, warm-started)")
    elif args.mode == "long":
        if t < 3:
            raise SystemExit("long mode needs >= 3 frames (got "
                             f"{t}; accumulation starts at F_{{2->0}})")
        outs = pipe.long_range(frames, normalized=True)
        for i in range(outs.shape[0]):
            save_flow(args.out, f"{stem(i + 2)}_to_{stem(0)}", outs[i, 0],
                      viz=not args.no_viz)
        print(f"[demo] wrote {outs.shape[0]} accumulated flows to {args.out}")
    elif args.occ:
        from PIL import Image
        import numpy as np

        for i in range(t - 1):
            flow, occ = pipe.occlusion(frames[i], frames[i + 1],
                                       normalized=True)
            name = f"{stem(i)}_to_{stem(i + 1)}"
            save_flow(args.out, name, flow[0], viz=not args.no_viz)
            Image.fromarray(
                (occ[0, ..., 0] * 255).astype(np.uint8)
            ).save(osp.join(args.out, name + "_occ.png"))
        print(f"[demo] wrote {t - 1} pair flows + occlusion masks to "
              f"{args.out}")
    else:
        flows = pipe.pairs(frames, warm_start=args.warm_start,
                           normalized=True)
        for i in range(flows.shape[0]):
            save_flow(args.out, f"{stem(i)}_to_{stem(i + 1)}", flows[i, 0],
                      viz=not args.no_viz)
        print(f"[demo] wrote {flows.shape[0]} pair flows to {args.out}")


if __name__ == "__main__":
    main()
