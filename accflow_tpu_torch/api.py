"""High-level inference API, counterpart of accflow_tpu/api.py: optical
flow on raw frames in three calls, on the card (or the CPU with
device="cpu"):

    from accflow_tpu_torch import FlowPipeline

    pipe = FlowPipeline.from_checkpoint(
        "acc+raft", acc_ckpt="checkpoints/acc+raft-things.pth")
    flow  = pipe.pair_flow(img1, img2)      # (H, W, 2) float32
    flows = pipe.pairs(frames)              # (T-1, H, W, 2) f_{i->i+1}
    longf = pipe.long_range(frames)         # (T-2, H, W, 2) F_{i->0}

    pipe = FlowPipeline.from_artifact("acc_raft_512.pt2")   # serving.py
    longf = pipe.long_range(frames)         # no model code or checkpoint

    stream = pipe.stream()                  # stateful per-frame serving
    for frame in video:                     # (streaming.py)
        flow = stream.send(frame)           # F_{i,0}, warm-started

The pipeline packages the protocol around the models: the preprocess
2 * (x / 255) - 1 (test_cvo.py:32-50), replicate padding to /8 dims
(ops/padding.py) and unpadding. Frames are HWC uint8 or float RGB in
[0, 255] (a leading batch or time axis is accepted; grayscale and RGBA
are taken); pass normalized=True for frames already in [-1, 1]. Results are
float32 numpy arrays. The default corr_lookup="auto" and attn_chunk=-1
pick per shape (ops/corr.py::resolve_auto_lookup,
models/gma.py::resolve_auto_attn_chunk): beyond the stored volume's budget
"auto" takes the volume-free "ondemand" lookup, so frames of any size run
(2560x1440 and up, where no stored pyramid fits the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _as_frames(images, normalized: bool, expect: str = "one") -> tuple[np.ndarray, bool]:
    """Coerce user images to float32 in [-1, 1] (`normalized` ones are
    already). expect "one": one HWC image or an NHWC batch -> (N, H, W, 3);
    "many": a sequence, a list of HWC images or a (T, H, W, 3) stack ->
    (T, 1, H, W, 3), or a (T, N, H, W, 3) batched stack as it is. Grayscale
    becomes RGB, alpha is dropped. Returns (array, had_batch_axis)."""
    if isinstance(images, (list, tuple)):
        arrs = [np.asarray(a) for a in images]
        shapes = {a.shape for a in arrs}
        if len(shapes) != 1:
            raise ValueError(f"frames disagree in shape: {sorted(shapes)}")
        images = np.stack(arrs, axis=0)
    a = np.asarray(images)
    if a.ndim == 2:  # single grayscale
        a = a[..., None]
    if a.shape[-1] == 1:  # grayscale -> RGB, like cli/demo.py
        a = np.concatenate([a] * 3, axis=-1)
    if a.shape[-1] == 4:  # drop alpha
        a = a[..., :3]
    if a.shape[-1] != 3:
        raise ValueError(f"expected channels-last RGB images, got shape {a.shape}")
    if expect == "one":
        if a.ndim not in (3, 4):
            raise ValueError(f"expected one (N)HWC image, got shape {a.shape}")
        batched = a.ndim == 4
        if not batched:
            a = a[None]
    else:
        if a.ndim == 3:
            raise ValueError(
                f"expected a SEQUENCE of frames, got one HWC image {a.shape}; pass a list "
                "or a (T, H, W, 3) stack")
        if a.ndim not in (4, 5):
            raise ValueError(f"expected (T[, N], H, W, 3) frames, got {a.shape}")
        batched = a.ndim == 5
        if not batched:
            a = a[:, None]
    a = a.astype(np.float32)
    if not normalized:
        if a.size:
            # Guard the classic footguns: float frames in [0, 1]
            # (matplotlib/skimage convention) or already in [-1, 1] would be
            # silently crushed to ~-1 by the [0, 255] preprocess.
            amin, amax = float(a.min()), float(a.max())
            if amin < 0.0:
                raise ValueError(
                    f"float frames span [{amin:.3g}, {amax:.3g}] — they look "
                    "already normalized; pass normalized=True"
                )
            if amax <= 1.0 and np.issubdtype(np.asarray(images).dtype, np.floating):
                raise ValueError(
                    f"float frames span [{amin:.3g}, {amax:.3g}] — they look "
                    "[0, 1]-scaled; scale to [0, 255] or pass normalized=True "
                    "for [-1, 1] input"
                )
        a = 2.0 * (a / 255.0) - 1.0  # test_cvo.py:32-50 preprocess
    return a, batched


def _numpy(x) -> np.ndarray:
    return x.float().cpu().numpy()


class FlowPipeline:
    """Optical-flow inference over a flow estimator (RAFT or GMA,
    models.FlowEstimator) and, with an AccFlow accumulator `acc`, the
    long-range accumulation. Build with from_checkpoint / from_artifact,
    or from models you hold. iters: the estimator's GRU iterations per
    solve."""

    def __init__(self, est, acc=None, iters: int = 12):
        self.est = est
        self.acc = acc
        self.iters = iters

    # -- construction -----------------------------------------------------

    @classmethod
    def from_checkpoint(cls, model_name: str = "raft", ofe_ckpt: Optional[str] = None,
                        acc_ckpt: Optional[str] = None, compute_dtype: str = "bfloat16",
                        iters: int = 12, corr_lookup: str = "auto", attn_chunk: int = -1,
                        device=None, **cfg_overrides) -> "FlowPipeline":
        """Build from reference .pth checkpoints or .npz param trees, as the
        CLIs take them, on `device` (default cuda). model_name: "raft" /
        "gma" picks the estimator (substring dispatch); an "acc" in it (e.g.
        "acc+gma") or an acc_ckpt adds the accumulator for long_range and
        stream. Without checkpoints the weights are drawn from seeds 0 (the
        estimator) and 1 (AccFlow): for smoke runs only."""
        from accflow_tpu_torch.convert import (
            load_accflow_checkpoint,
            load_flow_estimator_checkpoint,
        )
        from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow

        cfg_overrides.setdefault("iters", iters)
        est = build_flow_estimator(model_name, compute_dtype=compute_dtype, device=device,
                                   corr_lookup=corr_lookup, attn_chunk=attn_chunk,
                                   **cfg_overrides)
        acc = None
        if acc_ckpt is not None or "acc" in model_name.lower():
            if acc_ckpt and ofe_ckpt:
                raise ValueError("pass acc_ckpt OR ofe_ckpt, not both: the acc+* checkpoints "
                                 "already contain the OFE weights")
            acc = init_accflow(AccFlowConfig(compute_dtype=compute_dtype, ofe_iters=iters),
                               seed=1, device=device)
            if acc_ckpt:
                load_accflow_checkpoint(acc_ckpt, acc, est.model)
        if ofe_ckpt:
            load_flow_estimator_checkpoint(ofe_ckpt, est.model)
        return cls(est, acc, iters=iters)

    @classmethod
    def from_artifact(cls, path: str, device=None) -> "ArtifactPipeline":
        """An exported clip artifact (cli.export_serving, serving.py) on
        `device` (default cuda): long_range() with the weights in the
        program, no model code or checkpoint."""
        return ArtifactPipeline(path, device=device)

    @classmethod
    def from_streaming_artifact(cls, path: str, normalized: bool = False, device=None):
        """A streaming session from an exported streaming artifact
        (cli.export_serving --streaming): the send() surface of stream()."""
        from accflow_tpu_torch.streaming import FlowStream, load_streaming_artifact

        return FlowStream(load_streaming_artifact(path, device=device), normalized=normalized)

    # -- inference --------------------------------------------------------

    def _pair(self, image1, image2, normalized: bool):
        """Both images as (N, H, W, 3), padded; with the padder and batchedness."""
        from accflow_tpu_torch.ops.padding import InputPadder

        i1, batched = _as_frames(image1, normalized, "one")
        i2, batched2 = _as_frames(image2, normalized, "one")
        if i1.shape != i2.shape or batched != batched2:
            raise ValueError(f"pair shapes disagree: {i1.shape} vs {i2.shape}")
        padder = InputPadder(i1.shape)
        return padder.pad_np(i1), padder.pad_np(i2), padder, batched

    def pair_flow(self, image1, image2, normalized: bool = False) -> np.ndarray:
        """Flow image1 -> image2: HWC images give (H, W, 2), NHWC (N, H, W, 2)."""
        p1, p2, padder, batched = self._pair(image1, image2, normalized)
        out = self.est.forward(p1, p2, iters=self.iters, final_only=True)
        flow = _numpy(padder.unpad(out["flow_up"]))
        return flow if batched else flow[0]

    def occlusion(self, image1, image2, normalized: bool = False):
        """(flow_fw, occ_fw): the image1 -> image2 flow and the {0, 1} float
        mask of pixels occluded in image2 (1 = occluded), from the
        forward-backward check of the eval protocol (test_cvo.py:53-78,
        ops/occlusion.py::calc_occ_mask). Both directions in one batched
        solve. Each (H, W, .) for HWC inputs, (N, H, W, .) for NHWC."""
        from accflow_tpu_torch.ops.occlusion import calc_occ_mask

        p1, p2, padder, batched = self._pair(image1, image2, normalized)
        n = p1.shape[0]
        both = self.est.forward(np.concatenate([p1, p2]), np.concatenate([p2, p1]),
                                iters=self.iters, final_only=True)["flow_up"]
        fwd, bwd = both[:n], both[n:]
        _, occ_fw = calc_occ_mask(bwd, fwd)
        flow, occ = (_numpy(padder.unpad(x)) for x in (fwd, occ_fw))
        return (flow, occ) if batched else (flow[0], occ[0])

    def _clip(self, frames, normalized: bool, least: int, what: str):
        from accflow_tpu_torch.ops.padding import InputPadder

        clip, batched = _as_frames(frames, normalized, "many")
        if clip.shape[0] < least:
            raise ValueError(f"{what} needs >= {least} frames, got {clip.shape[0]}")
        padder = InputPadder(clip.shape)
        return padder.pad_np(clip), padder, batched

    def pairs(self, frames, warm_start: bool = True, normalized: bool = False) -> np.ndarray:
        """Consecutive-pair flows [f_{0->1}, ..., f_{T-2 -> T-1}] over a
        sequence (a list of HWC images or a (T, H, W, 3) stack: (T-1, H, W, 2);
        (T, N, H, W, 3): (T-1, N, H, W, 2)), each solve warm-started from the
        previous flow advected along itself (train/evaluate.py::evaluate_sequence)."""
        from accflow_tpu_torch.train.evaluate import evaluate_sequence

        padded, padder, batched = self._clip(frames, normalized, 2, "pairs()")
        flows = _numpy(padder.unpad(evaluate_sequence(self.est, padded, iters=self.iters,
                                                      warm_start=warm_start)))
        return flows if batched else flows[:, 0]

    def _need_acc(self, what: str) -> None:
        if self.acc is None:
            raise ValueError(f"{what} needs accumulator weights: build the pipeline with "
                             "from_checkpoint('acc+raft', acc_ckpt=...)")

    def long_range(self, frames, normalized: bool = False) -> np.ndarray:
        """Long-range flows [F_{2->0}, ..., F_{T-1 -> 0}] by AccFlow's
        backward accumulation over the clip (>= 3 frames, as in pairs());
        returns (T-2, [N,] H, W, 2)."""
        from accflow_tpu_torch.models.accflow import accflow_forward

        self._need_acc("long_range()")
        padded, padder, batched = self._clip(
            frames, normalized, 3, "long_range() (accumulation starts at F_{2->0})")

        def ofe(image1, image2, flow_init=None):
            return self.est.forward(image1, image2, iters=self.iters, flow_init=flow_init,
                                    final_only=True)["flow_up"]

        outs = accflow_forward(self.acc, padded, ofe_pairs=self.est.pairs_fn(iters=self.iters),
                               ofe=ofe)
        outs = _numpy(padder.unpad(outs))
        return outs if batched else outs[:, 0]

    def stream(self, iters: Optional[int] = 6, normalized: bool = False,
               ini_init: str = "ini"):
        """A stateful streaming session (streaming.py): long-range flows
        F_{i,0} over an unbounded stream, one frame at a time, each step
        warm-started. iters: the estimator's iterations per step (6, the
        serving count; None for this pipeline's). On the card each push
        replays a CUDA graph of the step. Needs accumulator weights.

            stream = pipe.stream()
            for frame in video:
                flow = stream.send(frame)   # None for the first 2 frames
        """
        from accflow_tpu_torch.models import FlowEstimator
        from accflow_tpu_torch.streaming import FlowStream, StreamAccumulator

        self._need_acc("stream()")
        est = FlowEstimator(self.est.name, self.est.model,
                            iters=self.iters if iters is None else iters)
        return FlowStream(StreamAccumulator(est, self.acc, ini_init=ini_init),
                          normalized=normalized)


class ArtifactPipeline:
    """long_range() through a saved clip artifact (serving.py) on `device`
    (default cuda). The artifact's (T, N, H, W, 3) input is fixed: exactly T
    frames, and the padded frame size must match. A fixed batch N is filled
    by repeating the last sample; an artifact with a symbolic batch
    (exported with --batch 0) takes any batch as it is."""

    def __init__(self, path: str, device=None):
        from accflow_tpu_torch.device import resolve_device
        from accflow_tpu_torch.serving import load_exported, serve_exported

        device = resolve_device(device)
        self.path = path
        exported = load_exported(path)
        (spec,) = [node.meta["val"] for node in exported.graph.nodes
                   if node.op == "placeholder"
                   and node.name in exported.graph_signature.user_inputs]
        self.clip_shape = tuple(spec.shape)  # (T, N, H, W, 3); N may be symbolic
        self._fn = serve_exported(exported, device)

    def long_range(self, frames, normalized: bool = False) -> np.ndarray:
        """frames as in FlowPipeline.pairs(); returns (T-2, [N,] H, W, 2)."""
        from accflow_tpu_torch.ops.padding import InputPadder

        t, n, h, w, _ = self.clip_shape
        fixed_batch = isinstance(n, int)
        clip, batched = _as_frames(frames, normalized, "many")
        if clip.shape[0] != t:
            raise ValueError(f"artifact expects a {t}-frame clip, got {clip.shape[0]}")
        if fixed_batch and clip.shape[1] > n:
            raise ValueError(f"artifact batch is {n}, got {clip.shape[1]}: re-export with a "
                             "larger batch (or --batch 0 for a symbolic one)")
        padder = InputPadder(clip.shape)
        padded = padder.pad_np(clip)
        if padded.shape[2:4] != (h, w):
            raise ValueError(
                f"artifact was exported for {h}x{w} frames; these are {padded.shape[2]}x"
                f"{padded.shape[3]} after /8 padding: re-export with --size to match")
        nb = clip.shape[1]
        if fixed_batch and nb < n:
            padded = np.concatenate([padded, np.repeat(padded[:, -1:], n - nb, axis=1)], axis=1)
        outs = _numpy(padder.unpad(self._fn(padded))[:, :nb])
        return outs if batched else outs[:, 0]


__all__ = ["FlowPipeline", "ArtifactPipeline"]
