"""Evaluation runtime: checkpoint loading, image-pyramid inference, WIDER writer.

Port of tinyfaces_tpu/evaluation.py on the `rgb` and `jpegdct` wires:
  * `get_model` / `load_weights`: build the detector and load the port
    trainer's own checkpoint, the JAX package's .npz export, or a reference
    PyTorch .pth (utils/convert.from_reference_pth);
  * `PyramidDetector`: the fused multi-scale pyramid — per-image resize of
    the mean-padded canvas to every level on the device, one forward per
    level, top-K decode, one cross-scale NMS per image — returning a packed
    (B, K, 6) tensor whose copy to the host runs behind a CUDA event. On
    the `jpegdct` wire it takes JPEG bytes (or DCTImage, or uint8 arrays
    through PIL's transcode): the host entropy-decodes and packs them
    (data/jpegdct.py) and the device reconstructs the normalized canvas
    (ops/jpeg.py);
  * `write_results`: the WIDER per-image result tree
    <results_dir>/<event>/<img>.txt, byte for byte as the JAX writer.

`EvalConfig.resample` picks the level resampling: "linear" (the JAX
package's scale_and_translate, on the normalized canvas) or "pil" (the
reference's uint8 PIL bilinear, ops/pilresize.py: each level resized in
pixel space in float64, byte-equal to the host oracle, then normalized;
`rgb` wire only).

Not ported (each raises, naming the ROADMAP item that brings it): the
`yuv420`/`jpegdct4` wires (item 15) and `mesh`/`shard` (items 13, 15). The
2x level resizes and then convolves whatever `EvalConfig.fold_stem` says:
the folded stem (ops/stemfold.py) equals that up to summation order
(config.py:85-89) and is in ROADMAP item 15.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import jpegdct
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.data.wider_face import MEAN_PIXEL
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.models.resnet import ARCH_STAGES
from tinyfaces_tpu_torch.ops.decode import decode_scores, valid_template_mask
from tinyfaces_tpu_torch.ops.jpeg import dct_batch_to_normalized
from tinyfaces_tpu_torch.ops.nms import batched_nms_padded
from tinyfaces_tpu_torch.ops.pilresize import max_taps, resize_pil_batch
from tinyfaces_tpu_torch.ops.resize import resize_batch
from tinyfaces_tpu_torch.utils.convert import from_npz, from_reference_pth

TRANSFERS = ("rgb", "jpegdct")
_UNPORTED_TRANSFERS = {
    "yuv420": "ROADMAP item 15 (decide or drop)",
    "jpegdct4": "ROADMAP item 15 (decide or drop)",
}


def pyramid_level_sizes(h0: torch.Tensor, w0: torch.Tensor, sexp: int):
    """Per-image resize target (th, tw) for pyramid level f = 2**sexp, in
    exact integer arithmetic: the short side is int(min_side * f), a shift
    since f is a power of two, and the long side is the integer division
    int(t_short * long / short) (equal to float64 truncation for dims
    < 2^15). h0, w0: integer tensors."""
    mins = torch.minimum(h0, w0)
    tshort = (mins << sexp) if sexp >= 0 else (mins >> (-sexp))
    th = torch.where(h0 <= w0, tshort, torch.div(h0 * tshort, w0, rounding_mode="floor"))
    tw = torch.where(h0 <= w0, torch.div(w0 * tshort, h0, rounding_mode="floor"), tshort)
    return th, tw


def pyramid_level_sizes_np(hs, ws, factor: float) -> np.ndarray:
    """Host (NumPy float64) sizing for an arbitrary scale factor: exactly
    `transforms.functional.resize(img, int(min_side * factor))` (reference
    evaluation.py:44-47) — float64 truncation for the short side,
    left-associative `int(size * long / short)` for the long side, both
    floored at 1 px. Returns (B, 2) int32 [[th, tw], ...]."""
    hs = np.asarray(hs, np.int64)
    ws = np.asarray(ws, np.int64)
    mins = np.minimum(hs, ws)
    tshort = np.maximum(1, (mins * np.float64(factor)).astype(np.int64))
    th = np.where(hs <= ws, tshort,
                  np.maximum(1, ((tshort * hs) / ws).astype(np.int64)))
    tw = np.where(hs <= ws,
                  np.maximum(1, ((tshort * ws) / hs).astype(np.int64)),
                  tshort)
    return np.stack([th, tw], axis=-1).astype(np.int32)


def get_model(
    checkpoint: Optional[str | Path] = None,
    num_templates: int = 25,
    dtype: torch.dtype = torch.float32,
    arch: str = "resnet101",
    *,
    device: torch.device | str,
) -> TinyFacesDetector:
    """The detector in eval mode on `device`, with weights from
    `checkpoint` or, without one, seeded fresh weights (generator seed 0).
    `arch` selects the backbone ("resnet101" | "resnet50")."""
    model = TinyFacesDetector(num_templates=num_templates, stage_sizes=ARCH_STAGES[arch],
                              dtype=dtype)
    init_model(model, torch.Generator().manual_seed(0))
    if checkpoint:
        model.load_state_dict(load_weights(checkpoint))
    return model.to(device).eval()


def load_weights(checkpoint: str | Path) -> dict[str, torch.Tensor]:
    """state_dict from the JAX package's .npz export, a reference PyTorch
    .pth/.pt, or (any other file) the port trainer's own checkpoint
    (trainer.save_checkpoint)."""
    path = Path(checkpoint)
    if path.is_dir():
        raise ValueError(f"{path} is a directory: orbax checkpoints need JAX; export one "
                         f"with `python tools/export_weights.py {path} out.npz` and pass the .npz")
    if path.suffix == ".npz":
        return from_npz(path)
    if path.suffix in (".pth", ".pt"):
        return from_reference_pth(path)
    payload = torch.load(path.absolute(), map_location="cpu", weights_only=True)
    if not (isinstance(payload, dict) and "model" in payload):
        raise ValueError(f"Unrecognized checkpoint format: {path}")
    return payload["model"]


def _round_up_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up(x: int) -> int:
    """Adaptive shape bucketing: finer buckets for small dims, coarser for
    large ones, so the set of canvas shapes stays small while padding waste
    stays ~<25%. Tiny dims (incl. 1 px) clamp to a 64-px bucket."""
    m = max(64, min(512, 1 << max(max(x - 1, 1).bit_length() - 3, 0)))
    return ((x + m - 1) // m) * m


class PackedBatch(NamedTuple):
    """Upload-ready host half of one detector batch (pack_inputs): `host`
    is the uint8 (B, h0p, w0p, 3) canvas on the rgb wire, the (B, total)
    uint8 wire on jpegdct, in pinned memory when the detector's device is a
    GPU; hs/ws the per-image true sizes; h0p/w0p the padded canvas."""

    host: torch.Tensor
    hs: np.ndarray
    ws: np.ndarray
    h0p: int
    w0p: int


class DeviceResult(NamedTuple):
    """A batch in flight (detect_batch_async): `host` receives the packed
    (B, K, 6) [x1, y1, x2, y2, score, valid] detections; on a GPU the copy
    is complete once `event` has completed (None on the CPU)."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]


class PyramidDetector:
    """Multi-scale detector over one device.

    `trace`: set to a list to record, on a GPU, one (phase, CUDA event) pair
    after each phase of every batch — "upload", "unpack" (the normalized
    canvas from the uint8 pixels or the jpegdct wire), then "resize s",
    "forward s" and "decode s" per level s, "nms" and "d2h"; the time of a
    phase is the elapsed time from the previous event. None (the default)
    records nothing."""

    def __init__(
        self,
        model: TinyFacesDetector,
        templates: np.ndarray,
        cfg: DetectorConfig | None = None,
        ec: EvalConfig | None = None,
        *,
        device: torch.device | str,
        mesh=None,
        transfer: str = "rgb",
        shard: str = "batch",
    ):
        if transfer in _UNPORTED_TRANSFERS:
            raise ValueError(f"transfer={transfer!r} is not ported yet: "
                             f"{_UNPORTED_TRANSFERS[transfer]}; use one of {TRANSFERS}")
        if transfer not in TRANSFERS:
            raise ValueError(f"unknown transfer mode {transfer!r}")
        if mesh is not None or shard != "batch":
            raise ValueError("mesh/shard (multi-device pyramid) is not ported yet: ROADMAP "
                             "item 13 (batch sharding) and item 15 (spatial sharding)")
        self.ec = ec or EvalConfig()
        if self.ec.resample not in ("linear", "pil"):
            raise ValueError(f"unknown resample kernel {self.ec.resample!r}")
        if self.ec.resample == "pil" and transfer != "rgb":
            raise ValueError(
                "resample='pil' reproduces the reference's uint8-domain "
                "resampling and needs exact pixels on device — use "
                "transfer='rgb' (lossy wires defeat the parity point)")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dtype = model.dtype or torch.float32
        self.templates = np.asarray(templates, np.float64)
        self.templates_t = torch.tensor(self.templates, dtype=torch.float32, device=self.device)
        self.cfg = cfg or DetectorConfig()
        self.transfer = transfer
        self.stride = float(self.cfg.rf.stride[0])
        self.offset = float(self.cfg.rf.offset[0])
        self.trace: Optional[list] = None
        self._ids_cache: dict[float, torch.Tensor] = {}

    def _template_mask(self, scale: float) -> np.ndarray:
        return valid_template_mask(self.templates, scale, pruning=self.ec.template_pruning)

    def _valid_ids(self, scale: float) -> torch.Tensor:
        """Device tensor of the template ids that may fire at `scale`."""
        if scale not in self._ids_cache:
            ids = np.nonzero(self._template_mask(scale))[0]
            self._ids_cache[scale] = torch.tensor(ids, dtype=torch.int64, device=self.device)
        return self._ids_cache[scale]

    def _mark(self, phase: str) -> None:
        if self.trace is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.trace.append((phase, event))

    def _pinned(self) -> bool:
        return self.device.type == "cuda"

    def detect(
        self,
        image: np.ndarray,  # (H, W, 3) uint8 original image
        prob_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        scales: Optional[Sequence[float]] = None,
        host_resize: bool = False,
    ) -> np.ndarray:
        """(N, 5) [x1, y1, x2, y2, score] detections on the host. Default:
        the fused pyramid; `host_resize=True` resizes each level with PIL on
        the host (the reference's resampling, one forward per level; JPEG
        bytes are decoded with PIL first). `image`: (H, W, 3) uint8, or on
        the jpegdct wire also JPEG bytes or a DCTImage."""
        if not host_resize:
            return self.detect_batch([image], prob_thresh, nms_thresh, scales)[0]
        return self._detect_host_resize(image, prob_thresh, nms_thresh, scales)

    def detect_batch(
        self,
        images: Sequence[np.ndarray],
        prob_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        scales: Optional[Sequence[float]] = None,
    ) -> list[np.ndarray]:
        """Fused-pyramid detection over a batch of images, padded to one
        bucketed canvas (batch same-sized images for best throughput). Any
        scale set works; non-integer octaves take host-computed float64
        level sizes."""
        return self._fetch(self.detect_batch_async(images, prob_thresh, nms_thresh, scales))

    def pack_inputs(self, images: Sequence) -> PackedBatch:
        """Host half of detect_batch_async, without touching the device: the
        bucketed uint8 canvas with mean-pixel margins, or on the jpegdct
        wire the packed coefficients of the bucketed canvas."""
        if self.transfer == "jpegdct":
            return self._pack_jpegdct(images)
        hs = [im.shape[0] for im in images]
        ws = [im.shape[1] for im in images]
        h0p, w0p = _round_up(max(hs)), _round_up(max(ws))

        # Fill only the padding margins; a fresh buffer per call keeps
        # copies still in flight safe.
        host = torch.empty((len(images), h0p, w0p, 3), dtype=torch.uint8,
                           pin_memory=self._pinned())
        batch = host.numpy()
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            batch[i, :h, :w] = im
            if w < w0p:
                batch[i, :h, w:] = MEAN_PIXEL
            if h < h0p:
                batch[i, h:] = MEAN_PIXEL
        return PackedBatch(host, np.asarray(hs, np.int32), np.asarray(ws, np.int32), h0p, w0p)

    def _pack_jpegdct(self, images: Sequence) -> PackedBatch:
        # Raw JPEG bytes stay raw: a header-only probe sizes the canvas and
        # pack_dct_batch entropy-decodes and packs them in one C++ pass.
        items = [jpegdct.as_wire_input(im) for im in images]
        hs, ws = zip(*(jpegdct.input_dims(im) for im in items))
        h0p, w0p = _round_up(max(hs)), _round_up(max(ws))
        total = jpegdct.wire_layout(h0p, w0p)["__total__"]
        host = torch.empty((len(items), total), dtype=torch.uint8, pin_memory=self._pinned())
        jpegdct.pack_dct_batch(items, h0p, w0p, out=host.numpy())
        return PackedBatch(host, np.asarray(hs, np.int32), np.asarray(ws, np.int32), h0p, w0p)

    def _level_sizes(self, hs: np.ndarray, ws: np.ndarray, scales: tuple) -> np.ndarray:
        """(B, L, 2) int64 level sizes: exact integer sizing for integer
        octaves, float64 truncation (pyramid_level_sizes_np) otherwise."""
        h0 = torch.from_numpy(hs.astype(np.int64))
        w0 = torch.from_numpy(ws.astype(np.int64))
        levels = []
        for s in scales:
            if float(s) == int(s):
                levels.append(torch.stack(pyramid_level_sizes(h0, w0, int(s)), 1).numpy())
            else:
                levels.append(pyramid_level_sizes_np(hs, ws, 2.0**s).astype(np.int64))
        return np.stack(levels, axis=1)

    @torch.no_grad()
    def detect_batch_async(
        self,
        images,
        prob_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        scales: Optional[Sequence[float]] = None,
    ) -> DeviceResult:
        """Queue the upload, the fused pyramid and the copy of the packed
        detections back to (pinned) host memory. Resolve with `_fetch`.
        Accepts raw images or a PackedBatch from pack_inputs."""
        prob_thresh = self.ec.prob_thresh if prob_thresh is None else prob_thresh
        nms_thresh = self.ec.nms_thresh if nms_thresh is None else nms_thresh
        scales = tuple(self.ec.scales if scales is None else scales)

        packed = images if isinstance(images, PackedBatch) else self.pack_inputs(images)
        b = packed.hs.shape[0]
        # One small int64 upload: true sizes (B, 2) and level sizes (B, L, 2).
        # (On the jpegdct wire the sizes also ride in its h0w0 field; both
        # come from the same header parse.)
        meta = np.concatenate([np.stack([packed.hs, packed.ws], 1).astype(np.int64),
                               self._level_sizes(packed.hs, packed.ws, scales).reshape(b, -1)], 1)
        taps = self._pil_taps(meta, scales, packed.h0p, packed.w0p) if self.ec.resample == "pil" else None
        meta_t = torch.from_numpy(meta)
        if self._pinned():
            meta_t = meta_t.pin_memory()
        meta_d = meta_t.to(self.device, non_blocking=True)
        images_d = packed.host.to(self.device, non_blocking=True)
        self._mark("upload")
        out = self._fused_pyramid(images_d, meta_d[:, :2], meta_d[:, 2:].reshape(b, len(scales), 2),
                                  scales=scales, h0p=packed.h0p, w0p=packed.w0p,
                                  prob_thresh=float(prob_thresh), nms_thresh=float(nms_thresh),
                                  pil_taps=taps)
        if not self._pinned():
            return DeviceResult(out, None)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        self._mark("d2h")
        event = torch.cuda.Event()
        event.record()
        return DeviceResult(host, event)

    @staticmethod
    def _level_canvas(h0p: int, w0p: int, s: float) -> tuple[int, int]:
        f = 2.0**s
        return _round_up_mult(int(round(h0p * f)), 32), _round_up_mult(int(round(w0p * f)), 32)

    def _pil_taps(self, meta: np.ndarray, scales: tuple, h0p: int, w0p: int) -> list:
        """Per level, the (rows, columns) tap bounds of the PIL weights
        (pilresize.max_taps) from the host's copy of the sizes, so building
        them needs no device sync."""
        sizes = meta[:, :2]
        levels = meta[:, 2:].reshape(meta.shape[0], len(scales), 2)
        return [tuple(max_taps(sizes[:, a], np.clip(levels[:, si, a], 1, pad))
                      for a, pad in enumerate(self._level_canvas(h0p, w0p, s)))
                for si, s in enumerate(scales)]

    def _normalize_nchw(self, pixels: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> the model's dtype, normalized, (B, 3, H, W)."""
        return normalize_images(pixels, dtype=self.dtype).permute(0, 3, 1, 2).contiguous()

    def _fused_pyramid(self, images, size_hw, level_hw, *, scales: tuple, h0p: int, w0p: int,
                       prob_thresh: float, nms_thresh: float, pil_taps=None) -> torch.Tensor:
        """Whole pyramid for one batch: the normalized canvas from either
        wire, resize of every level, forward, decode, then one cross-scale
        NMS per image. With resample="pil" the canvas stays in pixels: each
        level is resized on the uint8 grid, then normalized."""
        pil = self.ec.resample == "pil"
        if pil:
            # PIL's uint8 rounding does not commute with normalization.
            x0 = images.permute(0, 3, 1, 2).to(torch.float64)
        elif self.transfer == "jpegdct":
            # normalize commutes with the (linear) resize; straight into the
            # model's compute dtype, as the JAX program does
            x0 = dct_batch_to_normalized({"_wire": images}, h0p, w0p, dtype=self.dtype)
            x0 = x0.permute(0, 3, 1, 2).contiguous()
        else:
            x0 = self._normalize_nchw(images)
        self._mark("unpack")
        st = int(self.stride)
        all_b, all_s, all_v = [], [], []
        for si, s in enumerate(scales):
            f = 2.0**s
            thp, twp = self._level_canvas(h0p, w0p, s)
            level = torch.stack([level_hw[:, si, 0].clamp(1, thp), level_hw[:, si, 1].clamp(1, twp)], 1)
            if f == 1.0 and (thp, twp) == (h0p, w0p):
                # At scale 1 every image's level is its own size, and both
                # resizes at scale 1 are exactly the identity.
                xs = self._normalize_nchw(images) if pil else x0
            elif pil:
                xs = resize_pil_batch(x0, (thp, twp), size_hw, level, pil_taps[si])
                xs = self._normalize_nchw(xs.to(torch.uint8).permute(0, 2, 3, 1))
            else:
                xs = resize_batch(x0, (thp, twp), size_hw, level)
            self._mark(f"resize {s}")
            out = self.model(xs.permute(0, 2, 3, 1))
            self._mark(f"forward {s}")
            # three stride-2 stages: ceil(valid / 8) heatmap rows/cols
            hm = torch.div(level + st - 1, st, rounding_mode="floor")
            dets = decode_scores(out, self.templates_t, prob_thresh=prob_thresh,
                                 stride=self.stride, offset=self.offset, scale=float(f),
                                 k=self.ec.max_dets_per_scale, valid_hw=(hm[:, 0], hm[:, 1]),
                                 valid_ids=self._valid_ids(f))
            self._mark(f"decode {s}")
            all_b.append(dets.boxes)
            all_s.append(dets.scores)
            all_v.append(dets.valid)

        out_b, out_s, out_v = batched_nms_padded(
            torch.cat(all_b, 1), torch.cat(all_s, 1), nms_thresh, torch.cat(all_v, 1),
            self.ec.max_total_dets)
        packed = torch.cat([out_b, out_s[..., None], out_v[..., None].to(torch.float32)], -1)
        self._mark("nms")
        return packed

    @staticmethod
    def _fetch(async_result: DeviceResult) -> list[np.ndarray]:
        if async_result.event is not None:
            async_result.event.synchronize()
        packed = async_result.host.numpy()  # (B, K, 6)
        results = []
        for i in range(packed.shape[0]):
            n = int(packed[i, :, 5].sum())
            results.append(packed[i, :n, :5].copy())
        return results

    @torch.no_grad()
    def _detect_host_resize(
        self,
        image: np.ndarray,
        prob_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        scales: Optional[Sequence[float]] = None,
    ) -> np.ndarray:
        prob_thresh = self.ec.prob_thresh if prob_thresh is None else prob_thresh
        nms_thresh = self.ec.nms_thresh if nms_thresh is None else nms_thresh
        scales = self.ec.scales if scales is None else scales

        if jpegdct.is_bytes(image):
            # raw JPEG bytes (jpegdct wire): this path resizes pixels on the
            # host, so it decodes them fully first
            import io

            from PIL import Image

            image = np.asarray(Image.open(io.BytesIO(bytes(image))).convert("RGB"))

        h, w = image.shape[:2]
        min_side = min(h, w)
        st = int(self.stride)
        all_boxes, all_scores, all_valid = [], [], []
        for s in scales:
            factor = 2.0**s
            target_short = max(1, int(min_side * factor))
            # torchvision F.resize(int) sizing: shorter side := size, longer
            # side := int(size * long / short) — truncation (reference
            # evaluation.py:46-47).
            if w < h:
                tw, th = target_short, max(1, int(target_short * h / w))
            else:
                th, tw = target_short, max(1, int(target_short * w / h))
            resized = self._resize(image, (th, tw))

            # Pad to the bucketed shape with the ImageNet mean pixel (~zero
            # after normalization).
            padded = np.empty((_round_up(th), _round_up(tw), 3), np.uint8)
            padded[:] = MEAN_PIXEL
            padded[:th, :tw] = resized

            x = normalize_images(torch.from_numpy(padded[None]).to(self.device))
            out = self.model(x)
            hm = torch.tensor([[(th + st - 1) // st, (tw + st - 1) // st]], device=self.device)
            # The reference divides boxes by the exact 2**s factor even
            # though the resize rounds to integer pixels.
            dets = decode_scores(out, self.templates_t, prob_thresh=float(prob_thresh),
                                 stride=self.stride, offset=self.offset, scale=float(factor),
                                 k=self.ec.max_dets_per_scale, valid_hw=(hm[:, 0], hm[:, 1]),
                                 valid_ids=self._valid_ids(factor))
            all_boxes.append(dets.boxes)
            all_scores.append(dets.scores)
            all_valid.append(dets.valid)

        out_boxes, out_scores, out_valid = batched_nms_padded(
            torch.cat(all_boxes, 1), torch.cat(all_scores, 1), float(nms_thresh),
            torch.cat(all_valid, 1), self.ec.max_total_dets)
        n = int(out_valid.sum())
        return torch.cat([out_boxes[0, :n], out_scores[0, :n, None]], 1).cpu().numpy()

    @staticmethod
    def _resize(image: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
        th, tw = hw
        if (th, tw) == image.shape[:2]:
            return image
        from PIL import Image

        return np.asarray(Image.fromarray(image).resize((tw, th), Image.BILINEAR))


def get_detections(
    model: TinyFacesDetector,
    image: np.ndarray,
    templates: np.ndarray,
    prob_thresh: float = 0.65,
    nms_thresh: float = 0.3,
    scales: Sequence[float] = (-2, -1, 0, 1),
    cfg: DetectorConfig | None = None,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """Functional one-shot API mirroring reference evaluation.py:20-87."""
    det = PyramidDetector(model, templates, cfg=cfg, device=device)
    return det.detect(image, prob_thresh, nms_thresh, scales)


def write_results(
    dets: np.ndarray,  # (N, 5) with scores
    img_path: str,
    split: str,
    results_dir: Optional[str | Path] = None,
) -> Path:
    """WIDER-format result file (reference evaluation.py:90-114)."""
    results_dir = Path(results_dir or f"{split}_results")
    filename = results_dir / img_path.replace("jpg", "txt")
    filename.parent.mkdir(parents=True, exist_ok=True)

    # Non-finite rows (exp-overflowed regressions) cannot be written as
    # integers and carry no usable box, so they are dropped.
    finite = np.isfinite(dets).all(axis=1)
    if not finite.all():
        dets = dets[finite]

    with open(filename, "w") as f:
        f.write(img_path.split("/")[-1] + "\n")
        f.write(str(dets.shape[0]) + "\n")
        for x in dets:
            left, top = np.round(x[0]), np.round(x[1])
            width = np.round(x[2] - x[0] + 1)
            height = np.round(x[3] - x[1] + 1)
            f.write(f"{int(left)} {int(top)} {int(width)} {int(height)} {x[4]}\n")
    return filename
