"""Evaluation runtime: checkpoint loading, image-pyramid inference, WIDER writer.

Port of tinyfaces_tpu/evaluation.py on all its wires (`rgb`, `yuv420`,
`jpegdct`, `jpegdct4`):
  * `get_model` / `load_weights`: build the detector and load the port
    trainer's own checkpoint, the JAX package's .npz export, or a reference
    PyTorch .pth (utils/convert.from_reference_pth);
  * `PyramidDetector`: the fused multi-scale pyramid — per-image resize of
    the mean-padded canvas to every level on the device, one forward per
    level, top-K decode, one cross-scale NMS per image — returning a packed
    (B, K, 6) tensor whose copy to the host runs behind a CUDA event. On
    `yuv420` the host converts the uint8 canvas to planar YCbCr 4:2:0 (1.5
    B/px, data/targets.rgb_to_yuv420) and the device converts it back. On
    `jpegdct` (v3) and `jpegdct4` (v4) it takes JPEG bytes (or DCTImage, or
    uint8 arrays through PIL's transcode): the host entropy-decodes and
    packs them (data/jpegdct.py) and the device reconstructs the normalized
    canvas (ops/jpeg.py);
  * `write_results`: the WIDER per-image result tree
    <results_dir>/<event>/<img>.txt, byte for byte as the JAX writer.

`EvalConfig.resample` picks the level resampling: "linear" (the JAX
package's scale_and_translate, on the normalized canvas) or "pil" (the
reference's uint8 PIL bilinear, ops/pilresize.py: each level resized in
pixel space in float64, byte-equal to the host oracle, then normalized;
`rgb` wire only).

`device=` a list of cards runs the pyramid over them (the JAX package's
mesh), one model replica per entry. `shard="batch"` (the default) is data-parallel: each fused batch
split into equal contiguous pieces, every piece dispatched before any is
waited for, and the results gathered in order. `shard="spatial"` splits
each level's forward over the cards by rows (parallel/spatial.py): the
first card produces the normalized canvas (unpack, resize or the `pil`
path) and every level's input, including the folded stem's output (conv1's
rows, computed whole on the first card and then sliced); the score maps
come back to it for decode and NMS. `shard="auto"` is spatial for a batch
smaller than the card count and batch otherwise (spatial.choose_mode).

The compiled pyramid. The JAX package jits `fused_pyramid` once per static
key (tinyfaces_tpu/evaluation.py:453-457); its counterpart here is one
CUDA graph (utils/graphs.py) per `ProgramKey` and replica: the JAX program's
static arguments (scales, h0p, w0p, prob_thresh, nms_thresh, transfer) plus
what the port's shapes add (the replica's batch rows, the model's dtype,
the resample kernel and the `pil` taps). A key's first call runs the
pyramid eagerly (cuDNN's and cuBLAS's set-up, the device constants); its
second call captures it and replays the graph, and every later call copies
the wire and the sizes into the graph's static input buffers and replays
it, so a one-shot caller never pays for a capture. The NMS inside is
kernel N1 (ops/nms_kernel.py), so nothing in the pyramid reads the host.

Memory: each CUDA replica has one side stream and one memory pool
(`GraphCache`). Every eager run on the replica (a key's first call, a
traced batch) and every capture runs on that stream with all of its
allocations in that pool, so an eager run reuses the blocks that the
graphs leave free between replays instead of needing its own memory beside
theirs; replays are serialised on the replica's current stream, and each
packed output is copied out on that stream before the next replay. When an
eager run runs out of memory in the pool (its free blocks cut to other
keys' sizes), the replica's graphs and pool are released and the run is
made once more in a fresh pool.

The pyramid runs eagerly in three cases only (`eager_reason`): on a device
that is not a GPU (the CPU tests), under shard "spatial" (halos copied
across cards, parallel/spatial.py) and while `trace` is set (its CUDA
events split the eager run). A capture that fails raises.

`EvalConfig.fold_stem` (the default, as in the JAX package) folds the 2x
level's exact-2.0 upsample into conv1 (ops/stemfold.py): the stem runs at
1x on the unpacked canvas and the (B, 3, 2H, 2W) canvas is never made; the
trace's "resize 1" phase then holds the folded stem. `fold_stem=False`
resizes and then convolves, as does `resample="pil"`.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import jpegdct
from tinyfaces_tpu_torch.data.targets import normalize_images, rgb_to_yuv420, yuv420_to_normalized
from tinyfaces_tpu_torch.data.wider_face import MEAN_PIXEL
from tinyfaces_tpu_torch.models.detection import ARCHS, TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops.decode import decode_scores, valid_template_mask
from tinyfaces_tpu_torch.ops.jpeg import dct4_batch_to_normalized, dct_batch_to_normalized
from tinyfaces_tpu_torch.ops.nms import batched_nms_padded
from tinyfaces_tpu_torch.ops.pilresize import max_taps, resize_pil_batch
from tinyfaces_tpu_torch.ops.resize import resize_batch
from tinyfaces_tpu_torch.ops.stemfold import folded_stem_2x
from tinyfaces_tpu_torch.parallel.mesh import check_shard, split_batch
from tinyfaces_tpu_torch.parallel.spatial import choose_mode, spatial_forward
from tinyfaces_tpu_torch.utils import graphs
from tinyfaces_tpu_torch.utils.convert import from_npz, from_reference_pth

TRANSFERS = ("rgb", "yuv420", "jpegdct", "jpegdct4")
WIRE_VERSION = {"jpegdct": 3, "jpegdct4": 4}  # the JPEG wires' pack_dct_batch versions
YUV_THREADS = 4  # images of a batch converted side by side (NumPy's take drops the GIL)


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


def refuse_arch(arch: str) -> None:
    """The pyramid (PyramidDetector, the folded stem, the per-scale template
    pruning) is built for the ResNet backbones alone: any other raises."""
    if arch not in ARCHS or ARCHS[arch].stages is None:
        resnets = tuple(a for a, spec in ARCHS.items() if spec.stages is not None)
        raise ValueError(f"the eval pyramid supports the ResNet backbones {resnets} only: "
                         f"{arch!r} has no pyramid support (its detection pyramid, folded stem "
                         f"and template pruning are not ported); train it with main.py --arch {arch}")


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
    `arch` selects the backbone ("resnet101" | "resnet50"); the pyramid
    runs no other."""
    refuse_arch(arch)
    model = TinyFacesDetector(num_templates=num_templates, arch=arch, dtype=dtype)
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


def yuv420_wire(host: torch.Tensor, h: int, w: int) -> tuple:
    """The (Y, Cb, Cr) views, (B, h, w) and twice (B, h/2, w/2), of a
    (B, 1.5 h w) uint8 yuv420 wire row by row: Y, then Cb, then Cr."""
    b, n, q = host.shape[0], h * w, (h // 2) * (w // 2)
    return (host[:, :n].view(b, h, w), host[:, n:n + q].view(b, h // 2, w // 2),
            host[:, n + q:].view(b, h // 2, w // 2))


class PackedBatch(NamedTuple):
    """Upload-ready host half of one detector batch (pack_inputs): `host`
    is the uint8 (B, h0p, w0p, 3) canvas on the rgb wire, the (B, 1.5 h0p
    w0p) planes on yuv420 (yuv420_wire), the (B, total) uint8 wire on
    jpegdct and jpegdct4, in pinned memory when the detector's device is a
    GPU; hs/ws the per-image true sizes; h0p/w0p the padded canvas."""

    host: torch.Tensor
    hs: np.ndarray
    ws: np.ndarray
    h0p: int
    w0p: int


class DeviceResult(NamedTuple):
    """A batch in flight (detect_batch_async): `host` receives the packed
    (B, K, 6) [x1, y1, x2, y2, score, valid] detections; on GPUs the copy
    is complete once every one of `events` (one per card) has completed
    (none on the CPU)."""

    host: torch.Tensor
    events: tuple


class ProgramKey(NamedTuple):
    """What one captured pyramid is specialised to: the JAX program's
    static arguments (fused_pyramid's keyword-only parameters, in order),
    then the replica's batch rows, the model's dtype, the resample kernel
    and the `pil` taps (None on "linear")."""

    scales: tuple
    h0p: int
    w0p: int
    prob_thresh: float
    nms_thresh: float
    transfer: str
    batch: int
    dtype: torch.dtype
    resample: str
    taps: Optional[tuple]


class GraphCache:
    """One CUDA replica's compiled pyramids: the captured graph of every
    ProgramKey called at least twice, the keys called once (`warm`), and
    the side stream and memory pool that every eager run and capture on
    the replica uses (see the module docstring). `releases` counts the
    times the graphs were dropped for memory. A thread captures only after
    it has run the pyramid eagerly here (`warmed_here`): cuDNN and cuBLAS
    create a thread's handles at its first use, a call a capture may not
    make."""

    def __init__(self, device: torch.device):
        # "cuda" means the current card; the pool's routing needs its index
        self.device = device if device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        with torch.cuda.device(self.device):  # the pool lives on the current card
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.MemPool()
        self.graphs: dict = {}
        self.warm: set = set()
        self.releases = 0
        self._thread = threading.local()

    def eager(self, run, *args) -> torch.Tensor:
        """`run(*args)` on the side stream, after the current stream's work
        (which then waits for it), with this thread's allocations in the
        pool. Out of memory there (the pool's free blocks cut to other
        keys' sizes, which the allocator does not hand back while the pool
        lives): release the graphs and the pool, and run once more."""
        try:
            out = self._pooled(run, *args)
        except torch.cuda.OutOfMemoryError:
            out = None
        if out is None:
            self.release()
            self.releases += 1
            out = self._pooled(run, *args)
        self._thread.warmed = True
        return out

    def warmed_here(self) -> bool:
        """Whether the calling thread has run an eager pyramid here."""
        return getattr(self._thread, "warmed", False)

    def _pooled(self, run, *args) -> torch.Tensor:
        with graphs.side_stream(self.device, self.stream, self.pool):
            out = run(*args)
        out.record_stream(torch.cuda.current_stream(self.device))
        return out

    def release(self) -> None:
        """Drop every graph and warm key, and the pool (its memory goes
        back to the card); a key's next call starts again from its eager
        run."""
        torch.cuda.synchronize(self.device)  # replays in flight read the pool
        self.graphs.clear()
        self.warm.clear()
        with torch.cuda.device(self.device):
            self.pool = torch.cuda.MemPool()
        gc.collect()
        torch.cuda.empty_cache()

    def reserved_bytes(self) -> int:
        """Bytes the pool holds on the card."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool.id))


class Replica(NamedTuple):
    """One device's copy of the detector: its model in eval mode, the
    templates, per scale the template ids that may fire there, and on a
    GPU its GraphCache (None elsewhere)."""

    device: torch.device
    model: TinyFacesDetector
    templates: torch.Tensor
    valid_ids: dict
    cache: Optional[GraphCache]


class PyramidDetector:
    """Multi-scale detector over one device, or over a list of devices
    (one replica each): data-parallel under `shard="batch"` (a batch must
    split evenly over them), one image's rows split over them under
    "spatial", either by batch size under "auto".

    `trace`: set to a list to record, on a GPU, one (phase, CUDA event) pair
    after each phase of every batch — "upload", "unpack" (the normalized
    canvas from the wire), then "resize s" (the folded stem at the 2x level),
    "forward s" and "decode s" per level s, "nms" and "d2h"; the time of a
    phase is the elapsed time from the previous event (with several
    devices, of the first device's piece). The events split the eager run,
    so a traced batch runs eagerly, not from its captured graph. None (the
    default) records nothing."""

    def __init__(
        self,
        model: TinyFacesDetector,
        templates: np.ndarray,
        cfg: DetectorConfig | None = None,
        ec: EvalConfig | None = None,
        *,
        device: torch.device | str | Sequence[torch.device | str],
        transfer: str = "rgb",
        shard: str = "batch",
    ):
        if transfer not in TRANSFERS:
            raise ValueError(f"unknown transfer mode {transfer!r}; use one of {TRANSFERS}")
        check_shard(shard)
        refuse_arch(getattr(model, "arch", "resnet101"))
        devices = [torch.device(d) for d in
                   ([device] if isinstance(device, (str, torch.device)) else device)]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"devices {devices} mix device types")
        self.ec = ec or EvalConfig()
        if self.ec.resample not in ("linear", "pil"):
            raise ValueError(f"unknown resample kernel {self.ec.resample!r}")
        if self.ec.resample == "pil" and transfer != "rgb":
            raise ValueError(
                "resample='pil' reproduces the reference's uint8-domain "
                "resampling and needs exact pixels on device — use "
                "transfer='rgb' (lossy wires defeat the parity point)")
        self.dtype = model.dtype or torch.float32
        self.templates = np.asarray(templates, np.float64)
        self.shard = shard
        models = [model] + [copy.deepcopy(model) for _ in devices[1:]]
        self.replicas = [
            Replica(d, m.to(d).eval(), torch.tensor(self.templates, dtype=torch.float32, device=d),
                    {}, GraphCache(d) if d.type == "cuda" else None)
            for d, m in zip(devices, models)]
        self.cfg = cfg or DetectorConfig()
        self.transfer = transfer
        self.stride = float(self.cfg.rf.stride[0])
        self.offset = float(self.cfg.rf.offset[0])
        self.trace: Optional[list] = None

    @property
    def devices(self) -> list[torch.device]:
        return [r.device for r in self.replicas]

    def _template_mask(self, scale: float) -> np.ndarray:
        return valid_template_mask(self.templates, scale, pruning=self.ec.template_pruning)

    def _valid_ids(self, scale: float, replica: Replica) -> torch.Tensor:
        """Device tensor of the template ids that may fire at `scale`."""
        if scale not in replica.valid_ids:
            ids = np.nonzero(self._template_mask(scale))[0]
            replica.valid_ids[scale] = torch.tensor(ids, dtype=torch.int64, device=replica.device)
        return replica.valid_ids[scale]

    def eager_reason(self, device: torch.device, mode: str) -> Optional[str]:
        """Why a batch on `device` under shard mode `mode` runs eagerly,
        or None when it replays its captured graph."""
        if device.type != "cuda":
            return "not a GPU"
        if mode == "spatial":
            return "shard spatial"
        if self.trace is not None:
            return "trace"
        return None

    def release_graphs(self) -> None:
        """Drop every replica's captured pyramids, its warm keys and their
        pool (GraphCache.release)."""
        for r in self.replicas:
            if r.cache is not None:
                r.cache.release()

    def graph_stats(self) -> list[dict]:
        """Per GPU replica: its captured keys with their capture seconds and
        N1 launches each, the keys called once and not captured, the times
        its graphs were released for memory, and the bytes its pool
        reserves."""
        return [{"device": str(r.device), "graphs": len(r.cache.graphs),
                 "capture_s": [p.capture_s for p in r.cache.graphs.values()],
                 "n1_launches": [p.tally["n1"] for p in r.cache.graphs.values()],
                 "warm_keys": len(r.cache.warm), "releases": r.cache.releases,
                 "pool_reserved_bytes": r.cache.reserved_bytes()}
                for r in self.replicas if r.cache is not None]

    def _mark(self, phase: str) -> None:
        if self.trace is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.trace.append((phase, event))

    def _pinned(self) -> bool:
        return self.replicas[0].device.type == "cuda"

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
        the JPEG wires also JPEG bytes or a DCTImage."""
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
        bucketed uint8 canvas with mean-pixel margins, its yuv420 planes, or
        on the JPEG wires the packed coefficients of the bucketed canvas."""
        if self.transfer in WIRE_VERSION:
            return self._pack_jpegdct(images)
        hs = [im.shape[0] for im in images]
        ws = [im.shape[1] for im in images]
        h0p, w0p = _round_up(max(hs)), _round_up(max(ws))

        # Fill only the padding margins; a fresh buffer per call keeps
        # copies still in flight safe.
        yuv = self.transfer == "yuv420"
        host = torch.empty((len(images), h0p, w0p, 3), dtype=torch.uint8,
                           pin_memory=self._pinned() and not yuv)
        batch = host.numpy()
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            batch[i, :h, :w] = im
            if w < w0p:
                batch[i, :h, w:] = MEAN_PIXEL
            if h < h0p:
                batch[i, h:] = MEAN_PIXEL
        if yuv:
            host = self._pack_yuv420(batch)
        return PackedBatch(host, np.asarray(hs, np.int32), np.asarray(ws, np.int32), h0p, w0p)

    def _pack_yuv420(self, batch: np.ndarray) -> torch.Tensor:
        """The mean-padded canvas (B, h0p, w0p, 3) as one yuv420 wire."""
        b, h, w, _ = batch.shape
        host = torch.empty((b, h * w * 3 // 2), dtype=torch.uint8, pin_memory=self._pinned())
        planes = [p.numpy() for p in yuv420_wire(host, h, w)]

        def one(i):
            rgb_to_yuv420(batch[i:i + 1], tuple(p[i:i + 1] for p in planes))

        if b > 1:
            with ThreadPoolExecutor(min(YUV_THREADS, b)) as pool:  # disjoint rows
                list(pool.map(one, range(b)))
        else:
            one(0)
        return host

    def _pack_jpegdct(self, images: Sequence) -> PackedBatch:
        # Raw JPEG bytes stay raw: a header-only probe sizes the canvas and
        # pack_dct_batch entropy-decodes and packs them in one C++ pass.
        items = [jpegdct.as_wire_input(im) for im in images]
        hs, ws = zip(*(jpegdct.input_dims(im) for im in items))
        h0p, w0p = _round_up(max(hs)), _round_up(max(ws))
        version = WIRE_VERSION[self.transfer]
        total = jpegdct.layout_of(version)(h0p, w0p)["__total__"]
        host = torch.empty((len(items), total), dtype=torch.uint8, pin_memory=self._pinned())
        jpegdct.pack_dct_batch(items, h0p, w0p, wire_version=version, out=host.numpy())
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
        detections back to (pinned) host memory, on every device its piece
        of the batch. Resolve with `_fetch`. Accepts raw images or a
        PackedBatch from pack_inputs."""
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
        meta_t = torch.from_numpy(meta)
        if self._pinned():
            meta_t = meta_t.pin_memory()
        replicas, forward = self.replicas, None
        mode = choose_mode(len(replicas), b, self.shard)
        if mode == "spatial":
            # the whole batch on the first card, each level's forward split by rows
            models = [r.model for r in replicas]
            replicas = replicas[:1]

            def forward(replica, x, fold):
                return spatial_forward(models, x, stem_precomputed=fold)
        pieces = [slice(r.start, r.stop) for r in split_batch(range(b), len(replicas))]
        # the trace follows the first device's piece
        marks = [self._mark] + [lambda phase: None] * (len(pieces) - 1)
        outs = []
        for replica, rows, mark in zip(replicas, pieces, marks):
            with self._on(replica):
                taps = (self._pil_taps(meta[rows], scales, packed.h0p, packed.w0p)
                        if self.ec.resample == "pil" else None)

                def run(images_d, meta_d, replica=replica, taps=taps, mark=mark):
                    return self._fused_pyramid(
                        replica, images_d, meta_d[:, :2], meta_d[:, 2:].reshape(-1, len(scales), 2),
                        scales=scales, h0p=packed.h0p, w0p=packed.w0p,
                        prob_thresh=float(prob_thresh), nms_thresh=float(nms_thresh),
                        pil_taps=taps, mark=mark, forward=forward)

                if self.eager_reason(replica.device, mode) is None:
                    key = ProgramKey(scales, packed.h0p, packed.w0p, float(prob_thresh),
                                     float(nms_thresh), self.transfer, rows.stop - rows.start,
                                     self.dtype, self.ec.resample, None if taps is None else tuple(taps))
                    outs.append(self._replay(replica, key, run, packed.host[rows], meta_t[rows]))
                    continue
                meta_d = meta_t[rows].to(replica.device, non_blocking=True)
                images_d = packed.host[rows].to(replica.device, non_blocking=True)
                mark("upload")
                if replica.cache is not None and mode != "spatial":  # traced: in the graphs' pool
                    outs.append(replica.cache.eager(run, images_d, meta_d))
                else:
                    outs.append(run(images_d, meta_d))
        if not self._pinned():
            return DeviceResult(torch.cat(outs), ())
        host = torch.empty((b, *outs[0].shape[1:]), dtype=outs[0].dtype, pin_memory=True)
        events = []
        for replica, rows, mark, out in zip(replicas, pieces, marks, outs):
            with self._on(replica):
                host[rows].copy_(out, non_blocking=True)
                mark("d2h")
                events.append(torch.cuda.Event())
                events[-1].record()
        return DeviceResult(host, tuple(events))

    @staticmethod
    def _replay(replica: Replica, key: ProgramKey, run, images_h: torch.Tensor,
                meta_h: torch.Tensor) -> torch.Tensor:
        """The packed output of `run(images, meta)` on the replica's card
        for the key: its first call uploads and runs eagerly in the
        replica's pool; its second captures the graph (on a thread that
        has run eagerly here; on another, it runs eagerly once more); that
        call and every later one copy the pinned host rows into the graph's
        static buffers and replay it on the current stream."""
        cache = replica.cache
        prog = cache.graphs.get(key)
        if prog is None and (key not in cache.warm or not cache.warmed_here()):
            out = cache.eager(run, images_h.to(replica.device, non_blocking=True),
                              meta_h.to(replica.device, non_blocking=True))
            cache.warm.add(key)
            return out
        if prog is None:
            prog = cache.graphs[key] = graphs.Captured(run, images_h, meta_h, device=cache.device,
                                                       stream=cache.stream, pool=cache.pool)
            cache.warm.discard(key)
        return prog.replay(images_h, meta_h)

    @staticmethod
    def _replica_forward(replica: Replica, x: torch.Tensor, fold: bool) -> torch.Tensor:
        """The replica's model on an NCHW level input (conv1's output when
        `fold`)."""
        return replica.model(x if fold else x.permute(0, 2, 3, 1), stem_precomputed=fold)

    @staticmethod
    def _on(replica: Replica):
        """The replica's card as the current device (streams, events)."""
        if replica.device.type == "cuda":
            return torch.cuda.device(replica.device)
        return contextlib.nullcontext()

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

    def _fused_pyramid(self, replica: Replica, images, size_hw, level_hw, *, scales: tuple,
                       h0p: int, w0p: int, prob_thresh: float, nms_thresh: float,
                       mark, forward=None, pil_taps=None) -> torch.Tensor:
        """Whole pyramid for one batch on `replica`: the normalized canvas from any
        wire, resize of every level (the 2x level's folded into conv1 under
        fold_stem), forward, decode, then one cross-scale NMS per image.
        With resample="pil" the canvas stays in pixels: each level is
        resized on the uint8 grid, then normalized. `mark(phase)` records
        the trace's events; `forward(replica, x, fold)` runs the model on
        the NCHW level input (conv1's output when `fold`), by default the
        replica's own (_replica_forward)."""
        forward = forward or self._replica_forward
        pil = self.ec.resample == "pil"
        if pil:
            # PIL's uint8 rounding does not commute with normalization.
            x0 = images.permute(0, 3, 1, 2).to(torch.float64)
        elif self.transfer in WIRE_VERSION:
            # normalize commutes with the (linear) resize; straight into the
            # model's compute dtype, as the JAX program does
            unpack = dct4_batch_to_normalized if self.transfer == "jpegdct4" else dct_batch_to_normalized
            x0 = unpack({"_wire": images}, h0p, w0p, dtype=self.dtype)
            x0 = x0.permute(0, 3, 1, 2).contiguous()
        elif self.transfer == "yuv420":
            x0 = yuv420_to_normalized(*yuv420_wire(images, h0p, w0p), dtype=self.dtype)
            x0 = x0.permute(0, 3, 1, 2).contiguous()
        else:
            x0 = self._normalize_nchw(images)
        mark("unpack")
        st = int(self.stride)
        all_b, all_s, all_v = [], [], []
        for si, s in enumerate(scales):
            f = 2.0**s
            thp, twp = self._level_canvas(h0p, w0p, s)
            level = torch.stack([level_hw[:, si, 0].clamp(1, thp), level_hw[:, si, 1].clamp(1, twp)], 1)
            fold = not pil and self.ec.fold_stem and f == 2.0 and (thp, twp) == (2 * h0p, 2 * w0p)
            if fold:
                # The 2x level's factor is exactly 2.0 for every image (an
                # integer short side h goes to 2h), so the upsample folds
                # into conv1 and the stem runs at 1x.
                xs = folded_stem_2x(x0, replica.model.model.conv1.weight)
            elif f == 1.0 and (thp, twp) == (h0p, w0p):
                # At scale 1 every image's level is its own size, and both
                # resizes at scale 1 are exactly the identity.
                xs = self._normalize_nchw(images) if pil else x0
            elif pil:
                xs = resize_pil_batch(x0, (thp, twp), size_hw, level, pil_taps[si])
                xs = self._normalize_nchw(xs.to(torch.uint8).permute(0, 2, 3, 1))
            else:
                xs = resize_batch(x0, (thp, twp), size_hw, level)
            mark(f"resize {s}")
            out = forward(replica, xs, fold)
            mark(f"forward {s}")
            # three stride-2 stages: ceil(valid / 8) heatmap rows/cols
            hm = torch.div(level + st - 1, st, rounding_mode="floor")
            dets = decode_scores(out, replica.templates, prob_thresh=prob_thresh,
                                 stride=self.stride, offset=self.offset, scale=float(f),
                                 k=self.ec.max_dets_per_scale, valid_hw=(hm[:, 0], hm[:, 1]),
                                 valid_ids=self._valid_ids(f, replica))
            mark(f"decode {s}")
            all_b.append(dets.boxes)
            all_s.append(dets.scores)
            all_v.append(dets.valid)

        out_b, out_s, out_v = batched_nms_padded(
            torch.cat(all_b, 1), torch.cat(all_s, 1), nms_thresh, torch.cat(all_v, 1),
            self.ec.max_total_dets)
        packed = torch.cat([out_b, out_s[..., None], out_v[..., None].to(torch.float32)], -1)
        mark("nms")
        return packed

    @staticmethod
    def _fetch(async_result: DeviceResult) -> list[np.ndarray]:
        for event in async_result.events:
            event.synchronize()
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
        replica = self.replicas[0]

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

            x = normalize_images(torch.from_numpy(padded[None]).to(replica.device))
            out = replica.model(x)
            hm = torch.tensor([[(th + st - 1) // st, (tw + st - 1) // st]], device=replica.device)
            # The reference divides boxes by the exact 2**s factor even
            # though the resize rounds to integer pixels.
            dets = decode_scores(out, replica.templates, prob_thresh=float(prob_thresh),
                                 stride=self.stride, offset=self.offset, scale=float(factor),
                                 k=self.ec.max_dets_per_scale, valid_hw=(hm[:, 0], hm[:, 1]),
                                 valid_ids=self._valid_ids(factor, replica))
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
