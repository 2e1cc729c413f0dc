"""Host-to-device copy rate of a card: MiB/s by payload, size, dtype,
pinned or pageable host memory, and concurrency.

    python -m tinyfaces_tpu_torch.tools.h2d_probe [--mib 36] [--iters 4] [--device cuda]

Port of tools/h2d_probe.py, which asked whether the TPU's remote link
compresses (zeros against noise) and whether parallel puts pipeline. Each
copy here is `Tensor.copy_(host, non_blocking=True)` into a preallocated
device buffer, timed with CUDA events on the copying stream (median of
`--iters` after one warm copy):

  * payload: noise, zeros and a photo-like gradient, `--mib` MiB of uint8;
  * size: 1, 4 and 16 MiB of noise;
  * dtype: the same bytes as uint8, float32 and bfloat16;
  * host memory: pinned against pageable (CUDA stages pageable
    copies through its own pinned buffer);
  * concurrency: 4 chunks of `--mib`/4 MiB enqueued before waiting, on one
    stream and on 4 streams.

Prints one line per row and a JSON line with every row; rates carry the
card's `nvidia-smi` name and power limit. A host-to-device probe needs a
card: `--device cpu` exits.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

MIB = 2**20


def payloads(mib: int, seed: int = 0) -> dict:
    """uint8 arrays of `mib` MiB: noise, zeros, and tools/h2d_probe.py's
    photo-like tiling of a smooth 2-D gradient."""
    rng = np.random.default_rng(seed)
    n = mib * MIB
    x = np.linspace(0, 255, 1024)
    photo = ((x[None, :] + x[:, None]) / 2).astype(np.uint8)
    photo = np.resize(photo.reshape(-1), n)
    return {"noise": rng.integers(0, 255, (n,), dtype=np.uint8), "zeros": np.zeros(n, np.uint8),
            "photo": np.ascontiguousarray(photo)}


def _host(arr: np.ndarray, pinned: bool, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    t = torch.from_numpy(arr).view(dtype)
    return t.pin_memory() if pinned else t


def copy_ms(hosts: Sequence[torch.Tensor], dev: torch.device, iters: int,
            streams: Optional[list] = None) -> float:
    """Median ms of copying every host tensor into its device buffer, all
    enqueued before waiting (on `streams[i % len(streams)]`, or the current
    stream), between CUDA events on the current stream."""
    dsts = [torch.empty_like(h, device=dev) for h in hosts]
    current = torch.cuda.current_stream(dev)

    def once() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(current)
        for i, (d, h) in enumerate(zip(dsts, hosts)):
            if streams is None:
                d.copy_(h, non_blocking=True)
                continue
            s = streams[i % len(streams)]
            s.wait_event(start)
            with torch.cuda.stream(s):
                d.copy_(h, non_blocking=True)
            current.wait_stream(s)
        end.record(current)
        end.synchronize()
        return start.elapsed_time(end)

    once()
    return float(np.median([once() for _ in range(iters)]))


def probe(dev: torch.device, mib: int = 36, iters: int = 4) -> list[dict]:
    """Every row of the probe: {"case", "mib", "pinned", "ms", "mib_per_s"}."""
    rows = []

    def row(case: str, hosts: list, pinned: bool, streams=None) -> None:
        size = sum(h.numel() * h.element_size() for h in hosts) / MIB
        ms = copy_ms(hosts, dev, iters, streams)
        rows.append({"case": case, "mib": size, "pinned": pinned, "ms": ms,
                     "mib_per_s": size / (ms / 1e3)})

    data = payloads(mib)
    for pinned in (True, False):
        for name, arr in data.items():
            row(f"{name} {mib} MiB", [_host(arr, pinned)], pinned)
    rng = np.random.default_rng(1)
    for size in (1, 4, 16):
        row(f"noise {size} MiB", [_host(rng.integers(0, 255, (size * MIB,), dtype=np.uint8), True)],
            True)
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        row(f"noise {mib} MiB as {name}", [_host(data["noise"], True, dtype)], True)
    chunks = [_host(c, True) for c in np.array_split(data["noise"], 4)]
    row(f"4 x {mib / 4:g} MiB, one stream", chunks, True)
    row(f"4 x {mib / 4:g} MiB, 4 streams", chunks, True,
        [torch.cuda.Stream(dev) for _ in range(4)])
    return rows


def main(argv=None) -> dict:
    from tinyfaces_tpu_torch.utils.instruments import card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=36, help="payload size of the payload rows")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="the card (cuda or cuda:N)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit(f"--device {args.device}: the host-to-device probe measures a card's link")
    rows = probe(dev, args.mib, args.iters)
    name = card(dev)
    for r in rows:
        print(f"{r['case']} ({'pinned' if r['pinned'] else 'pageable'}): {r['mib_per_s']:.0f} "
              f"MiB/s ({r['ms']:.3f} ms) ({name})", flush=True)
    out = {"card": name, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
