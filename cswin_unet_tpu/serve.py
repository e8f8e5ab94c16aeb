"""Production serving: volumes in, segmentations out.

The reference repo has no serving path — its closest analogue is re-running
``test.py`` (reference test.py:103-165) over a dataset directory. This module
is the deployment story:

  * the batched slice forward is compiled ONCE at a fixed chunk shape and
    warmed before the first request (cold-compile never lands on a request);
  * host-side resizing runs on a thread pool while the device chews the
    previous chunk (the ``VolumeInferencer`` chunking pipeline);
  * inputs are files (``.npy.h5`` / ``.npz`` / ``.npy``), outputs are
    NIfTI-1 (same writer as eval — eval/inference.py:125-133) plus one JSON
    status line per volume on stdout — trivially composable behind any
    queue/filesystem-based dispatcher, no network dependency.

Two modes: one-shot (positional volume paths) and ``--watch`` (poll a
directory; processed inputs move to ``<dir>/done``; crashes leave the input
in place for retry).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from .eval.inference import VolumeInferencer
from .utils.nifti import write_nifti


def read_volume(path: str) -> np.ndarray:
    """(D, H, W) float32 from .npy.h5/.h5 ('image'), .npz ('image'), .npy."""
    if path.endswith((".h5", ".npy.h5")):
        import h5py

        with h5py.File(path, "r") as f:
            key = "image" if "image" in f else "images"
            vol = f[key][:]
    elif path.endswith(".npz"):
        with np.load(path) as f:
            vol = f["image"]
    elif path.endswith(".npy"):
        vol = np.load(path)
    else:
        raise ValueError(f"unsupported volume format: {path}")
    vol = np.asarray(vol, dtype=np.float32)
    if vol.ndim == 2:
        vol = vol[None]
    if vol.ndim != 3:
        raise ValueError(f"expected (D, H, W) volume, got {vol.shape}: {path}")
    return vol


class VolumeServer:
    """Compile-once volume segmentation server."""

    def __init__(self, model, params, *, img_size=224, batch_slices=32,
                 class_indices=None, z_spacing=1):
        self.patch = (img_size, img_size)
        self.z_spacing = z_spacing
        self.inferencer = VolumeInferencer(
            model, params, patch_size=self.patch, batch_slices=batch_slices,
            class_indices=class_indices,
        )

    def warmup(self):
        """Compile + execute the forward on dummy data; returns seconds."""
        t0 = time.perf_counter()
        dummy = np.zeros((1,) + self.patch, np.float32)
        self.inferencer.predict_slices(dummy)
        return time.perf_counter() - t0

    def segment(self, volume: np.ndarray) -> np.ndarray:
        """(D, H, W) float32 -> (D, H, W) int32 labels at input resolution."""
        from concurrent.futures import ThreadPoolExecutor

        from scipy.ndimage import zoom as nd_zoom

        d, x, y = volume.shape
        ph, pw = self.patch
        needs_zoom = (x, y) != (ph, pw)
        with ThreadPoolExecutor(8) as pool:
            if needs_zoom:
                slices = np.stack(list(pool.map(
                    lambda s: nd_zoom(s, (ph / x, pw / y), order=3), volume
                ))).astype(np.float32)
            else:
                slices = volume.astype(np.float32)
            preds = self.inferencer.predict_slices(slices)
            if needs_zoom:
                preds = np.stack(list(pool.map(
                    lambda s: nd_zoom(s, (x / ph, y / pw), order=0), preds
                )))
        return preds.astype(np.int32)

    def process_file(self, path: str, output_dir: str) -> dict:
        """Segment one volume file; write <case>_pred.nii.gz; return stats."""
        case = os.path.basename(path)
        for suf in (".npy.h5", ".h5", ".npz", ".npy"):
            if case.endswith(suf):
                case = case[: -len(suf)]
                break
        t0 = time.perf_counter()
        vol = read_volume(path)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = self.segment(vol)
        t_seg = time.perf_counter() - t0
        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, f"{case}_pred.nii.gz")
        t0 = time.perf_counter()
        write_nifti(out_path, pred.astype(np.float32),
                    (1, 1, self.z_spacing))
        t_write = time.perf_counter() - t0
        return {
            "case": case,
            "slices": int(vol.shape[0]),
            "shape": list(vol.shape),
            "output": out_path,
            "read_s": round(t_read, 4),
            "segment_s": round(t_seg, 4),
            "write_s": round(t_write, 4),
            "slices_per_s": round(vol.shape[0] / max(t_seg, 1e-9), 2),
        }


class ServeStats:
    """Latency aggregation across volumes: p50/p95 of per-volume segment
    and end-to-end latency, overall slice throughput (the SLO numbers a
    deployment tracks)."""

    def __init__(self):
        self.seg_s: list[float] = []
        self.total_s: list[float] = []
        self.slices = 0
        self.failed = 0

    def record(self, stats: dict):
        self.seg_s.append(stats["segment_s"])
        self.total_s.append(stats["read_s"] + stats["segment_s"]
                            + stats["write_s"])
        self.slices += stats["slices"]

    def summary(self) -> dict:
        if not self.seg_s:
            return {"volumes": 0, "failed": self.failed}
        pct = lambda xs, q: round(float(np.percentile(xs, q)), 4)
        return {
            "volumes": len(self.seg_s),
            "failed": self.failed,
            "slices": self.slices,
            "segment_p50_s": pct(self.seg_s, 50),
            "segment_p95_s": pct(self.seg_s, 95),
            "latency_p50_s": pct(self.total_s, 50),
            "latency_p95_s": pct(self.total_s, 95),
            "slices_per_s": round(self.slices / max(sum(self.seg_s), 1e-9), 2),
        }


def watch_loop(server: VolumeServer, watch_dir: str, output_dir: str, *,
               poll_s: float = 1.0, quiesce_s: float | None = None,
               max_volumes: int | None = None, emit=print):
    """Poll ``watch_dir`` for volumes, process each, move it to done/.

    A file is picked up only once QUIESCENT — its (size, mtime) unchanged
    for at least ``quiesce_s`` seconds (default ``max(2·poll_s, 0.25)``)
    and non-empty — so a volume still being copied in is left alone until
    fully written, not quarantined mid-write. A duration (not just
    two-consecutive-polls) is required because a slow writer's inter-chunk
    gap can straddle a whole poll interval. (Writers can also use the
    write-then-rename protocol: ``*.tmp`` names are always ignored.)

    ``max_volumes`` bounds the number processed (tests / drain mode);
    None = run forever. A failed volume is moved to failed/ with the error
    recorded, so one bad file cannot wedge the queue. Returns the count
    processed and emits a final p50/p95 latency summary line."""
    if quiesce_s is None:
        quiesce_s = max(2 * poll_s, 0.25)
    done_dir = os.path.join(watch_dir, "done")
    failed_dir = os.path.join(watch_dir, "failed")
    os.makedirs(done_dir, exist_ok=True)
    processed = 0
    agg = ServeStats()
    seen: dict[str, tuple] = {}  # name -> (sig, stable_since)
    while max_volumes is None or processed < max_volumes:
        now = time.monotonic()
        snap = {}
        for n in sorted(os.listdir(watch_dir)):
            if not n.endswith((".npy.h5", ".h5", ".npz", ".npy")):
                continue
            p = os.path.join(watch_dir, n)
            if not os.path.isfile(p):
                continue
            try:
                st = os.stat(p)
            except OSError:
                continue  # renamed/removed between listdir and stat
            snap[n] = (st.st_size, st.st_mtime)
        for n, sig in snap.items():
            if n not in seen or seen[n][0] != sig:
                seen[n] = (sig, now)
        for n in list(seen):
            if n not in snap:
                del seen[n]
        ready = [n for n, sig in snap.items()
                 if sig[0] > 0 and now - seen[n][1] >= quiesce_s]
        if not ready:
            time.sleep(poll_s)
            continue
        for name in ready:
            if max_volumes is not None and processed >= max_volumes:
                break
            path = os.path.join(watch_dir, name)
            try:
                stats = server.process_file(path, output_dir)
                shutil.move(path, os.path.join(done_dir, name))
                agg.record(stats)
                emit(json.dumps(stats))
            except Exception as e:  # noqa: BLE001 — quarantine, keep serving
                os.makedirs(failed_dir, exist_ok=True)
                shutil.move(path, os.path.join(failed_dir, name))
                agg.failed += 1
                emit(json.dumps({"case": name, "error": str(e)[:200]}))
            seen.pop(name, None)
            processed += 1
    emit(json.dumps({"summary": agg.summary()}))
    return processed
