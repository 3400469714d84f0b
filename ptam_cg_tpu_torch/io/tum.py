"""TUM-RGBD-style dataset reader and writer (port of ``ptam_cg_tpu.io.tum``).

The reference's VideoSourceDataSet (src/VideoSource.cc:59-159): parses
``rgb.txt`` (lines of ``timestamp filename``, '#' comments), loads frames
in order as grayscale float32 in [0, 255], optionally paces playback at a
fixed frame rate, and wraps around at the end of the sequence.

Frames are read with numpy alone where it can: ``.npy`` (what the
synthetic harness writes) and binary PGM (P5, 8-bit). Any other format
(PNG, JPG) needs PIL; without it the read raises. A frame that cannot be
read raises: no frame is skipped.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ptam_cg_tpu_torch.utils import se3 as se3lib


def _read_pgm(path: str) -> np.ndarray:
    """A binary 8-bit PGM (P5) as float32, scaled by 255 / maxval as the
    native frame pump scales it."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxv = fields[0], int(fields[1]), int(fields[2]), \
        int(fields[3])
    if magic != b"P5" or not 0 < maxv <= 255:
        raise ValueError(f"{path}: not an 8-bit binary PGM (P5)")
    pixels = np.frombuffer(data, np.uint8, w * h, pos + 1)
    scale = np.float32(255.0) / np.float32(maxv)
    return pixels.reshape(h, w).astype(np.float32) * scale


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".pgm"):
        return _read_pgm(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path}: reading this format needs PIL, which is not "
                f"installed; use .npy or .pgm frames") from e
        arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        # BT.601 luma, as CVD::convert does rgb -> byte.
        arr = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
               + 0.114 * arr[..., 2])
    return arr.astype(np.float32)


class TumDataset:
    """Deterministic dataset replay (VideoSourceDataSet)."""

    def __init__(self, root: str, index_file: str = "rgb.txt",
                 framerate: Optional[float] = None, loop: bool = True):
        self.root = root
        self.framerate = framerate
        self.loop = loop
        self.entries: List[Tuple[float, str]] = []
        index_path = os.path.join(root, index_file)
        with open(index_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                self.entries.append((float(parts[0]), parts[1]))
        if not self.entries:
            raise ValueError(f"no frames listed in {index_path}")
        self._pos = 0
        self._last_time = None

    def __len__(self) -> int:
        return len(self.entries)

    def timestamps(self) -> np.ndarray:
        return np.array([t for t, _ in self.entries])

    def frame(self, i: int) -> np.ndarray:
        _, rel = self.entries[i % len(self.entries)]
        return _load_image(os.path.join(self.root, rel))

    def next_frame(self) -> Tuple[float, np.ndarray]:
        """The next frame, wrapping around (or StopIteration without
        ``loop``), paced at ``framerate`` (the reference's dataset sleep,
        src/VideoSource.cc:102-103)."""
        if self._pos >= len(self.entries):
            if not self.loop:
                raise StopIteration
            self._pos = 0
        ts, rel = self.entries[self._pos]
        self._pos += 1
        if self.framerate:
            now = time.monotonic()
            if self._last_time is not None:
                wait = (1.0 / self.framerate) - (now - self._last_time)
                if wait > 0:
                    time.sleep(wait)
            self._last_time = time.monotonic()
        return ts, _load_image(os.path.join(self.root, rel))

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for i in range(len(self.entries)):
            yield self.entries[i][0], self.frame(i)


def load_groundtruth(root: str, fname: str = "groundtruth.txt"):
    """Parse a TUM groundtruth.txt (``timestamp tx ty tz qx qy qz qw``).
    Returns (timestamps (N,), positions (N, 3), quaternions wxyz (N, 4))."""
    ts, pos, quat = [], [], []
    with open(os.path.join(root, fname)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            pos.append(v[1:4])
            quat.append([v[7], v[4], v[5], v[6]])   # -> wxyz
    return (np.array(ts), np.array(pos, np.float32),
            np.array(quat, np.float32))


def write_synthetic_dataset(root: str, frames, timestamps=None, poses=None,
                            png: bool = False):
    """Write frames (arrays or tensors) as a TUM-layout dataset: float32
    ``.npy`` images, or 8-bit PNGs with ``png=True`` (needs PIL).

    ``poses``: optional world -> camera ``SE3``s; writes a TUM-format
    ``groundtruth.txt`` (camera to world, ``ts tx ty tz qx qy qz qw``)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    lines = ["# synthetic dataset", "# timestamp filename"]
    tss = []
    for i, frame in enumerate(frames):
        ts = timestamps[i] if timestamps is not None else i / 25.0
        tss.append(ts)
        if isinstance(frame, torch.Tensor):
            frame = frame.cpu().numpy()
        arr = np.asarray(frame, np.float32)
        if png:
            from PIL import Image
            rel = f"rgb/{i:06d}.png"
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                os.path.join(root, rel))
        else:
            rel = f"rgb/{i:06d}.npy"
            np.save(os.path.join(root, rel), arr)
        lines.append(f"{ts:.6f} {rel}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if poses is not None:
        glines = ["# ground truth trajectory",
                  "# timestamp tx ty tz qx qy qz qw"]
        for ts, p in zip(tss, poses):
            T = se3lib.inv(p)                       # camera to world
            q = se3lib.quat_from_rot(T.R).cpu().numpy()   # wxyz
            c = T.t.cpu().numpy()
            glines.append(
                f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("\n".join(glines) + "\n")
