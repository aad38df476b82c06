"""Frame images, and video decode/encode.

Frames and masks are PNGs read and written by the first-party codec in
omfs4d.io.png.  Video containers are host I/O on optional dependencies:
decoding (`probe_video`, `extract_frames`) needs OpenCV, and stitching
prefers a real ffmpeg binary (libx264 yuv420p crf18 — the reference's exact
encode contract, render_surgery.py:433-441) and falls back through cv2
codecs: avc1 -> mp4v -> MJPG.  Replaces the reference's ffmpeg subprocess
usage for frame extraction (ref: preprocess_video.py:45-54) and H.264
stitching (ref: render_surgery.py:412-449).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from omfs4d.io.png import SIGNATURE, decode_png, write_png


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (the opencv-python package), which is not "
            "installed") from e
    return cv2


def probe_video(path: str | Path) -> dict:
    cv2 = _cv2("reading a video container")
    cap = cv2.VideoCapture(str(path))
    try:
        return {
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "fps": float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
            "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        }
    finally:
        cap.release()


def extract_frames(
    video_path: str | Path,
    output_dir: str | Path,
    target_size: int = 0,
    max_frames: int = 0,
    stride: int = 1,
) -> list[Path]:
    """Decode a video into numbered PNG frames (RGB), optionally downscaled
    so min(H, W) ~ target_size (ref downsample policy: preprocess_video.py:452-463)."""
    cv2 = _cv2("decoding video frames")
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(video_path))
    paths = []
    i = kept = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            if target_size > 0:
                h, w = frame.shape[:2]
                scale = target_size / min(h, w)
                if scale < 1.0:
                    frame = cv2.resize(frame, (int(round(w * scale)), int(round(h * scale))),
                                       interpolation=cv2.INTER_AREA)
            p = out / f"{kept:05d}.png"
            write_png(p, frame[..., ::-1])           # cv2 decodes BGR
            paths.append(p)
            kept += 1
            if max_frames and kept >= max_frames:
                break
        i += 1
    cap.release()
    return paths


def read_image(path: str | Path) -> np.ndarray:
    """Read an image as (H, W, 3) uint8 RGB (grey is replicated, alpha
    dropped).  PNGs go through the first-party codec; other formats need
    OpenCV."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"cannot read image: {path}")
    data = path.read_bytes()
    if data[:8] != SIGNATURE:
        cv2 = _cv2(f"reading {path.suffix or 'non-PNG'} images")
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cannot decode image: {path}")
        return img[..., ::-1].copy()
    img = decode_png(data)
    if img.shape[2] < 3:
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def write_image(path: str | Path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) RGB or (H, W) grey image as PNG; float input in
    [0, 1] is scaled to 8 bits."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
    write_png(path, arr)


def find_ffmpeg() -> str | None:
    """Locate an ffmpeg binary: PATH first, then the imageio_ffmpeg wheel."""
    exe = shutil.which("ffmpeg")
    if exe:
        return exe
    try:                                           # pragma: no cover - env
        import imageio_ffmpeg
        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        return None


def find_encoder() -> str | None:
    """The video encoder `stitch_video` would use, or None if none exists."""
    exe = find_ffmpeg()
    if exe:
        return f"ffmpeg ({exe})"
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    return "opencv"


def ffmpeg_stitch_cmd(ffmpeg_bin: str, pattern: str, output_path: str,
                      fps: int, crf: int = 18) -> list[str]:
    """The reference's exact H.264 encode invocation
    (render_surgery.py:433-441): libx264, yuv420p, preset medium, CRF 18."""
    return [
        ffmpeg_bin, "-y",
        "-framerate", str(fps),
        "-i", pattern,
        "-c:v", "libx264",
        "-pix_fmt", "yuv420p",
        "-preset", "medium",
        "-crf", str(crf),
        str(output_path),
    ]


def _stitch_ffmpeg(frames: list[Path], out_path: Path, fps: int,
                   ffmpeg_bin: str) -> None:
    import tempfile

    with tempfile.TemporaryDirectory(prefix="stitch_") as tmp:
        for i, src in enumerate(frames):
            shutil.copy2(src, Path(tmp) / f"frame_{i:05d}.png")
        cmd = ffmpeg_stitch_cmd(
            ffmpeg_bin, str(Path(tmp) / "frame_%05d.png"), str(out_path), fps)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"ffmpeg failed:\n{res.stderr[-2000:]}")


def stitch_video(frames_dir: str | Path, output_path: str | Path, fps: int = 30) -> Path:
    """Stitch sorted PNG frames into an MP4 (parity: render_surgery.py:412-449).

    Uses ffmpeg (libx264 yuv420p crf18 — the reference's encode contract)
    when a binary is available; otherwise the cv2 codec ladder.
    """
    frames = sorted(Path(frames_dir).glob("*.png"))
    if not frames:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")
    out_path = Path(output_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin:
        _stitch_ffmpeg(frames, out_path, fps, ffmpeg_bin)
        return out_path

    cv2 = _cv2("stitching an MP4 without an ffmpeg binary")
    h, w = read_image(frames[0]).shape[:2]

    writer = None
    for codec in ("avc1", "mp4v", "MJPG"):
        fourcc = cv2.VideoWriter_fourcc(*codec)
        writer = cv2.VideoWriter(str(out_path), fourcc, float(fps), (w, h))
        if writer.isOpened():
            break
        writer.release()
        writer = None
    if writer is None:
        raise RuntimeError("no available video codec (tried avc1, mp4v, MJPG)")

    for p in frames:
        img = np.ascontiguousarray(read_image(p)[..., ::-1])
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        writer.write(img)
    writer.release()
    return out_path
