"""Video IO: frame extraction and H.264 muxing with source audio.

A copy of `e4s2024_tpu/video_io.py` (reference
gradio_utils/face_swapping.py:53-119, cv2 frame extraction + ffmpeg mux).
Decode and encode stream raw RGB through an ffmpeg pipe when the binary is
present (no per-frame image files on disk); cv2 otherwise, imported where it
is used, so that importing this module needs neither. The video pipeline
takes frames as arrays and never imports this module.
"""

from __future__ import annotations

import json
import shutil
import subprocess

import numpy as np

_FFMPEG = shutil.which("ffmpeg")
_FFPROBE = shutil.which("ffprobe")


def _probe(video_path: str) -> tuple[int, int, float] | None:
    """(width, height, fps) via ffprobe, or None when unavailable."""
    if _FFPROBE is None:
        return None
    try:
        out = subprocess.run(
            [_FFPROBE, "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height,r_frame_rate",
             "-of", "json", video_path],
            check=True, capture_output=True).stdout
        st = json.loads(out)["streams"][0]
        num, den = st["r_frame_rate"].split("/")
        fps = float(num) / max(float(den), 1.0)
        return int(st["width"]), int(st["height"]), fps or 25.0
    except (OSError, subprocess.CalledProcessError, ValueError, KeyError, IndexError):
        # no usable stream description: decode through cv2 instead
        return None


def extract_frames(video_path: str, max_frames: int | None = None
                   ) -> tuple[list[np.ndarray], float]:
    """Decode a video into RGB uint8 frames. Returns (frames, fps).

    ffmpeg rawvideo pipe when available (threaded decode, one memcpy per
    frame); cv2.VideoCapture fallback."""
    meta = _probe(video_path) if _FFMPEG is not None else None
    if meta is not None:
        w, h, fps = meta
        nbytes = w * h * 3
        cmd = [_FFMPEG, "-v", "error", "-threads", "0", "-i", video_path,
               "-f", "rawvideo", "-pix_fmt", "rgb24"]
        if max_frames:
            cmd += ["-frames:v", str(max_frames)]
        cmd += ["-"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        frames = []
        try:
            while True:
                buf = proc.stdout.read(nbytes)
                if len(buf) < nbytes:
                    break
                frames.append(
                    np.frombuffer(buf, np.uint8).reshape(h, w, 3).copy())
                if max_frames and len(frames) >= max_frames:
                    break
        finally:
            proc.stdout.close()
            proc.wait()
        if frames:
            return frames, fps

    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    return frames, fps


def write_video(frames: list[np.ndarray], out_path: str, fps: float = 25.0,
                audio_from: str | None = None,
                preset: str = "veryfast") -> str:
    """Encode RGB frames to H.264, muxing audio from `audio_from` when ffmpeg
    is available. Frames stream to ffmpeg's stdin as raw RGB (no temp image
    files); `preset` is the x264 speed/size trade-off."""
    if _FFMPEG is None:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return out_path

    h, w = frames[0].shape[:2]
    cmd = [_FFMPEG, "-y", "-v", "error", "-f", "rawvideo",
           "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-framerate", str(fps),
           "-i", "-"]
    if audio_from:
        cmd += ["-i", audio_from, "-map", "0:v", "-map", "1:a?",
                "-c:a", "aac", "-shortest"]
    cmd += ["-c:v", "libx264", "-preset", preset, "-pix_fmt", "yuv420p",
            "-threads", "0", out_path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    try:
        for f in frames:
            proc.stdin.write(np.ascontiguousarray(f, np.uint8).tobytes())
    finally:
        proc.stdin.close()
        ret = proc.wait()
    if ret != 0:
        raise RuntimeError(f"ffmpeg encode failed with exit code {ret}")
    return out_path
