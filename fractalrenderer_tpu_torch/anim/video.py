"""FFmpeg video encoding — port of src/video_encoder.{h,cpp}.

Same codec × quality matrix (video_encoder.cpp:82-193), same command shape
(`ffmpeg -framerate N -i frame_%06d.png …`, :195-224), same progress parsing
of `-progress pipe:1` key=value lines (:360-487), with graceful degradation
when ffmpeg is absent (vk_engine.cpp:121-128).

The PyTorch port's own copy of ``fractalrenderer_tpu/anim/video.py`` (that
package imports jax on import, so the port cannot share it); the two
stay line for line the same below this docstring.
"""
from __future__ import annotations

import enum
import os
import re
import shutil
import struct
import subprocess
from dataclasses import dataclass
from typing import Callable, List, Optional


class VideoCodec(enum.Enum):
    H264 = "h264"
    H265 = "h265"
    VP9 = "vp9"
    PRORES = "prores"
    AV1 = "av1"
    # Beyond the reference: lossless PNG-in-MOV muxed in pure Python —
    # the one codec that needs NO external binary (anim/qtpng.py)
    QTPNG = "qtpng"


class VideoQuality(enum.Enum):
    DRAFT = "draft"
    GOOD = "good"
    HIGH = "high"
    LOSSLESS = "lossless"


@dataclass
class VideoEncodeSettings:
    """video_encoder.h:22-31."""

    output_filename: str = "animation.mp4"
    codec: VideoCodec = VideoCodec.H264
    quality: VideoQuality = VideoQuality.HIGH
    fps: int = 60
    crf: int = 18
    audio_file: str = ""
    cleanup_frames: bool = False


@dataclass
class EncodeProgress:
    """video_encoder.h:33-42."""

    encoding: bool = False
    current_frame: int = 0
    total_frames: int = 0
    fps: float = 0.0
    progress: float = 0.0
    finished: bool = False
    success: bool = False
    error: str = ""


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def get_codec_params(settings: VideoEncodeSettings) -> List[str]:
    """Codec/quality matrix (video_encoder.cpp:82-193)."""
    c, q = settings.codec, settings.quality
    if c == VideoCodec.H264:
        args = ["-c:v", "libx264"]
        args += {
            VideoQuality.DRAFT: ["-preset", "veryfast", "-crf", "28"],
            VideoQuality.GOOD: ["-preset", "medium", "-crf", "23"],
            VideoQuality.HIGH: ["-preset", "slow", "-crf", str(settings.crf)],
            VideoQuality.LOSSLESS: ["-preset", "medium", "-crf", "0"],
        }[q]
        args += ["-pix_fmt", "yuv420p"]
    elif c == VideoCodec.H265:
        args = ["-c:v", "libx265"]
        args += {
            VideoQuality.DRAFT: ["-preset", "veryfast", "-crf", "28"],
            VideoQuality.GOOD: ["-preset", "medium", "-crf", "28"],
            VideoQuality.HIGH: ["-preset", "slow", "-crf", str(settings.crf)],
            VideoQuality.LOSSLESS: ["-preset", "medium", "-x265-params",
                                    "lossless=1"],
        }[q]
        args += ["-pix_fmt", "yuv420p"]
    elif c == VideoCodec.VP9:
        args = ["-c:v", "libvpx-vp9"]
        args += {
            VideoQuality.DRAFT: ["-crf", "40", "-b:v", "0"],
            VideoQuality.GOOD: ["-crf", "31", "-b:v", "0"],
            VideoQuality.HIGH: ["-crf", "15", "-b:v", "0"],
            VideoQuality.LOSSLESS: ["-lossless", "1"],
        }[q]
        args += ["-row-mt", "1"]
    elif c == VideoCodec.PRORES:
        args = ["-c:v", "prores_ks"]
        args += {
            VideoQuality.DRAFT: ["-profile:v", "0"],
            VideoQuality.GOOD: ["-profile:v", "2"],
            VideoQuality.HIGH: ["-profile:v", "3"],
            VideoQuality.LOSSLESS: ["-profile:v", "3", "-qscale:v", "0"],
        }[q]
        args += ["-pix_fmt", "yuv422p10le"]
    elif c == VideoCodec.AV1:
        args = ["-c:v", "libaom-av1"]
        args += {
            VideoQuality.DRAFT: ["-crf", "40", "-b:v", "0", "-cpu-used", "8"],
            VideoQuality.GOOD: ["-crf", "30", "-b:v", "0", "-cpu-used", "4"],
            VideoQuality.HIGH: ["-crf", "20", "-b:v", "0", "-cpu-used", "2"],
            VideoQuality.LOSSLESS: ["-crf", "0", "-b:v", "0"],
        }[q]
    else:
        raise ValueError(c)
    return args


def build_ffmpeg_command(frames_folder: str,
                         settings: VideoEncodeSettings) -> List[str]:
    """video_encoder.cpp:195-224 (argv form instead of a shell string)."""
    cmd = ["ffmpeg", "-y", "-framerate", str(settings.fps),
           "-i", os.path.join(frames_folder, "frame_%06d.png")]
    if settings.audio_file and os.path.exists(settings.audio_file):
        cmd += ["-i", settings.audio_file, "-c:a", "aac", "-b:a", "192k",
                "-shortest"]
    cmd += get_codec_params(settings)
    # -progress / -loglevel must precede the output filename: ffmpeg treats
    # everything after an output file as options for a *next* output and
    # ignores them, which would starve the progress parser (the reference
    # has this exact bug at video_encoder.cpp:218-222; fixed here).
    cmd += ["-progress", "pipe:1", "-loglevel", "warning",
            settings.output_filename]
    return cmd


class VideoEncoder:
    def __init__(self):
        self.progress = EncodeProgress()
        self._cancel = False
        self.on_progress: Optional[Callable[[EncodeProgress], None]] = None

    def cancel(self):
        self._cancel = True

    def encode(self, frames_folder: str,
               settings: VideoEncodeSettings) -> bool:
        """video_encoder.cpp:226-358."""
        self.progress = EncodeProgress(encoding=True)
        if settings.codec != VideoCodec.QTPNG and not ffmpeg_available():
            self.progress.error = ("FFmpeg not found in PATH (use codec "
                                   "'qtpng' for the built-in lossless "
                                   "PNG-in-MOV muxer)")
            self.progress.finished = True
            return False

        frames = sorted(f for f in os.listdir(frames_folder)
                        if re.fullmatch(r"frame_\d{6}\.png", f))
        if not frames:
            self.progress.error = f"No frames found in {frames_folder}"
            self.progress.finished = True
            return False
        self.progress.total_frames = len(frames)

        if settings.codec == VideoCodec.QTPNG:
            return self._encode_qtpng(frames_folder, frames, settings)

        cmd = build_ffmpeg_command(frames_folder, settings)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            self.progress.error = str(e)
            self.progress.finished = True
            return False

        # Parse `-progress pipe:1` key=value output (video_encoder.cpp:360-487)
        for line in proc.stdout:
            if self._cancel:
                proc.terminate()
                break
            line = line.strip()
            if line.startswith("frame="):
                try:
                    self.progress.current_frame = int(line.split("=", 1)[1])
                    self.progress.progress = (self.progress.current_frame
                                              / max(self.progress.total_frames, 1))
                except ValueError:
                    pass
            elif line.startswith("fps="):
                try:
                    self.progress.fps = float(line.split("=", 1)[1])
                except ValueError:
                    pass
            if self.on_progress:
                self.on_progress(self.progress)
        rc = proc.wait()

        self.progress.encoding = False
        self.progress.finished = True
        self.progress.success = (rc == 0 and not self._cancel
                                 and os.path.exists(settings.output_filename))
        if not self.progress.success and not self.progress.error:
            self.progress.error = f"ffmpeg exited with code {rc}"

        if self.progress.success and settings.cleanup_frames:
            for f in frames:  # video_encoder.cpp:323-331
                try:
                    os.remove(os.path.join(frames_folder, f))
                except OSError:
                    pass
        return self.progress.success

    def _encode_qtpng(self, frames_folder: str, frames: List[str],
                      settings: VideoEncodeSettings) -> bool:
        """Built-in lossless path: mux the PNG frames into a QuickTime
        .mov with the 'png ' codec (anim/qtpng.py) — no subprocess."""
        from . import qtpng

        out = settings.output_filename
        if not out.lower().endswith(".mov"):
            out = os.path.splitext(out)[0] + ".mov"
            settings.output_filename = out
        try:
            paths = [os.path.join(frames_folder, f) for f in frames]

            def tick(k):
                self.progress.current_frame = k
                self.progress.progress = k / max(len(frames), 1)
                if self.on_progress:
                    self.on_progress(self.progress)

            tick(0)
            info = qtpng.write_mov(out, paths, settings.fps)
            tick(len(frames))
        except (OSError, ValueError, struct.error) as e:
            self.progress.error = str(e)
            self.progress.finished = True
            self.progress.encoding = False
            return False
        self.progress.encoding = False
        self.progress.finished = True
        self.progress.success = info["frames"] == len(frames)
        if self.progress.success and settings.cleanup_frames:
            for f in frames:
                try:
                    os.remove(os.path.join(frames_folder, f))
                except OSError:
                    pass
        return self.progress.success
