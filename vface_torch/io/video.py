"""Video IO: Y4M read/write, the prefetch ring, the AVI writer with audio, WAV and GIF.

Port of ``vface_tpu/io/video.py``. The fast path is a ``ctypes`` binding over
the repository's dependency-free C++17 library ``native/vface_io.cc``, built
with ``g++`` on first use into ``build/vface_torch/libvface_io-<digest>.so`` at
the root of the checkout (``<digest>`` hashes the source, its header and the
flags). Nothing is built or loaded at import time, and a failed build raises
with the compiler's output: there is no silent fallback.

* Y4M (YUV4MPEG2, BT.601 limited range, 4:2:0) reader and writer;
* ``iter_y4m_prefetched``: a producer thread in the library decodes frames
  to float32 RGB in [0, 1] ahead of the consumer;
* ``write_avi``: an uncompressed (DIB, BGR24) AVI, with an interleaved
  16-bit PCM stream when audio is given;
* ``read_wav`` (stdlib ``wave``) and ``write_gif``.

``_read_y4m_py`` / ``_write_y4m_py`` are the pure-Python Y4M codec, the plain
version the native one is tested against; ``read_y4m`` and ``write_y4m`` take
it only when asked (``plain=True``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "vface_io.cc"
HEADER = ROOT / "native" / "vface_io.h"
BUILD_DIR = ROOT / "build" / "vface_torch"
GXX = "g++"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # name: (restype, argtypes)
    "vf_y4m_open": (_P, [ctypes.c_char_p]),
    "vf_y4m_width": (_I, [_P]),
    "vf_y4m_height": (_I, [_P]),
    "vf_y4m_fps_num": (_I, [_P]),
    "vf_y4m_fps_den": (_I, [_P]),
    "vf_y4m_read_rgb": (_I, [_P, _P]),
    "vf_y4m_close": (None, [_P]),
    "vf_y4m_create": (_P, [ctypes.c_char_p, _I, _I, _I, _I]),
    "vf_y4m_write_rgb": (_I, [_P, _P]),
    "vf_y4m_close_writer": (None, [_P]),
    "vf_avi_create": (_P, [ctypes.c_char_p, _I, _I, _I]),
    "vf_avi_create2": (_P, [ctypes.c_char_p, _I, _I, _I, _I, _I, _I]),
    "vf_avi_write_rgb": (_I, [_P, _P]),
    "vf_avi_write_audio": (_I, [_P, _P, ctypes.c_uint32]),
    "vf_avi_finish": (_I, [_P]),
    "vf_prefetch_open": (_P, [ctypes.c_char_p, _I]),
    "vf_prefetch_width": (_I, [_P]),
    "vf_prefetch_height": (_I, [_P]),
    "vf_prefetch_next": (_I, [_P, _P]),
    "vf_prefetch_close": (None, [_P]),
}


def lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + HEADER.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libvface_io-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises with the
    compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [GXX, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"vface_torch: cannot run {GXX} to build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"vface_torch: building {SOURCE.name} failed\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    """The native library, built and loaded on first use, every function's
    ``restype`` and ``argtypes`` declared."""
    with _lock:
        if "io" not in _libs:
            lib = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _libs["io"] = lib
        return _libs["io"]


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _frames_u8(frames_u8) -> np.ndarray:
    """Validate (N, H, W, 3) uint8 frames; C-contiguous."""
    a = np.asarray(frames_u8)
    if a.dtype != np.uint8 or a.ndim != 4 or a.shape[-1] != 3:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got {a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


# ------------------------------------------------------------------- readers


def read_y4m(path: str, plain: bool = False) -> Tuple[np.ndarray, int]:
    """Y4M file -> (frames uint8 (N, H, W, 3), fps); ``plain`` reads with the Python codec."""
    if plain:
        return _read_y4m_py(path)
    lib = _lib()
    h = lib.vf_y4m_open(os.fsencode(path))
    if not h:
        raise IOError(f"cannot open Y4M: {path}")
    try:
        w, hh = lib.vf_y4m_width(h), lib.vf_y4m_height(h)
        fps = max(1, lib.vf_y4m_fps_num(h) // max(1, lib.vf_y4m_fps_den(h)))
        frames = []
        buf = np.empty((hh, w, 3), np.uint8)
        while lib.vf_y4m_read_rgb(h, _ptr(buf)) == 1:
            frames.append(buf.copy())
    finally:
        lib.vf_y4m_close(h)
    return (np.stack(frames) if frames else np.empty((0, hh, w, 3), np.uint8)), fps


def iter_y4m_prefetched(path: str, depth: int = 4) -> Iterator[np.ndarray]:
    """Stream float32 [0, 1] frames (H, W, 3) through the native prefetch ring
    (``depth`` frames decoded ahead by the library's producer thread)."""
    lib = _lib()
    h = lib.vf_prefetch_open(os.fsencode(path), depth)
    if not h:
        raise IOError(f"cannot open Y4M: {path}")
    try:
        buf = np.empty((lib.vf_prefetch_height(h), lib.vf_prefetch_width(h), 3), np.float32)
        while lib.vf_prefetch_next(h, _ptr(buf)) == 1:
            yield buf.copy()
    finally:
        lib.vf_prefetch_close(h)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV file -> (int16 PCM (n_samples, channels), sample_rate); 8-bit
    unsigned samples are widened to int16."""
    import wave

    with wave.open(path, "rb") as f:
        sr, ch, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, np.int16)
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.int16) - 128) << 8
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return pcm.reshape(-1, ch), sr


# ------------------------------------------------------------------- writers


def write_y4m(path: str, frames_u8, fps: int = 10, plain: bool = False) -> None:
    """(N, H, W, 3) uint8 frames -> a 4:2:0 Y4M at ``fps``; ``plain`` writes with the Python codec."""
    frames = _frames_u8(frames_u8)
    if plain:
        return _write_y4m_py(path, frames, fps)
    lib = _lib()
    n, hh, w, _ = frames.shape
    h = lib.vf_y4m_create(os.fsencode(path), w, hh, fps, 1)
    if not h:
        raise IOError(f"cannot create Y4M: {path}")
    try:
        for f in frames:
            if lib.vf_y4m_write_rgb(h, _ptr(f)) != 1:
                raise IOError(f"cannot write Y4M frame: {path}")
    finally:
        lib.vf_y4m_close_writer(h)


def write_avi(path: str, frames_u8, fps: int = 10, audio: Optional[np.ndarray] = None,
              sample_rate: int = 0) -> None:
    """A playable uncompressed AVI at ``fps``. ``audio``: int16 PCM, (n_samples,)
    or (n_samples, channels), interleaved as a second stream, each video frame
    followed by its share of the samples (frame i gets samples
    [i * total // n, (i + 1) * total // n))."""
    lib = _lib()
    frames = _frames_u8(frames_u8)
    n, hh, w, _ = frames.shape
    pcm = None
    if audio is not None and sample_rate > 0:
        pcm = np.asarray(audio, np.int16)
        pcm = np.ascontiguousarray(pcm[:, None] if pcm.ndim == 1 else pcm)
        h = lib.vf_avi_create2(os.fsencode(path), w, hh, fps, sample_rate, pcm.shape[1], 16)
    else:
        h = lib.vf_avi_create(os.fsencode(path), w, hh, fps)
    if not h:
        raise IOError(f"cannot create AVI: {path}")
    total = 0 if pcm is None else pcm.shape[0]
    for i in range(n):
        lib.vf_avi_write_rgb(h, _ptr(frames[i]))
        if pcm is not None:
            s0, s1 = (i * total) // n, ((i + 1) * total) // n if i + 1 < n else total
            if s1 > s0:
                chunk = np.ascontiguousarray(pcm[s0:s1])
                lib.vf_avi_write_audio(h, _ptr(chunk), chunk.nbytes)
    lib.vf_avi_finish(h)


def write_gif(path: str, frames_u8, fps: int = 10) -> None:
    """An animated, looping GIF at ``fps`` (PIL's adaptive palette per frame)."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in _frames_u8(frames_u8)]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)


# ----------------------------------------------------- the plain Python codec


def _read_y4m_py(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        header = f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise IOError(f"not a Y4M file: {path}")
        w = h = 0
        fps = 30
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                fps = max(1, int(num) // int(den))
        frames = []
        ysz, csz = w * h, (w // 2) * (h // 2)
        while True:
            line = f.readline()
            if not line or not line.startswith(b"FRAME"):
                break
            raw = f.read(ysz + 2 * csz)
            if len(raw) < ysz + 2 * csz:
                break
            y = np.frombuffer(raw[:ysz], np.uint8).reshape(h, w).astype(np.int32)
            u = np.frombuffer(raw[ysz:ysz + csz], np.uint8).reshape(h // 2, w // 2)
            v = np.frombuffer(raw[ysz + csz:], np.uint8).reshape(h // 2, w // 2)
            u = u.repeat(2, 0).repeat(2, 1).astype(np.int32)
            v = v.repeat(2, 0).repeat(2, 1).astype(np.int32)
            c, d, e = y - 16, u - 128, v - 128
            r = np.clip((298 * c + 409 * e + 128) >> 8, 0, 255)
            g = np.clip((298 * c - 100 * d - 208 * e + 128) >> 8, 0, 255)
            b = np.clip((298 * c + 516 * d + 128) >> 8, 0, 255)
            frames.append(np.stack([r, g, b], axis=-1).astype(np.uint8))
        return (np.stack(frames) if frames else np.empty((0, h, w, 3), np.uint8)), fps


def _write_y4m_py(path: str, frames_u8: np.ndarray, fps: int) -> None:
    n, h, w, _ = frames_u8.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for fr in frames_u8.astype(np.int32):
            r, g, b = fr[..., 0], fr[..., 1], fr[..., 2]
            y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 0, 255)
            u = np.clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 0, 255)
            v = np.clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 0, 255)
            u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
            v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
            f.write(b"FRAME\n")
            f.write(y.astype(np.uint8).tobytes())
            f.write(u.astype(np.uint8).tobytes())
            f.write(v.astype(np.uint8).tobytes())
