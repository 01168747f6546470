"""Build the native host codecs: ``python -m amw_tpu_torch.native.build``.

Each ``.cpp`` of this directory is compiled by ``g++`` into a plain shared
library under ``amw_tpu_torch/_build/``, named by the hash of its source
and flags (an edited source rebuilds), and loaded with ``ctypes`` by
``native/__init__.py`` on first use::

    g++ -O3 -march=native -shared -fPIC -std=c++17 <src>.cpp -o <lib>.so

The lossy-codec shim (``lavc.cpp``) also needs FFmpeg's headers and
libraries; where the headers are absent it is not built and the callers
take the ffmpeg CLI, or raise (``utils/audio_io.py``).
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
BUILD = HERE.parent / "_build"
BASE_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def target(stem: str, extra: list[str] | None = None) -> pathlib.Path:
    """The library built from ``<stem>.cpp`` with ``extra`` flags."""
    key = (HERE / f"{stem}.cpp").read_bytes() + " ".join(
        BASE_FLAGS + (extra or [])).encode()
    return BUILD / f"lib{stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _compile(stem: str, verbose: bool,
             extra: list[str] | None = None) -> pathlib.Path | None:
    out = target(stem, extra)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *BASE_FLAGS, str(HERE / f"{stem}.cpp"), "-o", str(tmp),
           *(extra or [])]
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        if verbose:
            print(f"native build failed: {e}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    return out


def build(verbose: bool = True) -> pathlib.Path | None:
    return _compile("pcm", verbose)


def build_flac(verbose: bool = True) -> pathlib.Path | None:
    return _compile("flac", verbose)


def _lavc_include_dir() -> pathlib.Path | None:
    for d in ("/usr/include/x86_64-linux-gnu", "/usr/include",
              "/usr/local/include"):
        if (pathlib.Path(d) / "libavcodec" / "avcodec.h").exists():
            return pathlib.Path(d)
    return None


def build_lavc(verbose: bool = True) -> pathlib.Path | None:
    """Lossy-codec shim; needs the FFmpeg dev headers + shared libs.
    Returns None (callers fall back to the ffmpeg CLI / error contract)
    when they're absent."""
    inc = _lavc_include_dir()
    if inc is None:
        if verbose:
            print("lavc: FFmpeg dev headers not found", file=sys.stderr)
        return None
    return _compile("lavc", verbose,
                    extra=[f"-I{inc}", "-lavformat", "-lavcodec",
                           "-lswresample", "-lavutil"])


if __name__ == "__main__":
    ok = build() and build_flac()
    lavc = build_lavc()  # optional: absent headers is not a build failure
    print(f"lavc shim: {'built' if lavc else 'skipped'}", file=sys.stderr)
    sys.exit(0 if ok else 1)
