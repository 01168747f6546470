"""Output branding tags (reference: backend/app/metadata.py — mutagen-based
MASTERED_BY/ENCODER tags on export).  Implemented raw (no mutagen in this
image): ID3v2.3 prepend for MP3, VORBIS_COMMENT insertion for FLAC, LIST/INFO
chunk for WAV.  Best-effort: any failure returns the input unchanged, like
the reference's try/except wrapper (mastering.py:322-328).

The port's copy of ``amw_tpu/utils/metadata.py``: the same bytes.
"""

from __future__ import annotations

import struct

BRAND = "Magic Master TPU"
MASTERED_BY = "Magic Master — magicmaster.pro"


def _syncsafe(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])


def _id3_text_frame(fid: bytes, text: str) -> bytes:
    payload = b"\x00" + text.encode("latin-1", "replace")
    return fid + struct.pack(">I", len(payload)) + b"\x00\x00" + payload


def _id3_txxx(desc: str, value: str) -> bytes:
    payload = (b"\x00" + desc.encode("latin-1", "replace") + b"\x00"
               + value.encode("latin-1", "replace"))
    return b"TXXX" + struct.pack(">I", len(payload)) + b"\x00\x00" + payload


def brand_mp3(data: bytes) -> bytes:
    if data[:3] == b"ID3":
        return data  # keep existing tag untouched
    frames = (_id3_text_frame(b"TENC", BRAND)
              + _id3_txxx("MASTERED_BY", MASTERED_BY))
    header = b"ID3\x03\x00\x00" + _syncsafe(len(frames))
    return header + frames + data


def brand_flac(data: bytes) -> bytes:
    if data[:4] != b"fLaC":
        return data
    pos = 4
    blocks = []
    has_comment = False
    while pos + 4 <= len(data):
        hdr = data[pos]
        btype = hdr & 0x7F
        last = bool(hdr & 0x80)
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        blocks.append((btype, data[pos + 4:pos + 4 + size]))
        pos += 4 + size
        if btype == 4:
            has_comment = True
        if last:
            break
    audio = data[pos:]
    if has_comment:
        return data
    vendor = BRAND.encode()
    comments = [f"ENCODER={BRAND}".encode(),
                f"MASTERED_BY={MASTERED_BY}".encode()]
    body = struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", len(comments))
    for c in comments:
        body += struct.pack("<I", len(c)) + c
    blocks.append((4, body))
    out = b"fLaC"
    for i, (btype, payload) in enumerate(blocks):
        flag = 0x80 if i == len(blocks) - 1 else 0x00
        out += bytes([flag | btype]) + len(payload).to_bytes(3, "big") + payload
    return out + audio


def brand_wav(data: bytes) -> bytes:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return data
    soft = BRAND.encode() + b"\x00"
    if len(soft) % 2:
        soft += b"\x00"
    info = b"INFO" + b"ISFT" + struct.pack("<I", len(soft)) + soft
    chunk = b"LIST" + struct.pack("<I", len(info)) + info
    riff_size = struct.unpack("<I", data[4:8])[0] + len(chunk)
    return data[:4] + struct.pack("<I", riff_size) + data[8:] + chunk


def embed_branding(data: bytes, fmt: str) -> bytes:
    try:
        fmt = (fmt or "").lower()
        if fmt == "mp3":
            return brand_mp3(data)
        if fmt == "flac":
            return brand_flac(data)
        if fmt == "wav":
            return brand_wav(data)
        return data
    except Exception:  # noqa: BLE001
        return data
