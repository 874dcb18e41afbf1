"""ctypes bindings for the native C++ tokenizer (native/abctok.cpp).

The port's copy of ``inpaintnet_tpu/data/native.py``, numpy only: the two must
give the same bytes.

The native library implements the offline tokenizer hot path — ABC parse,
repeat expansion, pickup/last-bar fixes, transposition with diatonic
spelling, tick-grid encoding — behind a C ABI. The Python implementation in
``data/{abc_parser,tokenizer}.py`` remains the reference (equivalence is
test-enforced); the native path accelerates corpus-scale AOT tokenization
(the step that takes the reference hours through music21).

Use: ``NativeTokenizer.available()`` then ``encode_transpositions(...)``;
``FolkDatasetNBars`` picks it up automatically when built (env
``INPAINTNET_NATIVE=0`` disables).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_LIB_DIR, "libabctok.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("INPAINTNET_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_LIB_DIR, "abctok.cpp")
        if not os.path.exists(src):
            return None
        try:
            subprocess.run(
                ["make", "-C", _LIB_DIR], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.abctok_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
    lib.abctok_info.restype = ctypes.c_int
    lib.abctok_scan.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.abctok_scan.restype = ctypes.c_int
    lib.abctok_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.abctok_encode.restype = ctypes.c_int
    lib.abctok_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


class NativeTokenizer:
    """Thin OO wrapper; one instance caches the joined vocab bytes."""

    def __init__(self, vocab_tokens: Sequence[str], pitch_range=(55, 84)):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native tokenizer unavailable")
        self.vocab_bytes = "\n".join(vocab_tokens).encode()
        self.lo, self.hi = pitch_range

    @staticmethod
    def available() -> bool:
        return _load() is not None

    @staticmethod
    def last_error() -> str:
        lib = _load()
        return lib.abctok_last_error().decode() if lib else "library not loaded"

    @staticmethod
    def info(abc_text: str) -> Optional[dict]:
        """Parse + fix; returns dict or None on parse failure."""
        lib = _load()
        out = (ctypes.c_int32 * 7)()
        rc = lib.abctok_info(abc_text.encode(), out)
        if rc != 0:
            return None
        return {
            "ts": (out[0], out[1]),
            "num_notes": out[2],
            "min_pitch": out[3],
            "max_pitch": out[4],
            "total_ticks": out[5],
            "on_grid": bool(out[6]),
        }

    @staticmethod
    def scan_tokens(abc_text: str, semitones: Sequence[int],
                    pitch_range=(55, 84)) -> Optional[List[str]]:
        """All token names over the given transpositions (vocab pass)."""
        lib = _load()
        semis = (ctypes.c_int32 * len(semitones))(*semitones)
        cap = 1 << 22
        buf = ctypes.create_string_buffer(cap)
        n = lib.abctok_scan(
            abc_text.encode(), semis, len(semitones),
            pitch_range[0], pitch_range[1], buf, cap,
        )
        if n < 0:
            return None
        return buf.value.decode().splitlines()

    def encode_transpositions(
        self, abc_text: str, semitones: Sequence[int], max_len: int = 4096
    ) -> Optional[List[np.ndarray]]:
        """Token-id sequences for each transposition, or None on failure."""
        semis = (ctypes.c_int32 * len(semitones))(*semitones)
        out = np.zeros((len(semitones), max_len), dtype=np.int32)
        lens = np.zeros((len(semitones),), dtype=np.int32)
        rc = self.lib.abctok_encode(
            abc_text.encode(), semis, len(semitones), self.vocab_bytes,
            self.lo, self.hi,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len,
        )
        if rc != 0:
            return None
        return [out[i, : lens[i]].copy() if lens[i] >= 0 else None
                for i in range(len(semitones))]
