"""Minimal Standard MIDI File (type 0) writer + reader.

The port's copy of ``inpaintnet_tpu/data/midi.py``, numpy only: the two must
give the same bytes.

The reference exports listening-test material via music21's MIDI writer
(``score.write('midi', fp=...)``, script_gen_diff_models.py:232-233). This
module writes Score IR directly to SMF: one track, 480 ticks/quarter,
tempo 120, program 0. The reader exists for roundtrip tests.
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Tuple

from inpaintnet_tpu_torch.data.score import Score

TICKS_PER_QUARTER = 480
DEFAULT_TEMPO_US = 500_000  # 120 bpm
DEFAULT_VELOCITY = 80


def _varlen(value: int) -> bytes:
    out = bytearray([value & 0x7F])
    value >>= 7
    while value:
        out.insert(0, 0x80 | (value & 0x7F))
        value >>= 7
    return bytes(out)


def score_to_midi_bytes(score: Score, velocity: int = DEFAULT_VELOCITY) -> bytes:
    events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
    for n in score.notes:
        if n.is_rest:
            continue
        start = int(n.offset * TICKS_PER_QUARTER)
        end = int(n.end * TICKS_PER_QUARTER)
        pitch = max(0, min(127, n.pitch.midi))
        events.append((start, 1, bytes([0x90, pitch, velocity])))
        events.append((end, 0, bytes([0x80, pitch, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    # tempo + time signature meta events
    track += b"\x00\xff\x51\x03" + struct.pack(">I", DEFAULT_TEMPO_US)[1:]
    num, den = score.time_signature
    den_pow = max(0, den.bit_length() - 1)
    track += b"\x00\xff\x58\x04" + bytes([num, den_pow, 24, 8])
    track += b"\x00\xc0\x00"  # program change: acoustic grand

    last_tick = 0
    for tick, _, payload in events:
        track += _varlen(tick - last_tick) + payload
        last_tick = tick
    track += b"\x00\xff\x2f\x00"  # end of track

    header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, TICKS_PER_QUARTER)
    return header + b"MTrk" + struct.pack(">I", len(track)) + bytes(track)


def write_midi(score: Score, path: str, velocity: int = DEFAULT_VELOCITY):
    with open(path, "wb") as f:
        f.write(score_to_midi_bytes(score, velocity))


def read_midi_notes(path: str) -> List[Tuple[Fraction, Fraction, int]]:
    """Parse note (offset, duration, pitch) triples back out of an SMF file
    written by this module (single track, no running-status tricks needed —
    but running status is handled for robustness)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"MThd"
    division = struct.unpack(">H", data[12:14])[0]
    pos = 14
    notes = []
    active = {}
    while pos < len(data):
        assert data[pos : pos + 4] == b"MTrk"
        length = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        end = pos + 8 + length
        pos += 8
        tick = 0
        status = 0
        while pos < end:
            # delta time
            delta = 0
            while True:
                b = data[pos]
                pos += 1
                delta = (delta << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            tick += delta
            b = data[pos]
            if b & 0x80:
                status = b
                pos += 1
            if status == 0xFF:  # meta
                pos += 1  # type
                ln = data[pos]
                pos += 1 + ln
                continue
            kind = status & 0xF0
            if kind in (0x90, 0x80):
                pitch, vel = data[pos], data[pos + 1]
                pos += 2
                if kind == 0x90 and vel > 0:
                    active[pitch] = tick
                else:
                    if pitch in active:
                        start = active.pop(pitch)
                        notes.append(
                            (
                                Fraction(start, division),
                                Fraction(tick - start, division),
                                pitch,
                            )
                        )
            elif kind in (0xC0, 0xD0):
                pos += 1
            else:
                pos += 2
    notes.sort()
    return notes
